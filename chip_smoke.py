#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (`rt1_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without a result line:

1. device  — requires CUDA; prints `nvidia-smi --query-gpu=name,power.limit`.
2. build   — builds the fused attention kernel (`rt1_tpu_torch/csrc/
             fused_attention.cu`, nvcc for sm_90a) from the checkout.
3. kernel  — holds the kernel against its plain PyTorch version
             (`fused_attention_reference`) on the card, on the main path's
             shapes (q/k/v (b, 66, 8, 128) at the serving buckets, f32 and
             bf16, no mask / the RT-1 mask / causal) and on a ragged s=37,
             s=256 and d=64; tolerance 2e-5 in f32, 2e-2 in bf16. Times the
             kernel, the plain version and `scaled_dot_product_attention`
             (a yardstick only; the port never calls it) with CUDA events.
4. parity  — the flagship policy (FiLM-EfficientNet-B3 at 256x456, 8 decoder
             layers) from one seeded set of weights, one `infer_step` at
             batch 2 in f32 on the card (fused kernel, TF32 off for cuDNN and
             cuBLAS) against the same on the CPU (plain path): step logits
             within 1e-3 x max|logit|, image tokens within 1e-3 of their
             own scale, action tokens equal wherever the top-2 gap allows.
5. step    — one full-bucket (8 sessions) batched step of the flagship
             engine in process: host wall time, the card's busy time and
             idle share from torch.profiler, and the costliest kernels.
6. serve   — the main path: `python -m rt1_tpu_torch.serve --config
             language_table --random_init --port 0` (bf16, fused attention),
             3 sessions x 8 `/act` steps of 256x456 `image_b64` frames over
             HTTP, then `/reset`; every reply 200, actions finite and in
             bounds, the kernel's launch count (which starts at 0 in the new
             server process) > 0 and equal to 8 x the engine's batched steps,
             warm-up included; SIGTERM drains with exit 0.
7. kernels — one line listing every kernel of the path with its launches,
             error, times and bound.

The last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import base64
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM 3.35 TB/s; bf16 tensor cores
# 989 TFLOP/s; float32 outside the tensor cores 67 TFLOP/s. The kernel's
# bound takes the peak of its I/O type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# GPU-vs-CPU float32 parity of the flagship: both run the same math in full
# float32 (TF32 off); only the order of sums differs, across 26 MBConv
# blocks, BatchNorm, 8 decoder layers and 3 reductions per layer.
PARITY_REL_TOL = 1e-3

SERVE_SESSIONS = 3
SERVE_STEPS = 8
SERVE_TIMEOUT_S = 600


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 200) -> float:
    """Mean milliseconds of `fn` over `iters` back-to-back calls (CUDA events,
    after a warm-up)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 20):
    """What the card itself spent on `iters` calls of `fn`, from
    torch.profiler's CUDA activity: {"wall_ms", "busy_ms" (the union of
    device activity intervals), "kernels" ({name: total ms}), "launches"},
    each per call; None when the profiler fails or records no device
    activity (then the CUDA-event times stand alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    except RuntimeError as exc:  # CUPTI refused in this sandbox: not measured
        print(f"chip_smoke: torch.profiler failed: {exc}", file=sys.stderr)
        return None
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        return None
    busy_us, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, _ in spans[1:]:
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    kernels = {}
    for start, end, name in spans:
        kernels[name] = kernels.get(name, 0.0) + (end - start) / 1e3 / iters
    return {"wall_ms": wall_s * 1e3 / iters, "busy_ms": busy_us / 1e3 / iters,
            "kernels": kernels, "launches": len(spans) / iters}


def attention_bound(b, s, h, d, dtype: str, masked: bool):
    """Least time for the function on an H100: each of q, k, v, out moved
    once (plus the uint8 mask) over HBM, vs the two products' 4*b*h*s*s*d
    operations at the peak of the I/O type. Returns (ms, bound_by)."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * elem + (s * s if masked else 0)
    ops = 4 * b * h * s * s * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_cases():
    """(name, b, s, h, d, dtype, mask kind). The serve shape is the
    flagship window s = 6*(8+3) = 66 with 8 heads of 128, at the engine's
    buckets 1, 4 and 8."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        for mask in ("none", "rt1", "causal"):
            cases.append((f"serve_b8_{dtype}_{mask}", 8, 66, 8, 128, dtype, mask))
    cases += [
        ("serve_b1_bfloat16_rt1", 1, 66, 8, 128, "bfloat16", "rt1"),
        ("serve_b4_bfloat16_rt1", 4, 66, 8, 128, "bfloat16", "rt1"),
        ("ragged_s37_float32_causal", 8, 37, 8, 128, "float32", "causal"),
        ("ragged_s37_bfloat16_causal", 8, 37, 8, 128, "bfloat16", "causal"),
        ("s256_float32_none", 2, 256, 8, 128, "float32", "none"),
        ("s256_bfloat16_causal", 2, 256, 8, 128, "bfloat16", "causal"),
        ("d64_float32_rt1", 8, 66, 8, 64, "float32", "rt1"),
        ("d64_bfloat16_rt1", 8, 66, 8, 64, "bfloat16", "rt1"),
    ]
    return cases


def phase_kernel():
    """Kernel vs plain on the card. Returns the per-case records."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rt1_tpu_torch.models.rt1 import rt1_attention_mask
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, fused_attention_reference

    rng = np.random.default_rng(0)
    records = []
    for name, b, s, h, d, dtype, mask_kind in kernel_cases():
        tdt = getattr(torch, dtype)
        q, k, v = (
            torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32)).to("cuda", tdt)
            for _ in range(3)
        )
        if mask_kind == "none":
            mask = None
        elif mask_kind == "rt1":
            mask = torch.from_numpy(rt1_attention_mask(6, 8, 3)).cuda()
        else:
            mask = torch.tril(torch.ones((s, s), dtype=torch.uint8, device="cuda"))
        scale = 1.0 / d ** 0.5
        out = fused_attention(q, k, v, mask=mask, scale=scale)
        ref = fused_attention_reference(q, k, v, mask=mask, scale=scale)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        if not (torch.isfinite(out).all() and err <= TOL[dtype]):
            raise AssertionError(f"kernel case {name}: max abs err {err} > {TOL[dtype]}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_mask = None if mask is None else mask.bool()
        record = {
            "phase": "kernel", "case": name, "shape": [b, s, h, d], "dtype": dtype,
            "mask": mask_kind, "max_abs_err": err, "tol": TOL[dtype],
            "kernel_ms": cuda_time_ms(lambda: fused_attention(q, k, v, mask=mask, scale=scale)),
            "plain_ms": cuda_time_ms(lambda: fused_attention_reference(q, k, v, mask=mask, scale=scale)),
            "library_ms": cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask, scale=scale)
            ),
        }
        record["bound_ms"], record["bound_by"] = attention_bound(b, s, h, d, dtype, mask is not None)
        if name.startswith("serve_"):
            # Device-only time per call: the event times above include the
            # host's launch cost whenever the host, not the card, is slower.
            for key, fn in (
                ("device_ms", lambda: fused_attention(q, k, v, mask=mask, scale=scale)),
                ("plain_device_ms", lambda: fused_attention_reference(q, k, v, mask=mask, scale=scale)),
                ("library_device_ms", lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask, scale=scale)),
            ):
                prof = device_profile(fn)
                record[key] = None if prof is None else prof["busy_ms"]
        emit(record)
        records.append(record)
    return records


def phase_parity(device: str = "cuda", config_name: str = "language_table", batch: int = 2):
    """The flagship at f32 on `device` (fused kernel) vs the CPU (plain)."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.eval.restore import load_policy

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = get_config(config_name)
    config.model.dtype = "float32"
    rng = np.random.default_rng(1)
    h, w = config.data.height, config.data.width
    frame = rng.uniform(0, 1, (batch, h, w, 3)).astype(np.float32)
    emb = rng.standard_normal((batch, 512)).astype(np.float32)
    outs = {}
    for dev in (device, "cpu"):
        policy = load_policy(config, device=dev, attention_impl="fused")
        t0 = time.perf_counter()
        with torch.no_grad():
            obs = {"image": torch.from_numpy(frame).to(dev),
                   "natural_language_embedding": torch.from_numpy(emb).to(dev)}
            out, state = policy.infer_step(obs, policy.initial_state(batch))
            outs[dev] = (out["action_logits"].cpu().double(), out["action_tokens"].cpu(),
                         state["context_image_tokens"].cpu().double())
        outs[dev + "_s"] = time.perf_counter() - t0
    logits, tokens, image_tokens = outs[device]
    cpu_logits, cpu_tokens, cpu_image_tokens = outs["cpu"]
    if not (torch.isfinite(logits).all() and torch.isfinite(image_tokens).all()):
        raise AssertionError("flagship parity: non-finite output on the card")
    scale = max(1.0, float(cpu_logits.abs().max()))
    bound = PARITY_REL_TOL * scale
    diff = float((logits - cpu_logits).abs().max())
    # At random init the B3 tower's output is tiny (each non-residual block
    # attenuates: SiLU and the SE gate both halve small activations), so the
    # tower is held to the same relative bound against its own scale.
    token_scale = float(cpu_image_tokens.abs().max())
    token_rel_diff = float((image_tokens - cpu_image_tokens).abs().max()) / max(token_scale, 1e-30)
    agree = tokens == cpu_tokens
    # A token may flip only where the CPU's top-2 logits lie within the bound.
    top2 = cpu_logits.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    unexplained = int((~agree & (gap > 2 * bound)).sum())
    record = {
        "phase": "parity", "config": config_name, "batch": batch, "dtype": "float32",
        "tf32": False, "attention": "fused (card) vs plain (cpu)",
        "max_abs_logit_diff": diff, "bound": bound, "max_abs_logit": scale,
        "max_abs_image_token": token_scale, "image_token_rel_diff": token_rel_diff,
        "action_token_agreement": float(agree.float().mean()),
        "step_s": {"device": outs[device + "_s"], "cpu": outs["cpu_s"]},
    }
    emit(record)
    if diff > bound or unexplained or not token_rel_diff <= PARITY_REL_TOL:
        raise AssertionError(f"flagship parity: logit diff {diff} (bound {bound}), "
                             f"image-token relative diff {token_rel_diff}, "
                             f"{unexplained} token flips beyond the bound")
    return record


def phase_step(config_name: str = "language_table", bucket: int = 8, iters: int = 5,
               device: str = "cuda"):
    """One full-bucket batched control step of the flagship engine (bf16,
    fused attention), in process: host wall time per step, the card's busy
    time and idle share, launches, and the kernels that take the most
    device time."""
    import numpy as np
    import torch

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.eval.restore import build_serve_engine
    from rt1_tpu_torch.serve.engine import pow2_buckets

    config = get_config(config_name)
    h, w = config.data.height, config.data.width
    engine, _ = build_serve_engine(config, device=device, attention_impl="fused",
                                   max_sessions=bucket, buckets=pow2_buckets(bucket))
    engine.warmup((h, w, 3))
    rng = np.random.default_rng(3)
    items = [
        (f"step-{i}", {"image": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
                       "natural_language_embedding": rng.standard_normal(512).astype(np.float32)})
        for i in range(bucket)
    ]
    for _ in range(3):
        engine.act_batch(items)
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        engine.act_batch(items)
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = device_profile(lambda: engine.act_batch(items), iters=iters)
    record = {"phase": "step", "config": config_name, "bucket": bucket, "dtype": engine.dtype,
              "wall_ms": sorted(walls)}
    if prof is not None:
        top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:8]
        attn = sum(ms for name, ms in prof["kernels"].items() if "fused_attention" in name)
        record.update({
            "profiled_wall_ms": prof["wall_ms"], "device_busy_ms": prof["busy_ms"],
            "idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"],
            "device_launches": prof["launches"], "attention_device_ms": attn,
            "top_kernels_ms": [[name[:80], ms] for name, ms in top],
        })
    emit(record)
    return record


def _http(url, payload=None, timeout=120):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _read_ready_line(proc, timeout_s):
    """The server's `{"status": "serving", ...}` line, read on a thread so a
    silent server cannot hang the script."""
    box = {}

    def reader():
        for line in proc.stdout:
            line = line.strip()
            if line.startswith("{") and '"status": "serving"' in line:
                box["ready"] = json.loads(line)
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout_s)
    if "ready" not in box:
        raise RuntimeError(f"server not ready after {timeout_s}s (exit code {proc.poll()})")
    return box["ready"]


def phase_serve(config_name: str = "language_table", device: str = "cuda"):
    """Drive the port's server over HTTP; the main path."""
    import numpy as np

    from rt1_tpu_torch.configs import get_config

    config = get_config(config_name)
    h, w = config.data.height, config.data.width
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "rt1_tpu_torch.serve", "--config", config_name,
           "--random_init", "--port", "0", "--device", device]
    with tempfile.TemporaryFile(mode="w+") as errlog:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=errlog, text=True)
        try:
            t0 = time.perf_counter()
            ready = _read_ready_line(proc, SERVE_TIMEOUT_S)
            startup_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{ready['port']}"
            rng = np.random.default_rng(2)
            frames = rng.integers(0, 256, (SERVE_SESSIONS, SERVE_STEPS, h, w, 3), dtype=np.uint8)
            replies = []
            lock = threading.Lock()

            def session(i):
                for step in range(SERVE_STEPS):
                    body = {"session_id": f"smoke-{i}",
                            "image_b64": base64.b64encode(frames[i, step].tobytes()).decode(),
                            "instruction": f"push block {i} to the top left corner"}
                    t = time.perf_counter()
                    code, out = _http(url + "/act", body)
                    with lock:
                        replies.append((code, out, time.perf_counter() - t))

            threads = [threading.Thread(target=session, args=(i,)) for i in range(SERVE_SESSIONS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(SERVE_TIMEOUT_S)
            if len(replies) != SERVE_SESSIONS * SERVE_STEPS:
                raise AssertionError(f"serve: {len(replies)} replies of {SERVE_SESSIONS * SERVE_STEPS}")
            for code, out, _ in replies:
                action = np.asarray(out.get("action", []), np.float64)
                tokens = np.asarray(out.get("action_tokens", []))
                if code != 200 or action.shape != (2,) or not np.isfinite(action).all():
                    raise AssertionError(f"serve: bad /act reply {code} {out}")
                if (np.abs(action) > 0.03 + 1e-7).any() or tokens.shape != (3,) or \
                        ((tokens < 0) | (tokens >= config.model.vocab_size)).any():
                    raise AssertionError(f"serve: action out of bounds {out}")
            for i in range(SERVE_SESSIONS):
                code, out = _http(url + "/reset", {"session_id": f"smoke-{i}"})
                if code != 200 or not out.get("ok"):
                    raise AssertionError(f"serve: /reset {code} {out}")
            _, metrics = _http(url + "/metrics")
            launches = int(metrics["attention_launches_total"])
            steps = int(metrics["engine_steps_total"])
            layers = int(metrics["decoder_layers"])
            expected = layers * steps if device == "cuda" else 0
            if (device == "cuda" and launches <= 0) or launches != expected:
                raise AssertionError(f"serve: {launches} kernel launches, expected {layers} x {steps}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            if rc != 0:
                raise AssertionError(f"serve: exit code {rc} after SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            if proc.returncode not in (0, None):
                errlog.seek(0)
                sys.stderr.write(errlog.read()[-8000:])
    lat_ms = np.sort([r[2] for r in replies]) * 1e3
    record = {
        "phase": "serve", "config": config_name, "dtype": ready["dtype"],
        "attention": ready["attention"], "requests": len(replies), "startup_s": startup_s,
        "client_p50_ms": float(np.percentile(lat_ms, 50)),
        "client_p99_ms": float(np.percentile(lat_ms, 99)),
        "client_latencies_ms": [round(float(x), 3) for x in lat_ms],
        "server_latency_p50_ms": metrics["latency_p50_ms"],
        "server_latency_p99_ms": metrics["latency_p99_ms"],
        "server_step_p50_ms": metrics["step_p50_ms"],
        "mean_batch_occupancy": metrics["mean_batch_occupancy"],
        "engine_steps_total": steps, "attention_launches_total": launches,
        "decoder_layers": layers, "compile_count": metrics["compile_count"],
    }
    emit(record)
    return record


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rt1_tpu_torch.parallel import flash_attention

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    emit({"phase": "build", "seconds": flash_attention.build_seconds(),
          "library": os.path.relpath(flash_attention.library_path(), REPO)})
    records = phase_kernel()
    phase_parity()
    phase_step()
    serve = phase_serve()
    head = next(r for r in records if r["case"] == "serve_b8_bfloat16_rt1")
    emit({"kernels": [{
        "name": "fused_attention",
        "route": "cuda",
        "source": "rt1_tpu_torch/csrc/fused_attention.cu",
        "replaces": "rt1_tpu/parallel/flash_attention.py:34",
        "launches": serve["attention_launches_total"],
        "max_abs_err": max(r["max_abs_err"] for r in records if r["dtype"] == "bfloat16"),
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "device_ms": head.get("device_ms"),
        "plain_device_ms": head.get("plain_device_ms"),
        "library_device_ms": head.get("library_device_ms"),
        "shape": head["shape"],
        "dtype": head["dtype"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
