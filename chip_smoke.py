#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (`rt1_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases kernel,ab    # a quick kernel check

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without a result line:

1. device  — requires CUDA; prints `nvidia-smi --query-gpu=name,power.limit`.
2. build   — builds both attention kernels (`rt1_tpu_torch/csrc/
             fused_attention.cu`, the simple kernel, and
             `fused_attention_tc.cu`, the bf16 tensor-core kernel; one nvcc
             per source for sm_90a, in parallel) from the checkout, and
             prints ptxas's registers and spills per kernel.
3. kernel  — holds the kernels against their plain PyTorch version
             (`fused_attention_reference`) on the card: the serve shape
             q/k/v (b, 66, 8, 128) at the buckets 1/2/4/8, f32 and bf16, no
             mask / the RT-1 mask / causal / the RT-1 mask with fully masked
             rows; q/k/v as strided views of one packed projection; s=1;
             ragged s=37; s=256 and s=320 (several key tiles), with rows whose
             first key tile is fully masked; d=256, 64, 48 and 40.
             Tolerance 2e-5 in f32, 2e-2 in bf16, and in bf16 also at most
             one bf16 ulp of the reference (at max(|ref|, 2^-4)). Every bf16
             case with d % 16 == 0 must run the tensor-core kernel, every
             other case the simple one (per-variant launch counts). Times
             each kernel, the plain version and
             `scaled_dot_product_attention` (a yardstick only; the port never
             calls it) with CUDA events and, at the serve shape, the
             profiler's device time.
4. ab      — the simple kernel in bf16 against the tensor-core kernel at the
             serve shape, in turns (simple, tc, tc, simple), CUDA events and
             device time, beside SDPA; and the host's wall time per call
             over 200 calls issued without synchronising (kernel and SDPA).
5. sweep   — query slices (16 rows, one compute warp each) per block of
             the tensor-core kernel at the serve shape, b = 8 and b = 1,
             each setting held to the reference; prints the fastest.
6. parity  — the flagship policy (FiLM-EfficientNet-B3 at 256x456, 8 decoder
             layers) from one seeded set of weights, one `infer_step` at
             batch 2 in f32 on the card (simple kernel, TF32 off for cuDNN
             and cuBLAS) against the same on the CPU (plain path): step
             logits within 1e-3 x max|logit|, image tokens within 1e-3 of
             their own scale, action tokens equal wherever the top-2 gap
             allows; exactly one simple-kernel launch per layer and no
             tensor-core launch.
7. step    — one full-bucket (8 sessions) batched step of the flagship
             engine in process: host wall time, the card's busy time and
             idle share from torch.profiler, and the costliest kernels;
             tensor-core launches = 8 x engine steps, simple launches 0.
8. serve   — the main path: `python -m rt1_tpu_torch.serve --config
             language_table --random_init --port 0` (bf16, fused attention),
             3 sessions x 8 `/act` steps of 256x456 `image_b64` frames over
             HTTP, then `/reset`; every reply 200, actions finite and in
             bounds, the tensor-core kernel's launch count (which starts at
             0 in the new server process) equal to 8 x the engine's batched
             steps, warm-up included, and the simple kernel's 0; SIGTERM
             drains with exit 0.
9. kernels — one line listing both kernels with their launches on their
             path (serve for the tensor-core kernel, the f32 parity step
             for the simple one), errors, times and bound.

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
    buckets 1, 2, 4 and 8. Each bf16 case with d % 16 == 0 runs the
    tensor-core kernel (d = 48 and 64 with the head dim padded in shared
    memory); float32 and d = 40 run the simple kernel
    (`flash_attention._variant`)."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        for mask in ("none", "rt1", "causal", "rt1_masked_rows"):
            cases.append((f"serve_b8_{dtype}_{mask}", 8, 66, 8, 128, dtype, mask))
    cases += [
        ("serve_b1_bfloat16_rt1", 1, 66, 8, 128, "bfloat16", "rt1"),
        ("serve_b2_bfloat16_rt1", 2, 66, 8, 128, "bfloat16", "rt1"),
        ("serve_b4_bfloat16_rt1", 4, 66, 8, 128, "bfloat16", "rt1"),
        ("packed_qkv_b8_bfloat16_rt1", 8, 66, 8, 128, "bfloat16", "rt1"),
        ("s1_bfloat16_none", 8, 1, 8, 128, "bfloat16", "none"),
        ("ragged_s37_float32_causal", 8, 37, 8, 128, "float32", "causal"),
        ("ragged_s37_bfloat16_causal", 8, 37, 8, 128, "bfloat16", "causal"),
        ("s256_float32_none", 2, 256, 8, 128, "float32", "none"),
        ("s256_bfloat16_causal", 2, 256, 8, 128, "bfloat16", "causal"),
        ("s256_bfloat16_first_tile_masked", 2, 256, 8, 128, "bfloat16", "first_tile_masked"),
        ("s320_bfloat16_causal", 2, 320, 8, 128, "bfloat16", "causal"),
        ("s256_d256_bfloat16_causal", 2, 256, 8, 256, "bfloat16", "causal"),
        ("s256_d256_bfloat16_first_tile_masked", 2, 256, 8, 256, "bfloat16", "first_tile_masked"),
        ("d64_float32_rt1", 8, 66, 8, 64, "float32", "rt1"),
        ("d64_bfloat16_rt1", 8, 66, 8, 64, "bfloat16", "rt1"),
        ("d48_bfloat16_rt1", 8, 66, 8, 48, "bfloat16", "rt1"),
        ("d40_bfloat16_rt1", 8, 66, 8, 40, "bfloat16", "rt1"),
    ]
    return cases


def make_mask(kind, s):
    """The (s, s) uint8 mask of a case on the card (None for "none").
    "rt1_masked_rows" zeroes three whole rows of the RT-1 mask;
    "first_tile_masked" is causal, and rows from 128 on attend only to keys
    from 128 on, so their first key tile (128 keys at d <= 128, 64 at
    d = 256) is fully masked and the online softmax must rescale."""
    import numpy as np
    import torch

    from rt1_tpu_torch.models.rt1 import rt1_attention_mask

    if kind == "none":
        return None
    if kind in ("rt1", "rt1_masked_rows"):
        m = np.array(rt1_attention_mask(6, 8, 3), np.uint8)
        if kind == "rt1_masked_rows":
            m[[0, 30, 65]] = 0
    else:
        m = np.tril(np.ones((s, s), np.uint8))
        if kind == "first_tile_masked":
            m[128:, :128] = 0
    return torch.from_numpy(m).cuda()


def bf16_ulp_err(out, ref):
    """Largest |out - ref| in bf16 ulps of the reference, the ulp taken at
    max(|ref|, 2**-4): both sides round an fp32 value that agrees to about
    2e-5, so an honest kernel is at most one rounding step away."""
    import torch

    mag = ref.float().abs().clamp_min(2.0 ** -4)
    _, exp = torch.frexp(mag)  # mag = m * 2**exp, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(mag), exp - 8)  # 2**(floor(log2 mag) - 7)
    return float(((out.float() - ref.float()).abs() / ulp).max())


def _qkv(rng, b, s, h, d, tdt, packed=False):
    import numpy as np
    import torch

    if packed:  # q/k/v as views of one (b, s, 3, h, d) projection
        x = torch.from_numpy(rng.standard_normal((b, s, 3, h, d), dtype=np.float32))
        x = x.to("cuda", tdt)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]
    return tuple(
        torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32)).to("cuda", tdt)
        for _ in range(3)
    )


def phase_kernel():
    """Kernels vs plain on the card. Returns the per-case records."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rt1_tpu_torch.parallel import flash_attention as fa
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, fused_attention_reference

    # The plain version's einsums in full fp32 (no TF32), as on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    records = []
    for name, b, s, h, d, dtype, mask_kind in kernel_cases():
        tdt = getattr(torch, dtype)
        q, k, v = _qkv(rng, b, s, h, d, tdt, packed=name.startswith("packed_"))
        mask = make_mask(mask_kind, s)
        scale = 1.0 / d ** 0.5
        expected = "tensor_core" if dtype == "bfloat16" and d % 16 == 0 else "simple"
        before = dict(fused_attention.launches_by_variant)
        out = fused_attention(q, k, v, mask=mask, scale=scale)
        ref = fused_attention_reference(q, k, v, mask=mask, scale=scale)
        torch.cuda.synchronize()
        ran = [x for x in fa.VARIANTS if fused_attention.launches_by_variant[x] != before[x]]
        if ran != [expected]:
            raise AssertionError(f"kernel case {name}: ran {ran}, expected {expected}")
        err = float((out.float() - ref.float()).abs().max())
        ulps = bf16_ulp_err(out, ref) if dtype == "bfloat16" else None
        if not (torch.isfinite(out).all() and err <= TOL[dtype]) or (ulps is not None and ulps > 1.0):
            raise AssertionError(f"kernel case {name}: max abs err {err} (tol {TOL[dtype]}), "
                                 f"{ulps} bf16 ulps (tol 1)")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_mask = None if mask is None else mask.bool()
        record = {
            "phase": "kernel", "case": name, "variant": expected, "shape": [b, s, h, d],
            "dtype": dtype, "mask": mask_kind, "max_abs_err": err, "tol": TOL[dtype],
            "max_err_ulps": ulps,
            "kernel_ms": cuda_time_ms(lambda: fused_attention(q, k, v, mask=mask, scale=scale)),
            "plain_ms": cuda_time_ms(lambda: fused_attention_reference(q, k, v, mask=mask, scale=scale)),
            "library_ms": cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask, scale=scale)
            ),
        }
        record["bound_ms"], record["bound_by"] = attention_bound(b, s, h, d, dtype, mask is not None)
        if name.startswith("serve_b8_") and mask_kind == "rt1":
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


def _serve_inputs(b=8):
    """q/k/v (b, 66, 8, 128) bf16 and the RT-1 mask: the serve shape."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, b, 66, 8, 128, torch.bfloat16)
    return q, k, v, make_mask("rt1", 66), 1.0 / 128 ** 0.5


def phase_ab():
    """Same-run A/B at the serve shape: the simple kernel in bf16 against
    the tensor-core kernel, in turns (simple, tc, tc, simple), by CUDA
    events and by profiler device time, beside SDPA as the yardstick; and
    the host's cost per call (200 calls issued without synchronising)."""
    import torch
    import torch.nn.functional as F

    from rt1_tpu_torch.parallel import flash_attention as fa

    q, k, v, mask, scale = _serve_inputs()
    ref = fa.fused_attention_reference(q, k, v, mask=mask, scale=scale)
    runs = {"simple": lambda: fa._launch(q, k, v, mask, scale, variant="simple"),
            "tensor_core": lambda: fa._launch(q, k, v, mask, scale, variant="tensor_core")}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_mask = mask.bool()
    runs["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask,
                                                           scale=scale)
    for variant in ("simple", "tensor_core"):
        err = float((runs[variant]().float() - ref.float()).abs().max())
        if err > TOL["bfloat16"]:
            raise AssertionError(f"A/B: {variant} kernel max abs err {err}")
    turns = []
    for name in ("simple", "tensor_core", "tensor_core", "simple", "sdpa", "sdpa"):
        prof = device_profile(runs[name], iters=50)
        turns.append({"kernel": name, "ms": cuda_time_ms(runs[name]),
                      "device_ms": None if prof is None else prof["busy_ms"]})
    host_us = {}
    for name in ("tensor_core", "sdpa"):
        runs[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            runs[name]()
        host_us[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    record = {"phase": "ab", "shape": [8, 66, 8, 128], "dtype": "bfloat16", "mask": "rt1",
              "turns": turns, "host_us_per_call": host_us}
    emit(record)
    return record


def phase_sweep(values=(8, 3, 2, 1)):
    """Query slices (16 rows, one compute warp each) per block of the
    tensor-core kernel at the serve shape, b = 8 and b = 1: 8 (clamped to
    the 5 slices of s = 66) is one block per (batch, head) and one K/V read;
    fewer slices mean more blocks that re-read K/V from L2. Each setting is
    also held to the reference."""
    from rt1_tpu_torch.parallel import flash_attention as fa

    rows = []
    for b in (8, 1):
        q, k, v, mask, scale = _serve_inputs(b)
        ref = fa.fused_attention_reference(q, k, v, mask=mask, scale=scale)
        for slices in values:
            fn = lambda: fa._launch(q, k, v, mask, scale, variant="tensor_core", slices=slices)  # noqa: E731
            ulps = bf16_ulp_err(fn(), ref)
            if ulps > 1.0:
                raise AssertionError(f"sweep b={b} slices={slices}: {ulps} bf16 ulps")
            prof = device_profile(fn, iters=50)
            rows.append({"b": b, "slices": slices, "blocks": b * 8 * -(-5 // min(slices, 5)),
                         "ms": cuda_time_ms(fn),
                         "device_ms": None if prof is None else prof["busy_ms"],
                         "max_err_ulps": ulps})
    timed = [r for r in rows if r["b"] == 8 and r["device_ms"] is not None]
    best = min(timed, key=lambda r: r["device_ms"])["slices"] if timed else None
    record = {"phase": "sweep", "rows": rows, "fastest_slices_b8": best,
              "default_slices": fa.TC_SLICES_PER_BLOCK}
    emit(record)
    return record


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
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

    outs = {}
    for dev in (device, "cpu"):
        policy = load_policy(config, device=dev, attention_impl="fused")
        if dev == device:
            reset_launch_counts()  # counts this path's launches only
        t0 = time.perf_counter()
        with torch.no_grad():
            obs = {"image": torch.from_numpy(frame).to(dev),
                   "natural_language_embedding": torch.from_numpy(emb).to(dev)}
            out, state = policy.infer_step(obs, policy.initial_state(batch))
            outs[dev] = (out["action_logits"].cpu().double(), out["action_tokens"].cpu(),
                         state["context_image_tokens"].cpu().double())
        outs[dev + "_s"] = time.perf_counter() - t0
        if dev == device:
            launches = dict(fused_attention.launches_by_variant)
            layers = policy.num_layers
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
        "launches_by_variant": launches, "decoder_layers": layers,
    }
    emit(record)
    if diff > bound or unexplained or not token_rel_diff <= PARITY_REL_TOL:
        raise AssertionError(f"flagship parity: logit diff {diff} (bound {bound}), "
                             f"image-token relative diff {token_rel_diff}, "
                             f"{unexplained} token flips beyond the bound")
    # One f32 infer_step: one simple-kernel launch per decoder layer.
    if launches != {"tensor_core": 0, "simple": layers}:
        raise AssertionError(f"flagship parity: launches {launches}, expected {layers} simple")
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
    from rt1_tpu_torch.parallel.flash_attention import fused_attention, reset_launch_counts

    engine, _ = build_serve_engine(config, device=device, attention_impl="fused",
                                   max_sessions=bucket, buckets=pow2_buckets(bucket))
    reset_launch_counts()
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
    launches = dict(fused_attention.launches_by_variant)
    expected = {"tensor_core": engine.policy.num_layers * engine.steps_total, "simple": 0}
    record = {"phase": "step", "config": config_name, "bucket": bucket, "dtype": engine.dtype,
              "wall_ms": sorted(walls), "launches_by_variant": launches,
              "engine_steps_total": engine.steps_total}
    if launches != expected:
        raise AssertionError(f"step: launches {launches}, expected {expected}")
    if prof is not None:
        top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:8]
        # Both attention kernels' names hold "attention"; nothing else in the step does.
        attn = sum(ms for name, ms in prof["kernels"].items() if "attention" in name)
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
            tc_launches = int(metrics["attention_launches_tensor_core_total"])
            simple_launches = int(metrics["attention_launches_simple_total"])
            steps = int(metrics["engine_steps_total"])
            layers = int(metrics["decoder_layers"])
            expected = layers * steps if device == "cuda" else 0
            # bf16 serving runs the tensor-core kernel only.
            if (device == "cuda" and launches <= 0) or tc_launches != expected or \
                    simple_launches != 0 or launches != tc_launches:
                raise AssertionError(f"serve: {tc_launches} tensor-core and {simple_launches} "
                                     f"simple launches, expected {layers} x {steps} and 0")
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
        "attention_launches_tensor_core_total": tc_launches,
        "attention_launches_simple_total": simple_launches,
        "decoder_layers": layers, "compile_count": metrics["compile_count"],
    }
    emit(record)
    return record


def _kernel_entry(name, source, launches, path, head, cases):
    """One entry of the `kernels` line: the kernel's numbers at `head` (the
    case of its path's shape) and its largest error over `cases`."""
    ulps = [r["max_err_ulps"] for r in cases if r["max_err_ulps"] is not None]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": "rt1_tpu/parallel/flash_attention.py:34",
        "launches": launches, "path": path,
        "max_abs_err": max(r["max_abs_err"] for r in cases),
        "max_err_ulps": max(ulps) if ulps else None,
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "device_ms": head.get("device_ms"),
        "plain_device_ms": head.get("plain_device_ms"),
        "library_device_ms": head.get("library_device_ms"),
        "shape": head["shape"], "dtype": head["dtype"],
    }


PHASES = ("kernel", "ab", "sweep", "parity", "step", "serve")


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of %(default)s (build and device always "
                             "run); the kernels and ok lines need all of them")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        parser.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
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
    seconds = flash_attention.build_seconds()
    library = flash_attention.library_path()
    report = library + ".ptxas.txt"
    ptxas = []
    if os.path.exists(report):
        with open(report) as f:
            ptxas = [line.strip() for line in f if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": seconds, "library": os.path.relpath(library, REPO),
          "ptxas": ptxas})
    done = {}
    for phase in PHASES:
        if phase in phases:
            done[phase] = globals()["phase_" + phase]()
    if set(phases) != set(PHASES):
        print(smi, flush=True)
        emit({"partial": phases, "passed": True})
        return 0
    records, serve, parity = done["kernel"], done["serve"], done["parity"]
    tc_cases = [r for r in records if r["variant"] == "tensor_core"]
    simple_cases = [r for r in records if r["variant"] == "simple"]
    emit({"kernels": [
        _kernel_entry(
            "fused_attention_tc", "rt1_tpu_torch/csrc/fused_attention_tc.cu",
            serve["attention_launches_tensor_core_total"], "serve (bf16)",
            next(r for r in records if r["case"] == "serve_b8_bfloat16_rt1"), tc_cases),
        _kernel_entry(
            "fused_attention_simple", "rt1_tpu_torch/csrc/fused_attention.cu",
            parity["launches_by_variant"]["simple"], "flagship infer_step (float32)",
            next(r for r in records if r["case"] == "serve_b8_float32_rt1"), simple_cases),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
