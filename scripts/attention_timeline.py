#!/usr/bin/env python3
"""Where the time of a tensor-core attention kernel goes, per phase.

Builds `rt1_tpu_torch/csrc/fused_attention_tc.cu` (bf16; with `--kernel
tf32x3`, `fused_attention_tf32x3.cu` in float32) with
-DRT1_ATTENTION_TIMELINE (a separate library under `csrc/build/`; the
wrapper's own build never sets it), launches it and reads back each warp's
stamps: the SM's clock64 at entry, after issuing the first copies, when Q
and K have landed, after S and the softmax, when V has landed, after the
PV product, and at the end; the same four stamps for the second key tile,
which runs warm code; for the tf32x3 kernel, also after the first tile's
mask bits and after its S product; and %globaltimer at entry, which gives
each block's start relative to the first. Cases: the serve shape q/k/v
(b, 66, 8, 128) in the kernel's dtype with the RT-1 mask (b = 8 and 1; 3
query slices per block, the wrapper's default, then 5 and 1) and without
a mask, and s = 256 (two or more key tiles). Prints the card's name and
power limit, then one JSON line per case with the median and maximum of
every phase in SM cycles, the SM clock (nvidia-smi), the launch's device
time from torch.profiler beside that of a one-element fill kernel (the
profiler's floor), and then one line with the SASS instruction count of
each kernel instance (cuobjdump).

Run on a machine with one H100, from the repository root:

    python3 scripts/attention_timeline.py                   # bf16 tensor-core kernel
    python3 scripts/attention_timeline.py --kernel tf32x3   # float32 3xTF32 kernel
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("issue", "wait_q_k", "s_softmax", "wait_v", "pv", "epilogue")
TILE1_PHASES = ("wait_k1", "s_softmax_1", "wait_v1", "pv_1")
# (b, s, mask, query slices per block); every block has WARPS = 8 warps.
WARPS = 8
CASES = ((8, 66, "rt1", 3), (8, 66, "none", 3), (1, 66, "rt1", 3), (8, 66, "rt1", 8),
         (8, 66, "rt1", 1), (2, 256, "causal", 8))


# --kernel: (source, C entry, dtype).
KERNELS = {"tc": ("fused_attention_tc.cu", "rt1_fused_attention_tc_fwd", "bfloat16"),
           "tf32x3": ("fused_attention_tf32x3.cu", "rt1_fused_attention_tf32x3_fwd", "float32")}


def build_timeline_library(kernel: str = "tc") -> str:
    from rt1_tpu_torch.parallel import flash_attention as fa

    src = os.path.join(fa._CSRC, KERNELS[kernel][0])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(fa.BUILD_DIR, f"libfused_attention_{kernel}_timeline_{digest}.so")
    if not os.path.exists(path):
        os.makedirs(fa.BUILD_DIR, exist_ok=True)
        cmd = [fa._find_nvcc(), *fa.NVCC_FLAGS, "-DRT1_ATTENTION_TIMELINE", "-shared",
               "-Xcompiler", "-fPIC", "-o", path, src]
        subprocess.run(cmd, check=True)
    return path


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def device_ms(fn, iters=50):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(spans) / 1e3 / iters if spans else None


def sass_sizes(path):
    """Instructions per kernel instance in the library's SASS."""
    import re

    from rt1_tpu_torch.parallel import flash_attention as fa

    tool = os.path.join(os.path.dirname(fa._find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
    sizes, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            sizes[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            sizes[name] += 1
    return sizes


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="tc")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_timeline: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from rt1_tpu_torch.models.rt1 import rt1_attention_mask

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    one = torch.zeros(1, device="cuda")
    floor_ms = device_ms(lambda: one.fill_(1.0))
    path = build_timeline_library(args.kernel)
    run_cases(ctypes.CDLL(path), floor_ms, rt1_attention_mask, args.kernel)
    print(json.dumps({"sass_instructions": sass_sizes(path)}), flush=True)
    return 0


def run_cases(lib, floor_ms, rt1_attention_mask, kernel="tc"):
    import numpy as np
    import torch

    _, entry, dtype = KERNELS[kernel]
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    for b, s, mask_kind, slices in CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, s, 8, 128), dtype=np.float32))
                   .to("cuda", getattr(torch, dtype)) for _ in range(3))
        out = torch.empty_like(q)
        if mask_kind == "rt1":
            mask = torch.from_numpy(np.asarray(rt1_attention_mask(6, 8, 3), np.uint8)).cuda()
        elif mask_kind == "causal":
            mask = torch.tril(torch.ones((s, s), dtype=torch.uint8, device="cuda"))
        else:
            mask = None
        chunks = -(-s // 16)
        spb = min(slices, chunks)
        blocks = b * 8 * -(-chunks // spb)
        stamps = torch.zeros((blocks, WARPS, 16), dtype=torch.int64, device="cuda")
        # The warps that compute: the first spb of a block, on rows below s.
        block_y = np.arange(blocks) // (b * 8)
        first_row = (block_y[:, None] * spb + np.arange(WARPS)[None, :]) * 16
        computing = (np.arange(WARPS)[None, :] < spb) & (first_row < s)

        def launch():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if mask is None else mask.data_ptr(), out.data_ptr(), b, s, 8, 128,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                     128 ** -0.5, slices, torch.cuda.current_stream().cuda_stream,
                     stamps.data_ptr())
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        for _ in range(10):
            launch()
        torch.cuda.synchronize()
        clock = sm_clock_mhz()
        launch()
        torch.cuda.synchronize()
        st = stamps.cpu().numpy()[computing]
        cyc = np.diff(st[:, 1:8], axis=1)  # the six phases, per warp
        start_ns = st[:, 0] - st[:, 0].min()
        total = st[:, 7] - st[:, 1]
        record = {
            "kernel": kernel, "b": b, "s": s, "mask": mask_kind, "slices": spb, "blocks": blocks,
            "sm_clock_mhz": clock,
            "phase_cycles_median": dict(zip(PHASES, np.median(cyc, 0).tolist())),
            "phase_cycles_max": dict(zip(PHASES, cyc.max(0).tolist())),
            "warp_total_cycles_median": float(np.median(total)),
            "warp_total_cycles_max": int(total.max()),
            "block_start_spread_ns": int(start_ns.max()),
            "device_ms": device_ms(launch),
            "fill_kernel_device_ms": floor_ms,
        }
        if kernel == "tf32x3":  # its slots 12-13 split S + softmax of the first tile
            split = np.diff(st[:, [3, 12, 13, 4]], axis=1)
            record["s_softmax_split_median"] = dict(
                zip(("mask_bits", "s_product", "softmax"), np.median(split, 0).tolist()))
        if s > 128:
            tile1 = np.diff(st[:, [6, 8, 9, 10, 11]], axis=1)
            record["tile1_cycles_median"] = dict(zip(TILE1_PHASES, np.median(tile1, 0).tolist()))
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    sys.exit(main())
