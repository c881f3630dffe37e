"""Fused masked attention: hand-written CUDA kernels for Hopper.

Counterpart of `rt1_tpu/parallel/flash_attention.py`, whose Pallas TPU
kernel `_attention_kernel` (wrapper `fused_attention`) this replaces. Both
compute, per (batch, head),

    out = softmax(where(mask != 0, (q * scale) k^T, -1e9)) v

with logits, softmax and the PV product in fp32 and the result cast to
q's dtype. q/k/v/out are `(b, s, h, d)`; the optional mask is `(s, s)` and
shared by every (batch, head). Forward only: training takes the dense
path, as it does in the JAX package.

Three kernel variants, chosen per call by `_variant`:

* "tensor_core" (`csrc/fused_attention_tc.cu`): bf16 on the tensor cores
  (mma.sync with fp32 accumulate, P kept in fp32 as a bf16 hi + lo pair),
  cp.async copies, one K/V read per block. It takes bf16 with d a
  multiple of 16 up to 256 and every row 16-byte aligned: the serve path.
* "tf32x3" (`csrc/fused_attention_tf32x3.cu`): float32 on the tensor cores
  in 3xTF32 (every operand split as tf32 big + small, three mma products,
  fp32-grade), on the same skeleton. It takes float32 with d a multiple of
  8 up to 256 and every row 16-byte aligned: the float32 paths (the `tiny`
  config, a flagship run in float32, the parity check against the CPU).
* "simple" (`csrc/fused_attention.cu`): exact fp32 products on the CUDA
  cores, no TF32. It takes any call, and gets those the other two cannot:
  bf16 with d not a multiple of 16 (the `tiny` config's d = 8), float32
  with d not a multiple of 8, misaligned rows. At `tiny`'s shape (3.8 KB
  of q/k/v/out, 1.2 ns at 3.35 TB/s) its time is the launch and one
  block's chain of dependent steps, so the design
  keeps that chain short: Q, K, V and the mask bytes of a tile arrive in
  one round trip (16-byte loads where the pointers, strides and d allow,
  all issued before any is read), the key tile is sized to s (one pass up
  to 96-128 keys, an online softmax past it), and the warp that owns 4
  query rows scores them, reduces their softmax and runs their PV product
  over (row, 4-column) items without a block barrier between. At serve
  scale a block takes up to 3 slices of 16 rows, as many as keep one block
  for each SM, so that each (batch, head)'s K and V are read fewer times.

The sources are compiled with `nvcc` for `sm_90a`, in parallel, into one
library under `csrc/build/` on first use, and bound with `ctypes`. The
function's bound at the serve shape (b=8, s=66, h=8, d=128) is about
4.3 MB of q/k/v/out in bf16 (8.7 MB in float32), or 1.3 us (2.6 us) at
3.35 TB/s; its 0.14 GFLOP lie far below the tensor-core line. `PERF.md`
has the kernels' times.

`fused_attention` launches a kernel for CUDA tensors (or raises) and runs
`fused_attention_reference`, the plain PyTorch version of the same
function, for CPU tensors. `fused_attention.launches` counts kernel
launches in all and `fused_attention.launches_by_variant` per variant, so
a run can show which kernel its main path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import operator
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional, Sequence

import torch

NEG_INF = -1e9
MAX_HEAD_DIM = 256
VARIANTS = ("tensor_core", "tf32x3", "simple")
# Query slices of 16 rows (one compute warp each) per block of the
# tensor-core kernel (1..8): the fewer, the more blocks and the more K/V
# re-reads from L2. 3 was the fastest in the sweep of chip_smoke.py at the
# serve shape (PERF.md).
TC_SLICES_PER_BLOCK = 3
# The same for the tf32x3 kernel, whose float32 tiles are twice the bytes
# (chip_smoke.py sweeps it too; PERF.md).
TF32X3_SLICES_PER_BLOCK = 3

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = (
    os.path.join(_CSRC, "fused_attention.cu"),
    os.path.join(_CSRC, "fused_attention_tc.cu"),
    os.path.join(_CSRC, "fused_attention_tf32x3.cu"),
)
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: fp32 logits of `q * scale`
    against k, -1e9 where the mask is 0, fp32 softmax, fp32 PV, cast back to
    q's dtype. q/k/v: (b, s, h, d); mask: (s, s) nonzero = attend."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    qf = q.to(torch.float32) * scale
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.to(torch.float32))
    if mask is not None:
        logits = torch.where(mask.to(logits.device) != 0, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def _variant(dtype: torch.dtype, d: int, strides: Sequence[int], ptrs: Sequence[int]) -> str:
    """Which kernel takes a call. Both tensor-core kernels need every row
    to start 16-byte aligned: each data pointer and each batch/sequence/
    head stride in bytes a multiple of 16. Then bf16 with d a multiple of
    16 (at most 256) goes to "tensor_core" and float32 with d a multiple
    of 8 (at most 256) to "tf32x3"; every other call to "simple".
    `strides` are element strides of the non-last dims of q, k and v;
    `ptrs` their data pointers and the mask's, if any (the mask's rows
    need no alignment, its base does)."""
    if functools.reduce(operator.or_, ptrs) % 16 or not 1 <= d <= MAX_HEAD_DIM:
        return "simple"
    if functools.reduce(operator.or_, strides) * dtype.itemsize % 16:
        return "simple"
    if dtype == torch.bfloat16 and d % 16 == 0:
        return "tensor_core"
    if dtype == torch.float32 and d % 8 == 0:
        return "tf32x3"
    return "simple"


def variant_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> str:
    """The variant `_variant` names for a call on these tensors (the mask
    as the kernel receives it: uint8 and contiguous)."""
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if mask is not None:
        ptrs += (mask.data_ptr(),)
    strides = q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
    return _variant(q.dtype, q.shape[-1], strides, ptrs)


def _find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home:
            candidate = os.path.join(home, "bin", "nvcc")
            if os.path.exists(candidate):
                return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the fused attention kernels need it")
    return found


def library_path() -> str:
    """Where the built kernels live: keyed by a hash of every source, so an
    edit to any of them builds a new library instead of loading a stale one."""
    digest = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libfused_attention_{digest.hexdigest()[:16]}.so")


def _run(procs) -> str:
    """Wait for every (cmd, Popen), then raise on the first that failed, or
    return their joined output."""
    logs = [proc.communicate() for _, proc in procs]
    for (cmd, proc), (out, err) in zip(procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}{err}")
    return "".join(out + err for out, err in logs)


def build() -> str:
    """Compile every source for sm_90a (one nvcc per source, all started
    together) and link them into one library, unless this set of sources'
    library already exists. Concurrent builds (replicas of one fleet
    starting together) each work in a private temporary directory and
    rename the library into place; ptxas's report (registers, spills,
    shared memory per kernel) is written there too and renamed beside it
    as `<library>.ptxas.txt`, so neither file is ever seen half written.
    Returns the library's path."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        report = _run(procs)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        report_tmp = os.path.join(tmp, "ptxas.txt")
        with open(report_tmp, "w") as f:
            f.write(report)
        os.replace(report_tmp, path + ".ptxas.txt")
        os.replace(lib, path)
    return path


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    strides = [ctypes.c_longlong] * 12
    lib.rt1_fused_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + strides + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.rt1_fused_attention_tc_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + strides
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.rt1_fused_attention_tf32x3_fwd.argtypes = lib.rt1_fused_attention_tc_fwd.argtypes
    lib.rt1_fused_attention_fwd.restype = ctypes.c_int
    lib.rt1_fused_attention_tc_fwd.restype = ctypes.c_int
    lib.rt1_fused_attention_tf32x3_fwd.restype = ctypes.c_int
    return lib


def build_seconds() -> float:
    """Build (if needed) and load the kernel library; the seconds it took."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def _current_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on `device`."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def reset_launch_counts() -> None:
    """Zero the total and per-variant launch counts (before a run reads them)."""
    fused_attention.launches = 0
    fused_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def _launch(q, k, v, mask, scale, variant: Optional[str] = None,
            slices: Optional[int] = None) -> torch.Tensor:
    """Launch a kernel on CUDA tensors: the one `_variant` picks, or
    `variant` where the caller names one (comparisons and benchmarks;
    "tensor_core" and "tf32x3" raise on a call the rule does not give
    them, "simple" takes any). `slices` overrides the tensor-core kernels'
    TC_SLICES_PER_BLOCK / TF32X3_SLICES_PER_BLOCK."""
    b, s, h, d = q.shape
    dtype, device = q.dtype, q.device
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention kernels take float32 or bfloat16, got {dtype}")
    if k.dtype != dtype or v.dtype != dtype or k.device != device or v.device != device:
        raise ValueError("k and v must match q's dtype and device")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"fused_attention kernels take head dim 1..{MAX_HEAD_DIM}, got {d}")
    qst, kst, vst = q.stride(), k.stride(), v.stride()
    if qst[3] != 1 or kst[3] != 1 or vst[3] != 1:
        raise ValueError("q, k and v must be contiguous in their last (head) dim")
    lib = _library()  # builds on first use
    if mask is not None and (mask.dtype != torch.uint8 or mask.device != device
                             or not mask.is_contiguous()):
        mask = (mask != 0).to(device=device, dtype=torch.uint8).contiguous()
    chosen = variant_of(q, k, v, mask)
    if variant is None:
        variant = chosen
    elif variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    elif variant != "simple" and chosen != variant:
        raise ValueError(f"the {variant} kernel does not take this call: the rule gives it "
                         f"to {chosen}")
    out = torch.empty((b, s, h, d), dtype=dtype, device=device)
    # out is contiguous: strides (s*h*d, h*d, d).
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr())
    geometry = (b, s, h, d, *qst[:3], *kst[:3], *vst[:3], s * h * d, h * d, d, float(scale))
    stream = _current_stream(device)
    if variant == "tensor_core":
        err = lib.rt1_fused_attention_tc_fwd(*args, *geometry, slices or TC_SLICES_PER_BLOCK,
                                             stream)
    elif variant == "tf32x3":
        err = lib.rt1_fused_attention_tf32x3_fwd(*args, *geometry,
                                                 slices or TF32X3_SLICES_PER_BLOCK, stream)
    else:
        err = lib.rt1_fused_attention_fwd(*args, _DTYPE_CODES[dtype], *geometry, stream)
    if err != 0:
        raise RuntimeError(f"fused_attention {variant} kernel launch failed: cudaError {err}")
    fused_attention.launches += 1
    fused_attention.launches_by_variant[variant] += 1
    return out


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused masked attention. q/k/v: (b, s, h, d); mask: (s, s), nonzero =
    attend. CUDA tensors go through a hand-written kernel (or raise); CPU
    tensors through `fused_attention_reference`."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (b, s, h, d) shape, got {q.shape}, {k.shape}, {v.shape}")
    s = q.shape[1]
    if mask is not None and tuple(mask.shape) != (s, s):
        raise ValueError(f"mask must be ({s}, {s}), got {tuple(mask.shape)}")
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cuda":
        return _launch(q, k, v, mask, scale)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, mask, scale)
    raise ValueError(f"fused_attention runs on cuda or cpu tensors, got {q.device}")


reset_launch_counts()
