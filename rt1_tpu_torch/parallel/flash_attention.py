"""Fused masked attention: a hand-written CUDA kernel for Hopper.

Counterpart of `rt1_tpu/parallel/flash_attention.py`, whose Pallas TPU
kernel `_attention_kernel` (wrapper `fused_attention`) this replaces. Both
compute, per (batch, head),

    out = softmax(where(mask != 0, (q * scale) k^T, -1e9)) v

with logits, softmax and the PV product in fp32 and the result cast to q's
dtype. q/k/v/out are `(b, s, h, d)`; the optional mask is `(s, s)` and
shared by every (batch, head). Forward only: training takes the dense
path, as it does in the JAX package.

The kernel is `csrc/fused_attention.cu`, built with `nvcc` for `sm_90a`
into `csrc/build/` on first use and bound with `ctypes`. Its bound at the
serve shape (b=8, s=66, h=8, d=128, bf16) is about 4.3 MB of q/k/v/out, or
about 1.3 us at 3.35 TB/s; its arithmetic, about 0.14 GFLOP, lies far below
the tensor-core line, so the function is memory- and launch-bound. The
simple design (fp32 CUDA-core products, scalar tile loads, K/V re-read per
query block) runs far above that bound (`PERF.md`) and leaves wgmma and TMA
to a later redesign; see the note in the source.

`fused_attention` launches the kernel for CUDA tensors (or raises) and runs
`fused_attention_reference`, the plain PyTorch version of the same
function, for CPU tensors. `fused_attention.launches` counts kernel
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import torch

NEG_INF = -1e9
MAX_HEAD_DIM = 256

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCE = os.path.join(_CSRC, "fused_attention.cu")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
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


def _find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home:
            candidate = os.path.join(home, "bin", "nvcc")
            if os.path.exists(candidate):
                return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the fused attention kernel needs it")
    return found


def library_path() -> str:
    """Where the built kernel lives: keyed by the source's hash, so an edit
    to the source builds a new library instead of loading a stale one."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfused_attention_{digest}.so")


def build() -> str:
    """Compile `csrc/fused_attention.cu` for sm_90a unless this source's
    library already exists. Concurrent builders each compile into a private
    temporary file and rename it into place. Returns the library path."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    fn = lib.rt1_fused_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def build_seconds() -> float:
    """Build (if needed) and load the kernel library; the seconds it took."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def _launch(q, k, v, mask, scale) -> torch.Tensor:
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"fused_attention kernel takes head dim 1..{MAX_HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last (head) dim")
    kernel = _library().rt1_fused_attention_fwd  # builds on first use
    mask_ptr = None
    if mask is not None:
        if mask.dtype != torch.uint8 or mask.device != q.device or not mask.is_contiguous():
            mask = (mask != 0).to(device=q.device, dtype=torch.uint8).contiguous()
        mask_ptr = mask.data_ptr()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    err = kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        _DTYPE_CODES[q.dtype], b, s, h, d, *strides, float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: cudaError {err}")
    fused_attention.launches += 1
    return out


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused masked attention. q/k/v: (b, s, h, d); mask: (s, s), nonzero =
    attend. CUDA tensors go through the hand-written kernel (or raise); CPU
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


fused_attention.launches = 0
