"""rt1_tpu_torch — RT-1 serving and training in PyTorch, for one NVIDIA H100.

A port of `rt1_tpu` (JAX) that imports torch and numpy and nothing of JAX
or of `rt1_tpu`. The module layout mirrors the JAX package, so
`rt1_tpu_torch/models/rt1.py` is the counterpart of `rt1_tpu/models/rt1.py`.
Public functions keep the JAX layouts (images NHWC, attention q/k/v
`(b, s, h, d)`); the conv tower permutes to NCHW inside.

The one hand-written kernel is the fused masked attention
(`parallel/flash_attention.py`, CUDA sources in `csrc/`), the counterpart
of the Pallas kernel in `rt1_tpu/parallel/flash_attention.py`; like it,
forward only, so training takes the dense attention path.

Entry points run on `cuda` unless the caller passes `device="cpu"`; without
CUDA they raise instead of falling back (`resolve_device`).
"""

from __future__ import annotations


def resolve_device(device=None) -> "torch.device":
    """The device an entry point runs on: `cuda` unless the caller asks for
    the CPU. Raises when CUDA is requested (or defaulted) but absent — the
    port never falls back to the CPU on its own. torch is imported here,
    not with the package, so the model-free fleet modules (router,
    supervisor, stub replica) import no torch."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to "
            "run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev
