"""Image dtype conversion (counterpart of `rt1_tpu/ops/image.py`).

Inference does not crop (`rt1_tpu/models/rt1.py` crops only when training),
so `convert_dtype` is the only op the serving path needs.
"""

from __future__ import annotations

import torch


def convert_dtype(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; float inputs pass through as float32."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images.to(torch.float32)
