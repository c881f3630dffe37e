"""Image dtype conversion and the train-time crop (counterpart of
`rt1_tpu/ops/image.py`).

Inference does not crop (`rt1_tpu/models/rt1.py` crops only when
training). The crop draws its offsets from the generator it is given, on
the images' device, and cuts the window out with index selects on that
device, so it needs no host sync.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def convert_dtype(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; float inputs pass through as float32."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images.to(torch.float32)


def random_shift_crop(images: torch.Tensor, generator: torch.Generator,
                      ratio: float = 0.07) -> torch.Tensor:
    """Zero-pad H/W by `int(dim * ratio)` on each side and crop back at one
    random offset for the whole batch, uniform over [0, 2 * pad] in each
    axis. (..., H, W, C) in and out, any leading batch dims."""
    h, w = images.shape[-3], images.shape[-2]
    ud_pad, lr_pad = int(h * ratio), int(w * ratio)
    padded = F.pad(images, (0, 0, lr_pad, lr_pad, ud_pad, ud_pad))
    dev = images.device
    shift_h = torch.randint(0, 2 * ud_pad + 1, (), generator=generator, device=dev)
    shift_w = torch.randint(0, 2 * lr_pad + 1, (), generator=generator, device=dev)
    rows = shift_h + torch.arange(h, device=dev)
    cols = shift_w + torch.arange(w, device=dev)
    return padded.index_select(-3, rows).index_select(-2, cols)


def convert_dtype_and_crop_images(images: torch.Tensor,
                                  generator: Optional[torch.Generator] = None,
                                  ratio: float = 0.07, train: bool = True) -> torch.Tensor:
    """dtype conversion, then (train only, ratio > 0) the random shift crop,
    which needs a generator."""
    images = convert_dtype(images)
    if train and ratio > 0:
        if generator is None:
            raise ValueError("the train-time crop needs a generator")
        images = random_shift_crop(images, generator, ratio)
    return images
