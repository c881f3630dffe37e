"""Image dtype conversion, the train-time crop and the eval-side central
crop-resize (counterpart of `rt1_tpu/ops/image.py`).

Inference does not crop (`rt1_tpu/models/rt1.py` crops only when
training). The crop draws its two offsets from the generator it is given,
on the generator's device, and cuts the window out with index selects on
the images' device, so it needs no host sync: a host generator's offsets
(the train step's `crop_on_host`) enter the device's index arithmetic as
0-dim host scalars, with no copy.

`resize_bilinear` is `jax.image.resize(method="bilinear")`: half-pixel
centres and a triangle kernel widened by the scale when downscaling
(antialiased), its weights normalised per output pixel. It builds JAX's
two separable weight matrices (`scale_and_translate`'s rule, with the
sample coordinate rounded once as XLA's fused multiply-add rounds it) in
float32 on the images' device and applies them with two einsums, plain
torch ops. Rounded twice (as `F.interpolate(antialias=True)` and an
eager evaluation of JAX's rule round it) the coordinate can move by a
float32 ulp, 3e-5 near 320, and the weights with it.
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
    axis, drawn on `generator`'s device. (..., H, W, C) in and out, any
    leading batch dims."""
    h, w = images.shape[-3], images.shape[-2]
    ud_pad, lr_pad = int(h * ratio), int(w * ratio)
    padded = F.pad(images, (0, 0, lr_pad, lr_pad, ud_pad, ud_pad))
    dev, drawn_on = images.device, generator.device
    shift_h = torch.randint(0, 2 * ud_pad + 1, (), generator=generator, device=drawn_on)
    shift_w = torch.randint(0, 2 * lr_pad + 1, (), generator=generator, device=drawn_on)
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


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of one axis, as JAX's
    `compute_weight_mat` builds them for the triangle kernel (scale
    out / in, no translation, antialiased)."""
    inv_scale = 1.0 / (out_size / in_size)
    f32 = torch.float32
    # XLA fuses `(i + 0.5) * inv_scale - 0.5` into one multiply-add: one
    # rounding, which float64 (exact for the product of two float32s) gives.
    half = torch.arange(out_size, dtype=f32, device=device) + 0.5
    inv32 = torch.tensor(inv_scale, dtype=f32).item()
    sample = (half.to(torch.float64) * inv32 - 0.5).to(f32)
    kernel_scale = max(inv_scale, 1.0)
    x = (sample[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs()
    weights = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_bilinear(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize to (height, width); NHWC, any leading dims. An axis
    whose size does not change is left as it is, as JAX leaves it."""
    if not images.is_floating_point():
        images = images.to(torch.float32)
    h, w = images.shape[-3], images.shape[-2]
    if h != height:
        wh = _resize_weights(h, height, images.device).to(images.dtype)
        images = torch.einsum("...hwc,hH->...Hwc", images, wh)
    if w != width:
        ww = _resize_weights(w, width, images.device).to(images.dtype)
        images = torch.einsum("...hwc,wW->...hWc", images, ww)
    return images


def central_crop_and_resize(images: torch.Tensor, crop_factor: float, height: int,
                            width: int) -> torch.Tensor:
    """Deterministic centre crop of `int(h * crop_factor)` x `int(w *
    crop_factor)` at the floor-centred offset, then `resize_bilinear`: the
    eval-side counterpart of the train crop (the reference's
    `CentralCropImageWrapper`)."""
    h, w = images.shape[-3], images.shape[-2]
    ch, cw = int(h * crop_factor), int(w * crop_factor)
    top, left = (h - ch) // 2, (w - cw) // 2
    cropped = images[..., top:top + ch, left:left + cw, :]
    return resize_bilinear(cropped, height, width)
