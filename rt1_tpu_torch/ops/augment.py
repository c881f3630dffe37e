"""Photometric distortions (counterpart of `rt1_tpu/ops/augment.py`).

Per-video uniform brightness, saturation, hue and contrast jitter, applied
in that order with TF image semantics, on the device inside the train
forward. Images are float in [0, 1], shape (..., H, W, 3).

One distortion level is drawn per call, over the whole batch, as JAX draws
it: `draw_photometric_factors` takes the levels from an explicit
`torch.Generator`, `apply_photometric` applies given levels, and
`photometric_distortions` is the two in a row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    safe_delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    s = torch.where(maxc == 0, torch.zeros_like(maxc),
                    delta / torch.where(maxc == 0, torch.ones_like(maxc), maxc))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = torch.remainder(i.to(torch.int64), 6).unsqueeze(-1)
    # The sector picks each channel among (v, q, p, t), as jnp.select does.
    r = torch.stack([v, q, p, p, t, v], dim=-1).gather(-1, sector)
    g = torch.stack([t, v, v, q, p, p], dim=-1).gather(-1, sector)
    b = torch.stack([p, p, t, v, v, q], dim=-1).gather(-1, sector)
    return torch.cat([r, g, b], dim=-1)


def adjust_brightness(images: torch.Tensor, delta) -> torch.Tensor:
    return torch.clamp(images + delta, 0.0, 1.0)


def adjust_contrast(images: torch.Tensor, factor) -> torch.Tensor:
    """TF semantics: interpolate toward the per-channel spatial mean."""
    mean = images.mean(dim=(-3, -2), keepdim=True)
    return torch.clamp((images - mean) * factor + mean, 0.0, 1.0)


def adjust_saturation(images: torch.Tensor, factor) -> torch.Tensor:
    hsv = rgb_to_hsv(images)
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def adjust_hue(images: torch.Tensor, delta) -> torch.Tensor:
    hsv = rgb_to_hsv(images)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


@dataclasses.dataclass(frozen=True)
class PhotometricConfig:
    brightness_max_delta: float = 0.1
    contrast_lower: float = 0.8
    contrast_upper: float = 1.2
    hue_max_delta: float = 0.03
    saturation_lower: float = 0.8
    saturation_upper: float = 1.2


def draw_photometric_factors(generator: torch.Generator,
                             config: Optional[PhotometricConfig] = None
                             ) -> Dict[str, torch.Tensor]:
    """One level per enabled distortion, each a 0-d float32 tensor on the
    generator's device drawn uniformly in its range: "brightness" (delta),
    "saturation" (factor), "hue" (delta), "contrast" (factor)."""
    config = config or PhotometricConfig()

    def uniform(low, high):
        u = torch.rand((), generator=generator, device=generator.device)
        return low + (high - low) * u

    factors = {}
    if config.brightness_max_delta:
        factors["brightness"] = uniform(-config.brightness_max_delta,
                                        config.brightness_max_delta)
    if config.saturation_lower != 1.0 or config.saturation_upper != 1.0:
        factors["saturation"] = uniform(config.saturation_lower, config.saturation_upper)
    if config.hue_max_delta:
        factors["hue"] = uniform(-config.hue_max_delta, config.hue_max_delta)
    if config.contrast_lower != 1.0 or config.contrast_upper != 1.0:
        factors["contrast"] = uniform(config.contrast_lower, config.contrast_upper)
    return factors


def apply_photometric(images: torch.Tensor, factors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The distortions `factors` names, in the reference's order:
    brightness -> saturation -> hue -> contrast."""
    if "brightness" in factors:
        images = adjust_brightness(images, factors["brightness"])
    if "saturation" in factors:
        images = adjust_saturation(images, factors["saturation"])
    if "hue" in factors:
        images = adjust_hue(images, factors["hue"])
    if "contrast" in factors:
        images = adjust_contrast(images, factors["contrast"])
    return images


def photometric_distortions(images: torch.Tensor, generator: torch.Generator,
                            config: Optional[PhotometricConfig] = None) -> torch.Tensor:
    """One uniform distortion level per call (per video), reference order:
    brightness -> saturation -> hue -> contrast."""
    return apply_photometric(images, draw_photometric_factors(generator, config))
