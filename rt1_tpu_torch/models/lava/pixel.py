"""PixelLang baseline: channel-stacked frames + multiplicative language
fusion (counterpart of `rt1_tpu/models/lava/pixel.py`).

Parity source: reference `language_table/train/networks/pixel.py:25-111`.
The history is stacked frame-major along the channels (the JAX module's
documented deviation from the reference's raw reshape), the language of
the last frame gates the conv features from the second conv on and the
pooled features at the end. NHWC in [0, 1] at the interface, NCHW inside,
float32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from rt1_tpu_torch.models.lava.blocks import DenseResnet, LavaDense, layer_norm
from rt1_tpu_torch.models.lava.resnet import SameConv2d
from rt1_tpu_torch.ops.dropout import Rngs

CONV_CHANNELS = (32, 64, 128, 256)
FUSE_FROM = 2


class LanguageFusion(nn.Module):
    """Project language to the image channel dim and multiply per pixel."""

    def __init__(self, lang_dim: int, channels: int):
        super().__init__()
        self.Dense_0 = LavaDense(lang_dim, channels)

    def forward(self, lang: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        return image * self.Dense_0(lang)[:, :, None, None]


class ConvMaxpoolLanguageEncoder(nn.Module):
    """Conv stack with multiplicative language fusion from layer 2 on."""

    def __init__(self, in_channels: int, lang_dim: int):
        super().__init__()
        fusion = 0
        for idx, ch in enumerate(CONV_CHANNELS):
            self.add_module(f"Conv_{idx}", SameConv2d(in_channels, ch, 3))
            if FUSE_FROM <= idx + 1:
                self.add_module(f"LanguageFusion_{fusion}", LanguageFusion(lang_dim, ch))
                fusion += 1
            in_channels = ch
        self.Dense_0 = LavaDense(lang_dim, CONV_CHANNELS[-1])
        self.LayerNorm_0 = layer_norm(CONV_CHANNELS[-1])

    def forward(self, rgb: torch.Tensor, lang: torch.Tensor) -> torch.Tensor:
        x, fusion = rgb, 0
        for idx in range(len(CONV_CHANNELS)):
            x = getattr(self, f"Conv_{idx}")(x)
            if FUSE_FROM <= idx + 1:
                x = getattr(self, f"LanguageFusion_{fusion}")(lang, x)
                fusion += 1
            x = F.max_pool2d(F.relu(x), 2, 2)
        x = x.mean(dim=(2, 3)) * self.Dense_0(lang)
        return self.LayerNorm_0(F.relu(x))


class PixelLangMSE(nn.Module):
    """Channel-stack frames, fuse language, regress actions with MSE."""

    def __init__(self, action_size: int, dense_resnet_width: int, dense_resnet_num_blocks: int,
                 num_frames: int, lang_dim: int = 512,
                 lang_key: str = "natural_language_embedding"):
        super().__init__()
        self.lang_key = lang_key
        self.encoder = ConvMaxpoolLanguageEncoder(3 * num_frames, lang_dim)
        self.dense_resnet = DenseResnet(CONV_CHANNELS[-1], dense_resnet_width,
                                        dense_resnet_num_blocks)
        self.action_projection = LavaDense(dense_resnet_width, action_size)

    def forward(self, obs: Dict[str, torch.Tensor], train: bool = False,
                rngs: Rngs = None) -> torch.Tensor:
        rgb = obs["rgb"]
        b, n, h, w, c = rgb.shape
        rgb = rgb.permute(0, 1, 4, 2, 3).reshape(b, n * c, h, w)  # frame-major channels
        lang = obs[self.lang_key][:, -1]
        return self.action_projection(self.dense_resnet(self.encoder(rgb, lang)))
