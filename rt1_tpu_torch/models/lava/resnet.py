"""ResNet-V1 with multiscale (pyramid) outputs (counterpart of
`rt1_tpu/models/lava/resnet.py`).

Parity source: reference `language_table/train/networks/resnet_v1.py:37-259`.
`MultiscaleResNet` returns the per-stage feature maps instead of a
classification head, feeding the LAVA visual pyramid. Activations are
NCHW inside (cuDNN's layout). Convolutions pad as flax's "SAME" does
(`same_pad`: the odd pixel of a stride-2 window goes at the end), the
stem max-pool pads with -inf, and BatchNorm (epsilon 1e-5) normalises with
its running statistics only: LAVA applies the tower frozen, as the
reference does (`lava.py:62`). Names follow flax's (`conv_init`,
`bn_init`, `BottleneckResNetBlock_<k>` numbered across stages,
`Conv_<i>`, `BatchNorm_<i>`, `conv_proj`, `norm_proj`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rt1_tpu_torch.models.efficientnet import BatchNorm


def same_pad(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW `x` as flax's padding="SAME" does for a square window:
    total `max((ceil(n / s) - 1) * s + k - n, 0)`, the smaller half first."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: last dim first
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


class SameConv2d(nn.Conv2d):
    """`nn.Conv(..., padding="SAME")`, NCHW."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = same_pad(x, self.kernel_size[0], self.stride[0])
        return self._conv_forward(x, self.weight, self.bias)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """`nn.max_pool(..., padding="SAME")`: -inf padding, NCHW."""
    return F.max_pool2d(same_pad(x, window, stride, float("-inf")), window, stride)


class FrozenBatchNorm(BatchNorm):
    """BatchNorm that always normalises with its running statistics."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return super().forward(x, train=False)


class BottleneckResNetBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck residual block, NCHW."""

    def __init__(self, in_ch: int, filters: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, filters, 1, bias=False)
        self.BatchNorm_0 = FrozenBatchNorm(filters)
        self.Conv_1 = SameConv2d(filters, filters, 3, stride=strides, bias=False)
        self.BatchNorm_1 = FrozenBatchNorm(filters)
        self.Conv_2 = SameConv2d(filters, filters * 4, 1, bias=False)
        self.BatchNorm_2 = FrozenBatchNorm(filters * 4)
        self.BatchNorm_2.init_scale = 0.0  # flax's scale_init=zeros
        if in_ch != filters * 4 or strides != 1:
            self.conv_proj = SameConv2d(in_ch, filters * 4, 1, stride=strides, bias=False)
            self.norm_proj = FrozenBatchNorm(filters * 4)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class MultiscaleResNet(nn.Module):
    """ResNet stem + stages, returning [stem_features, stage_0, stage_1, ...]."""

    def __init__(self, stage_sizes: Sequence[int], num_filters: int = 64):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv_init = nn.Conv2d(3, num_filters, 7, stride=2, padding=3, bias=False)
        self.bn_init = FrozenBatchNorm(num_filters)
        k, in_ch = 0, num_filters
        self.out_channels = [num_filters]
        for i, block_size in enumerate(self.stage_sizes):
            for j in range(block_size):
                strides = 2 if i > 0 and j == 0 else 1
                self.add_module(f"BottleneckResNetBlock_{k}",
                                BottleneckResNetBlock(in_ch, num_filters * 2 ** i, strides))
                in_ch = num_filters * 2 ** i * 4
                k += 1
            self.out_channels.append(in_ch)

    def forward(self, x: torch.Tensor, num_outputs: Optional[int] = None) -> List[torch.Tensor]:
        """x: NCHW. The first `num_outputs` feature maps (default all): the
        stages past them are not run (XLA drops them when unused)."""
        num_outputs = num_outputs or len(self.stage_sizes) + 1
        x = F.relu(self.bn_init(self.conv_init(x)))
        outputs = [x]
        x = max_pool_same(x, 3, 2)
        k = 0
        for block_size in self.stage_sizes:
            if len(outputs) >= num_outputs:
                break
            for _ in range(block_size):
                x = getattr(self, f"BottleneckResNetBlock_{k}")(x)
                k += 1
            outputs.append(x)
        return outputs
