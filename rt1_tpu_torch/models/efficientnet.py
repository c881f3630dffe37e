"""FiLM-conditioned EfficientNet (counterpart of
`rt1_tpu/models/efficientnet.py`).

Same architecture and parameter names as the JAX module: a 3x3 stride-2
stem, MBConv blocks (expand 1x1 -> depthwise kxk -> squeeze-excite sized
from the BLOCK INPUT -> project 1x1), an optional FiLM layer after every
block, and a 1x1 top conv. B3 = width 1.2 / depth 1.4: stem 40 channels,
26 blocks, top 1536.

The public `EfficientNet.forward` takes and returns NHWC like the JAX
module; inside the tower activations are NCHW, the layout cuDNN's
convolutions take. Convolutions use explicit symmetric padding
`(k - 1) // 2`, which `padding=pad` reproduces.

`train=True` (an argument, as in JAX; `nn.Module.training` is not read)
normalises with batch statistics and updates the running ones as flax does
(momentum 0.9 on the BIASED batch variance), and applies row-mode
stochastic depth to the residual blocks at `drop_connect_rate * b /
total_repeats`, drawing from the generator passed as `rngs["stochastic_depth"]`.
`remat=True` recomputes each MBConv block in the backward pass
(`ops/remat.py`), as JAX's `nn.remat(MBConvBlock)` does.

`include_top=True` adds JAX's classifier head: the mean over H and W,
dropout at `dropout_rate` in train mode (from `rngs["dropout"]`), and an
`nn.Linear` named `classifier` to `classes` logits. It is off by default,
as the RT-1 encoder builds the tower; `EfficientNetB3()` is the ImageNet
classifier that `models/load_pretrained.py` ports torchvision's weights
into.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rt1_tpu_torch.models.film import FilmConditioning
from rt1_tpu_torch.models.quant import QuantConv2d
from rt1_tpu_torch.ops.dropout import Rngs, dropout
from rt1_tpu_torch.ops.remat import checkpoint, recomputing
from rt1_tpu_torch.parallel.collectives import current_batch_shard, rows_of_global_draw

# Table-1 base (B0) config.
BLOCKS_ARGS: Tuple[Dict[str, Any], ...] = (
    dict(kernel_size=3, repeats=1, in_size=32, out_size=16, expand_ratio=1, strides=1, se_ratio=0.25),
    dict(kernel_size=3, repeats=2, in_size=16, out_size=24, expand_ratio=6, strides=2, se_ratio=0.25),
    dict(kernel_size=5, repeats=2, in_size=24, out_size=40, expand_ratio=6, strides=2, se_ratio=0.25),
    dict(kernel_size=3, repeats=3, in_size=40, out_size=80, expand_ratio=6, strides=2, se_ratio=0.25),
    dict(kernel_size=5, repeats=3, in_size=80, out_size=112, expand_ratio=6, strides=1, se_ratio=0.25),
    dict(kernel_size=5, repeats=4, in_size=112, out_size=192, expand_ratio=6, strides=2, se_ratio=0.25),
    dict(kernel_size=3, repeats=1, in_size=192, out_size=320, expand_ratio=6, strides=1, se_ratio=0.25),
)


def round_filters(filters: float, divisor: int, width_coefficient: float) -> int:
    """Width scaling with snap-to-multiple-of-divisor."""
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    return int(math.ceil(depth_coefficient * repeats))


def stochastic_depth(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Row-mode stochastic depth: each row (dim 0) is kept with probability
    `1 - rate` and scaled by `1 / (1 - rate)`, else zeroed."""
    keep = 1.0 - rate
    draw = rows_of_global_draw((x.shape[0],) + (1,) * (x.dim() - 1),
                               lambda shape: torch.rand(shape, generator=generator,
                                                        device=x.device))
    return torch.where(draw < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with flax's semantics (eps 1e-5): `scale`/`bias`
    parameters, `mean`/`var` statistics.

    Eval mode normalises with the running statistics; scale and bias take
    their dtype when it differs (a bf16 compute copy of f32 buffers).
    Train mode normalises with the batch statistics, computed in float32
    whatever the input dtype (flax's `force_float32_reductions`), and
    updates the running statistics as flax `momentum=0.9` does:
    `r = 0.9 r + 0.1 batch`, on the biased batch variance.
    `F.batch_norm` updates with the unbiased one (a factor n / (n - 1)),
    so the update is corrected: with `r0` the old and `r1` torch's
    new running variance, flax's is `r1 (n - 1) / n + 0.9 r0 / n`.

    Inside a `batch_shard` of several ranks (the train step of a
    data-parallel world) the statistics are the GLOBAL batch's, as flax's
    are under GSPMD (`_SyncBatchNorm`): the per-rank count, sum and sum of
    squares are all-reduced over the batch ranks, the variance is flax's
    fast one, E[x^2] - E[x]^2, the running update takes it biased, and the
    backward all-reduces its two sums."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        weight, bias = self.weight, self.bias
        if weight.dtype != self.running_mean.dtype:
            weight = weight.to(self.running_mean.dtype)
            bias = bias.to(self.running_mean.dtype)
        if not train:
            return F.batch_norm(
                x, self.running_mean, self.running_var, weight, bias,
                training=False, eps=self.eps,
            )
        group, _, ways = current_batch_shard()
        if ways > 1:
            return self._synced(x, weight, bias, group)
        n = x.numel() // x.shape[1]
        # torch updates the statistics it is given and keeps them for the
        # backward, so it gets copies; the module's buffers take the result.
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(
            x, mean, var, weight, bias,
            training=True, momentum=1.0 - self.MOMENTUM, eps=self.eps,
        )
        if recomputing():  # the first run of a remat block wrote them
            return y
        with torch.no_grad():
            var_flax = var * ((n - 1) / n) + self.running_var * (self.MOMENTUM / n)
            self.running_mean.copy_(mean)
            self.running_var.copy_(var_flax)
        return y


    def _synced(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                group) -> torch.Tensor:
        """Train mode over the global batch of the ranks of `group`."""
        y, mean, var = _SyncBatchNorm.apply(x, weight, bias, self.eps, group)
        if not recomputing():
            m = self.MOMENTUM
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


class _SyncBatchNorm(torch.autograd.Function):
    """BatchNorm's train-mode forward and backward over the global batch:
    the per-rank count, sum and sum of squares are all-reduced over `group`
    (flax's fast variance E[x^2] - E[x]^2, biased), and the backward is
    BatchNorm's analytic one, `F.batch_norm`'s, on the all-reduced sums of
    dy and dy * (x - mean): the gradient of every rank's loss, whose
    statistics read every rank's x. The weight's and bias's gradients are
    this rank's shares (the step sums them over the ranks). Returns (y,
    batch mean, batch variance). `torch.distributed.nn.functional.
    all_reduce`, which would differentiate the sums, is deprecated in this
    torch."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        import torch.distributed as dist

        dims = [0] + list(range(2, x.dim()))
        shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
        xf = x.to(torch.float32)
        c = x.shape[1]
        count = torch.full((1,), float(x.numel() // c), dtype=torch.float32, device=x.device)
        stats = torch.cat([count, xf.sum(dims), (xf * xf).sum(dims)])
        dist.all_reduce(stats, op=dist.ReduceOp.SUM, group=group)
        n = stats[0]
        mean = stats[1:1 + c] / n
        var = torch.clamp(stats[1 + c:] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        w = weight.to(torch.float32)
        y = (xf - mean.view(shape)) * (invstd * w).view(shape) + bias.to(torch.float32).view(shape)
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        import torch.distributed as dist

        x, mean, invstd, weight = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
        dyf = dy.to(torch.float32)
        centered = x.to(torch.float32) - mean.view(shape)
        sum_dy = dyf.sum(dims)
        dot_p = (dyf * centered).sum(dims)
        local = torch.stack([sum_dy, dot_p])
        total = local.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.group)
        grad_mean = total[0] / ctx.n
        proj = total[1] * invstd * invstd / ctx.n
        w = weight.to(torch.float32)
        dx = (dyf - grad_mean.view(shape) - centered * proj.view(shape)) \
            * (invstd * w).view(shape)
        grad_weight = (dot_p * invstd).to(weight.dtype)
        grad_bias = sum_dy.to(weight.dtype)
        return dx.to(x.dtype), grad_weight, grad_bias, None, None


class ConvNormAct(nn.Module):
    """Conv (no bias) -> BatchNorm -> optional SiLU, NCHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, strides: int = 1,
                 groups: int = 1, use_act: bool = True):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv = QuantConv2d(in_ch, out_ch, kernel_size, stride=strides,
                                padding=pad, groups=groups, bias=False)
        self.bn = BatchNorm(out_ch)
        self.use_act = use_act

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.bn(self.conv(x), train)
        return F.silu(x) if self.use_act else x


class SqueezeExcite(nn.Module):
    """SE whose reduction width comes from the BLOCK INPUT size, NCHW."""

    def __init__(self, expand_size: int, block_in_size: int, se_ratio: float = 0.25):
        super().__init__()
        se_size = max(1, int(block_in_size * se_ratio))
        self.fc1 = QuantConv2d(expand_size, se_size, 1)
        self.fc2 = QuantConv2d(se_size, expand_size, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.fc2(F.silu(self.fc1(s))))
        return x * s


class MBConvBlock(nn.Module):
    """Inverted residual block with SE, NCHW."""

    def __init__(self, kernel_size: int, in_size: int, out_size: int, expand_ratio: int,
                 strides: int, se_ratio: float, drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        expand_size = in_size * expand_ratio
        if expand_ratio != 1:
            self.expand = ConvNormAct(in_size, expand_size, 1)
        else:
            self.expand = None
        self.depthwise = ConvNormAct(expand_size, expand_size, kernel_size,
                                     strides=strides, groups=expand_size)
        if 0.0 < se_ratio <= 1.0:
            self.se = SqueezeExcite(expand_size, in_size, se_ratio)
        else:
            self.se = None
        self.project = ConvNormAct(expand_size, out_size, 1, use_act=False)
        self.residual = strides == 1 and in_size == out_size

    def forward(self, inputs: torch.Tensor, train: bool = False, rngs: Rngs = None) -> torch.Tensor:
        x = inputs
        if self.expand is not None:
            x = self.expand(x, train)
        x = self.depthwise(x, train)
        if self.se is not None:
            x = self.se(x)
        x = self.project(x, train)
        if not self.residual:
            return x
        if train and self.drop_rate > 0:
            if not rngs or "stochastic_depth" not in rngs:
                raise ValueError("stochastic depth in train mode needs rngs['stochastic_depth']")
            x = stochastic_depth(x, self.drop_rate, rngs["stochastic_depth"])
        return inputs + x


class EfficientNet(nn.Module):
    """EfficientNet with optional per-block FiLM and optional classifier head."""

    def __init__(self, width_coefficient: float, depth_coefficient: float,
                 include_film: bool = False, context_dim: int = 512,
                 depth_divisor: int = 8, drop_connect_rate: float = 0.2, remat: bool = False,
                 include_top: bool = False, classes: int = 1000, dropout_rate: float = 0.2):
        super().__init__()
        self.remat = remat
        self.width_coefficient = width_coefficient
        self.depth_coefficient = depth_coefficient
        self.depth_divisor = depth_divisor
        self.drop_connect_rate = drop_connect_rate
        self.include_film = include_film
        self.include_top = include_top
        self.dropout_rate = dropout_rate
        stem_ch = round_filters(32, depth_divisor, width_coefficient)
        self.stem = ConvNormAct(3, stem_ch, 3, strides=2)
        self.num_blocks = 0
        for i, cfg in enumerate(self.block_configs()):
            self.add_module(f"block_{i}", MBConvBlock(**cfg))
            if include_film:
                self.add_module(f"film_{i}", FilmConditioning(context_dim, cfg["out_size"]))
            self.num_blocks += 1
        last = self.block_configs()[-1]["out_size"]
        self.top_ch = round_filters(1280, depth_divisor, width_coefficient)
        self.top = ConvNormAct(last, self.top_ch, 1)
        if include_top:
            self.classifier = nn.Linear(self.top_ch, classes)

    def block_configs(self) -> List[Dict[str, Any]]:
        """Flattened per-block args after width/depth scaling."""
        configs = []
        total_repeats = float(
            sum(round_repeats(a["repeats"], self.depth_coefficient) for a in BLOCKS_ARGS)
        )
        b = 0
        for args in BLOCKS_ARGS:
            in_size = round_filters(args["in_size"], self.depth_divisor, self.width_coefficient)
            out_size = round_filters(args["out_size"], self.depth_divisor, self.width_coefficient)
            for j in range(round_repeats(args["repeats"], self.depth_coefficient)):
                configs.append(
                    dict(
                        kernel_size=args["kernel_size"],
                        in_size=in_size if j == 0 else out_size,
                        out_size=out_size,
                        expand_ratio=args["expand_ratio"],
                        strides=args["strides"] if j == 0 else 1,
                        se_ratio=args["se_ratio"],
                        drop_rate=self.drop_connect_rate * b / total_repeats,
                    )
                )
                b += 1
        return configs

    def forward_nchw(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                     train: bool = False, rngs: Rngs = None) -> torch.Tensor:
        x = self.stem(x, train)
        for i in range(self.num_blocks):
            block = getattr(self, f"block_{i}")
            if self.remat and train:
                x = checkpoint(block, x, train, rngs, rngs=rngs)
            else:
                x = block(x, train, rngs)
            if self.include_film:
                x = getattr(self, f"film_{i}")(x, context, channel_dim=1)
        return self.top(x, train)

    def forward(self, inputs: torch.Tensor, context: Optional[torch.Tensor] = None,
                train: bool = False, rngs: Rngs = None) -> torch.Tensor:
        """inputs: (B, H, W, 3) float; context: (B, D) when FiLM. Returns
        the top's features NHWC, or with `include_top` (B, classes) logits."""
        x = inputs.to(self.stem.conv.compute_dtype).permute(0, 3, 1, 2)
        x = self.forward_nchw(x, context, train, rngs)
        if not self.include_top:
            return x.permute(0, 2, 3, 1)
        x = dropout(x.mean(dim=(2, 3)), self.dropout_rate, train, rngs)
        return self.classifier(x)


def EfficientNetB3(include_top: bool = True, classes: int = 1000, include_film: bool = False,
                   dtype: torch.dtype = torch.float32) -> EfficientNet:
    """B3 scaling: width 1.2, depth 1.4, dropout 0.3, in `dtype`; FiLM
    conditions on a 512-d context. Trained natively on 300x300 (a 10x10
    feature map); Language-Table feeds 256x456 (8x15)."""
    net = EfficientNet(1.2, 1.4, include_film=include_film, include_top=include_top,
                       classes=classes, dropout_rate=0.3)
    return net.to(dtype)
