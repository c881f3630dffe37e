"""FLOPs of a train step and MFU arithmetic, shared by the train loop's
goodput ledger and `chip_smoke.py`.

The port's counterpart of `rt1_tpu/obs/flops.py`. JAX reads FLOPs from
XLA's cost analysis of the lowered step; the port has no lowered program,
so it counts the operations of one call with `FlopCounterMode`
(`torch.utils.flop_counter`): matmuls, convolutions and their backwards,
each by its shapes. Elementwise work (the optimizer, norms, activations)
is not counted, as a model-FLOPs count should not count it.

One correction to FlopCounterMode's own formulas: it counts the
grad-weight of a grouped convolution as a dense one, `groups` times too
many (a depthwise conv's by its channel count), and B3's tower is mostly
depthwise. `conv_backward_flop` counts it per group.

MFU is ``FLOPs per step / seconds per step / peak FLOP/s``. The peak
defaults to one H100 SXM's dense bf16 989 TFLOP/s (NVIDIA's data sheet;
JAX's default is a v5e chip's 197); the ``RT1_TPU_PEAK_FLOPS`` environment
variable overrides it, under the JAX package's name.

Import-light by contract: stdlib at module scope, torch inside the
functions that count.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional, Tuple

#: Default peak FLOP/s assumed for MFU: one H100 SXM's dense bf16 peak.
DEFAULT_PEAK_FLOPS = 989e12

PEAK_FLOPS_ENV = "RT1_TPU_PEAK_FLOPS"


def default_peak_flops() -> float:
    """Peak FLOP/s per card: ``RT1_TPU_PEAK_FLOPS`` env or the H100 default."""
    return float(os.environ.get(PEAK_FLOPS_ENV, DEFAULT_PEAK_FLOPS))


def conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                       transposed, _output_padding, _groups, output_mask, out_shape=None,
                       **kwargs) -> int:
    """FLOPs of `aten.convolution_backward`: each of grad-input and
    grad-weight repeats the forward's multiply-adds, 2 * prod(w_shape) per
    output position (w_shape's input dim is already per group)."""
    # A forward conv's multiply-adds run over its output positions, a
    # transposed conv's over its input's.
    spatial = x_shape if transposed else grad_out_shape
    positions = spatial[0] * math.prod(spatial[2:])
    per_pass = 2 * math.prod(w_shape) * positions
    return per_pass * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _count(fn: Callable[[], object], per_group: bool) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    mapping = {torch.ops.aten.convolution_backward: conv_backward_flop} if per_group else None
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        fn()
    return counter.get_total_flops()


def step_flops(fn: Callable[[], object]) -> Tuple[int, int]:
    """(FLOPs of `fn()` by FlopCounterMode with `conv_backward_flop`, by
    FlopCounterMode's own formulas). Calls `fn` twice."""
    return _count(fn, per_group=True), _count(fn, per_group=False)


def train_step_flops(fn: Callable[[], object]) -> Optional[float]:
    """FLOPs of one call of `fn` (with `conv_backward_flop`), or None when
    the count fails or is zero — callers treat that as "no MFU gauge",
    never as a real measurement."""
    try:
        flops = float(_count(fn, per_group=True))
    except Exception:  # noqa: BLE001 - an estimator must never kill a run
        return None
    return flops if flops > 0 else None


def mfu_pct(
    flops_per_step: float,
    sec_per_step: float,
    n_chips: int = 1,
    peak_flops: Optional[float] = None,
) -> float:
    """Model-FLOPs-utilization in percent: achieved / peak FLOP/s."""
    if sec_per_step <= 0 or flops_per_step <= 0:
        return 0.0
    peak = default_peak_flops() if peak_flops is None else float(peak_flops)
    n = max(int(n_chips), 1)
    return flops_per_step / sec_per_step / (peak * n) * 100.0


def mfu_detail(
    flops_per_step: float,
    sec_per_step: float,
    n_chips: int = 1,
    peak_flops: Optional[float] = None,
) -> Dict[str, float]:
    """FLOPs, seconds, assumed peak and MFU of a step, as JAX's bench prints
    them."""
    peak = default_peak_flops() if peak_flops is None else float(peak_flops)
    return {
        "flops_per_step": float(flops_per_step),
        "sec_per_step": round(float(sec_per_step), 6),
        "peak_flops_assumed": peak,
        "mfu_pct": round(
            mfu_pct(flops_per_step, sec_per_step, n_chips, peak), 3
        ),
    }
