"""What the card spent, read from `torch.profiler`'s CUDA activity.

`device_summary(prof, calls, wall_s)` turns a finished profile into
per-call numbers: the host wall time, the card's busy time (the union of
its activity intervals, so overlapping kernels count once), the launches
and the device time of each kernel by name. `device_profile(fn, iters)`
profiles `iters` calls of `fn` and returns that summary, or None when the
profiler fails or records no device activity (a CPU tensor, or CUPTI
refused). `top_kernels` ranks a summary's kernels.

`python -m rt1_tpu_torch.train.profile_train` and `chip_smoke.py` read
their profiles through these functions.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple


def cuda_spans(prof) -> List[Tuple[float, float, str]]:
    """(start µs, end µs, name) of each device activity in `prof`, sorted.
    A `record_function` span (a step mark) shows on the device's timeline
    too, covering the kernels it encloses and the gaps between them: it is
    an annotation, not device work, and is left out."""
    import torch

    return sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    )


def busy_us(spans: List[Tuple[float, float, str]]) -> float:
    """Length of the union of the spans' intervals."""
    if not spans:
        return 0.0
    total, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, _ in spans[1:]:
        if start > cur_end:
            total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total + cur_end - cur_start


def device_summary(prof, calls: int, wall_s: float) -> Optional[Dict]:
    """{"wall_ms", "busy_ms", "kernels" ({name: ms}), "launches"}, each per
    call over `calls` calls that took `wall_s` of host time; None when the
    profile holds no device activity."""
    spans = cuda_spans(prof)
    if not spans:
        return None
    kernels: Dict[str, float] = {}
    for start, end, name in spans:
        kernels[name] = kernels.get(name, 0.0) + (end - start) / 1e3 / calls
    return {"wall_ms": wall_s * 1e3 / calls, "busy_ms": busy_us(spans) / 1e3 / calls,
            "kernels": kernels, "launches": len(spans) / calls}


def top_kernels(kernels: Dict[str, float], n: int = 10, width: int = 80) -> List[List]:
    """The `n` kernels of most device ms, as [name cut to `width`, ms]."""
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:width], ms] for name, ms in ranked]


def device_profile(fn, iters: int = 20) -> Optional[Dict]:
    """`device_summary` of `iters` calls of `fn` on the card, after one
    unprofiled call; None when the profiler fails (CUPTI refused: the
    reason goes to stderr) or records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    except RuntimeError as exc:
        print(f"torch.profiler failed: {exc}", file=sys.stderr)
        return None
    return device_summary(prof, iters, wall_s)
