"""What the per-layer metric readers (metrics/<name>.py) share. Each reader
gets `ctx`: the unit kind, the units profiled (`units`), the profiled
window's wall seconds (`window_s`), the wall seconds of as many units run
just before it without the profiler (`timed_s`), the device's busy seconds
in the profiled window (`busy_s`),
device seconds by kernel name (`kernel_s`), device ms by profiler range
(`range_ms`), the cell's work file (`work`) and the peak allocation since
warm-up began (`peak_mem_bytes`). A reader that finds nothing to read
returns None, and the metric is left out of the run's line."""

from __future__ import annotations

from typing import Optional, Sequence

from work import PEAK_BF16_FLOPS


def mfu(ctx) -> float:
    """The units' model FLOPs over their unprofiled wall time at the bf16
    peak, %. (The profiler's host work stretches a host-bound unit: a
    config-5 step by about 1.7x.)"""
    return 100.0 * ctx["work"]["flops"] * ctx["units"] / (ctx["timed_s"] * PEAK_BF16_FLOPS)


def roofline(ctx, kernels: Sequence[str], bound_key: str) -> Optional[float]:
    """The kernels' least time (the work file's bound per unit) over the
    device time of every kernel whose name holds one of `kernels`, %."""
    if bound_key not in ctx["work"]:
        return None
    t = sum(s for name, s in ctx["kernel_s"].items() if any(k in name for k in kernels))
    if t <= 0:
        return None
    return 100.0 * ctx["work"][bound_key] * ctx["units"] / (t * 1e3)


def range_ms(ctx, name: str) -> Optional[float]:
    """Device ms per unit of the work launched under the range `name`."""
    ms = ctx["range_ms"].get(name)
    return None if not ms else ms / ctx["units"]


def idle_share(ctx) -> float:
    """1 - the profiled units' device busy time over the wall time of as
    many units unprofiled, %. The busy time is the profiled one: the
    profiler's device-side cost (CUPTI's per-kernel records) is left in."""
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["timed_s"])


def peak_mem_gb(ctx) -> Optional[float]:
    return ctx["peak_mem_bytes"] / 1e9 or None
