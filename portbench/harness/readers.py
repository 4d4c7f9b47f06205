"""What the per-layer metric readers (``portbench/metrics/*.py``) share.
Each returns None where the run has nothing to read, and the harness
then leaves the metric out of the line; a share of a peak is never 0 for
want of a reading."""
from __future__ import annotations

from typing import Optional

from portbench.harness import cost, profile


def span_ms(ctx, name: str) -> Optional[float]:
    """A span's device milliseconds a step or request of the window."""
    if name not in ctx.span_ms or not ctx.units:
        return None
    return ctx.span_ms[name] / ctx.units


def mfu(ctx) -> Optional[float]:
    """The window's model FLOPs over its time, % of the bf16 peak."""
    if not ctx.flops or not ctx.window_s:
        return None
    return 100.0 * ctx.flops / ctx.window_s / cost.PEAK_BF16_FLOPS


def fwht_roofline(ctx) -> Optional[float]:
    """The FWHT's payload bytes over HBM bandwidth, % of the time the
    profiler gives its kernel."""
    if ctx.prof is None:
        return None
    _, seconds = profile.kernel_seconds(ctx.prof, "fwht_kernel")
    if not seconds or not ctx.prof_fwht_bytes:
        return None
    return 100.0 * ctx.prof_fwht_bytes / cost.PEAK_HBM_BYTES / seconds


def device_idle(ctx) -> Optional[float]:
    if ctx.prof is None or not ctx.prof["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.prof["busy_s"] / ctx.prof["window_s"])


def launches(ctx) -> Optional[float]:
    if ctx.prof is None or not ctx.prof_units:
        return None
    return ctx.prof["n_device_ops"] / ctx.prof_units
