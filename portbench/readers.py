"""Arithmetic that the per-layer metrics' readers share.

A reader gets ``ctx``: ``ctx.model`` (the reference model), ``ctx.config``,
``ctx.traffic``, ``ctx.window`` (the untraced window: ``units``,
``seconds``, ``iterations``), ``ctx.trace`` (a ``trace.TraceSummary``, or
None off the card) and ``ctx.device_kind``. Each function returns None
where there is nothing to read.
"""

from __future__ import annotations

from typing import Optional

from portbench import counts


def idle_share(ctx) -> Optional[float]:
    """The device's idle share in %, 100 * (1 - busy / wall): busy is the
    union of the device operations' intervals in the traced stretch, wall
    the same stretch's untraced time just before. Not clamped: a reading
    below 0 means the traced operations took longer than the untraced
    stretch (the profiler's own cost on the card)."""
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.untraced_s)


def launches_per_iteration(ctx) -> Optional[float]:
    """Device operations (kernels, copies, fills) per step of the traced stretch."""
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.trace.iterations


def flop_share(ctx, flop_per_unit: int) -> Optional[float]:
    """The untraced window's FLOP rate as % of the card's float32 peak."""
    peak = counts.peak(ctx.device_kind, "fp32_flop_per_s")
    if peak is None or not ctx.window.units:
        return None
    return 100.0 * flop_per_unit * ctx.window.units / ctx.window.seconds / peak


def kernel_roofline(ctx, match: str, least_bytes: int) -> Optional[float]:
    """The least time the card needs to move ``least_bytes`` over the mean
    device time of the traced kernels whose name holds ``match``, in %."""
    peak = counts.peak(ctx.device_kind, "hbm_bytes_per_s")
    if ctx.trace is None or peak is None:
        return None
    times = [op.end_ns - op.start_ns for op in ctx.trace.ops if match in op.name]
    if not times:
        return None
    return 100.0 * (least_bytes / peak) / (sum(times) / len(times) / 1e9)
