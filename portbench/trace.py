"""A traced stretch of a cell's work, read from ``torch.profiler``'s timeline.

The stretch runs twice, back to back in the same process: untraced (its
wall time) and traced. From the trace:

- device operations: every kernel, copy and fill on the card, but not the
  ranges that ``record_function`` marks on the device timeline;
- busy time: the length of the union of their intervals, so operations
  that overlap count once;
- the breakdown: the operations that took most device time, and the idle
  time between device operations summed by what the host was doing at the
  start of each gap (the benchmark's span, then the outermost host
  operation inside it).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class TraceSummary(NamedTuple):
    untraced_s: float         # wall time of the stretch untraced
    window_s: float           # wall time of the stretch traced
    busy_s: float             # union of the device operations' intervals
    ops: List[DeviceOp]
    units: int                # work units (pixels, samples) in the stretch
    iterations: int           # scenes or steps in the stretch
    device_ops: List[list]    # [name, seconds], most device time first, at most 10
    idle_gaps: List[list]     # [host activity, idle seconds], most first, at most 10


def _union(ops: List[DeviceOp]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for op in sorted(ops, key=lambda o: o.start_ns):
        if merged and op.start_ns <= merged[-1][1]:
            if op.end_ns > merged[-1][1]:
                merged[-1] = (merged[-1][0], op.end_ns)
        else:
            merged.append((op.start_ns, op.end_ns))
    return merged


class _HostTimeline:
    """What the host was doing at a time: the benchmark span open then, and
    the outermost other host event open then (over every thread)."""

    def __init__(self, host: list):
        host.sort(key=lambda h: (h[1], -h[2]))
        self.spans = [h for h in host if h[0].startswith(SPAN_PREFIX)]
        self.outer = []
        reach = None
        for h in host:
            if h[0].startswith(SPAN_PREFIX):
                continue
            if reach is None or h[1] >= reach:
                self.outer.append(h)
            reach = h[2] if reach is None else max(reach, h[2])

    @staticmethod
    def _open(events: list, t: int) -> Optional[str]:
        i = bisect.bisect_right(events, t, key=lambda h: h[1]) - 1
        return events[i][0] if i >= 0 and events[i][2] > t else None

    def label(self, t: int) -> str:
        span = self._open(self.spans, t) or "outside spans"
        outer = self._open(self.outer, t)
        return span if outer is None else f"{span} > {outer}"


def summarize(events, untraced_s: float, window_s: float, units: int,
              iterations: int, top: int = 10) -> TraceSummary:
    """Read ``prof.profiler.kineto_results.events()``."""
    ops, host = [], []
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append(DeviceOp(e.name(), start, end))
        elif e.device_type() == torch.autograd.DeviceType.CPU and end > start:
            host.append((e.name(), start, end))
    merged = _union(ops)
    busy_ns = sum(end - start for start, end in merged)
    by_name = defaultdict(int)
    for op in ops:
        by_name[op.name] += op.end_ns - op.start_ns
    timeline = _HostTimeline(host)
    gaps = defaultdict(int)
    for (_, prev_end), (next_start, _) in zip(merged, merged[1:]):
        gaps[timeline.label(prev_end)] += next_start - prev_end
    ranked = sorted(by_name.items(), key=lambda item: -item[1])[:top]
    idle = sorted(gaps.items(), key=lambda item: -item[1])[:top]
    return TraceSummary(untraced_s, window_s, busy_ns / 1e9, ops, units, iterations,
                        [[name[:160], ns / 1e9] for name, ns in ranked],
                        [[label[:160], ns / 1e9] for label, ns in idle])


def traced_stretch(run: Callable[[], Tuple[int, int]], device: torch.device
                   ) -> Optional[TraceSummary]:
    """Run ``run`` (which returns its (units, iterations)) untraced, then
    traced; None where the device is not a card (the CPU tests)."""
    def timed() -> Tuple[float, Tuple[int, int]]:
        _sync(device)
        start = time.perf_counter()
        done = run()
        _sync(device)
        return time.perf_counter() - start, done

    untraced_s, _ = timed()
    if device.type != "cuda":
        return None
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        window_s, (units, iterations) = timed()
    return summarize(prof.profiler.kineto_results.events(), untraced_s, window_s, units,
                     iterations)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
