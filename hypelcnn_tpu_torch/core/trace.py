"""Spans at the phase boundaries of the port's hot paths, on the device's clock.

``span(name, id, index=None)`` marks one phase: ``train_step.input``,
``.forward``, ``.backward`` and ``.optimizer`` in each training step
(``train/trainer.py``), ``sweep.setup``, one ``sweep.band`` a band and
``sweep.map`` in each full-scene sweep (``infer/scene_inference.py``). The
phases of a path tile it: no span encloses a whole step or scene. Inside a
phase, CAP's forward (``models/cap.py``) marks its capsule layer:
``cap.transform`` (the prediction vectors, or on the folded route the first
round's folded weight and weighted sum) and ``cap.routing`` (the rest of the
routing and the class norms), with the forward's call number as ``id``; they
are children of ``sweep.band`` in a sweep and of ``train_step.forward`` in a
step. CONCNN's forward (``models/concnn.py``) marks ``concnn.front`` (the
three bank convolutions and their concatenation) and ``concnn.lrn`` (each
local response normalization, ``index`` 0 after the bank and 1 after
``conv11``), with the forward's call number as ``id``, children of the same
phases.

Spans are off unless a ``torch.profiler`` session is active; off, a span is
one read of the profiler's own flag and a shared no-op context. Under a
profile each span:

- opens ``torch.profiler.record_function(name)``, so the phase sits on the
  profiler's timeline beside the kernels that it launched;
- keeps a record in memory (the newest ``CAPACITY``): the name, ``id`` (the
  step, or the sweep's call number), ``index`` (the band), the enclosing open
  span's name, the host's clock at enter and exit, and a device mark at
  each: a timing CUDA event on the current stream where CUDA was initialised
  at the anchor (below), else the host's clock; none while the stream is
  captured into a CUDA graph.

The first record after :func:`clear` synchronises the device once and takes
an anchor: a host time and a mark. :func:`records` resolves every mark to
milliseconds after the anchor, on the host's clock (the anchor's host time
plus the device time elapsed from the anchor's mark), so a record's device
times say when the device reached its phase and its host times when the
host got there.

To see the phases of a training run or a sweep, run the CLI inside a
profile, from the root of a checkout::

    import torch
    from hypelcnn_tpu_torch.apps import infer_for_classification as cli
    from hypelcnn_tpu_torch.core import trace

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        cli.main([...])  # or apps.train_for_classification
    prof.export_chrome_trace("sweep.json")  # the phases beside the kernels
    phases = trace.records()
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as autograd_profiler

CAPACITY = 65_536


class Record(NamedTuple):
    """A span, its times in ms after the anchor; a device time is None where
    no mark was recorded, an exit None while the span is open."""

    name: str
    id: int
    index: Optional[int]
    parent: Optional[str]
    host_enter_ms: float
    host_exit_ms: Optional[float]
    device_enter_ms: Optional[float]
    device_exit_ms: Optional[float]


class _Off:
    """The shared span of the off path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """An open span of the on path, and its record until resolved."""

    __slots__ = ("recorder", "scope", "name", "id", "index", "parent", "host_enter", "host_exit",
                 "mark_enter", "mark_exit")

    def __init__(self, recorder: "Recorder", name: str, id: int, index: Optional[int]):
        self.recorder, self.name, self.id, self.index = recorder, name, id, index

    def __enter__(self):
        self.scope = torch.profiler.record_function(self.name)
        self.scope.__enter__()
        self.recorder.enter(self)
        return None

    def __exit__(self, *exc):
        self.recorder.exit(self)
        self.scope.__exit__(*exc)
        return False


class Recorder:
    """The records of the spans, the newest ``CAPACITY``, and their anchor."""

    def __init__(self):
        self.entries = deque(maxlen=CAPACITY)
        self.stack = []  # the open spans, innermost last
        self.anchor = None  # (host ns, mark), the mark a CUDA event on the card

    def _mark(self):
        if self.anchor is None:
            return None
        if not isinstance(self.anchor[1], torch.cuda.Event):
            return time.perf_counter_ns()
        if torch.cuda.is_current_stream_capturing():
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _ensure_anchor(self) -> None:
        if self.anchor is not None:
            return
        if not torch.cuda.is_initialized():
            host = time.perf_counter_ns()
            self.anchor = (host, host)
        elif not torch.cuda.is_current_stream_capturing():  # else no anchor and no mark yet
            torch.cuda.synchronize()
            event = torch.cuda.Event(enable_timing=True)
            host = time.perf_counter_ns()
            event.record()
            self.anchor = (host, event)

    def enter(self, entry: _Span) -> None:
        self._ensure_anchor()
        entry.parent = self.stack[-1].name if self.stack else None
        entry.host_exit = entry.mark_exit = None
        entry.host_enter = time.perf_counter_ns()
        entry.mark_enter = self._mark()
        self.stack.append(entry)
        self.entries.append(entry)

    def exit(self, entry: _Span) -> None:
        entry.host_exit = time.perf_counter_ns()
        entry.mark_exit = self._mark()
        if self.stack and self.stack[-1] is entry:
            self.stack.pop()

    def records(self) -> List[Record]:
        entries = list(self.entries)
        if not entries or self.anchor is None:
            return []
        host0, mark0 = self.anchor
        on_card = isinstance(mark0, torch.cuda.Event)
        if on_card:
            torch.cuda.synchronize()

        def host(ns):
            return None if ns is None else (ns - host0) / 1e6

        def device(mark):
            if mark is None:
                return None
            return mark0.elapsed_time(mark) if on_card else (mark - host0) / 1e6

        return [Record(e.name, e.id, e.index, e.parent, host(e.host_enter), host(e.host_exit),
                       device(e.mark_enter), device(e.mark_exit)) for e in entries]

    def clear(self) -> None:
        self.entries.clear()
        self.anchor = None


_RECORDER = Recorder()


def span(name: str, id: int, index: Optional[int] = None):
    """A context that marks the phase ``name`` of step or call ``id`` (and
    band ``index``) while a profile is active; a shared no-op otherwise."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(_RECORDER, name, id, index)


def records() -> List[Record]:
    """Every kept record, oldest first, its marks resolved (waits for the device)."""
    return _RECORDER.records()


def clear() -> None:
    """Forget every record and the anchor."""
    _RECORDER.clear()
