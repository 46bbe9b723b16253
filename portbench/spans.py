"""Arithmetic of the per-layer metrics that read the program's own spans.

The port marks the phases of a training step (``train_step.input``,
``.forward``, ``.backward``, ``.optimizer``, each with the step as its id)
and of a full-scene sweep (``sweep.setup``, one ``sweep.band`` a band with
the band as its index, ``sweep.map``, each with the sweep's call number as
its id) while a profile is active: ``hypelcnn_tpu_torch.core.trace``. Its
records hold a device time at each span's enter and exit, in ms on the
host's clock. In a run of the benchmark only the traced stretch is
profiled, so the records are that stretch's.

Each function returns None where there is nothing to read: a CPU run (no
profile, no record), or a program without the spans.
"""

from __future__ import annotations

import statistics
from typing import List, Optional


def _records(prefix: str) -> List:
    try:
        from hypelcnn_tpu_torch.core import trace
    except ImportError:  # a program without spans
        return []
    return [r for r in trace.records() if r.name.startswith(prefix)
            and r.device_enter_ms is not None and r.device_exit_ms is not None]


def _groups(records: List) -> List[List]:
    """Consecutive records of one id: the phases of one step or one scene."""
    groups: List[List] = []
    for r in records:
        if groups and groups[-1][0].id == r.id:
            groups[-1].append(r)
        else:
            groups.append([r])
    return groups


def phase_ms(name: str) -> Optional[float]:
    """The mean device time of the spans named ``name``, in ms."""
    times = [r.device_exit_ms - r.device_enter_ms for r in _records(name) if r.name == name]
    return sum(times) / len(times) if times else None


def _median_lead(records: List) -> Optional[float]:
    """The median over ``records`` of how far the device's arrival at the
    span's enter lies behind the host's: the work queued ahead of the device
    when the host got there, in ms."""
    if not records:
        return None
    return statistics.median(r.device_enter_ms - r.host_enter_ms for r in records)


def step_lead_ms() -> Optional[float]:
    """The host's lead at ``train_step.input``, over the steps after the first."""
    return _median_lead(_records("train_step.input")[1:])


def band_lead_ms() -> Optional[float]:
    """The host's lead at ``sweep.band``, over each scene's bands after the first."""
    return _median_lead([r for scene in _groups(_records("sweep.band")) for r in scene[1:]])


def scene_edges_ms() -> Optional[float]:
    """The mean over the sweeps of the device time of ``sweep.setup`` and
    ``sweep.map``: the part of a scene in which no band runs, in ms."""
    edges = []
    for group in _groups(_records("sweep.")):
        ends = [r for r in group if r.name in ("sweep.setup", "sweep.map")]
        if len(ends) == 2:
            edges.append(sum(r.device_exit_ms - r.device_enter_ms for r in ends))
    return sum(edges) / len(edges) if edges else None
