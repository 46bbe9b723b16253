"""The port's spans (``hypelcnn_tpu_torch/core/trace.py``) on the CPU: off
outside a profile, and under one the phases of a training step and of a
full-scene sweep, in order, tiling them, on the profiler's timeline, and
read by the benchmark's per-layer metrics (``portbench/spans.py``)."""

import math

import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.core import trace
from hypelcnn_tpu_torch.core.registry import get_importer_from_name
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TRAIN_PHASES = ["train_step.input", "train_step.forward", "train_step.backward",
                "train_step.optimizer"]
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture
def fresh():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def data():
    np.random.seed(0)
    return get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", "synthetic://?h=20&w=24&bands=6&classes=4&seed=3",
        train_ratio=0.5, test_ratio=0.1, neighborhood=1)


@pytest.fixture(scope="module")
def trainer(data):
    params = {**HYPELCNNModel().default_params(), "filter_count": 32}
    return ClassificationTrainer(
        model=HYPELCNNModel(), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, device="cpu")


def _profiled(work):
    with torch.profiler.profile(activities=CPU) as prof:
        work()
    return prof


def _outside(prof, names):
    """The ATen operations of the profile that no range named ``names``
    encloses, and the count of those that one does."""
    inside, outside = 0, []
    for event in prof.events():
        if not event.name.startswith("aten::"):
            continue
        top = event
        while top.cpu_parent is not None:
            top = top.cpu_parent
        if top.name in names:
            inside += 1
        else:
            outside.append(event.name)
    return inside, outside


def test_span_off_path_is_one_shared_no_op(fresh, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first = trace.span("train_step.input", 0)
    assert first is trace.span("sweep.band", 3, 7)
    with first as value:
        assert value is None
    assert trace.records() == []


def test_profiler_flag_follows_the_profile():
    assert torch.autograd.profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=CPU):
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_span_parents_and_times(fresh):
    def nested():
        with trace.span("outer", 4):
            with trace.span("inner", 4, 1):
                torch.ones(3).sum()

    _profiled(nested)
    inner, outer = sorted(trace.records(), key=lambda r: r.name)
    assert (outer.name, outer.id, outer.index, outer.parent) == ("outer", 4, None, None)
    assert (inner.name, inner.id, inner.index, inner.parent) == ("inner", 4, 1, "outer")
    assert 0 <= outer.host_enter_ms <= inner.host_enter_ms <= inner.host_exit_ms \
        <= outer.host_exit_ms
    for r in (inner, outer):  # off the card a mark is the host's clock
        assert r.host_enter_ms <= r.device_enter_ms <= r.device_exit_ms
        assert r.device_exit_ms >= r.host_exit_ms


def test_records_are_capped(fresh, monkeypatch):
    assert trace.Recorder().entries.maxlen == trace.CAPACITY == 65_536
    monkeypatch.setattr(trace, "CAPACITY", 5)
    monkeypatch.setattr(trace, "_RECORDER", trace.Recorder())

    def many():
        for step in range(7):
            with trace.span("train_step.input", step):
                pass

    _profiled(many)
    assert [r.id for r in trace.records()] == [2, 3, 4, 5, 6]
    trace.clear()
    assert trace.records() == []


def test_train_step_phases_tile_each_step(fresh, trainer):
    state = trainer.init_state()
    tables = trainer.training_tables(4, 16)
    prof = _profiled(lambda: [trainer.train_step(state, tables, step) for step in range(3)])
    records = trace.records()
    assert [r.name for r in records] == TRAIN_PHASES * 3
    assert [r.id for r in records] == [step for step in range(3) for _ in TRAIN_PHASES]
    assert all(r.index is None and r.parent is None for r in records)
    for before, after in zip(records, records[1:]):
        assert before.host_exit_ms <= after.host_enter_ms
        assert before.device_exit_ms <= after.device_enter_ms
    names = {e.name for e in prof.events()}
    assert set(TRAIN_PHASES) <= names
    inside, outside = _outside(prof, set(TRAIN_PHASES))
    assert inside > 50 and outside == []


def test_sweep_phases_tile_each_scene(fresh, data):
    module = HYPELCNNModel().create_module(data.class_count, {"filter_count": 32},
                                           data.data_shape)
    maps = []
    prof = _profiled(lambda: maps.extend(
        predict_full_scene(module, data.scene, batch_rows=8, device="cpu") for _ in range(2)))
    records = trace.records()
    bands = 3  # 20 rows in bands of 8
    names = ["sweep.setup"] + ["sweep.band"] * bands + ["sweep.map"]
    assert [r.name for r in records] == names * 2
    first = records[0].id
    assert [r.id for r in records] == [first] * len(names) + [first + 1] * len(names)
    assert [r.index for r in records[:len(names)]] == [None, 0, 1, 2, None]
    assert all(r.parent is None for r in records)
    for before, after in zip(records, records[1:]):
        assert before.host_exit_ms <= after.host_enter_ms
        assert before.device_exit_ms <= after.device_enter_ms
    assert {"sweep.setup", "sweep.band", "sweep.map"} <= {e.name for e in prof.events()}
    inside, outside = _outside(prof, set(names))
    assert inside > 20 and outside == []
    np.testing.assert_array_equal(maps[0], maps[1])


def _record(name, id, index, host, device, length=1.0):
    return trace.Record(name, id, index, None, host, host + length, device, device + length)


def test_span_arithmetic(monkeypatch):
    from portbench import spans

    steps = []
    for step, (host, device) in enumerate([(0.0, 0.0), (10.0, 30.0), (20.0, 70.0), (30.0, 90.0)]):
        steps += [_record(name, step, None, host + i, device + i * 2, 2.0)
                  for i, name in enumerate(TRAIN_PHASES)]
    scenes = []
    for call, start in ((5, 0.0), (6, 100.0)):
        scenes.append(_record("sweep.setup", call, None, start, start, 3.0))
        scenes += [_record("sweep.band", call, band, start + 3 + band, start + 3 + 10 * band, 10.0)
                   for band in range(4)]
        scenes.append(_record("sweep.map", call, None, start + 43, start + 43, 4.0))
    monkeypatch.setattr(trace, "records", lambda: steps + scenes)
    assert spans.phase_ms("train_step.forward") == 2.0
    assert spans.step_lead_ms() == 50.0  # the median of 20, 50, 60
    assert spans.band_lead_ms() == 18.0  # each scene's bands after the first: 9, 18, 27
    assert spans.scene_edges_ms() == 7.0
    monkeypatch.setattr(trace, "records", lambda: [])
    assert spans.phase_ms("train_step.input") is None
    assert spans.band_lead_ms() is None
    assert spans.scene_edges_ms() is None


NEW_METRICS = {
    "train": ["input_ms_per_step.train", "forward_ms_per_step.train",
              "backward_ms_per_step.train", "optimizer_ms_per_step.train", "host_lead_ms.train"],
    "sweep": ["host_lead_ms.sweep", "scene_edges_ms.sweep"],
}


@pytest.mark.parametrize("workload", ["hypelcnn480.sweep", "hypelcnn480.train_b16384",
                                      "dualcnn.sweep", "dualcnn.train_b4096"])
def test_span_metrics_read_a_profiled_stretch(fresh, monkeypatch, workload):
    """The harness with its traced stretch under a CPU profile: each new
    reader of the cell gives a finite number, and none without a profile."""
    from portbench import harness
    from portbench import trace as trace_lib
    from portbench.tests import tiny

    def profiled_stretch(run, device):
        _profiled(run)
        return None

    kind = "sweep" if workload.endswith("sweep") else "train"
    monkeypatch.setattr(trace_lib, "traced_stretch", profiled_stretch)
    result = tiny.run(workload, trace=True)
    assert result["correct"]
    for name in NEW_METRICS[kind]:
        assert math.isfinite(result["metrics"][name]["value"]), name
        assert result["metrics"][name]["unit"] == "ms"
    cell = harness.Cell(tiny.ROOT, workload)
    trace.clear()
    assert all(cell.reader(name).read(None) is None for name in NEW_METRICS[kind])
