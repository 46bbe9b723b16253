"""CONCNN's spans and LRN counter (``models/concnn.py``, ``ops/nn.py``) on the
CPU: under a profile one ``concnn.front`` and two ``concnn.lrn`` (index 0 and
1) inside each ``sweep.band`` of a sweep and inside ``train_step.forward`` of
a step, none without a profile; the LRN counter; and the benchmark's two LRN
metrics read from such records."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.core import trace
from hypelcnn_tpu_torch.core.registry import get_importer_from_name
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene
from hypelcnn_tpu_torch.models.concnn import CONCNNModel
from hypelcnn_tpu_torch.ops.nn import local_response_normalization, reset_lrn_counts
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"filter_count": 4}
CPU = [torch.profiler.ProfilerActivity.CPU]
BAND = ["sweep.band", "concnn.front", "concnn.lrn", "concnn.lrn"]


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
        train_ratio=0.5, test_ratio=0.1, neighborhood=2)


def _module(data):
    return CONCNNModel().create_module(data.class_count, SMALL, data.data_shape)


def _sweep(module, data):
    return predict_full_scene(module, data.scene, batch_rows=8, device="cpu")


def test_concnn_spans_sit_inside_each_band(fresh, data):
    module = _module(data)
    with torch.profiler.profile(activities=CPU) as prof:
        _sweep(module, data)
    records = trace.records()
    bands = 3  # 20 rows in bands of 8
    assert [r.name for r in records] == ["sweep.setup"] + BAND * bands + ["sweep.map"]
    for index in range(bands):
        band, front, lrn0, lrn1 = records[1 + 4 * index:5 + 4 * index]
        assert band.index == index
        assert {front.parent, lrn0.parent, lrn1.parent} == {"sweep.band"}
        assert front.id == lrn0.id == lrn1.id
        assert (front.index, lrn0.index, lrn1.index) == (None, 0, 1)
        assert band.host_enter_ms <= front.host_enter_ms <= front.host_exit_ms \
            <= lrn0.host_enter_ms <= lrn0.host_exit_ms <= lrn1.host_enter_ms \
            <= lrn1.host_exit_ms <= band.host_exit_ms
    assert [records[2 + 4 * i].id for i in range(bands)] == \
        list(range(records[2].id, records[2].id + bands))  # a forward's call number
    assert {"concnn.front", "concnn.lrn"} <= {e.name for e in prof.events()}


def test_concnn_spans_off_without_a_profile(fresh, data):
    _sweep(_module(data), data)
    assert trace.records() == []


def test_lrn_counter_counts_two_calls_a_forward(data):
    module = _module(data).eval()
    k = 2 * 2 + 1
    reset_lrn_counts()
    with torch.no_grad():
        module(torch.rand(5, *data.data_shape))
    assert local_response_normalization.calls == 2
    assert local_response_normalization.elements == 2 * 5 * 3 * SMALL["filter_count"] * k * k
    _sweep(module, data)  # 3 bands of 8 x 24 windows
    assert local_response_normalization.calls == 2 + 2 * 3
    assert local_response_normalization.elements == \
        2 * (5 + 3 * 8 * 24) * 3 * SMALL["filter_count"] * k * k
    reset_lrn_counts()
    assert (local_response_normalization.calls, local_response_normalization.elements) == (0, 0)


def test_concnn_spans_inside_the_training_forward(fresh, data):
    trainer = ClassificationTrainer(
        model=CONCNNModel(), class_count=data.class_count,
        algorithm_params={**CONCNNModel().default_params(), **SMALL}, scene=data.scene,
        sample_set=data.sample_set, sources=data.sources, data_shape=data.data_shape,
        device="cpu")
    state = trainer.init_state()
    tables = trainer.training_tables(2, 16)
    with torch.profiler.profile(activities=CPU):
        for step in range(2):
            trainer.train_step(state, tables, step)
    ours = [r for r in trace.records() if r.name.startswith("concnn.")]
    assert [(r.name, r.index) for r in ours] == \
        [("concnn.front", None), ("concnn.lrn", 0), ("concnn.lrn", 1)] * 2
    assert all(r.parent == "train_step.forward" for r in ours)


def _record(name, id, index, device, length):
    return trace.Record(name, id, index, None, device, device + length, device, device + length)


def test_lrn_metrics_arithmetic(monkeypatch):
    from portbench.harness import Cell

    cell = Cell(ROOT, "concnn.sweep")
    records = []
    for band in range(2):
        start = 100.0 * band
        records += [_record("sweep.band", 7, band, start, 40.0),
                    _record("concnn.front", band, None, start + 1, 5.0),
                    _record("concnn.lrn", band, 0, start + 6, 3.0),
                    _record("concnn.lrn", band, 1, start + 20, 5.0)]
    monkeypatch.setattr(trace, "records", lambda: records)
    ctx = SimpleNamespace(model=cell.model, config=cell.config, traffic=cell.traffic,
                          device_kind="NVIDIA H100 80GB HBM3")
    assert cell.reader("lrn_share.sweep").read(ctx) == pytest.approx(20.0)
    least_s = 2 * 2 * 4 * 25 * 384 * (16 * 1905) / 3.35e12
    assert cell.reader("lrn_roofline.sweep").read(ctx) == pytest.approx(100.0 * least_s / 0.008)
    assert cell.reader("lrn_roofline.sweep").read(
        SimpleNamespace(**{**vars(ctx), "device_kind": "cpu"})) is None
    monkeypatch.setattr(trace, "records", lambda: [r for r in records
                                                   if not r.name.startswith("concnn.")])
    assert cell.reader("lrn_share.sweep").read(ctx) is None  # a program without the spans
    assert cell.reader("lrn_roofline.sweep").read(ctx) is None
    monkeypatch.setattr(trace, "records", lambda: [])
    assert cell.reader("lrn_share.sweep").read(ctx) is None
    assert cell.reader("lrn_roofline.sweep").read(ctx) is None


def test_lrn_metrics_read_a_profiled_stretch(fresh, monkeypatch):
    """The harness with its traced stretch under a CPU profile: the share
    reads, the roofline has no peak for the CPU."""
    from portbench import trace as trace_lib
    from portbench.harness import run_cell

    def profiled_stretch(run, device):
        with torch.profiler.profile(activities=CPU):
            run()
        return None

    monkeypatch.setattr(trace_lib, "traced_stretch", profiled_stretch)
    overrides = {"params": SMALL, "calibration_windows": 64, "check_pixels": 100000,
                 "check_block": 256,
                 "scene": {"height": 20, "width": 24, "casi_bands": 8, "classes": 5}}
    result = run_cell(ROOT, "concnn.sweep", 2 ** 31 + 5, 0.2, True, "cpu", overrides=overrides)
    assert result["correct"]
    share = result["metrics"]["lrn_share.sweep"]
    assert 0 < share["value"] < 100 and share["unit"] == "%"
    assert "lrn_roofline.sweep" not in result["metrics"]
