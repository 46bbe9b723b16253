"""CAP's capsule-layer spans and counters (``models/cap.py``) on the CPU: under
a profile one ``cap.transform`` and one ``cap.routing`` inside each
``sweep.band`` of a sweep (the folded route) and inside ``train_step.forward``
of a step (the ``u_hat`` route), none without a profile; the counters of the
last forward; and the benchmark's three capsule-layer metrics read from them."""

import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.core import trace
from hypelcnn_tpu_torch.core.registry import get_importer_from_name
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene
from hypelcnn_tpu_torch.models.cap import CAPModel, CAPModule
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"feature_count": 16, "primary_capsule_count": 4, "digit_capsule_output_space": 8}
CPU = [torch.profiler.ProfilerActivity.CPU]
BAND = ["sweep.band", "cap.transform", "cap.routing"]


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


def _module(data):
    return CAPModel().create_module(data.class_count, SMALL, data.data_shape)


def _sweep(module, data):
    return predict_full_scene(module, data.scene, batch_rows=8, device="cpu")


def test_cap_spans_sit_inside_each_band(fresh, data):
    module = _module(data)
    with torch.profiler.profile(activities=CPU) as prof:
        _sweep(module, data)
    records = trace.records()
    bands = 3  # 20 rows in bands of 8
    assert [r.name for r in records] == ["sweep.setup"] + BAND * bands + ["sweep.map"]
    for index in range(bands):
        band, transform, routing = records[1 + 3 * index:4 + 3 * index]
        assert band.index == index
        assert (transform.parent, routing.parent) == ("sweep.band", "sweep.band")
        assert transform.id == routing.id
        assert transform.index is None and routing.index is None
        assert band.host_enter_ms <= transform.host_enter_ms <= transform.host_exit_ms \
            <= routing.host_enter_ms <= routing.host_exit_ms <= band.host_exit_ms
    assert [records[2 + 3 * i].id for i in range(bands)] == \
        list(range(records[2].id, records[2].id + bands))  # a forward's call number
    assert {"cap.transform", "cap.routing"} <= {e.name for e in prof.events()}


def test_cap_spans_off_without_a_profile(fresh, data):
    _sweep(_module(data), data)
    assert trace.records() == []


def test_cap_counters_of_the_last_forward(data):
    """A sweep and a no-grad forward take the folded route, which
    materializes no ``u_hat``; a training forward materializes all of it."""
    module = _module(data)
    _sweep(module, data)
    assert CAPModule.u_hat_bytes == 0
    assert CAPModule.routing_products == 2 * module.iter_routing - 1
    with torch.no_grad():
        module(torch.rand(5, *data.data_shape))
    assert CAPModule.u_hat_bytes == 0
    labels = torch.nn.functional.one_hot(torch.arange(5) % data.class_count,
                                         data.class_count).float()
    module.train()(torch.rand(5, *data.data_shape), labels)
    assert CAPModule.u_hat_bytes == module.data_size * data.class_count * module.dco * 4 * 5
    assert CAPModule.routing_products == 2 * module.iter_routing - 1


def test_cap_spans_inside_the_training_forward(fresh, data):
    trainer = ClassificationTrainer(
        model=CAPModel(), class_count=data.class_count,
        algorithm_params={**CAPModel().default_params(), **SMALL}, scene=data.scene,
        sample_set=data.sample_set, sources=data.sources, data_shape=data.data_shape,
        device="cpu")
    state = trainer.init_state()
    tables = trainer.training_tables(2, 16)
    with torch.profiler.profile(activities=CPU):
        for step in range(2):
            trainer.train_step(state, tables, step)
    caps = [r for r in trace.records() if r.name.startswith("cap.")]
    assert [r.name for r in caps] == ["cap.transform", "cap.routing"] * 2
    assert all(r.parent == "train_step.forward" for r in caps)


def _record(name, id, index, device, length):
    return trace.Record(name, id, index, None, device, device + length, device, device + length)


def test_capsule_metrics_arithmetic(monkeypatch):
    from portbench.harness import Cell

    cell = Cell(ROOT, "cap.sweep_bands")
    records = []
    for band in range(2):
        start = 100.0 * band
        records += [_record("sweep.band", 7, band, start, 40.0),
                    _record("cap.transform", band, None, start + 1, 10.0),
                    _record("cap.routing", band, None, start + 12, 20.0)]
    monkeypatch.setattr(trace, "records", lambda: records)
    ctx = SimpleNamespace(model=cell.model, config=cell.config, traffic=cell.traffic,
                          device_kind="NVIDIA H100 80GB HBM3")
    assert cell.reader("capsule_share.sweep").read(ctx) == pytest.approx(75.0)
    windows = 16 * 1905
    least_s = 2_903_040 * windows / 67e12
    assert cell.reader("capsule_roofline.sweep").read(ctx) == pytest.approx(
        100.0 * least_s / 0.030)
    assert cell.reader("capsule_roofline.sweep").read(
        SimpleNamespace(**{**vars(ctx), "device_kind": "cpu"})) is None
    monkeypatch.setattr(trace, "records", lambda: [])
    assert cell.reader("capsule_share.sweep").read(ctx) is None
    assert cell.reader("capsule_roofline.sweep").read(ctx) is None


def test_capsule_metrics_read_a_profiled_stretch(fresh, monkeypatch):
    """The harness with its traced stretch under a CPU profile: the share and
    the counter read, the roofline has no peak for the CPU."""
    from portbench import trace as trace_lib
    from portbench.harness import run_cell

    def profiled_stretch(run, device):
        with torch.profiler.profile(activities=CPU):
            run()
        return None

    monkeypatch.setattr(trace_lib, "traced_stretch", profiled_stretch)
    overrides = {"params": SMALL, "batch_rows": 6,
                 "scene": {"height": 20, "width": 24, "casi_bands": 8, "classes": 5}}
    result = run_cell(ROOT, "cap.sweep_bands", 2 ** 31 + 5, 0.2, True, "cpu",
                      overrides=overrides)
    assert result["correct"]
    share = result["metrics"]["capsule_share.sweep"]
    assert 0 < share["value"] < 100 and share["unit"] == "%"
    # the sweep's folded route materializes no u_hat
    assert result["metrics"]["u_hat_bytes_per_window.sweep"] == {"value": 0.0, "unit": "bytes"}
    assert "capsule_roofline.sweep" not in result["metrics"]
    assert math.isfinite(share["value"])
