"""The port's spans on the card: the device marks add no device operation,
and a training step's four phases tile it on the device's clock.

Every test here needs a CUDA device and skips without one. The file imports
no JAX; run it on the card with::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_trace_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.core import trace
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_importer_from_name
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer

PHASES = ["train_step.input", "train_step.forward", "train_step.backward", "train_step.optimizer"]
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trace.clear()
    yield resolve_device("cuda")
    trace.clear()


@pytest.fixture
def data():
    np.random.seed(0)
    return get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", "synthetic://?h=96&w=128&bands=144&classes=5&seed=3",
        train_ratio=0.5, test_ratio=0.1, neighborhood=1)


def _device_ops(work) -> int:
    """The kernels, copies and fills that ``work`` puts on the card, as the
    benchmark's trace counts them (not the spans' ranges on its timeline)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        work()
        torch.cuda.synchronize()
    return sum(e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
               for e in prof.profiler.kineto_results.events())


def _no_spans(name, id, index=None):
    return contextlib.nullcontext()


@pytest.mark.cuda
def test_step_spans_add_no_device_operation_and_tile_the_step(cuda, data, monkeypatch):
    params = {**HYPELCNNModel().default_params(), "filter_count": 32}
    trainer = ClassificationTrainer(
        model=HYPELCNNModel(), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, device=cuda)
    state = trainer.init_state()
    tables = trainer.training_tables(12, 1024)
    for step in range(3):  # warm-up: cuDNN's choices made
        trainer.train_step(state, tables, step)

    def steps(first):
        return lambda: [trainer.train_step(state, tables, step) for step in range(first, first + 3)]

    spanned = _device_ops(steps(3))
    records = trace.records()
    monkeypatch.setattr(trace, "span", _no_spans)
    plain = _device_ops(steps(6))
    assert spanned == plain > 0

    assert [r.name for r in records] == PHASES * 3
    assert all(r.device_enter_ms is not None and r.device_exit_ms is not None for r in records)
    for start in range(0, len(records), len(PHASES)):
        step = records[start:start + len(PHASES)]
        phases = sum(r.device_exit_ms - r.device_enter_ms for r in step)
        interval = step[-1].device_exit_ms - step[0].device_enter_ms
        assert interval > 0 and abs(phases - interval) <= 0.03 * interval


@pytest.mark.cuda
def test_sweep_spans_add_no_device_operation(cuda, data, monkeypatch):
    module = HYPELCNNModel().create_module(data.class_count, {"filter_count": 32},
                                           data.data_shape).to(cuda)
    predict_full_scene(module, data.scene, batch_rows=16, device=cuda)  # warm-up

    def sweep():
        predict_full_scene(module, data.scene, batch_rows=16, device=cuda)

    spanned = _device_ops(sweep)
    records = trace.records()
    monkeypatch.setattr(trace, "span", _no_spans)
    assert spanned == _device_ops(sweep) > 0
    assert [r.name for r in records] == ["sweep.setup"] + ["sweep.band"] * 6 + ["sweep.map"]
    assert [r.index for r in records[1:-1]] == list(range(6))
    assert all(r.device_exit_ms >= r.device_enter_ms for r in records)
