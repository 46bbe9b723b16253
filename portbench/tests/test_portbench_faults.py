"""A run of each cell on the CPU with the timed path broken underneath:
``correct`` comes out false, once for each fault the cell can have (one
chip: no exchange between chips to leave out)."""

import pytest
import torch

import hypelcnn_tpu_torch.ops.window_gather as window_gather
from hypelcnn_tpu_torch.models.dualcnn import DUALCNNModel, DUALCNNModule
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel, HYPELCNNModule
from hypelcnn_tpu_torch.train.state import TrainState
from portbench.tests import tiny

MODULES = {"hypelcnn480": (HYPELCNNModule, HYPELCNNModel),
           "dualcnn": (DUALCNNModule, DUALCNNModel)}


def _state_unchanged(monkeypatch, config):
    def apply_gradients(self):  # the step count moves, the parameters do not
        self.step += 1
    monkeypatch.setattr(TrainState, "apply_gradients", apply_gradients)


def _half_batch(monkeypatch, config):
    model = MODULES[config][1]
    loss = model.loss

    def half(self, output, labels):  # the mean is taken over the first half alone
        per_example = loss(self, output, labels)
        return per_example[: per_example.shape[0] // 2]
    monkeypatch.setattr(model, "loss", half)


def _answer_altered(monkeypatch, config):
    module = MODULES[config][0]
    forward = module.forward

    def altered(self, *args, **kwargs):  # a quarter of the logits rolled by one class
        out = forward(self, *args, **kwargs)
        logits = out.y_conv.clone()
        rows = logits.shape[0] // 4
        logits[:rows] = torch.roll(logits[:rows], 1, dims=1)
        return out._replace(y_conv=logits)
    monkeypatch.setattr(module, "forward", altered)


def _half_band_left_out(monkeypatch, config):
    gather = window_gather.gather_patches_torch

    def half(scene, coords, k):  # the second half's windows are the first half's
        out = gather(scene, coords, k)
        count = out.shape[0] // 2
        out[count:2 * count] = out[:count]
        return out
    monkeypatch.setattr(window_gather, "gather_patches_torch", half)


FAULTS = {"train": [_state_unchanged, _half_batch],
          "sweep": [_answer_altered, _half_band_left_out]}
CASES = [(cell, fault) for cell in tiny.CELLS
         for fault in FAULTS[cell.split(".")[1].split("_")[0]]]  # by the mix's kind


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in CASES])
def test_portbench_planted_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch, workload.split(".")[0])
    result = tiny.run(workload)
    assert not result["correct"], result["checks"]
