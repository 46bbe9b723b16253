"""CAP against its plain reference (``portbench/reference/cap.py``) on the CPU
at a small size: evaluation scores with the batch's statistics, the training
loss with the decoder and every parameter's gradient, for k = 1 and 3; then
the benchmark's cell ``cap.sweep_bands`` at a tiny size, judged by whole
bands, and the two faults of CAP planted in the program.

Tolerances: the port and the reference differ only in float32 summation
order (batch norm's moments in one pass against two, batched products
against einsum, the agreement summed in another order). Routing sums its
agreement over the batch and its softmax couplings amplify a logit's rounding
where two classes nearly tie, so the scores part by up to 7e-6 of the largest
and a gradient by up to 1e-4 of its norm on these seeds; a wrong equation
parts them by 1e-2 or more."""

import json
from pathlib import Path

import pytest
import torch

from hypelcnn_tpu_torch.models.cap import CAPModel, CAPModule
from portbench import capsules, counts
from portbench import weights as weights_lib
from portbench.drivers.band_sweep import capsule_weights
from portbench.reference.cap import Model
from portbench.reference.common import Norms
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "cap.json").read_text())
SMALL = {"feature_count": 16, "primary_capsule_count": 4, "digit_capsule_output_space": 8}
PARAMS = {**CONFIG["params"], **SMALL}
CLASSES, CHANNELS, BATCH = 5, 9, 64
SCORE_TOL, LOSS_TOL, GRAD_TOL = 2e-5, 1e-6, 5e-4
CASES = [(k, seed) for k in (1, 3) for seed in range(4)]


def _pair(k: int, seed: int):
    """The reference, the port's module with the same weights, and a batch."""
    shape = [k, k, CHANNELS]
    ref = Model(PARAMS, CLASSES, shape)
    gen = torch.Generator().manual_seed(seed)
    weights = weights_lib.make_weights(ref, gen, "cpu")
    capsule_weights(weights, gen)
    module = CAPModel().create_module(CLASSES, PARAMS, shape)
    module.load_state_dict(weights)
    x = torch.rand(BATCH, k, k, CHANNELS, generator=gen)
    labels = torch.nn.functional.one_hot(torch.randint(0, CLASSES, (BATCH,), generator=gen),
                                         CLASSES).float()
    return ref, weights, module, x, labels


@pytest.mark.parametrize("k", [1, 3])
def test_cap_reference_params_match_port_state_dict(k):
    ref = Model(PARAMS, CLASSES, [k, k, CHANNELS])
    module = CAPModel().create_module(CLASSES, PARAMS, [k, k, CHANNELS])
    assert {p.name: p.shape for p in ref.params()} == \
        {name: tuple(t.shape) for name, t in module.state_dict().items()}


@pytest.mark.parametrize("k,seed", CASES)
def test_cap_eval_scores_match_reference(k, seed):
    ref, weights, module, x, _ = _pair(k, seed)
    module.eval()
    with torch.no_grad():
        got = module(x).y_conv
        want, image = ref.forward(weights, x, Norms("running"))  # batch moments all the same
    assert image is None
    assert torch.allclose(got, want, atol=SCORE_TOL * want.abs().max().item(), rtol=0)
    assert len(set(want.argmax(1).tolist())) > 1  # more than one class wins


@pytest.mark.parametrize("k,seed", CASES)
def test_cap_train_loss_and_gradients_match_reference(k, seed):
    ref, weights, module, x, labels = _pair(k, seed)
    module.train()
    out = module(x, labels)
    loss = CAPModel().loss(out, labels).mean()
    names = [name for name, _ in module.named_parameters()]
    got = torch.autograd.grad(loss, [p for _, p in module.named_parameters()])
    leaves = {name: weights[name].clone().requires_grad_(True) for name in names}
    logits, image = ref.forward({**weights, **leaves}, x, Norms("batch"), train=True,
                                labels=labels)
    want_loss = ref.loss(logits, image, x, labels)
    want = torch.autograd.grad(want_loss, [leaves[name] for name in names])
    assert abs(loss.item() - want_loss.item()) <= LOSS_TOL * abs(want_loss.item())
    for name, g, w in zip(names, got, want):
        assert torch.isfinite(w).all(), name
        assert (g - w).norm() <= GRAD_TOL * w.norm(), name


def test_cap_counts_at_published_widths():
    model = Model(CONFIG["params"], 15, [3, 3, 145])
    assert model.data_size == 288
    assert capsules.layer_flop(model) == 2 * (288 * 16 * 240 + 5 * 288 * 240) == 2_903_040
    assert counts.forward_flop(model) == 5_930_496
    windows = 16 * 1905
    least = capsules.layer_least_bytes(model, windows)
    assert least == 4 * (windows * (288 * 16 + 240) + 288 * 16 * 240 + 288 * 240)
    assert 0.59e9 < least < 0.6e9
    kind = "NVIDIA H100 80GB HBM3"
    assert capsules.layer_least_s(model, windows, kind) == pytest.approx(
        2_903_040 * windows / 67e12)  # compute bound: 88.5 GFLOP against 0.6 GB
    assert capsules.layer_least_s(model, windows, "cpu") is None
    module = CAPModel().create_module(15, CONFIG["params"], [3, 3, 145])
    assert sum(p.numel() for p in module.parameters()) == CONFIG["parameters"]


# ---- the benchmark's cell at a tiny size ----

OVERRIDES = {"params": SMALL, "scene": {"height": 20, "width": 24, "casi_bands": 8, "classes": 5},
             "batch_rows": 6}  # 4 bands, the last (rows 14 to 19) overlapping the third


def _run(seed=2 ** 31 + 11, **kwargs):
    from portbench.harness import run_cell

    return run_cell(ROOT, "cap.sweep_bands", seed, 0.2, False, "cpu", overrides=OVERRIDES,
                    **kwargs)


def test_cap_sweep_bands_judges_whole_bands():
    seen = {}

    def after(driver, env):
        seen["bands"] = driver.checked_bands()
        seen["owned"] = [driver.owned_rows(i) for i in range(len(driver.band_starts()))]
        seen["starts"] = driver.band_starts()
        seen["pixels"] = driver.sample().shape[0]

    result = _run(after_check=after)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"class_gap", "class_gap_near_tie"}
    assert seen["starts"] == [0, 6, 12, 14]
    assert seen["owned"] == [range(0, 6), range(6, 12), range(12, 14), range(14, 20)]
    assert len(seen["bands"]) == 3 and seen["bands"][-1] == 3
    assert seen["pixels"] == sum(len(seen["owned"][i]) for i in seen["bands"]) * 24


def _blocks(monkeypatch):
    """The band classified in blocks (a quarter of a band here, as 8,192 of
    30,480 windows at full size): batch norm and routing see each block alone."""
    forward = CAPModule.forward

    def blocks(self, x, *args, **kwargs):
        outs = [forward(self, part, *args, **kwargs) for part in x.split(x.shape[0] // 4 + 1)]
        return outs[0]._replace(y_conv=torch.cat([o.y_conv for o in outs]))
    monkeypatch.setattr(CAPModule, "forward", blocks)


def _one_round_less(monkeypatch):
    init = CAPModule.__init__

    def two_rounds(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.iter_routing -= 1
    monkeypatch.setattr(CAPModule, "__init__", two_rounds)


@pytest.mark.parametrize("fault", [_blocks, _one_round_less],
                         ids=["band_in_blocks", "one_routing_round_left_out"])
def test_cap_sweep_bands_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = _run()
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values()), result["checks"]
