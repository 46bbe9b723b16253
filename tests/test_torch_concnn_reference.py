"""CONCNN against its plain reference (``portbench/reference/concnn.py``) on the
CPU at a small size: evaluation logits for k = 3 and 5; the reference's LRN
against TF's formula written out by hand; the two LRN faults a port could
make, planted in the program; the counts at the published widths; then the
benchmark's cell ``concnn.sweep`` at a tiny size, sound and with each LRN
fault planted.

Tolerance: the port takes LRN's window sums of squares as a difference of
cumulative sums over the 3f channels (as the JAX package does), the reference
as a plain sum over each window. In float32 the cumulative sum carries the
rounding of every channel before the window, so the logits part by up to
1.1e-6 of the largest on these seeds; the tolerance is 5e-6. Leaving an LRN
out, or normalizing with torch's ``local_response_norm`` (alpha over the
window), parts them by 0.38 or more; the faults' bar is 1e-2."""

import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

import hypelcnn_tpu_torch.models.concnn as concnn
from hypelcnn_tpu_torch.models.concnn import CONCNNModel
from portbench import counts, lrn
from portbench import weights as weights_lib
from portbench.reference.common import Norms
from portbench.reference.concnn import Model, local_response_normalization
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "concnn.json").read_text())
SMALL = {"filter_count": 8}
PARAMS = {**CONFIG["params"], **SMALL}
CLASSES, CHANNELS, BATCH = 5, 9, 64
SCORE_TOL, FAULT_GAP = 5e-6, 1e-2
CASES = [(k, seed) for k in (3, 5) for seed in range(4)]
H100 = "NVIDIA H100 80GB HBM3"


def _pair(k: int, seed: int):
    """The reference, its weights (the logits centred on the batch), the
    port's module with them, and the batch."""
    shape = [k, k, CHANNELS]
    ref = Model(PARAMS, CLASSES, shape)
    gen = torch.Generator().manual_seed(seed)
    weights = weights_lib.make_weights(ref, gen, "cpu")
    x = torch.rand(BATCH, k, k, CHANNELS, generator=gen)
    weights_lib.calibrate(ref, weights, x, gen)  # centred logits: every class can win
    module = CONCNNModel().create_module(CLASSES, PARAMS, shape)
    module.load_state_dict(weights)
    return ref, weights, module.eval(), x


def _gap(module, ref, weights, x) -> float:
    """The largest gap of the module's logits from the reference's, over the
    largest reference logit."""
    with torch.no_grad():
        got = module(x).y_conv
        want, image = ref.forward(weights, x, Norms("running"))
    assert image is None
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("k", [3, 5])
def test_concnn_reference_params_match_port_state_dict(k):
    ref = Model(PARAMS, CLASSES, [k, k, CHANNELS])
    module = CONCNNModel().create_module(CLASSES, PARAMS, [k, k, CHANNELS])
    assert {p.name: p.shape for p in ref.params()} == \
        {name: tuple(t.shape) for name, t in module.state_dict().items()}


@pytest.mark.parametrize("k,seed", CASES)
def test_concnn_eval_logits_match_reference(k, seed):
    ref, weights, module, x = _pair(k, seed)
    assert _gap(module, ref, weights, x) <= SCORE_TOL
    with torch.no_grad():
        assert len(set(ref.forward(weights, x, Norms("running"))[0].argmax(1).tolist())) > 1


def test_concnn_reference_lrn_is_tf_formula_by_hand():
    """``sqr_sum[c] = sum(x[c - r : c + r + 1] ** 2)``, clipped at the
    channels' ends, and ``x / (bias + alpha * sqr_sum) ** beta``, in Python
    floats, at TF's defaults (r 5, bias 1, alpha 1, beta 0.5) and at others."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 13, 2, 3, generator=gen, dtype=torch.float64)
    for radius, bias, alpha, beta in ((5, 1.0, 1.0, 0.5), (2, 2.0, 0.3, 0.75)):
        want = torch.empty_like(x)
        for b in range(2):
            for i in range(2):
                for j in range(3):
                    v = [x[b, c, i, j].item() for c in range(13)]
                    for c in range(13):
                        window = v[max(0, c - radius):min(13, c + radius + 1)]
                        want[b, c, i, j] = v[c] / (bias + alpha * sum(t * t for t in window)) \
                            ** beta
        got = local_response_normalization(x, radius, bias, alpha, beta)
        assert torch.allclose(got, want, rtol=1e-12, atol=0)


def one_lrn_left_out(monkeypatch):
    """The LRN after ``conv11`` left out: every second call is the identity."""
    calls = []

    def lrn_or_not(x, *args, **kwargs):
        calls.append(None)
        if len(calls) % 2 == 0:
            return x
        return lrn_port(x, *args, **kwargs)
    lrn_port = concnn.local_response_normalization
    monkeypatch.setattr(concnn, "local_response_normalization", lrn_or_not)


def torch_lrn(monkeypatch):
    """torch's LRN over the same 2r + 1 channels: it divides alpha by the
    window's size and pads the channels with zeros."""
    def torch_local_response_norm(x):
        return F.local_response_norm(x, size=11, alpha=1.0, beta=0.5, k=1.0)
    monkeypatch.setattr(concnn, "local_response_normalization", torch_local_response_norm)


LRN_FAULTS = [one_lrn_left_out, torch_lrn]


@pytest.mark.parametrize("fault", LRN_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("k", [3, 5])
def test_concnn_planted_lrn_fault_parts_from_reference(monkeypatch, fault, k):
    ref, weights, module, x = _pair(k, 0)
    fault(monkeypatch)
    assert _gap(module, ref, weights, x) > FAULT_GAP


def test_concnn_counts_at_published_widths():
    model = Model(CONFIG["params"], 15, [5, 5, 145])
    assert sum(math.prod(p.shape) for p in model.params()) == CONFIG["parameters"] == 1_976_719
    module = CONCNNModel().create_module(15, CONFIG["params"], [5, 5, 145])
    assert sum(p.numel() for p in module.parameters()) == CONFIG["parameters"]
    # taps of the bank (1x1, 3x3, 5x5 SAME, in full), eight 384 x 384 1x1s, the head
    bank = 25 * 128 * 145 * (1 + 9 + 25)
    assert counts.forward_flop(model) == 2 * (bank + 8 * 25 * 384 * 384 + 9600 * 15) \
        == 91_750_400
    windows = 16 * 1905
    assert model.lrn_elements() == 25 * 384
    assert lrn.least_bytes(model, windows) == 2 * 2 * 4 * 25 * 384 * windows == 4_681_728_000
    assert lrn.least_s(model, windows, H100) == pytest.approx(4_681_728_000 / 3.35e12)
    assert lrn.least_s(model, windows, "cpu") is None


# ---- the benchmark's cell at a tiny size ----

OVERRIDES = {"params": SMALL, "scene": {"height": 20, "width": 24, "casi_bands": 8, "classes": 5},
             "calibration_windows": 64, "check_pixels": 100000, "check_block": 256}


def _run(seed=2 ** 31 + 11):
    from portbench.harness import run_cell

    return run_cell(ROOT, "concnn.sweep", seed, 0.2, False, "cpu", overrides=OVERRIDES)


def test_concnn_sweep_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"class_gap"}
    assert result["checks"]["class_gap"]["value"] <= SCORE_TOL


@pytest.mark.parametrize("fault", LRN_FAULTS, ids=lambda f: f.__name__)
def test_concnn_sweep_planted_lrn_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = _run()
    assert not result["correct"], result["checks"]
