"""The benchmark's FLOP and byte counts against the figures measured before."""

import json
import math

import pytest

from portbench import counts
from portbench.reference import dualcnn, hypelcnn
from portbench.tests import tiny


def _params(name):
    return json.loads((tiny.ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,module,k,flop,parameters", [
    ("hypelcnn480", hypelcnn, 3, 12_141_900, 1_291_395),
    ("dualcnn", dualcnn, 5, 138_009_350, 7_783_240),
])
def test_portbench_forward_flop_per_pixel(name, module, k, flop, parameters):
    cfg = _params(name)
    model = module.Model(cfg["params"], 15, [k, k, 145])
    assert counts.forward_flop(model) == flop
    trainable = [p for p in model.params() if not p.name.endswith((".mean", ".var"))]
    assert sum(math.prod(p.shape) for p in trainable) == parameters == \
        cfg["parameters"]


def test_portbench_train_flop_hypelcnn():
    # 3 training-mode passes (the eval pass plus the reconstruction heads'
    # 589,950 multiply-adds) less conv_enc_0's input gradient (9 x 120 x 145)
    model = hypelcnn.Model(_params("hypelcnn480")["params"], 15, [3, 3, 145])
    assert counts.train_flop(model) == 3 * (12_141_900 + 2 * 589_950) - 2 * 9 * 120 * 145


def test_portbench_gather_band_bound():
    seconds = counts.gather_band_bytes(16, 1905, 3, 145) / counts.PEAKS[
        "NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"]
    assert round(seconds * 1e3, 6) == 0.053510
    assert counts.gather_band_bytes(16, 1905, 3, 145) == \
        4 * (30480 * 9 * 145 + 18 * 1907 * 145 + 30480 * 2)
