"""The control on the card, at the cell's own size: the reference computed
in TF32 (one step below the configurations' float32 with TF32 off) in the
program's place reads above a limit of ``correct``, as do the planted
faults' readings. Marked ``cuda``: it needs the card, and skips without one."""

import json

import pytest
import torch

from portbench.tests import tiny

SEED = 2 ** 31 + 101


@pytest.mark.cuda
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_portbench_control_fails_a_limit(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.readings import readings

    out = readings(workload, [SEED], 1, 1.0)
    limits = json.loads((tiny.ROOT / "portbench" / "limits" / f"{workload}.json").read_text())
    assert all(v <= limits[k] for k, v in out["program"][str(SEED)].items())
    for name, by_seed in out["faults"].items():
        values = by_seed[str(SEED)]
        assert any(v > limits[k] for k, v in values.items()), (name, values)
