"""The port's DCL trainers (dcl_gan, dcl_cycle_gan) against the JAX
package's on the CPU, with the tolerances of ``test_torch_gan_train.py``;
dcl_cycle_gan equal to dcl_gan bit for bit without the cycle-loss fix, and
the fix's optimizers advancing once a step."""

import pytest
import torch

from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict
from test_torch_gan_train import CONFIG, MAX_STEPS, _run, five_steps_match_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.mark.parametrize("family, config", [
    ("dcl_gan", CONFIG),
    ("dcl_cycle_gan", CONFIG),
    ("dcl_cycle_gan", {**CONFIG, "apply_cycle_loss_fix": True}),
], ids=["dcl_gan-16", "dcl_cycle_gan-16", "dcl_cycle_gan_fix-16"])
def test_five_steps_match_jax(family, config):
    five_steps_match_jax(family, 16, config)


def test_dcl_cycle_gan_equals_dcl_gan_bit_for_bit():
    bands = 16
    dcl = get_trainer_dict(CONFIG, bands, MAX_STEPS)["dcl_gan"]
    cycle = get_trainer_dict(CONFIG, bands, MAX_STEPS)["dcl_cycle_gan"]
    init = dcl.init_state("cpu", torch.Generator().manual_seed(0)).nets.state_dict()
    states = [t.init_state("cpu", state_dict=init) for t in (dcl, cycle)]
    runs = [_run(t, s, bands) for t, s in zip((dcl, cycle), states)]
    for ours, theirs in zip(*runs):
        assert ours.keys() == theirs.keys()
        assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    for key, value in states[0].nets.state_dict().items():
        assert torch.equal(states[1].nets.state_dict()[key], value), key


def test_cycle_loss_fix_advances_each_schedule_once_a_step():
    trainer = get_trainer_dict({**CONFIG, "apply_cycle_loss_fix": True}, 16, 100)["dcl_cycle_gan"]
    state = trainer.init_state("cpu", torch.Generator().manual_seed(0))
    assert {"x2y.cycle_gen", "y2x.cycle_gen"} <= set(state.opt_states)
    metrics = _run(trainer, state, 16)
    assert "cycle_loss" in metrics[-1]
    assert {name: opt.count for name, opt in state.opt_states.items()} == \
        {name: 3 for name in state.opt_states}
