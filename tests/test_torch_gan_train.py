"""The port's GAN trainers against the JAX package's on the CPU (the DCL
families' in ``test_torch_gan_dcl.py``, which shares these helpers).

Five steps from the same initial weights (the JAX trainer's init, copied
through the weight bridge) on the same batches, the pools fed JAX's own
draws. The schedule decays from step 4 of 8. Tolerances: every loss to
``rtol=1e-5``; after every step every parameter to 1e-6 of the larger of
its tensor's largest magnitude and 1 (a bias starts at 0, and an Adam step
moves a parameter by about the learning rate whatever its gradient's size,
so a tensor's own magnitude is no scale for it). Measured on this CPU:
losses within 9e-7, parameters within 3.2e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypelcnn_tpu.gan.wrapper_registry import get_trainer_dict as jax_get_trainer_dict
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict
from hypelcnn_tpu_torch.gan.wrappers.base import POOL_SIZE
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CONFIG = {"patches": 3, "embedded_feat_size": 2}
BATCH, STEPS, MAX_STEPS = 8, 5, 8
FAMILIES = ["cycle_gan", "gan_x2y", "gan_y2x", "cut_x2y", "cut_y2x", "dcl_gan", "dcl_cycle_gan"]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _batches(bands, steps=STEPS, seed=1):
    """Lit x and a darker, band-scaled y, as the samplers' pairs look."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        x = rng.uniform(0.2, 1.0, (BATCH, 1, 1, bands)).astype(np.float32)
        out.append((x, (x * rng.uniform(0.3, 0.6, (1, 1, 1, bands))).astype(np.float32)))
    return out


def _pool_draws(key):
    """The (slots, swap) that JAX's ``pool_apply`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return (torch.from_numpy(np.asarray(jax.random.choice(k1, POOL_SIZE, (BATCH,),
                                                          replace=False))),
            torch.from_numpy(np.asarray(jax.random.bernoulli(k2, 0.5, (BATCH,)))))


def _draws(family, key):
    if family == "cycle_gan":
        k1, k2 = jax.random.split(key)
        return {"x2y": _pool_draws(k1), "y2x": _pool_draws(k2)}
    if family.startswith("gan_"):
        return {"pool": _pool_draws(key)}
    return None


def _assert_params_match(ours, theirs, what):
    for key, value in theirs.items():
        scale = max(1.0, float(value.abs().max()))
        err = float((ours[key] - value).abs().max())
        assert err <= 1e-6 * scale, f"{what}: {key} differs by {err}"


def five_steps_match_jax(family, bands, config):
    jax_trainer = jax_get_trainer_dict(config, bands, MAX_STEPS)[family]
    trainer = get_trainer_dict(config, bands, MAX_STEPS)[family]
    jax_state = jax_trainer.init_state(jax.random.key(0))
    state = trainer.init_state("cpu", state_dict=variables_to_state_dict(_numpy(jax_state.params)))
    for step, (x, y) in enumerate(_batches(bands)):
        key = jax.random.key(100 + step)
        jax_state, jax_metrics = jax_trainer.train_step(jax_state, jnp.asarray(x), jnp.asarray(y),
                                                        key)
        metrics = trainer.train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                                     draws=_draws(family, key))
        assert sorted(metrics) == sorted(jax_metrics)
        for name, value in jax_metrics.items():
            assert float(metrics[name]) == pytest.approx(float(value), rel=1e-5), (step, name)
        _assert_params_match(state.nets.state_dict(), variables_to_state_dict(
            _numpy(jax_state.params)), f"{family} step {step + 1}")
    assert state.step == int(jax_state.step) == STEPS


# the DCL cases are in their own file, so that the two files' JAX compiles
# run on different test workers
@pytest.mark.parametrize("family, bands", [
    *[(family, 16) for family in FAMILIES if not family.startswith("dcl_")],
    ("cycle_gan", 24),
], ids=[*[f"{family}-16" for family in FAMILIES if not family.startswith("dcl_")],
        "cycle_gan-24"])
def test_five_steps_match_jax(family, bands):
    five_steps_match_jax(family, bands, CONFIG)


def _run(trainer, state, bands, steps=3):
    return [{k: v.clone() for k, v in trainer.train_step(
        state, torch.from_numpy(x), torch.from_numpy(y)).items()}
        for x, y in _batches(bands, steps)]


@pytest.mark.parametrize("family", FAMILIES)
def test_translate_folds_cells_into_the_batch(family):
    """Every family translates pixels and k x k windows, cell by cell."""
    trainer = get_trainer_dict(CONFIG, 16, MAX_STEPS)[family]
    state = trainer.init_state("cpu", torch.Generator().manual_seed(0))
    _run(trainer, state, 16, steps=2)
    patch = torch.from_numpy(np.random.default_rng(5).uniform(size=(2, 3, 3, 16))
                             .astype(np.float32))
    for is_shadow in (True, False):
        out = trainer.translate(state.nets, patch, is_shadow)
        assert out.shape == patch.shape and bool(torch.isfinite(out).all())
        pixels = trainer.translate(state.nets, patch.reshape(-1, 1, 1, 16), is_shadow)
        torch.testing.assert_close(out.reshape(-1, 1, 1, 16), pixels, rtol=0, atol=0)


def test_translate_scene_equals_translate_across_blocks():
    """Blocks of 16 pixels over 77 (a zero-padded tail), bit for bit the
    direct translation."""
    trainer = get_trainer_dict(CONFIG, 16, MAX_STEPS)["cycle_gan"]
    state = trainer.init_state("cpu", torch.Generator().manual_seed(0))
    _run(trainer, state, 16, steps=2)
    scene = np.random.default_rng(3).uniform(size=(7, 11, 16)).astype(np.float32)
    swept = trainer.translate_scene(state.nets, scene, True, block=16)
    direct = trainer.translate(state.nets, torch.from_numpy(scene.reshape(-1, 1, 1, 16)), True)
    np.testing.assert_array_equal(swept, direct.numpy().reshape(7, 11, 16))


def test_full_state_round_trips(tmp_path):
    """The whole state (networks, every optimizer's count and moments, the
    pools, the step) saves and restores exactly."""
    from hypelcnn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    trainer = get_trainer_dict(CONFIG, 16, MAX_STEPS)["cycle_gan"]
    state = trainer.init_state("cpu", torch.Generator().manual_seed(0))
    _run(trainer, state, 16, steps=3)
    save_checkpoint(str(tmp_path), state.checkpoint_tree())
    fresh = trainer.init_state("cpu", torch.Generator().manual_seed(1))
    fresh.restore(restore_checkpoint(str(tmp_path)))
    saved, restored = state.checkpoint(), fresh.checkpoint()
    assert restored["step"] == saved["step"] == 3
    assert all(torch.equal(restored["state_dict"][k], v) for k, v in saved["state_dict"].items())
    for name, opt in saved["opt_states"].items():
        assert restored["opt_states"][name]["count"] == opt["count"] == 3
        for a, b in zip(restored["opt_states"][name]["m"] + restored["opt_states"][name]["v"],
                        opt["m"] + opt["v"]):
            assert torch.equal(a, b)
    for name, pool in saved["pools"].items():
        assert restored["pools"][name]["count"] == pool["count"] == 24
        assert torch.equal(restored["pools"][name]["buffer"], pool["buffer"])
    other = get_trainer_dict(CONFIG, 16, MAX_STEPS)["gan_x2y"].init_state("cpu")
    with pytest.raises(ValueError, match="not this trainer's"):
        other.restore({**saved, "state_dict": other.checkpoint()["state_dict"]})


def test_init_state_and_restore_nets_need_a_device(tmp_path):
    """Neither entry point picks a device for a caller that names none: the
    CPU is never a silent default."""
    trainer = get_trainer_dict(CONFIG, 16, MAX_STEPS)["cycle_gan"]
    with pytest.raises(TypeError, match="device"):
        trainer.init_state()
    with pytest.raises(TypeError, match="device"):
        trainer.init_state(generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="device"):
        trainer.restore_nets(str(tmp_path))
