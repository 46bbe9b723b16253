"""The PyTorch port's GAN trainers data-parallel on two gloo ranks on the CPU.

All seven registry families, two ranks against one, and cycle_gan against
the JAX package's trainer on a two-device mesh (two of the session's eight
virtual CPU devices), from the JAX init through the weight bridge, the pools
fed JAX's own draws. Five steps of batch 16: the pools (50 slots) fill in
the first four and swap in the fifth, over the global batch. The schedule
decays from step 4 of 8.

Tolerances: every reported loss ``rtol=1e-4``, as the JAX package holds its
mesh against one device (``tests/test_parallel.py``); measured: two ranks
against one within 8.7e-7, against JAX within 1.1e-7. Both ranks report the
same losses and hold the same networks bit for bit, and ``translate`` gives
the same pixels with and without the mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hypelcnn_tpu.gan.wrapper_registry import get_trainer_dict as jax_get_trainer_dict
from hypelcnn_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.gan.wrappers.base import POOL_SIZE
from hypelcnn_tpu_torch.parallel.mesh import create_mesh
from torch_mp_worker import run_gan
from torch_parity import numpy_tree
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CONFIG = {"patches": 3, "embedded_feat_size": 2}
BANDS, BATCH, STEPS, MAX_STEPS = 12, 16, 5, 8
FAMILIES = ["cycle_gan", "gan_x2y", "gan_y2x", "cut_x2y", "cut_y2x", "dcl_gan", "dcl_cycle_gan"]


def _task(name, family, batches, **extra):
    return {"kind": "gan", "name": name, "family": family, "bands": BANDS, "config": CONFIG,
            "max_steps": MAX_STEPS, "steps": STEPS, "batches": batches, **extra}


def _pool_draws(key):
    """The (slots, swap) that JAX's ``pool_apply`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return (torch.from_numpy(np.asarray(jax.random.choice(k1, POOL_SIZE, (BATCH,),
                                                          replace=False))),
            torch.from_numpy(np.asarray(jax.random.bernoulli(k2, 0.5, (BATCH,)))))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    work = tmp_path_factory.mktemp("gan_ranks")
    rng = np.random.default_rng(1)
    batches = {}
    for step in range(STEPS):
        x = rng.uniform(0.2, 1.0, (BATCH, 1, 1, BANDS)).astype(np.float32)
        batches[f"x{step}"] = x
        batches[f"y{step}"] = (x * rng.uniform(0.3, 0.6, (1, 1, 1, BANDS))).astype(np.float32)
    np.savez(work / "batches.npz", **batches)
    return work, str(work / "batches.npz"), batches


@pytest.fixture(scope="module")
def jax_cycle_gan(inputs):
    """cycle_gan on JAX's two-device mesh: its init, draws and losses."""
    work, _, batches = inputs
    mesh = JaxMesh(np.array(jax.devices()[:2]).reshape(2, 1), (DATA_AXIS, MODEL_AXIS))
    trainer = jax_get_trainer_dict(CONFIG, BANDS, MAX_STEPS, mesh=mesh)["cycle_gan"]
    state = trainer.init_state(jax.random.key(0))
    torch.save(variables_to_state_dict(numpy_tree(state.params)), work / "init.pt")
    draws, losses = [], []
    for step in range(STEPS):
        key = jax.random.key(100 + step)
        k1, k2 = jax.random.split(key)
        draws.append({"x2y": _pool_draws(k1), "y2x": _pool_draws(k2)})
        state, metrics = trainer.train_step(state, jnp.asarray(batches[f"x{step}"]),
                                            jnp.asarray(batches[f"y{step}"]), key)
        losses.append({k: float(v) for k, v in metrics.items()})
    torch.save(draws, work / "draws.pt")
    return str(work / "init.pt"), str(work / "draws.pt"), losses


@pytest.fixture(scope="module")
def ranks(inputs, jax_cycle_gan):
    work, batches, _ = inputs
    tasks = [_task(family, family, batches) for family in FAMILIES]
    tasks.append(_task("cycle_gan_from_jax", "cycle_gan", batches,
                       state_dict=jax_cycle_gan[0], draws=jax_cycle_gan[1]))
    return run_ranks(tasks, work / "out")


def _assert_losses(ours, theirs):
    assert [sorted(m) for m in ours] == [sorted(m) for m in theirs]
    for step, (mine, other) in enumerate(zip(ours, theirs)):
        for name, value in other.items():
            assert mine[name] == pytest.approx(value, rel=1e-4), (step, name)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_ranks_train_as_one(ranks, inputs, family):
    one = run_gan(_task(family, family, inputs[1]), create_mesh())
    first, second = (r[family] for r in ranks)
    assert first["metrics"] == second["metrics"]
    for key, value in first["state"].items():
        assert torch.equal(second["state"][key], value), key
    assert all(np.isfinite(v) for m in first["metrics"] for v in m.values())
    _assert_losses(first["metrics"], one["metrics"])
    assert first["translate_same"] and second["translate_same"]


def test_cycle_gan_matches_jax_two_device_mesh(ranks, jax_cycle_gan):
    _assert_losses(ranks[0]["cycle_gan_from_jax"]["metrics"], jax_cycle_gan[2])
