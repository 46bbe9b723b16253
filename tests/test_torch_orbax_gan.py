"""The port reads the JAX package's GAN checkpoints, on the CPU (the
formats' readers and the classifier's states in ``test_torch_orbax.py``).

- ``compat/orbax.py`` equals the JAX package's ``restore_params_pytree`` bit
  for bit for each GAN family's params snapshot, and the port's networks load it.
- The seven families' JAX ``GANState`` (networks, every ``gan_adam``'s
  count and moments, the pools) restores into the port's exactly; a third
  step taken by both then agrees as in ``test_torch_gan_train.py`` (losses to
  ``rtol=1e-5``, parameters to 1e-6 of their scale), so every moment landed
  on its parameter.
- The GAN train CLI resumes the JAX GAN CLI's log dir and prunes both kinds
  of step together; the two GAN inference CLIs read its ``gan_params`` and
  ``ckpt_params_N``.
- A JAX ``gan_params`` at the loader's declared path is the shadow
  augmenter the JAX package builds (``rtol=1e-5, atol=1e-6``); one the port
  cannot read (zarr v3) is raised, not reported and left out.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypelcnn_tpu.apps import gan_train_for_shadow as jax_gan_app
from hypelcnn_tpu.gan import shadow_ops as jax_shadow_ops
from hypelcnn_tpu.gan.wrapper_registry import get_trainer_dict as jax_get_trainer_dict
from hypelcnn_tpu.train.checkpoint import restore_params_pytree as jax_restore_params
from hypelcnn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from hypelcnn_tpu.train.checkpoint import save_params_pytree as jax_save_params
from hypelcnn_tpu_torch.apps import (
    gan_infer_for_shadow,
    gan_infer_image_for_shadow,
    gan_train_for_shadow,
)
from hypelcnn_tpu_torch.compat import FormatNotRead, orbax
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.gan import shadow_ops
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict
from hypelcnn_tpu_torch.train.checkpoint import (
    checkpoint_steps,
    holds_orbax_step,
    restore_checkpoint,
    restore_params,
)
from hypelcnn_tpu_torch.utils.tiff_io import imread
from test_torch_gan_train import CONFIG as GAN_CONFIG
from test_torch_gan_train import FAMILIES as GAN_FAMILIES
from test_torch_gan_train import MAX_STEPS as GAN_MAX_STEPS
from test_torch_gan_train import _assert_params_match, _batches, _draws
from test_torch_orbax import SPEC, _assert_tree_equals_jax
from torch_parity import numpy_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytest.importorskip("tensorstore")


@pytest.mark.parametrize("family", GAN_FAMILIES)
def test_orbax_equals_jax_restore_of_each_gan_snapshot(family, tmp_path):
    trainer = jax_get_trainer_dict(GAN_CONFIG, 16, GAN_MAX_STEPS)[family]
    params = trainer.init_state(jax.random.key(3)).params
    jax_save_params(str(tmp_path / "gan_params"), params)
    tree = orbax.read_orbax(str(tmp_path / "gan_params"))
    _assert_tree_equals_jax(tree, jax_restore_params(str(tmp_path / "gan_params"), params))
    nets = get_trainer_dict(GAN_CONFIG, 16, GAN_MAX_STEPS)[family].build_nets()
    nets.load_state_dict(restore_params(str(tmp_path / "gan_params")), strict=True)



# ------------------------------------------------------------- GAN states ----

@pytest.mark.parametrize("family", GAN_FAMILIES)
def test_each_jax_gan_state_restores_into_the_port(family, tmp_path):
    """JAX's state after 2 steps restores exactly (networks, counts, pools);
    a third step of each then agrees as in ``test_torch_gan_train.py``, so
    the moments landed on their parameters."""
    jax_trainer = jax_get_trainer_dict(GAN_CONFIG, 16, GAN_MAX_STEPS)[family]
    trainer = get_trainer_dict(GAN_CONFIG, 16, GAN_MAX_STEPS)[family]
    batches = _batches(16, steps=3)
    jax_state = jax_trainer.init_state(jax.random.key(0))
    for step, (x, y) in enumerate(batches[:2]):
        jax_state, _ = jax_trainer.train_step(jax_state, jnp.asarray(x), jnp.asarray(y),
                                              jax.random.key(100 + step))
    jax_save_checkpoint(str(tmp_path), jax_state)
    state = trainer.init_state("cpu", torch.Generator().manual_seed(5))
    state.restore(restore_checkpoint(str(tmp_path)))
    assert state.step == 2
    for key, value in variables_to_state_dict(numpy_tree(jax_state.params)).items():
        assert torch.equal(state.nets.state_dict()[key], value), key
    assert {name: opt.count for name, opt in state.opt_states.items()} == \
        {name: 2 for name in trainer.optimizers}
    jax_pools = numpy_tree(jax_state.pool)
    jax_pools = {"pool": jax_pools} if set(state.pools) == {"pool"} else jax_pools or {}
    assert sorted(state.pools) == sorted(jax_pools)
    for name, pool in state.pools.items():
        np.testing.assert_array_equal(pool.buffer.numpy(), jax_pools[name].buffer)
        assert pool.count == int(jax_pools[name].count)
    x, y = batches[2]
    key = jax.random.key(102)
    jax_state, jax_metrics = jax_trainer.train_step(jax_state, jnp.asarray(x), jnp.asarray(y),
                                                    key)
    metrics = trainer.train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                                 draws=_draws(family, key))
    for name, value in jax_metrics.items():
        assert float(metrics[name]) == pytest.approx(float(value), rel=1e-5), name
    _assert_params_match(state.nets.state_dict(),
                         variables_to_state_dict(numpy_tree(jax_state.params)), family)


GAN_SPEC = SPEC
GAN_TRAIN = ["--loader_name=SyntheticDataLoader", f"--path={GAN_SPEC}", "--batch_size=8",
             "--validation_steps=2", "--validation_sample_count=20"]


def test_the_gan_train_cli_resumes_a_jax_log_dir(tmp_path, capsys):
    jax_gan_app.main(GAN_TRAIN + ["--step=4", f"--base_log_path={tmp_path / 'run'}"])
    (log_dir,) = [p for p in tmp_path.iterdir() if p.name.startswith("run_")]
    assert checkpoint_steps(str(log_dir)) == [2, 4]
    capsys.readouterr()
    gan_train_for_shadow.main(GAN_TRAIN + ["--device=cpu", "--step=6",
                                           f"--base_log_path={tmp_path / 'run'}"])
    out = capsys.readouterr().out
    assert "Resuming GAN training from checkpoint at step 4" in out and "step 6:" in out
    assert "step 2:" not in out and "step 4:" not in out
    assert checkpoint_steps(str(log_dir)) == [2, 4, 6]
    assert [holds_orbax_step(str(log_dir), s) for s in (2, 4, 6)] == [True, True, True]
    assert restore_checkpoint(str(log_dir))["step"] == 6
    # gan_params now holds the port's snapshot (orbax, step 6's networks) in place of JAX's
    assert orbax.is_orbax_checkpoint(str(log_dir / "gan_params"))
    assert not list(log_dir.rglob("*.pt"))
    final = restore_params(str(log_dir / "gan_params"))
    assert all(torch.equal(final[k], v) for k, v in
               restore_checkpoint(str(log_dir))["state_dict"].items())
    assert orbax.is_orbax_checkpoint(str(log_dir / "ckpt_params_4"))
    restore_params(str(log_dir / "ckpt_params_4"))


def test_the_gan_inference_clis_read_jax_snapshots(tmp_path):
    jax_gan_app.main(GAN_TRAIN + ["--step=2", f"--base_log_path={tmp_path / 'run'}"])
    (log_dir,) = [p for p in tmp_path.iterdir() if p.name.startswith("run_")]
    for snapshot in ("gan_params", "ckpt_params_2"):
        assert orbax.is_orbax_checkpoint(str(log_dir / snapshot))
        (tmp_path / snapshot).mkdir()
        validator = gan_infer_for_shadow.main([
            "--loader_name=SyntheticDataLoader", f"--path={GAN_SPEC}", "--device=cpu",
            f"--base_log_path={log_dir / snapshot}", f"--output_path={tmp_path / snapshot}",
            "--number_of_samples=50"])
        assert len(validator.get_best_mean_div() + validator.get_best_upper_div()) == 4
    path = gan_infer_image_for_shadow.main([
        "--loader_name=SyntheticDataLoader", f"--path={GAN_SPEC}", "--device=cpu",
        "--make_them_shadow=shadow", f"--base_log_path={log_dir / 'gan_params'}",
        f"--output_path={tmp_path}"])
    assert imread(path).shape == (48, 64, 12)


@pytest.fixture(scope="module")
def jax_gan_params(tmp_path_factory):
    """A JAX cycle_gan ``gan_params`` (random weights, std 0.05) where the
    synthetic loader declares it."""
    trainer = jax_get_trainer_dict({}, 12, max_steps=1)["cycle_gan"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.05, np.shape(a)).astype(np.float32),
        jax.device_get(trainer.init_state(jax.random.key(0)).params))
    base = tmp_path_factory.mktemp("models")
    jax_save_params(str(base / "shadow_gen_model" / "cycle_gan"), params)
    return trainer, params, base


def test_a_jax_gan_params_at_the_declared_path_is_the_jax_augmenter(jax_gan_params):
    trainer, params, base = jax_gan_params
    loader = SyntheticDataLoader(SPEC + f"&base={base}")
    creators = shadow_ops.build_shadow_creators(loader, loader.load_data(1, True), 1, "cpu")
    assert sorted(creators) == ["cycle_gan", "simple"]
    x = np.random.default_rng(4).uniform(0.05, 1.0, (16, 3, 3, 13)).astype(np.float32)
    theirs = jax_shadow_ops.create_gan_shadow_struct(trainer, params, 12)
    for name in ("shadow_fn", "deshadow_fn"):
        expected = np.asarray(jax.vmap(getattr(theirs, name))(jnp.asarray(x)))
        got = getattr(creators["cycle_gan"], name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


def test_a_declared_generator_the_port_cannot_read_is_raised(jax_gan_params, tmp_path):
    _, _, base = jax_gan_params
    shutil.copytree(base, tmp_path / "models")
    metadata = tmp_path / "models" / "shadow_gen_model" / "cycle_gan" / "_METADATA"
    metadata.write_text(json.dumps({**json.loads(metadata.read_text()), "use_zarr3": True}))
    loader = SyntheticDataLoader(SPEC + f"&base={tmp_path / 'models'}")
    with pytest.raises(FormatNotRead, match="zarr v3"):
        shadow_ops.build_shadow_creators(loader, loader.load_data(1, True), 1, "cpu")
