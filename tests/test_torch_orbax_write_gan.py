"""The port writes the JAX package's GAN checkpoints, on the CPU (the
formats' writers and the classifier's states in ``test_torch_orbax_write.py``).

- Each of the seven families' ``GANState`` after two steps of the port
  (networks, every ``gan_adam``'s count and moments, the pools) has the
  ``_METADATA`` tree the JAX package writes for its own state, and the JAX
  package's ``restore_checkpoint`` with its trainer's template returns it
  bit for bit; so ``restore_params_pytree`` returns the port's params
  snapshots (``ckpt_params_N``, ``gan_params``).
- The JAX GAN train CLI resumes the port GAN CLI's log dir; the JAX GAN
  inference CLIs read its ``gan_params`` and ``ckpt_params_N``, the image
  CLI's TIFF within one count of the port's (float32 translations truncated
  to uint16, as ``test_torch_gan_apps.py``); at the loader's declared path
  the port's ``gan_params`` is the JAX package's shadow augmenter, which
  translates as the port's (``rtol=1e-5, atol=1e-6``).
- A snapshot the port wrote before it wrote orbax (``params.pt``, made here
  with ``torch.save``) still reads, and the GAN inference CLI takes it.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypelcnn_tpu.apps import gan_infer_for_shadow as jax_gan_infer_app
from hypelcnn_tpu.apps import gan_infer_image_for_shadow as jax_gan_image_app
from hypelcnn_tpu.apps import gan_train_for_shadow as jax_gan_app
from hypelcnn_tpu.data.loaders.synthetic import SyntheticDataLoader as JaxSyntheticDataLoader
from hypelcnn_tpu.gan import shadow_ops as jax_shadow_ops
from hypelcnn_tpu.gan.wrapper_registry import get_trainer_dict as jax_get_trainer_dict
from hypelcnn_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from hypelcnn_tpu.train.checkpoint import restore_params_pytree as jax_restore_params
from hypelcnn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from hypelcnn_tpu.train.checkpoint import save_params_pytree as jax_save_params
from hypelcnn_tpu_torch.apps import (
    gan_infer_for_shadow,
    gan_infer_image_for_shadow,
    gan_train_for_shadow,
)
from hypelcnn_tpu_torch.compat import orbax
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.gan import shadow_ops
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict
from hypelcnn_tpu_torch.train.checkpoint import (
    checkpoint_steps,
    holds_orbax_step,
    restore_params,
    save_checkpoint,
    save_params,
)
from hypelcnn_tpu_torch.utils.tiff_io import imread
from test_torch_gan_train import CONFIG as GAN_CONFIG
from test_torch_gan_train import FAMILIES as GAN_FAMILIES
from test_torch_gan_train import MAX_STEPS as GAN_MAX_STEPS
from test_torch_gan_train import _run
from test_torch_orbax import SPEC, _assert_tree_equals_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytest.importorskip("tensorstore")

BANDS = 16
# a batch the tests' 8 JAX devices do not divide: the JAX GAN CLI then trains on
# one device. Data-parallel, it cannot resume any log dir, its own included (the
# restored state is committed to one device, the step's constraints to 8).
GAN_TRAIN = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--batch_size=6",
             "--validation_steps=2", "--validation_sample_count=20"]


def _tree_metadata(item):
    return list(json.loads((item / "_METADATA").read_text())["tree_metadata"].items())


@pytest.mark.parametrize("family", GAN_FAMILIES)
def test_the_port_writes_each_jax_gan_state_and_snapshot(family, tmp_path):
    trainer = get_trainer_dict(GAN_CONFIG, BANDS, GAN_MAX_STEPS)[family]
    state = trainer.init_state("cpu", torch.Generator().manual_seed(3))
    _run(trainer, state, BANDS, steps=2)
    save_checkpoint(str(tmp_path / "port"), state.checkpoint_tree())
    save_params(str(tmp_path / "port" / "gan_params"), state.nets.state_dict())

    jax_trainer = jax_get_trainer_dict(GAN_CONFIG, BANDS, GAN_MAX_STEPS)[family]
    template = jax_trainer.init_state(jax.random.key(0))
    jax_save_checkpoint(str(tmp_path / "jax"), template.replace(step=jnp.asarray(2, jnp.int32)))
    jax_save_params(str(tmp_path / "jax" / "gan_params"), jax.device_get(template.params))
    ours, theirs = (tmp_path / side / "checkpoints" / "2" for side in ("port", "jax"))
    assert _tree_metadata(ours / "default") == _tree_metadata(theirs / "default")
    assert _tree_metadata(tmp_path / "port" / "gan_params") == \
        _tree_metadata(tmp_path / "jax" / "gan_params")

    restored = jax_restore_checkpoint(str(tmp_path / "port"), template)
    assert int(restored.step) == 2
    tree = orbax.read_orbax(str(ours))
    _assert_tree_equals_jax(tree, restored)
    saved = state.checkpoint()
    for name, opt in saved["opt_states"].items():  # each optimizer where JAX nests it
        node = tree["opt_states"]
        for part in name.split("."):
            node = node[part]
        assert int(node["count"]) == opt["count"] == 2
    for name, pool in saved["pools"].items():
        node = tree["pool"] if name == "pool" else tree["pool"][name]
        assert np.array_equal(node["buffer"], pool["buffer"].numpy())
        assert int(node["count"]) == pool["count"]
    params = jax_restore_params(str(tmp_path / "port" / "gan_params"), template.params)
    _assert_tree_equals_jax(orbax.read_orbax(str(tmp_path / "port" / "gan_params")), params)
    _assert_tree_equals_jax(tree["params"], params)


@pytest.fixture(scope="module")
def port_gan_run(tmp_path_factory):
    """The port GAN CLI's cycle_gan log dir at step 4 (made once)."""
    root = tmp_path_factory.mktemp("port_gan")
    gan_train_for_shadow.main(GAN_TRAIN + ["--device=cpu", "--step=4",
                                           f"--base_log_path={root / 'run'}"])
    (log_dir,) = [p for p in root.iterdir() if p.name.startswith("run_")]
    return log_dir


def test_the_jax_gan_train_cli_resumes_a_port_log_dir(port_gan_run, tmp_path, capsys):
    shutil.copytree(port_gan_run.parent, tmp_path / "logs")
    log_dir = tmp_path / "logs" / port_gan_run.name
    assert checkpoint_steps(str(log_dir)) == [2, 4] and not list(log_dir.rglob("*.pt"))
    capsys.readouterr()
    jax_gan_app.main(GAN_TRAIN + ["--step=6", f"--base_log_path={tmp_path / 'logs' / 'run'}"])
    out = capsys.readouterr().out
    assert "step 6:" in out and "step 2:" not in out and "step 4:" not in out
    assert checkpoint_steps(str(log_dir)) == [2, 4, 6]
    assert all(holds_orbax_step(str(log_dir), s) for s in (2, 4, 6))


def test_the_jax_gan_inference_clis_read_port_snapshots(port_gan_run, tmp_path):
    for snapshot in ("gan_params", "ckpt_params_4"):
        (tmp_path / snapshot).mkdir()
        jax_gan_infer_app.main([
            "--loader_name=SyntheticDataLoader", f"--path={SPEC}",
            f"--base_log_path={port_gan_run / snapshot}", f"--output_path={tmp_path / snapshot}",
            "--number_of_samples=50"])
        assert (tmp_path / snapshot / "best_ratio_shadowed.json").is_file()
    common = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--make_them_shadow=shadow",
              f"--base_log_path={port_gan_run / 'gan_params'}"]
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    jax_gan_image_app.main(common + [f"--output_path={tmp_path / 'jax'}"])
    path = gan_infer_image_for_shadow.main(common + ["--device=cpu",
                                                     f"--output_path={tmp_path / 'port'}"])
    ours, theirs = imread(path), imread(str(tmp_path / "jax" / os.path.basename(path)))
    assert ours.shape == theirs.shape == (48, 64, 12)
    assert int(np.abs(ours.astype(np.int32) - theirs).max()) <= 1


def test_a_port_gan_params_at_the_declared_path_is_the_jax_augmenter(port_gan_run, tmp_path):
    shutil.copytree(port_gan_run / "gan_params", tmp_path / "shadow_gen_model" / "cycle_gan")
    spec = SPEC + f"&base={tmp_path}"
    jax_loader = JaxSyntheticDataLoader(spec)
    theirs = jax_shadow_ops.build_shadow_creators(jax_loader, jax_loader.load_data(1, True), 1)
    loader = SyntheticDataLoader(spec)
    ours = shadow_ops.build_shadow_creators(loader, loader.load_data(1, True), 1, "cpu")
    assert sorted(theirs) == sorted(ours) == ["cycle_gan", "simple"]
    x = np.random.default_rng(4).uniform(0.05, 1.0, (16, 3, 3, 13)).astype(np.float32)
    for name in ("shadow_fn", "deshadow_fn"):
        expected = np.asarray(jax.vmap(getattr(theirs["cycle_gan"], name))(jnp.asarray(x)))
        got = getattr(ours["cycle_gan"], name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


def test_a_params_pt_snapshot_still_reads(tmp_path):
    """The layout the port wrote before orbax: ``<snapshot>/params.pt``
    holding the networks' ``state_dict``, written here with ``torch.save``."""
    trainer = get_trainer_dict({}, 12, max_steps=1)["cycle_gan"]
    nets = trainer.init_state("cpu", torch.Generator().manual_seed(1)).nets
    (tmp_path / "gan_params").mkdir()
    torch.save(nets.state_dict(), tmp_path / "gan_params" / "params.pt")
    assert not orbax.is_orbax_checkpoint(str(tmp_path / "gan_params"))
    restored = restore_params(str(tmp_path / "gan_params"))
    assert all(torch.equal(restored[k], v) for k, v in nets.state_dict().items())
    (tmp_path / "out").mkdir()
    validator = gan_infer_for_shadow.main([
        "--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu",
        f"--base_log_path={tmp_path / 'gan_params'}", f"--output_path={tmp_path / 'out'}",
        "--number_of_samples=50"])
    assert len(validator.get_best_mean_div() + validator.get_best_upper_div()) == 4
    # the port's orbax snapshot replaces it, as the JAX package's force=True does
    save_params(str(tmp_path / "gan_params"), nets.state_dict())
    assert orbax.is_orbax_checkpoint(str(tmp_path / "gan_params"))
    assert not (tmp_path / "gan_params" / "params.pt").exists()
