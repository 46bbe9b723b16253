"""The port's three GAN CLIs on the CPU: training (files, cadence, resume
after a kill equal to an uninterrupted run), validation, and whole-scene
translation against the JAX package's CLI on the same weights."""

import json
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from hypelcnn_tpu.apps import gan_infer_image_for_shadow as jax_image_app
from hypelcnn_tpu.apps.gan_train_for_shadow import get_log_suffix as jax_get_log_suffix
from hypelcnn_tpu.gan.wrapper_registry import get_trainer_dict as jax_get_trainer_dict
from hypelcnn_tpu.train.checkpoint import save_params_pytree
from hypelcnn_tpu_torch.apps import (
    gan_infer_for_shadow,
    gan_infer_image_for_shadow,
    gan_train_for_shadow,
)
from hypelcnn_tpu_torch.compat.flax_to_torch import ORBAX_TREE, variables_to_state_dict
from hypelcnn_tpu_torch.compat.orbax import is_orbax_checkpoint
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.train.checkpoint import (
    checkpoint_steps,
    holds_orbax_step,
    restore_checkpoint,
    restore_params,
    save_params,
)
from hypelcnn_tpu_torch.utils.tiff_io import imread
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
TRAIN = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu",
         "--batch_size=8", "--validation_steps=2", "--validation_sample_count=20"]


def _train(base, *extra):
    return gan_train_for_shadow.main(TRAIN + [f"--base_log_path={base}", *extra])


def _log_dir(base):
    (log_dir,) = [p for p in base.parent.iterdir() if p.name.startswith(base.name + "_")]
    return log_dir


def test_train_cli_writes_the_jax_files_at_its_cadence(tmp_path):
    divergences = _train(tmp_path / "run", "--step=4")
    log_dir = _log_dir(tmp_path / "run")
    flags = SimpleNamespace(loader_name="SyntheticDataLoader", gan_type="cycle_gan", neighborhood=0,
                            regularization_support_rate=0.0, batch_size=8, use_identity_loss=True)
    assert log_dir.name == f"run_{jax_get_log_suffix(flags)}" == \
        f"run_{gan_train_for_shadow.get_log_suffix(flags)}"
    assert len(divergences) == 2 and all(math.isfinite(d) for d in divergences)
    for name in ("best_ratio_shadowed.json", "best_ratio_deshadowed.json"):
        points = json.loads((log_dir / name).read_text())
        assert sorted(p[0] for p in points) == [2, 4]
    for name in ("ckpt_params_2", "ckpt_params_4", "gan_params"):
        assert is_orbax_checkpoint(str(log_dir / name))
    assert not list(log_dir.rglob("*.pt"))
    assert checkpoint_steps(str(log_dir)) == [2, 4]  # keep = step // validation_steps
    assert holds_orbax_step(str(log_dir), 2) and holds_orbax_step(str(log_dir), 4)
    final = restore_params(str(log_dir / "gan_params"))
    assert all(torch.equal(final[k], v) for k, v in
               restore_params(str(log_dir / "ckpt_params_4")).items())
    assert "gen_x2y.net1.weight" in final and "disc_y2x.fc3.bias" in final


class _Killed(Exception):
    pass


def _assert_same_tree(a, b, path=()):
    """Two trees ``read_orbax`` gave hold the same arrays, bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            _assert_same_tree(a[key], b[key], path + (key,))
    else:
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


def test_killed_and_resumed_run_equals_an_uninterrupted_one(tmp_path, monkeypatch, capsys):
    """A cycle_gan run stopped right after its first full-state checkpoint,
    then run again into the same log dir, ends bit for bit where an
    uninterrupted run ends: networks, both optimizers, both pools (full from
    step 2 on, so their draws are held too), and the regularization-support
    draws."""
    args = ["--step=6", "--regularization_support_rate=0.3"]
    _train(tmp_path / "straight", *args)

    save = gan_train_for_shadow.save_checkpoint

    def save_then_die(*a, **kw):
        save(*a, **kw)
        raise _Killed()

    monkeypatch.setattr(gan_train_for_shadow, "save_checkpoint", save_then_die)
    with pytest.raises(_Killed):
        _train(tmp_path / "killed", *args)
    monkeypatch.setattr(gan_train_for_shadow, "save_checkpoint", save)
    capsys.readouterr()
    _train(tmp_path / "killed", *args)
    assert "Resuming GAN training from checkpoint at step 2" in capsys.readouterr().out

    straight, resumed = _log_dir(tmp_path / "straight"), _log_dir(tmp_path / "killed")
    assert checkpoint_steps(str(straight)) == checkpoint_steps(str(resumed)) == [2, 4, 6]
    a, b = restore_checkpoint(str(straight)), restore_checkpoint(str(resumed))
    assert a["step"] == b["step"] == 6
    assert all(torch.equal(b["state_dict"][k], v) for k, v in a["state_dict"].items())
    # the whole saved GANState: networks, both optimizers' counts and moments, both pools
    a, b = a[ORBAX_TREE], b[ORBAX_TREE]
    assert sorted(a["opt_states"]) == ["discriminators", "generators"]
    assert sorted(a["pool"]) == ["x2y", "y2x"]
    for opt in a["opt_states"].values():
        assert int(opt["count"]) == 6
    _assert_same_tree(a, b)
    final_a, final_b = (restore_params(str(d / "gan_params")) for d in (straight, resumed))
    assert all(torch.equal(final_b[k], v) for k, v in final_a.items())


def test_opt_search_is_not_ported_and_a_flag_file_is_merged(tmp_path, monkeypatch):
    """The search mode (ported since this test's name was given): one trial
    of a space over ``gan_type`` runs in the working directory's study; and a
    flag file's keys are laid over the flags."""
    monkeypatch.chdir(tmp_path)
    space = tmp_path / "x.json"
    space.write_text(json.dumps({"gan_type": ["gan_x2y"], "identity_loss_weight":
                                 {"min": 0.1, "max": 2.0}}))
    study = _train(tmp_path / "opt", "--step=2", f"--flag_config_file_opt={space}",
                   "--opt_trial_count=1", "--opt_run_count=1")
    (trial,) = study.trials
    assert trial["params"]["gan_type"] == "gan_x2y" and math.isfinite(trial["value"])
    assert 0.1 <= trial["params"]["identity_loss_weight"] <= 2.0
    assert (tmp_path / "gan_shadow_opt.db").is_file()
    (opt_dir,) = [p for p in tmp_path.iterdir() if p.name.startswith("opt_")]
    assert "gan_x2y" in opt_dir.name and checkpoint_steps(str(opt_dir)) == [2]
    flag_file = tmp_path / "flags.json"
    flag_file.write_text(json.dumps({"gan_type": "gan_x2y", "step": 2}))
    _train(tmp_path / "merged", f"--flag_config_file={flag_file}")
    log_dir = _log_dir(tmp_path / "merged")
    assert "gan_x2y" in log_dir.name and checkpoint_steps(str(log_dir)) == [2]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Random cycle_gan weights (std 0.05, so the generators translate),
    saved as the JAX package's orbax snapshot and as the port's."""
    root = tmp_path_factory.mktemp("weights")
    trainer = jax_get_trainer_dict({}, 12, max_steps=1)["cycle_gan"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.05, np.shape(a)).astype(np.float32),
        jax.device_get(trainer.init_state(jax.random.key(0)).params))
    save_params_pytree(str(root / "jax" / "gan_params"), params)
    save_params(str(root / "port" / "gan_params"), variables_to_state_dict(params))
    return root


def test_infer_cli_validates_both_directions(weights, tmp_path):
    validator = gan_infer_for_shadow.main([
        "--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu",
        f"--base_log_path={weights / 'port' / 'gan_params'}", f"--output_path={tmp_path}",
        "--number_of_samples=50"])
    divergences = validator.get_best_mean_div() + validator.get_best_upper_div()
    assert len(divergences) == 4 and all(math.isfinite(d) for d in divergences)
    assert (tmp_path / "best_ratio_shadowed.json").is_file()


@pytest.mark.parametrize("mode, convert_all", [("shadow", False), ("deshadow", False),
                                               ("shadow", True), ("", False)])
def test_image_cli_matches_jax(weights, tmp_path, mode, convert_all):
    common = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}",
              f"--make_them_shadow={mode}", f"--convert_all={convert_all}"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_image_app.main(common + [f"--base_log_path={weights / 'jax' / 'gan_params'}",
                                 f"--output_path={tmp_path / 'jax'}"])
    path = gan_infer_image_for_shadow.main(common + [
        "--device=cpu", f"--base_log_path={weights / 'port' / 'gan_params'}",
        f"--output_path={tmp_path / 'port'}"])
    suffix = "_all" if convert_all else ""
    name = f"shadow_image_{mode or 'none'}_gan_params{suffix}.tif"
    assert path == str(tmp_path / "port" / name)
    ours, theirs = imread(path), imread(str(tmp_path / "jax" / name))
    assert ours.shape == theirs.shape == (48, 64, 12) and ours.dtype == theirs.dtype == np.uint16
    # float32 translations, then truncation to uint16: within one count
    assert int(np.abs(ours.astype(np.int32) - theirs).max()) <= 1
    rgb = f"shadow_image_rgb_{mode or 'none'}_gan_params_{suffix}.tif"
    assert np.abs(imread(str(tmp_path / "port" / rgb)).astype(np.int32)
                  - imread(str(tmp_path / "jax" / rgb))).max() <= 1
    if mode and not convert_all:
        # pixels outside the translated side are the untranslated output's
        untranslated = imread(gan_infer_image_for_shadow.main(common[:2] + [
            "--device=cpu", f"--base_log_path={weights / 'port' / 'gan_params'}",
            f"--output_path={tmp_path}"]))
        shadow_map, _ = SyntheticDataLoader(SPEC).load_shadow_map(0, None)
        untouched = shadow_map != (0 if mode == "shadow" else 1)
        assert np.array_equal(ours[untouched], untranslated[untouched])
        assert not np.array_equal(ours[~untouched], untranslated[~untouched])
