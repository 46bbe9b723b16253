"""The PyTorch port's training loop and CLIs against the JAX package, on the
scene spec of ``tests/conftest.py``.

- Trajectory: 5 steps from the flax init (copied through the weight bridge)
  on the same batches, dropout and augmentation off. Per-step losses agree
  to ``rtol=1e-4``: both run float32 on the CPU and sum the convolutions in
  different orders. After 5 steps the weights and batch-norm statistics
  agree to ``atol=2e-3`` (``rtol=1e-3``): Adam moves a parameter whose
  gradient is near 0 by about ``lr`` (1e-3 here) whatever the gradient's
  size, so a sign that rounding flips moves it by up to ``2 * lr`` a step in
  the other direction; the mean difference stays far below that.
- Hooks fire at the JAX trainer's steps for the same cadences.
- A resumed run equals an uninterrupted one bit for bit (dropout and
  augmentation on).
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hypelcnn_tpu.apps import infer_for_classification as jax_infer_app
from hypelcnn_tpu.apps.train_for_classification import get_log_suffix as jax_get_log_suffix
from hypelcnn_tpu.core.registry import get_importer_from_name as jax_get_importer
from hypelcnn_tpu.models.hypelcnn import HYPELCNNModel as JaxHYPELCNNModel
from hypelcnn_tpu.parallel.mesh import create_mesh
from hypelcnn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from hypelcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from hypelcnn_tpu.train.state import TrainState as JaxTrainState
from hypelcnn_tpu.train.trainer import ClassificationTrainer as JaxClassificationTrainer
from hypelcnn_tpu_torch.apps import infer_for_classification, train_for_classification
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.core.registry import get_importer_from_name
from hypelcnn_tpu_torch.data.augmentation import AugmentationInfo
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
from hypelcnn_tpu_torch.train.checkpoint import checkpoint_steps
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer
from torch_parity import init_jax, save_module, torch_module
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
CLASSES = 5
BATCH = 16
PARAMS = {**HYPELCNNModel().default_params(), "filter_count": 32, "drop_out_ratio": 0.0,
          "learning_rate": 1e-3, "batch_size": BATCH}
STEPS = 5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port_trainer(params, **kw):
    np.random.seed(0)
    data = get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    return ClassificationTrainer(
        model=HYPELCNNModel(), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_run():
    np.random.seed(0)
    data = jax_get_importer("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    trainer = JaxClassificationTrainer(
        model=JaxHYPELCNNModel(), class_count=data.class_count, algorithm_params=PARAMS,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, mesh=create_mesh(), test_cadence=2, validation_cadence=3)
    init = trainer.init_state()
    init_state_dict = variables_to_state_dict(_numpy_tree(init.params),
                                              _numpy_tree(init.batch_stats))
    losses = []
    result = trainer.fit(STEPS, BATCH, progress_callback=lambda s, l: losses.append((s, l)),
                         log_every=1)
    final = variables_to_state_dict(_numpy_tree(trainer.final_state.params),
                                    _numpy_tree(trainer.final_state.batch_stats))
    return init_state_dict, losses, result, final


@pytest.fixture(scope="module")
def port_run(jax_run):
    init_state_dict = jax_run[0]
    trainer = _port_trainer(PARAMS, test_cadence=2, validation_cadence=3)
    losses = []
    result = trainer.fit(STEPS, BATCH, progress_callback=lambda s, l: losses.append((s, l)),
                         log_every=1, state_dict=init_state_dict)
    return losses, result


def test_training_trajectory_matches_jax(jax_run, port_run):
    _, jax_losses, jax_result, jax_final = jax_run
    losses, result = port_run
    assert [s for s, _ in losses] == [s for s, _ in jax_losses] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([l for _, l in losses], [l for _, l in jax_losses], rtol=1e-4)
    assert losses[-1][1] < losses[0][1]
    final = result.final_state.module.state_dict()
    assert sorted(final) == sorted(jax_final)
    for key, theirs in jax_final.items():
        ours = final[key]
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=1e-3, atol=2e-3,
                                   err_msg=key)
        assert float((ours - theirs).abs().mean()) < 2e-4, key
    assert result.final_state.step == STEPS


def test_hooks_fire_at_the_jax_steps(jax_run, port_run):
    jax_history = jax_run[2].history
    history = port_run[1].history
    assert [(r["step"], sorted(r)) for r in history] == \
        [(r["step"], sorted(r)) for r in jax_history]
    assert [r["step"] for r in history] == [2, 3, 4]  # test at 2 and 4, validation at 3
    # the accuracies agree but for argmax near-ties between the frameworks
    for ours, theirs in zip(history, jax_history):
        for key in ("test_oa", "val_oa"):
            if key in ours:
                assert ours[key] == pytest.approx(theirs[key], abs=0.02)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    params = dict(PARAMS, drop_out_ratio=0.5)
    augmentation = AugmentationInfo(perform_rotation_augmentation=True,
                                    perform_reflection_augmentation=True,
                                    perform_spectral_augmentation=0.05)

    def run(log_dir, steps):
        losses = []
        trainer = _port_trainer(params, log_dir=str(log_dir), save_checkpoint_steps=3,
                                augmentation_info=augmentation)
        result = trainer.fit(steps, BATCH, progress_callback=lambda s, l: losses.append((s, l)),
                             log_every=1)
        return result.final_state, result.steps_run, losses

    run(tmp_path / "a", 3)
    resumed, steps_run, resumed_losses = run(tmp_path / "a", 6)
    assert steps_run == 3
    straight, _, straight_losses = run(tmp_path / "b", 6)
    assert resumed_losses == straight_losses[3:]
    assert checkpoint_steps(str(tmp_path / "a")) == checkpoint_steps(str(tmp_path / "b")) == [3, 6]
    for key, value in straight.module.state_dict().items():
        assert torch.equal(resumed.module.state_dict()[key], value), key
    ours = resumed.optimizer.state_dict()["state"]
    for index, slots in straight.optimizer.state_dict()["state"].items():
        for name, value in slots.items():
            assert torch.equal(ours[index][name], value), (index, name)


def test_logs_history_confusion_and_histograms(tmp_path, monkeypatch):
    from hypelcnn_tpu_torch.train.summaries import SummaryWriter
    histograms = []
    monkeypatch.setattr(SummaryWriter, "histogram",
                        lambda self, tag, values, step: histograms.append((tag, step)))
    trainer = _port_trainer(PARAMS, log_dir=str(tmp_path), test_cadence=2,
                            validation_cadence=3, log_model_params=True)
    trainer.fit(4, BATCH, log_every=2)
    history = [json.loads(line) for line in (tmp_path / "history.jsonl").read_text().splitlines()]
    assert [r["step"] for r in history] == [2, 3]
    confusion = np.loadtxt(tmp_path / "validation_confusion_3.csv", delimiter=",")
    assert confusion.shape == (CLASSES, CLASSES)
    assert confusion.sum() == trainer.sample_set.validation_targets.shape[0]
    summaries = [json.loads(line) for line in (tmp_path / "summaries.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["step"]) for r in summaries if r["tag"] == "loss"] == [("loss", 2),
                                                                               ("loss", 4)]
    assert {step for _, step in histograms} == {2, 4}
    assert any(tag.startswith("params/") for tag, _ in histograms)
    assert any(tag.startswith("batch_stats/") for tag, _ in histograms)


@pytest.mark.parametrize("overrides", [
    {},
    {"augment_data_with_shadow": "cycle_gan"},
    {"augment_data_with_spectral": 0.05, "train_ratio": 0.5, "neighborhood": 2},
    {"train_ratio": 50.0, "algorithm_param_path": None, "model_name": "CONCNNModel"},
    {"augment_data_with_shadow": "simple", "augmentation_random_threshold": 0.25,
     "augment_data_with_spectral": 0.125, "loader_name": "SyntheticDataLoader"},
])
def test_log_suffix_matches_jax(overrides):
    from types import SimpleNamespace
    flags = dict(loader_name="GRSS2013DataLoader", model_name="HYPELCNNModel",
                 train_ratio=0.10, algorithm_param_path="x/alg_param_hypelcnn.json",
                 neighborhood=1, augment_data_with_shadow=None,
                 augmentation_random_threshold=0.5, augment_data_with_spectral=None)
    flags = SimpleNamespace(**{**flags, **overrides})
    assert train_for_classification.get_log_suffix(flags) == jax_get_log_suffix(flags)


def _params_file(tmp_path):
    path = tmp_path / "params.json"
    path.write_text(json.dumps({"filter_count": 32}))
    return str(path)


def _tiff(path):
    with Image.open(path) as image:
        return np.asarray(image)


def test_train_cli_then_infer_cli(tmp_path):
    params = _params_file(tmp_path)
    common = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--neighborhood=1",
              f"--algorithm_param_path={params}", "--device=cpu"]
    result = train_for_classification.main(common + [
        "--importer_name=GeneratorImporter", "--step=4", f"--batch_size={BATCH}",
        "--save_checkpoint_steps=2", f"--base_log_path={tmp_path / 'log'}"])
    (log_dir,) = (tmp_path / "log").iterdir()
    assert log_dir.name == "syntheticldr_hypelcnnmdl_trn010_params_3x3"
    assert checkpoint_steps(str(log_dir)) == [2, 4]
    assert np.isfinite(result.loss)
    infer_for_classification.main(common + [f"--base_log_path={log_dir}",
                                            f"--output_path={tmp_path / 'out'}", "--domain=all"])
    scene = SyntheticDataLoader(SPEC).load_data(1, True)
    expected = predict_full_scene(result.final_state.module, scene, device="cpu")
    np.testing.assert_array_equal(_tiff(tmp_path / "out" / "result_raw.tif"), expected)
    assert _tiff(tmp_path / "out" / "result_colorized.tif").shape == (48, 64, 3)


def test_infer_cli_sample_and_gt_match_jax(tmp_path):
    params = _params_file(tmp_path)
    jax_module, flax_params, batch_stats = init_jax("HYPELCNNModel", CLASSES,
                                                    {"filter_count": 32}, (3, 3, 13), seed=4)
    tx, _ = jax_build_optimizer({**JaxHYPELCNNModel().default_params(), "filter_count": 32})
    to_jax = jax.tree_util.tree_map
    state = JaxTrainState.create(to_jax(jax.numpy.asarray, flax_params),
                                 to_jax(jax.numpy.asarray, batch_stats), tx)
    jax_save_checkpoint(str(tmp_path / "jax_log"), state.replace(step=jax.numpy.asarray(1)))
    module = torch_module("HYPELCNNModel", flax_params, batch_stats, CLASSES,
                          {"filter_count": 32}, (3, 3, 13))
    save_module(tmp_path / "log", 1, module)

    common = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--neighborhood=1",
              f"--algorithm_param_path={params}"]
    for domain in ("sample", "gt"):
        jax_infer_app.main(common + [f"--domain={domain}", f"--base_log_path={tmp_path / 'jax_log'}",
                                     f"--output_path={tmp_path / ('jax_' + domain)}"])
        infer_for_classification.main(common + [
            f"--domain={domain}", "--device=cpu", f"--base_log_path={tmp_path / 'log'}",
            f"--output_path={tmp_path / domain}"])
        for name in ("result_raw.tif", "result_colorized.tif"):
            np.testing.assert_array_equal(_tiff(tmp_path / domain / name),
                                          _tiff(tmp_path / ("jax_" + domain) / name))
    sample_map = _tiff(tmp_path / "sample" / "result_raw.tif")
    assert len(np.unique(sample_map)) > 1 and sample_map.max() < CLASSES
