"""The dual-resolution and multi-scene gathers, and the scenes they serve,
against the JAX package on the CPU.

- ``gather_patches_dual`` and ``gather_from_multi`` (members injected, as
  JAX's threefry draws cannot be matched) are bit for bit JAX's, out-of-range
  coordinates included.
- Training on a ``DualResScene`` (narrow CONCNN, 3 steps) and on a
  ``MultiScene`` (members injected) follows the JAX trainer to 1e-4.
- A ``DualResScene`` cannot be swept, in either package; ``--domain gt`` works.
- The dataset layout writers give what their loaders read, and the train and
  infer CLIs run on a written GRSS2013 directory.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hypelcnn_tpu.apps import infer_for_classification as jax_infer_app
from hypelcnn_tpu.core.registry import get_model_from_name as jax_get_model
from hypelcnn_tpu.core.rng import RngPool as JaxRngPool
from hypelcnn_tpu.data.importers import InMemoryImporter as JaxInMemoryImporter
from hypelcnn_tpu.data.loaders.base import SampleSet as JaxSampleSet
from hypelcnn_tpu.data.scene import DualResScene as JaxDualResScene
from hypelcnn_tpu.data.scene import MultiScene as JaxMultiScene
from hypelcnn_tpu.data.scene import Scene as JaxScene
from hypelcnn_tpu.data.scene import gather_from_multi as jax_gather_from_multi
from hypelcnn_tpu.ops.window_gather import gather_patches_dual as jax_gather_patches_dual
from hypelcnn_tpu.parallel.mesh import create_mesh
from hypelcnn_tpu.train.trainer import ClassificationTrainer as JaxClassificationTrainer
from hypelcnn_tpu_torch.apps import infer_for_classification, train_for_classification
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.core.registry import get_importer_from_name, get_loader_from_name
from hypelcnn_tpu_torch.core.registry import get_model_from_name
from hypelcnn_tpu_torch.data import layouts
from hypelcnn_tpu_torch.data.importers import ScenePatchSource
from hypelcnn_tpu_torch.data.loaders.base import SampleSet
from hypelcnn_tpu_torch.data.scene import DualResScene, MultiScene, Scene
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene, predict_targets
from hypelcnn_tpu_torch.models.layers import init_parameters
from hypelcnn_tpu_torch.ops.window_gather import gather_from_multi, gather_patches_dual
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer
from hypelcnn_tpu_torch.utils.tiff_io import imread
from torch_parity import numpy_tree, save_module
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CLASSES = 4


def _dual_arrays(seed=0, height=20, width=25, bands=6):
    rng = np.random.default_rng(seed)
    casi = rng.integers(100, 4000, (height, width, bands)).astype(np.uint16)
    lidar = rng.uniform(0, 40, (2 * height, 2 * width, 1)).astype(np.float32)
    return casi, lidar


def _coords(rng, batch, width, height, wild=True):
    coords = np.stack([rng.integers(0, width, batch), rng.integers(0, height, batch)], axis=1)
    if wild:  # out of range on either side
        coords[:batch // 4] = rng.integers(-2 * max(width, height), 2 * max(width, height),
                                           (batch // 4, 2))
    return coords.astype(np.int32)


def _equal(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("neighborhood", [0, 1, 2, 3])
def test_gather_patches_dual_matches_jax(neighborhood):
    casi, lidar = _dual_arrays(neighborhood)
    scene = DualResScene(casi.copy(), lidar.copy(), neighborhood, True)
    expected_scene = JaxDualResScene(casi.copy(), lidar.copy(), neighborhood, True)
    coords = _coords(np.random.default_rng(neighborhood), 203, 50, 40)
    casi_t, lidar_t = scene.device_modalities("cpu")
    assert casi_t.is_contiguous() and lidar_t.is_contiguous()
    assert scene.device_modalities("cpu")[0] is casi_t
    got = gather_patches_dual(casi_t, lidar_t, torch.from_numpy(coords), neighborhood)
    expected = jax_gather_patches_dual(*expected_scene.device_modalities(), jnp.asarray(coords),
                                       neighborhood)
    _equal(got.numpy(), expected)
    # in range, the host window
    for i in range(203 // 4, 203):
        x, y = coords[i]
        if x < 50 - 2 * neighborhood and y < 40 - 2 * neighborhood:
            _equal(got.numpy()[i], scene.get_data_point(int(x), int(y)))
    # the importer's source dispatches a dual scene to this gather
    source = ScenePatchSource(scene)
    assert not source.draws_members
    _equal(source.gather(source.device_arrays("cpu"), None, torch.from_numpy(coords)).numpy(),
           expected)


def _multi_pair(neighborhood, seed=0):
    rng = np.random.default_rng(seed)
    casi = rng.uniform(0, 1, (12, 15, 5)).astype(np.float32)
    lidar = rng.uniform(0, 9, (12, 15, 1)).astype(np.float32)

    def build(scene_cls, multi_cls):
        original = scene_cls(casi.copy(), lidar.copy(), neighborhood, True)
        shadowed = scene_cls(casi * np.float32(0.5), lidar.copy(), neighborhood, True,
                             casi_min=original.casi_min, casi_max=original.casi_max)
        return multi_cls([original, shadowed, shadowed, shadowed])
    return build(Scene, MultiScene), build(JaxScene, JaxMultiScene)


def _jax_members(key, batch, n_members=4):
    """The members JAX's ``gather_from_multi`` draws from ``key``."""
    return np.array(jax.random.randint(key, (batch,), 0, n_members))


@pytest.mark.parametrize("neighborhood", [0, 1, 2])
def test_gather_from_multi_matches_jax_with_injected_members(neighborhood):
    scene, expected_scene = _multi_pair(neighborhood)
    arrays = scene.device_scenes("cpu")
    jax_arrays = expected_scene.device_scenes()
    _equal(arrays[0].numpy(), jax_arrays[0])
    coords = _coords(np.random.default_rng(1), 301, 15, 12)
    key = jax.random.PRNGKey(neighborhood)
    expected = jax_gather_from_multi(jax_arrays, jnp.asarray(coords), neighborhood, key)
    member = torch.from_numpy(_jax_members(key, 301))
    _equal(gather_from_multi(arrays, torch.from_numpy(coords), neighborhood, member=member),
           expected)
    # no member and no generator: member 0, as JAX without a key
    _equal(gather_from_multi(arrays, torch.from_numpy(coords), neighborhood),
           jax_gather_from_multi(jax_arrays, jnp.asarray(coords), neighborhood))


def test_multi_scene_source_draws_members_from_its_generator():
    """Each window is its member's host window; 3 of 4 members are the
    shadowed scene; the same generator seed draws the same members."""
    scene, _ = _multi_pair(1)
    source = ScenePatchSource(scene)
    assert source.draws_members
    coords = torch.from_numpy(_coords(np.random.default_rng(2), 12000, 13, 10, wild=False))
    arrays = source.device_arrays("cpu")
    windows = source.gather(arrays, None, coords, torch.Generator().manual_seed(3))
    _equal(windows.numpy(), source.gather(arrays, None, coords,
                                          torch.Generator().manual_seed(3)).numpy())
    original, shadowed = scene.scenes[0], scene.scenes[1]
    kinds = []
    for (x, y), window in zip(coords.tolist(), windows.numpy()):
        is_original = np.array_equal(window, original.get_data_point(x, y))
        assert is_original != np.array_equal(window, shadowed.get_data_point(x, y))
        kinds.append(is_original)
    assert 0.70 < 1 - np.mean(kinds) < 0.80


def _sample_sets(rng, width, height, sizes=(96, 24, 24)):
    splits = [np.stack([rng.integers(0, width, n), rng.integers(0, height, n),
                        rng.integers(0, CLASSES, n)], axis=1) for n in sizes]
    return SampleSet(splits[0], splits[1], splits[2]), JaxSampleSet(splits[0], splits[1], splits[2])


def _trajectories(model_name, params, scene, jax_scene, samples, batch, steps, sources=None):
    """Per-step losses of the JAX trainer and of the port's, from the flax init."""
    algorithm_params = {**jax_get_model(model_name).default_params(), **params,
                        "batch_size": batch}
    jax_trainer = JaxClassificationTrainer(
        model=jax_get_model(model_name), class_count=CLASSES, algorithm_params=algorithm_params,
        scene=jax_scene, sample_set=samples[1], mesh=create_mesh(), test_cadence=10 ** 6)
    init = jax_trainer.init_state()
    init_state_dict = variables_to_state_dict(numpy_tree(init.params),
                                              numpy_tree(init.batch_stats))
    jax_losses = []
    jax_trainer.fit(steps, batch, log_every=1,
                    progress_callback=lambda s, l: jax_losses.append(l))
    trainer = ClassificationTrainer(
        model=get_model_from_name(model_name), class_count=CLASSES,
        algorithm_params=algorithm_params, scene=scene, sample_set=samples[0],
        sources=sources, device="cpu", test_cadence=10 ** 6)
    losses = []
    trainer.fit(steps, batch, log_every=1, state_dict=init_state_dict,
                progress_callback=lambda s, l: losses.append(l))
    return losses, jax_losses, jax_trainer


def test_dual_res_training_follows_the_jax_trainer():
    """3 steps of a narrow CONCNN on a ``DualResScene`` from the flax init,
    augmentation and dropout off (CONCNN keeps with probability 1.0)."""
    casi, lidar = _dual_arrays(5, 16, 20, 6)
    scene = DualResScene(casi.copy(), lidar.copy(), 1, True)
    jax_scene = JaxDualResScene(casi.copy(), lidar.copy(), 1, True)
    samples = _sample_sets(np.random.default_rng(6), 38, 30)
    losses, jax_losses, _ = _trajectories(
        "CONCNNModel", {"filter_count": 8, "drop_out_ratio": 1.0}, scene, jax_scene, samples,
        batch=16, steps=3)
    assert len(losses) == len(jax_losses) == 3
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)


class _InjectedMembers(ScenePatchSource):
    """The training source with each step's members given, not drawn."""

    def __init__(self, scene, members):
        super().__init__(scene)
        self.members = list(members)

    def draw_members(self, arrays, count, generator):
        assert generator is not None  # the trainer asks this source to draw
        members = torch.from_numpy(self.members.pop(0))
        assert members.shape == (count,)
        return members


def test_multi_scene_training_follows_the_jax_trainer_with_injected_members():
    """2 steps of a narrow CONCNN on the MIXED-style scene, dropout and
    augmentation off; each step's members are the JAX trainer's draws."""
    batch, steps = 16, 2
    scene, jax_scene = _multi_pair(1, seed=7)
    samples = _sample_sets(np.random.default_rng(8), 15, 12)
    # the JAX trainer's key derivation: fold the step into the "train" key,
    # split in three, the first is the gather's
    key_base = JaxRngPool(1234).key("train", 0)
    members = [_jax_members(jax.random.split(jax.random.fold_in(key_base, step), 3)[0], batch)
               for step in range(steps)]
    source = _InjectedMembers(scene, members)
    plain = ScenePatchSource(scene)
    losses, jax_losses, _ = _trajectories(
        "CONCNNModel", {"filter_count": 8, "drop_out_ratio": 1.0}, scene, jax_scene, samples,
        batch, steps,
        sources={"training": source, "test": plain, "validation": plain})
    assert source.members == []
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)


def test_multi_scene_sweeps_member_zero():
    scene, _ = _multi_pair(1)
    module = get_model_from_name("HYPELCNNModel").create_module(
        CLASSES, {"filter_count": 32}, scene.get_data_shape())
    init_parameters(module, torch.Generator().manual_seed(0))
    _equal(predict_full_scene(module, scene, batch_rows=5, device="cpu"),
           predict_full_scene(module, scene.scenes[0], batch_rows=5, device="cpu"))


def test_dual_res_scene_cannot_be_swept_in_either_package(tmp_path):
    casi, lidar = _dual_arrays(9)
    scene = DualResScene(casi, lidar, 1, True)
    module = get_model_from_name("HYPELCNNModel").create_module(
        CLASSES, {"filter_count": 32}, scene.get_data_shape())
    for sweep in (lambda: predict_full_scene(module, scene, device="cpu"),
                  lambda: predict_targets(module, scene, np.zeros((3, 3), np.int32), "cpu")):
        with pytest.raises(NotImplementedError, match="JAX package cannot sweep"):
            sweep()
    with pytest.raises(ValueError, match="concatenation axis"):
        JaxDualResScene(casi, lidar, 1, True).device_scene()


@pytest.fixture(scope="module")
def grss2018_root(tmp_path_factory):
    """The smallest GRSS2018 layout that holds the GT at the loader's
    offsets: CASI 1202 x 600 x 4, LiDAR 2404 x 1200, GT 1202 x 6."""
    root = tmp_path_factory.mktemp("grss2018")
    arrays = layouts.write_grss2018(str(root), casi_height=1202, casi_width=600, bands=4,
                                    gt_width=6, labelled_fraction=0.5, outlier_fraction=0.01)
    return str(root), arrays


def test_grss2018_layout_and_gt_domain(grss2018_root, tmp_path):
    """The loader reads the written arrays as ``DualResScene`` builds them;
    its targets' windows come through the importer's gather as on the host;
    the infer CLI's ``gt`` map is the JAX package's, and ``all`` raises."""
    root, arrays = grss2018_root
    lidar = arrays["lidar"][:, :, None].copy()
    assert (lidar > 300).any()
    lidar[lidar > 300] = 0
    expected = DualResScene(arrays["casi"][:, :, :-2], lidar, 1, True)
    np.random.seed(0)
    data = get_importer_from_name("GeneratorImporter").read_data_set(
        "GRSS2018DataLoader", root, 0.5, 0.1, 1)
    assert isinstance(data.scene, DualResScene)
    for name in ("casi", "lidar", "casi_min", "casi_max", "lidar_min", "lidar_max"):
        _equal(getattr(data.scene, name), getattr(expected, name))
    targets = np.vstack([data.sample_set.training_targets, data.sample_set.test_targets,
                         data.sample_set.validation_targets])
    assert len(targets) == int((arrays["gt"] > 0).sum())
    source = data.sources["training"]
    windows = source.gather(source.device_arrays("cpu"), None,
                            torch.from_numpy(targets[:, :2].astype(np.int32))).numpy()
    for (x, y), window in zip(targets[:, :2], windows):
        _equal(window, data.scene.get_data_point(int(x), int(y)))

    # the in-memory importer cuts the same windows on the host as the JAX one
    np.random.seed(1)
    in_memory = get_importer_from_name("InMemoryImporter").read_data_set(
        "GRSS2018DataLoader", root, 0.5, 0.1, 1)
    np.random.seed(1)
    jax_in_memory = JaxInMemoryImporter().read_data_set("GRSS2018DataLoader", root, 0.5, 0.1, 1)
    for split in ("training", "test", "validation"):
        _equal(in_memory.sources[split].patches, np.asarray(jax_in_memory.sources[split].patches))

    common = ["--loader_name=GRSS2018DataLoader", f"--path={root}", "--neighborhood=1"]
    jax_infer_app.main(common + ["--domain=gt", f"--output_path={tmp_path / 'jax'}",
                                 f"--base_log_path={tmp_path}"])
    infer_for_classification.main(common + ["--domain=gt", "--device=cpu",
                                            f"--output_path={tmp_path / 'gt'}",
                                            f"--base_log_path={tmp_path}"])
    for name in ("result_raw.tif", "result_colorized.tif"):
        with Image.open(tmp_path / "jax" / name) as theirs:
            _equal(imread(str(tmp_path / "gt" / name)), np.asarray(theirs))
    module = get_model_from_name("HYPELCNNModel").create_module(20, {"filter_count": 32}, [3, 3, 3])
    save_module(tmp_path / "log", 1, module)
    (tmp_path / "params.json").write_text(json.dumps({"filter_count": 32}))
    with pytest.raises(NotImplementedError, match="JAX package cannot sweep"):
        infer_for_classification.main(common + [
            "--domain=all", "--device=cpu", f"--output_path={tmp_path / 'all'}",
            f"--base_log_path={tmp_path / 'log'}",
            f"--algorithm_param_path={tmp_path / 'params.json'}"])


def test_gulfport_and_avon_layouts_read_back(tmp_path):
    root = str(tmp_path)
    gulfport = layouts.write_gulfport(root, height=30, width=22, bands=8)
    avon = layouts.write_avon(root, height=40, width=24, bands=12)
    loader = get_loader_from_name("GULFPORTALTDataLoader", root)
    scene = loader.load_data(1, True)
    expected = Scene(gulfport["hsi"], gulfport["lidar"][:, :, None], 1, True)
    for name in ("casi", "lidar", "casi_min", "casi_max"):
        _equal(getattr(scene, name), getattr(expected, name))
    shadow_map, _ = loader.load_shadow_map(0, None)
    _equal(shadow_map, gulfport["shadow_map"])
    np.random.seed(0)
    samples = loader.load_samples(0.5, 0.1)
    assert samples.test_targets.shape[0] == 0
    lit = samples.training_targets
    assert not shadow_map[lit[:, 1], lit[:, 0]].any()

    loader = get_loader_from_name("AVONDataLoader", root)
    scene = loader.load_data(0, True)
    casi = avon["casi"].copy()
    np.clip(casi, None, np.percentile(casi, 95, axis=[0, 1]).astype(np.uint16), out=casi)
    _equal(scene.casi, Scene(casi, None, 0, True, casi_min=0).casi)
    np.random.seed(0)
    samples = loader.load_samples(0.5, 0.0)
    every = np.vstack([samples.training_targets, samples.validation_targets])
    for target in (1, 2):
        mask = avon[f"{target}_nsh"] | avon[f"{target}_sh"]
        rows = every[every[:, 2] == target - 1]
        assert len(rows) == int(mask.sum())
        assert mask[rows[:, 1] + 55, rows[:, 0]].all()


def test_train_and_infer_clis_on_a_written_grss2013_directory(tmp_path):
    """A CPU drive of the train CLI through ``GRSS2013DataLoader``, then the
    infer CLI's ``all`` map against the sweep over a ``Scene`` built from the
    arrays that were written."""
    arrays = layouts.write_grss2013(str(tmp_path / "data"), height=24, width=40, bands=10,
                                    training_fraction=0.3, validation_fraction=0.3)
    (tmp_path / "params.json").write_text(json.dumps({"filter_count": 32}))
    common = ["--loader_name=GRSS2013DataLoader", f"--path={tmp_path / 'data'}",
              "--neighborhood=1", f"--algorithm_param_path={tmp_path / 'params.json'}",
              "--device=cpu"]
    result = train_for_classification.main(common + [
        "--importer_name=GeneratorImporter", "--step=4", "--batch_size=8",
        "--save_checkpoint_steps=4", f"--base_log_path={tmp_path / 'log'}"])
    (log_dir,) = (tmp_path / "log").iterdir()
    assert log_dir.name.startswith("grss2013ldr_hypelcnnmdl")
    assert np.isfinite(result.loss)
    infer_for_classification.main(common + [f"--base_log_path={log_dir}",
                                            f"--output_path={tmp_path / 'out'}", "--domain=all"])
    scene = Scene(arrays["casi"], arrays["lidar"][:, :, None], 1, True)
    expected = predict_full_scene(result.final_state.module, scene, device="cpu")
    with Image.open(tmp_path / "out" / "result_raw.tif") as image:
        _equal(np.asarray(image), expected)
