"""The port's five real-dataset loaders against the JAX package's, on small
dataset directories in each loader's own file layout (the layouts of
``tests/test_loaders.py``, written once as TIFF and BMP files through PIL,
and read through both packages): the padded, normalized host arrays, their
statistics, the sample sets under one ``np.random`` seed, the shadow maps and
ratios, and the host windows are bit for bit equal."""

import numpy as np
import pytest
from PIL import Image

from hypelcnn_tpu.core.registry import get_loader_from_name as jax_get_loader
from hypelcnn_tpu.data.loaders.base import LoadingMode as JaxLoadingMode
from hypelcnn_tpu.utils.tiff_io import imwrite as jax_imwrite
from hypelcnn_tpu_torch.core.registry import get_loader_from_name
from hypelcnn_tpu_torch.data.loaders.base import LoadingMode
from hypelcnn_tpu_torch.data.scene import DualResScene, MultiScene
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """GRSS2013, GRSS2018, GULFPORT (with the ALT files) and AVON under one root."""
    base = tmp_path_factory.mktemp("real_layouts")

    d = base / "2013_DFTC"
    d.mkdir()
    rng = np.random.default_rng(0)
    jax_imwrite(str(d / "2013_IEEE_GRSS_DF_Contest_CASI.tif"),
                rng.integers(100, 4000, size=(20, 30, 144)).astype(np.uint16))
    jax_imwrite(str(d / "2013_IEEE_GRSS_DF_Contest_LiDAR.tif"),
                rng.uniform(0, 30, size=(20, 30)).astype(np.float32))
    gt = rng.integers(0, 15, size=(20, 30)).astype(np.uint8)
    gt[gt > 12] = 255
    jax_imwrite(str(d / "2013_IEEE_GRSS_DF_Contest_Samples_TR.tif"), gt)
    np.save(str(d / "2013_IEEE_GRSS_DF_Contest_Samples_VA.npy"), gt[::-1].copy())
    shadow = np.zeros((20, 30), dtype=np.uint8)
    shadow[:, :10] = 1
    jax_imwrite(str(d / "shadow_map.tif"), shadow)

    d = base / "2018_DFTC"
    d.mkdir()
    rng = np.random.default_rng(1)
    jax_imwrite(str(d / "20170218_UH_CASI_S4_NAD83.tiff"),
                rng.integers(100, 4000, size=(40, 50, 50)).astype(np.uint16))
    lidar = rng.uniform(0, 40, size=(80, 100)).astype(np.float32)
    lidar[0, 0] = 500.0  # an outlier to zero
    lidar[7, 3] = 301.0
    jax_imwrite(str(d / "UH17c_GEF051.tif"), lidar)
    gt = np.zeros((8, 10), dtype=np.uint8)
    gt[:4, :5] = 1
    gt[4:, 5:] = 2
    gt[0:2, 7:10] = 20
    jax_imwrite(str(d / "2018_IEEE_GRSS_DFC_GT_TR.tif"), gt)

    d = base / "GULFPORT"
    d.mkdir()
    rng = np.random.default_rng(2)
    hsi = rng.uniform(0, 1, size=(24, 30, 64)).astype(np.float32)
    jax_imwrite(str(d / "muulf_hsi.tif"), hsi)
    jax_imwrite(str(d / "muulf_lidar.tif"), rng.uniform(0, 10, size=(24, 30)).astype(np.float32))
    gt = rng.integers(1, 12, size=(24, 30)).astype(np.uint8)
    gt[3, 4] = 255
    jax_imwrite(str(d / "muulf_gt.tif"), gt)
    jax_imwrite(str(d / "muulf_hsi_shadowed.tif"), hsi * np.float32(0.5))
    jax_imwrite(str(d / "muulf_hsi_deshadowed.tif"), hsi * np.float32(1.5))
    jax_imwrite(str(d / "muulf_gt_shadow_corrected.tif"), gt)
    shadow = np.zeros((24, 30), dtype=np.uint8)
    shadow[:, :10] = 1
    jax_imwrite(str(d / "muulf_shadow_map.tif"), shadow)

    d = base / "AVON"
    d.mkdir()
    rng = np.random.default_rng(3)
    cube = rng.integers(0, 3000, size=(360, 40, 130)).astype(np.uint16)  # (bands, W, H)
    jax_imwrite(str(d / "0920-1857.georef_cropped.tif"), cube)
    jax_imwrite(str(d / "0920-1857.georef_cropped_shcorrected.tif"),
                np.swapaxes(cube[:, :, 55:-55], 0, 2)[:, :, ::-1].copy())
    shadow = np.zeros((20, 40), dtype=np.uint8)
    shadow[:, :10] = 1
    jax_imwrite(str(d / "0920-1857.georef_cropped_shadow.tif"), shadow)
    masks = {}
    for target, (rows, cols) in ((1, (slice(60, 70), slice(5, 15))),
                                 (2, (slice(58, 70), slice(20, 30)))):
        mask = np.zeros((130, 40), dtype=bool)
        mask[rows, cols] = True
        masks[f"{target}_nsh"] = mask
        shadowed = np.zeros_like(mask)
        shadowed[rows.start + 2:rows.stop + 2, cols] = True
        masks[f"{target}_sh"] = shadowed
    for name, mask in masks.items():
        Image.fromarray(mask).save(d / f"0920-1857.georef_cropped_rgb_with_targets_{name}.bmp")
    return str(base)


LOADERS = ["GRSS2013DataLoader", "GRSS2018DataLoader", "GULFPORTDataLoader",
           "GULFPORTALTDataLoader", "AVONDataLoader"]


def _equal(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


def _pair(name, root, mode=None, corrected=False):
    ours, theirs = get_loader_from_name(name, root), jax_get_loader(name, root)
    if mode is not None:
        ours.load_mode, theirs.load_mode = LoadingMode[mode], JaxLoadingMode[mode]
    if corrected:
        ours.load_shadow_corrected = theirs.load_shadow_corrected = True
    return ours, theirs


def _scene_equal(ours, theirs):
    for name in ("casi", "lidar", "casi_min", "casi_max", "lidar_min", "lidar_max"):
        if getattr(theirs, name) is None:
            assert getattr(ours, name) is None
        else:
            _equal(getattr(ours, name), getattr(theirs, name))
    assert ours.get_data_shape() == theirs.get_data_shape()
    assert ours.get_scene_shape() == theirs.get_scene_shape()
    assert ours.get_casi_band_count() == theirs.get_casi_band_count()
    assert ours.get_unnormalized_casi_dtype() == theirs.get_unnormalized_casi_dtype()


def test_every_loader_is_registered(data_root):
    for name in LOADERS + ["AVONDATALoader"]:
        assert type(get_loader_from_name(name, data_root)).__name__ == \
            type(jax_get_loader(name, data_root)).__name__


@pytest.mark.parametrize("name, mode, corrected", [
    ("GRSS2013DataLoader", None, False), ("GRSS2018DataLoader", None, False),
    ("GULFPORTDataLoader", None, False), ("GULFPORTALTDataLoader", "ORIGINAL", False),
    ("GULFPORTALTDataLoader", "SHADOWED", False), ("GULFPORTALTDataLoader", "DESHADOWED", False),
    ("AVONDataLoader", None, False), ("AVONDataLoader", None, True)])
@pytest.mark.parametrize("neighborhood, normalize", [(0, True), (2, True), (1, False)])
def test_scene_arrays_and_statistics_bit_equal(data_root, name, mode, corrected, neighborhood,
                                               normalize):
    ours, theirs = _pair(name, data_root, mode, corrected)
    scene, expected = ours.load_data(neighborhood, normalize), theirs.load_data(neighborhood,
                                                                               normalize)
    assert type(scene).__name__ == type(expected).__name__
    _scene_equal(scene, expected)
    rng = np.random.default_rng(neighborhood)
    height, width = expected.get_scene_shape()
    if isinstance(scene, DualResScene):  # keep the windows inside the half-size CASI
        height, width = height - 2 * neighborhood, width - 2 * neighborhood
    for x, y in zip(rng.integers(0, width, 12), rng.integers(0, height, 12)):
        _equal(scene.get_data_point(int(x), int(y)), expected.get_data_point(int(x), int(y)))


@pytest.mark.parametrize("name", LOADERS)
@pytest.mark.parametrize("train_ratio, test_ratio", [(0.5, 0.1), (0.25, 0.0), (3, 0.0)])
def test_sample_sets_bit_equal(data_root, name, train_ratio, test_ratio):
    ours, theirs = _pair(name, data_root)
    np.random.seed(4)
    samples = ours.load_samples(train_ratio, test_ratio)
    np.random.seed(4)
    expected = theirs.load_samples(train_ratio, test_ratio)
    for split in ("training_targets", "test_targets", "validation_targets"):
        _equal(getattr(samples, split), getattr(expected, split))
    assert samples.training_targets.shape[0] > 0


@pytest.mark.parametrize("name", LOADERS)
def test_shadow_maps_and_descriptions_equal(data_root, name):
    ours, theirs = _pair(name, data_root)
    for neighborhood in (0, 1):
        scene = ours.load_data(neighborhood, True)
        shadow_map, ratio = ours.load_shadow_map(neighborhood, scene)
        expected_map, expected_ratio = theirs.load_shadow_map(
            neighborhood, theirs.load_data(neighborhood, True))
        for got, want in ((shadow_map, expected_map), (ratio, expected_ratio)):
            if want is None:
                assert got is None
            else:
                _equal(got, want)
    if name not in ("GRSS2018DataLoader", "GULFPORTDataLoader"):
        assert ours.load_shadow_map(0, None)[1] is None
        assert ours.load_shadow_map(0, None)[0].shape == tuple(scene.get_scene_shape())
    assert ours.get_class_count() == theirs.get_class_count()
    assert ours.get_shadow_checkpoints() == theirs.get_shadow_checkpoints()
    _equal(ours.get_samples_color_list(), theirs.get_samples_color_list())
    _equal(ours.get_band_measurements(), theirs.get_band_measurements())
    assert ours.get_model_base_dir() == theirs.get_model_base_dir()


def test_mixed_scene_dedups_members_and_draws_like_jax(data_root):
    ours, theirs = _pair("GULFPORTALTDataLoader", data_root, "MIXED")
    scene, expected = ours.load_data(1, True), theirs.load_data(1, True)
    assert isinstance(scene, MultiScene) and len(scene.scenes) == 4
    assert scene.scenes[1] is scene.scenes[2] is scene.scenes[3]
    for member, want in zip(scene.scenes, expected.scenes):
        _scene_equal(member, want)
    # the shadowed member keeps the original's normalization range
    _equal(scene.scenes[1].casi_max, scene.scenes[0].casi_max)
    # attributes are member 0's
    assert scene.get_scene_shape() == [24, 30] and scene.casi is scene.scenes[0].casi
    stacked, lookup = scene.device_scenes("cpu")
    jax_stacked, jax_lookup = expected.device_scenes()
    assert stacked.shape[0] == 2
    assert lookup.tolist() == [0, 1, 1, 1] == np.asarray(jax_lookup).tolist()
    _equal(stacked.numpy(), np.asarray(jax_stacked))
    assert scene.device_scenes("cpu")[0] is stacked
    # host windows draw their member from the global np.random state
    np.random.seed(9)
    windows = [scene.get_data_point(x, 5) for x in range(20)]
    np.random.seed(9)
    for x, window in enumerate(windows):
        _equal(window, expected.get_data_point(x, 5))
    # the signal-to-member map of this scene: each window is one member's
    kinds = {int(np.array_equal(w, scene.scenes[1].get_data_point(x, 5)))
             for x, w in enumerate(windows)}
    assert kinds == {0, 1}


def test_in_memory_importer_matches_jax_on_the_mixed_scene(data_root, monkeypatch):
    """``InMemoryImporter`` cuts every split's windows through
    ``get_data_point``; on the MIXED scene both packages draw the same
    members from one ``np.random`` seed."""
    from hypelcnn_tpu.data.loaders.gulfport_alt import GULFPORTALTDataLoader as JaxAlt
    from hypelcnn_tpu.data.importers import InMemoryImporter as JaxInMemory
    from hypelcnn_tpu_torch.data.importers import InMemoryImporter
    from hypelcnn_tpu_torch.data.loaders.gulfport_alt import GULFPORTALTDataLoader

    for cls, enum in ((GULFPORTALTDataLoader, LoadingMode), (JaxAlt, JaxLoadingMode)):
        original_init = cls.__init__

        def init(self, base_dir, _init=original_init, _mode=enum.MIXED):
            _init(self, base_dir)
            self.load_mode = _mode
        monkeypatch.setattr(cls, "__init__", init)
    np.random.seed(5)
    ours = InMemoryImporter().read_data_set("GULFPORTALTDataLoader", data_root, 0.5, 0.0, 1)
    np.random.seed(5)
    theirs = JaxInMemory().read_data_set("GULFPORTALTDataLoader", data_root, 0.5, 0.0, 1)
    assert isinstance(ours.scene, MultiScene)
    for split in ("training", "test", "validation"):
        _equal(ours.sources[split].patches, np.asarray(theirs.sources[split].patches))
