"""The port's synthetic loader and ``Scene`` against the JAX package's: the
host arrays are bit for bit equal (same numpy code, same generator calls),
and so is the fused device scene on the CPU."""

import numpy as np
import pytest

from hypelcnn_tpu.data.loaders.synthetic import SyntheticDataLoader as JaxSyntheticDataLoader
from hypelcnn_tpu.data.scene import Scene as JaxScene
from hypelcnn_tpu_torch.core.registry import get_loader_from_name
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.data.scene import Scene

SPECS = ["synthetic://?h=48&w=64&bands=12&classes=5&seed=3",
         "synthetic://?h=21&w=35&bands=7&classes=4&seed=11&noise=900"]


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", SPECS)
def test_synthetic_arrays_bit_equal(spec):
    ours, theirs = SyntheticDataLoader(spec), JaxSyntheticDataLoader(spec)
    ours._materialize()
    theirs._materialize()
    for name in ("_gt", "_casi", "_lidar"):
        _equal(getattr(ours, name), getattr(theirs, name))
    _equal(ours.get_samples_color_list(), theirs.get_samples_color_list())
    _equal(ours.get_band_measurements(), theirs.get_band_measurements())
    assert ours.get_class_count() == theirs.get_class_count()


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("neighborhood", [0, 1, 2])
@pytest.mark.parametrize("normalize", [True, False])
def test_scene_bit_equal(spec, neighborhood, normalize):
    ours = SyntheticDataLoader(spec).load_data(neighborhood, normalize)
    theirs = JaxSyntheticDataLoader(spec).load_data(neighborhood, normalize)
    _equal(ours.casi, theirs.casi)
    _equal(ours.lidar, theirs.lidar)
    assert ours.get_data_shape() == theirs.get_data_shape()
    assert ours.get_scene_shape() == theirs.get_scene_shape()
    fused = ours.device_scene("cpu")
    assert fused.is_contiguous()
    _equal(fused.numpy(), np.asarray(theirs.device_scene()))
    assert ours.device_scene("cpu") is fused


def test_scene_without_lidar_matches():
    casi = np.random.default_rng(5).uniform(0, 900, (9, 7, 3)).astype(np.float32)
    ours = Scene(casi=casi.copy(), lidar=None, neighborhood=2, normalize=True)
    theirs = JaxScene(casi=casi.copy(), lidar=None, neighborhood=2, normalize=True)
    _equal(ours.device_scene("cpu").numpy(), np.asarray(theirs.device_scene()))


def test_registry_and_unported_samples():
    loader = get_loader_from_name("SyntheticDataLoader", SPECS[0])
    assert isinstance(loader, SyntheticDataLoader)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loader.load_samples(0.1, 0)
    with pytest.raises(ValueError):
        SyntheticDataLoader("/data/not/a/spec")
