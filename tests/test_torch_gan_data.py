"""The port's GAN pairing samplers, validation statistics and index stream
against the JAX package, bit for bit (all numpy), and the band-ratio plot
with and without matplotlib."""

import json
import os
import random
import sys

import numpy as np
import pytest

from hypelcnn_tpu.core.rng import RngPool as JaxRngPool
from hypelcnn_tpu.data.loaders.grss2013 import GRSS2013DataLoader as JaxGRSS2013
from hypelcnn_tpu.data.loaders.synthetic import SyntheticDataLoader as JaxSynthetic
from hypelcnn_tpu.gan import sampling as jax_sampling
from hypelcnn_tpu.gan import validation as jax_validation
from hypelcnn_tpu.gan.wrapper_registry import get_sampling_map as jax_sampling_map
from hypelcnn_tpu_torch.core.rng import RngPool
from hypelcnn_tpu_torch.data import layouts
from hypelcnn_tpu_torch.data.loaders.grss2013 import GRSS2013DataLoader
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.gan import sampling, validation
from hypelcnn_tpu_torch.gan.wrapper_registry import get_sampling_map
from hypelcnn_tpu_torch.train.trainer import make_epoch_index_stream
from hypelcnn_tpu_torch.utils.tiff_io import imwrite
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"


def _scenes(neighborhood):
    ours, theirs = SyntheticDataLoader(SPEC), JaxSynthetic(SPEC)
    scene, jax_scene = ours.load_data(neighborhood, True), theirs.load_data(neighborhood, True)
    return (ours, scene, ours.load_shadow_map(neighborhood, scene)[0],
            theirs, jax_scene, theirs.load_shadow_map(neighborhood, jax_scene)[0])


@pytest.mark.parametrize("method", ["random", "neighbour", "dummy"])
@pytest.mark.parametrize("neighborhood", [0, 1])
def test_samplers_match_jax(method, neighborhood):
    loader, scene, shadow_map, jax_loader, jax_scene, jax_map = _scenes(neighborhood)
    normal, shadow = sampling.read_hsi_data(loader, scene, shadow_map, method,
                                            get_sampling_map())
    expected = jax_sampling.read_hsi_data(jax_loader, jax_scene, jax_map, method,
                                          jax_sampling_map())
    for ours, theirs in zip((normal, shadow), expected):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert normal.shape[3] == scene.get_casi_band_count() == 12
    with pytest.raises(ValueError, match="Wrong sampling"):
        sampling.read_hsi_data(loader, scene, shadow_map, "nearest", get_sampling_map())


def test_target_sampler_matches_jax(tmp_path):
    """Class-balanced pairs from ``shadow_gen_model/class_result.tif``, on a
    small GRSS2013 layout."""
    layouts.write_grss2013(str(tmp_path), height=40, width=60, bands=8, training_fraction=0.3,
                           validation_fraction=0.3)
    classes = np.random.default_rng(0).integers(0, 15, (40, 60)).astype(np.uint8)
    os.makedirs(tmp_path / "2013_DFTC" / "shadow_gen_model")
    imwrite(str(tmp_path / "2013_DFTC" / "shadow_gen_model" / "class_result.tif"), classes)
    loader, jax_loader = GRSS2013DataLoader(str(tmp_path)), JaxGRSS2013(str(tmp_path))
    scene, jax_scene = loader.load_data(0, True), jax_loader.load_data(0, True)
    got = sampling.read_hsi_data(loader, scene, loader.load_shadow_map(0, scene)[0], "target",
                                 get_sampling_map())
    expected = jax_sampling.read_hsi_data(jax_loader, jax_scene,
                                          jax_loader.load_shadow_map(0, jax_scene)[0], "target",
                                          jax_sampling_map())
    assert got[0].shape[0] > 0
    for ours, theirs in zip(got, expected):
        assert np.array_equal(ours, theirs)


def test_ratio_stats_and_divergences_match_jax():
    rng = np.random.default_rng(0)
    originals = rng.uniform(0.1, 1.0, (64, 1, 1, 12)).astype(np.float32)
    originals[3, 0, 0, 5] = 0.0  # a zero band: that row's ratio is not finite and drops
    generated = (originals * rng.uniform(0.3, 0.7, originals.shape)).astype(np.float32)
    ratio = rng.uniform(1.5, 3.0, 12).astype(np.float32)
    ours = validation.compute_ratio_stats(generated, originals, ratio)
    theirs = jax_validation.compute_ratio_stats(generated, originals, ratio)
    assert ours[0].shape[0] == 63
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


def test_validation_samples_and_best_ratio_files_match_jax(tmp_path):
    """Seeded, the unseeded ``random`` draw picks the same pixels; a peer
    validation writes the same best-ratio files."""
    loader, scene, shadow_map, jax_loader, jax_scene, jax_map = _scenes(0)
    for fetch_shadows in (True, False):
        random.seed(4)
        ours = validation.load_samples_for_testing(scene, 20, 0, shadow_map, fetch_shadows)
        random.seed(4)
        theirs = jax_validation.load_samples_for_testing(jax_scene, 20, 0, jax_map, fetch_shadows)
        assert np.array_equal(ours, theirs)
    _, ratio = loader.load_shadow_map(0, scene)
    for module, root in ((validation, tmp_path / "ours"), (jax_validation, tmp_path / "jax")):
        os.makedirs(root)
        random.seed(5)
        peer = module.PeerValidator(loader, scene, shadow_map, ratio, 0, 30, str(root))
        for iteration in (10, 20):
            peer.run(lambda s, i=iteration: s * (0.5 + 0.01 * i),
                     lambda s, i=iteration: s * (2.0 - 0.01 * i), iteration, plot=False)
    for name in ("best_ratio_shadowed.json", "best_ratio_deshadowed.json"):
        assert json.loads((tmp_path / "ours" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text())
        assert len(json.loads((tmp_path / "ours" / name).read_text())) == 2


@pytest.mark.parametrize("pairs, batch, steps", [(1000, 32, 100), (37, 8, 20)])
def test_index_stream_matches_jax(pairs, batch, steps):
    """The JAX CLI's stream: ``numpy_rng("gan-shuffle")`` permutations,
    concatenated for ceil(steps * batch / pairs) epochs, cut to steps rows."""
    ours = make_epoch_index_stream(pairs, batch, steps, RngPool(1234).numpy_rng("gan-shuffle"))
    host_rng = JaxRngPool(1234).numpy_rng("gan-shuffle")
    epochs = -(-steps * batch // pairs)
    perms = np.concatenate([host_rng.permutation(pairs) for _ in range(epochs)])
    expected = perms[: steps * batch].astype(np.int32).reshape(steps, batch)
    assert ours.dtype == expected.dtype and np.array_equal(ours, expected)


def test_band_ratio_plot_with_and_without_matplotlib(tmp_path, monkeypatch, capsys):
    bands = np.linspace(400, 700, 12)
    mean = np.ones(12)
    pytest.importorskip("matplotlib")
    validation.plot_overall_info(bands, mean, mean - 0.1, mean + 0.1, 7, "band_ratio_x",
                                 str(tmp_path))
    assert (tmp_path / "band_ratio_x_7.pdf").is_file()
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import now raises ImportError
    validation.plot_overall_info(bands, mean, mean - 0.1, mean + 0.1, 8, "band_ratio_x",
                                 str(tmp_path))
    assert not (tmp_path / "band_ratio_x_8.pdf").exists()
    lines = [line for line in capsys.readouterr().out.splitlines() if "not written" in line]
    assert lines == [f"matplotlib is not installed: {tmp_path / 'band_ratio_x_8.pdf'} "
                     "not written"]
