"""The training data path of the PyTorch port against the JAX package and
scikit-learn: splits, the index stream, the importers and augmentation.

Everything here is exact. The splits and index streams are the same numpy
draws in the same order; the augmentation ops get JAX's own draws injected
and only move or add float32 values, so they are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import StratifiedShuffleSplit
from sklearn.utils.extmath import _approximate_mode as sk_approximate_mode

from hypelcnn_tpu.core.registry import get_importer_from_name as jax_get_importer
from hypelcnn_tpu.data import augmentation as jax_aug
from hypelcnn_tpu.data.loaders.synthetic import SyntheticDataLoader as JaxSyntheticDataLoader
from hypelcnn_tpu.data.splitters import shuffle_training_data_using_size as jax_split_by_size
from hypelcnn_tpu.train.trainer import make_epoch_index_stream as jax_index_stream
from hypelcnn_tpu_torch.core.registry import get_importer_from_name
from hypelcnn_tpu_torch.data import augmentation as aug
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.data.splitters import (
    approximate_mode,
    shuffle_training_data_using_size,
    stratified_shuffle_split,
)
from hypelcnn_tpu_torch.train.trainer import make_epoch_index_stream
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"


def _sample_arrays(sample_set):
    return (sample_set.training_targets, sample_set.test_targets, sample_set.validation_targets)


@pytest.mark.parametrize("spec, train_ratio, test_ratio", [
    (SPEC, 0.5, 0.1),
    (SPEC, 0.1, 0.05),
    ("synthetic://?h=40&w=37&bands=4&classes=7&seed=1", 0.3, 0.2),
    ("synthetic://?h=40&w=37&bands=4&classes=7&seed=1", 0.25, 0),
])
def test_load_samples_matches_jax(spec, train_ratio, test_ratio):
    np.random.seed(1234)
    expected = JaxSyntheticDataLoader(spec).load_samples(train_ratio, test_ratio)
    after_jax = np.random.random()
    np.random.seed(1234)
    got = SyntheticDataLoader(spec).load_samples(train_ratio, test_ratio)
    assert np.random.random() == after_jax  # the same number of global draws
    for ours, theirs in zip(_sample_arrays(got), _sample_arrays(expected)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def _labels(counts):
    return np.concatenate([np.full(c, k) for k, c in enumerate(counts)])


@pytest.mark.parametrize("counts, train_size, test_size, random_state", [
    ([50, 30, 20], 0.3, None, None),
    ([10, 10, 10, 7], 0.5, None, None),         # tied remainders
    ([9, 9, 9, 9, 9], 0.22, None, None),        # every remainder tied
    ([40, 3, 17, 2, 25], None, 0.15, 0),        # test_size alone, fixed seed
    ([12, 12, 12], None, 0.5, 0),
    ([30, 20, 10], 7, None, None),              # an integer size
    ([30, 20, 10], 0.4, 0.3, None),             # both sizes
])
def test_stratified_split_matches_sklearn(counts, train_size, test_size, random_state):
    y = np.random.default_rng(len(counts)).permutation(_labels(counts))
    np.random.seed(7)
    splitter = StratifiedShuffleSplit(n_splits=1, train_size=train_size, test_size=test_size,
                                      random_state=random_state)
    sk_train, sk_test = next(splitter.split(np.zeros((len(y), 1)), y))
    after_sklearn = np.random.random()
    np.random.seed(7)
    train, test = stratified_shuffle_split(y, train_size=train_size, test_size=test_size,
                                           random_state=random_state)
    assert np.random.random() == after_sklearn
    np.testing.assert_array_equal(train, sk_train)
    np.testing.assert_array_equal(test, sk_test)


@pytest.mark.parametrize("counts, n_draws", [
    ([4, 2], 3), ([5, 2], 4), ([2, 2, 2, 1], 2), ([3, 3, 3, 3, 3, 3], 7), ([10, 1, 1, 1], 5),
])
def test_approximate_mode_matches_sklearn(counts, n_draws):
    for seed in (0, 42, 1234):
        expected = sk_approximate_mode(np.asarray(counts), n_draws, np.random.RandomState(seed))
        got = approximate_mode(np.asarray(counts), n_draws, np.random.RandomState(seed))
        np.testing.assert_array_equal(got, expected)


def test_stratified_split_rejects_what_sklearn_rejects():
    with pytest.raises(ValueError, match="only 1 member"):
        stratified_shuffle_split(np.array([0, 0, 1, 2, 2]), train_size=0.5)
    with pytest.raises(ValueError, match="number of classes"):
        stratified_shuffle_split(_labels([10, 10, 10]), train_size=2)
    with pytest.raises(ValueError, match="range"):
        stratified_shuffle_split(_labels([10, 10]), train_size=1.5)


def test_split_by_size_matches_jax():
    result = np.stack([np.arange(60), np.arange(60) * 2, _labels([30, 5, 25])], axis=1)
    np.random.seed(3)
    expected = jax_split_by_size(range(3), result, 10, 8)
    np.random.seed(3)
    got = shuffle_training_data_using_size(range(3), result, 10, 8)
    for ours, theirs in zip(got, expected):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("num_samples, batch, steps", [(10, 2, 5), (37, 16, 9), (100, 48, 1)])
def test_epoch_index_stream_matches_jax(num_samples, batch, steps):
    expected = jax_index_stream(num_samples, batch, steps, np.random.default_rng(5))
    got = make_epoch_index_stream(num_samples, batch, steps, np.random.default_rng(5))
    assert got.dtype == np.int32 and got.shape == (steps, batch)
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("importer_name", ["GeneratorImporter", "InMemoryImporter"])
def test_importers_match_jax(importer_name):
    np.random.seed(0)
    theirs = jax_get_importer(importer_name).read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    np.random.seed(0)
    ours = get_importer_from_name(importer_name).read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    assert ours.class_count == theirs.class_count and ours.data_shape == theirs.data_shape
    np.testing.assert_array_equal(ours.color_list, theirs.color_list)
    for split in ("training", "test", "validation"):
        np.testing.assert_array_equal(ours.targets(split), theirs.targets(split))
        targets = ours.targets(split)[:40]
        idx = np.arange(targets.shape[0], dtype=np.int32)
        src, jsrc = ours.sources[split], theirs.sources[split]
        got = src.gather(src.device_arrays("cpu"), torch.from_numpy(idx),
                         torch.from_numpy(targets[:, :2].astype(np.int32)))
        expected = jsrc.gather(jsrc.device_arrays(), jnp.asarray(idx),
                               jnp.asarray(targets[:, :2].astype(np.int32)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def test_scene_data_point_matches_jax():
    ours = SyntheticDataLoader(SPEC).load_data(2, True)
    theirs = JaxSyntheticDataLoader(SPEC).load_data(2, True)
    for x, y in ((0, 0), (63, 47), (10, 31)):
        np.testing.assert_array_equal(ours.get_data_point(x, y), theirs.get_data_point(x, y))


def test_record_importer_is_not_ported_yet(tmp_path):
    """Ported since this test's name was given: ``TFRecordImporter`` (an alias
    of ``RecordImporter``) reads the record writer's patch cache as the JAX
    importer reads it."""
    from hypelcnn_tpu_torch.utils.record_writer import write_records
    np.random.seed(3)
    cache = write_records("SyntheticDataLoader", SPEC, 0.2, 0.1, 1, str(tmp_path))
    ours = get_importer_from_name("TFRecordImporter").read_data_set(None, cache, None, None, None)
    theirs = jax_get_importer("TFRecordImporter").read_data_set(None, cache, None, None, None)
    assert ours.scene is None and ours.class_count == theirs.class_count == 5
    for split in ("training", "test", "validation"):
        np.testing.assert_array_equal(ours.targets(split), theirs.targets(split))
        np.testing.assert_array_equal(ours.sources[split].device_arrays("cpu").numpy(),
                                      np.asarray(theirs.sources[split].device_arrays()))


# ---- augmentation: JAX's own draws injected, bit-equal ----

def _patches(seed=0, batch=32, k=5, channels=7):
    return np.random.default_rng(seed).normal(size=(batch, k, k, channels)).astype(np.float32)


def _jax_draws(key, batch, channels, amount):
    """The draws that ``augment_batch`` makes from ``key``, by op."""
    k_rot, _, k_refl, k_spec = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_refl)
    return {
        "k": torch.from_numpy(np.array(jax.random.randint(k_rot, (batch,), 0, 3))),
        "flips": tuple(torch.from_numpy(np.array(jax.random.bernoulli(kk, 0.5, (batch,))))
                       for kk in (k1, k2)),
        "deltas": torch.from_numpy(np.array(jax.random.uniform(
            k_spec, (batch, 1, 1, channels), minval=-amount, maxval=0.0))),
    }


def test_rotation_matches_jax():
    x = _patches()
    key = jax.random.PRNGKey(3)
    expected = np.asarray(jax_aug._rotate_batch(jnp.asarray(x), key))
    k = torch.from_numpy(np.array(jax.random.randint(key, (x.shape[0],), 0, 3)))
    assert set(k.tolist()) == {0, 1, 2}
    np.testing.assert_array_equal(aug.rotate_batch(torch.from_numpy(x), k=k).numpy(), expected)


def test_reflection_matches_jax():
    x = _patches(1)
    key = jax.random.PRNGKey(4)
    expected = np.asarray(jax_aug._reflect_batch(jnp.asarray(x), key))
    k1, k2 = jax.random.split(key)
    flips = tuple(torch.from_numpy(np.array(jax.random.bernoulli(kk, 0.5, (x.shape[0],))))
                  for kk in (k1, k2))
    np.testing.assert_array_equal(aug.reflect_batch(torch.from_numpy(x), flips=flips).numpy(),
                                  expected)


def test_spectral_matches_jax():
    x = _patches(2)
    key = jax.random.PRNGKey(5)
    expected = np.asarray(jax_aug._spectral_batch(jnp.asarray(x), key, 0.05))
    deltas = torch.from_numpy(np.array(jax.random.uniform(
        key, (x.shape[0], 1, 1, x.shape[-1]), minval=-0.05, maxval=0.0)))
    np.testing.assert_array_equal(aug.spectral_batch(torch.from_numpy(x), 0.05,
                                                     deltas=deltas).numpy(), expected)


def test_augment_batch_order_matches_jax():
    x = _patches(3)
    key = jax.random.PRNGKey(6)
    info = dict(perform_rotation_augmentation=True, perform_reflection_augmentation=True,
                perform_spectral_augmentation=0.05)
    expected = np.asarray(jax_aug.augment_batch(jnp.asarray(x), key,
                                                jax_aug.AugmentationInfo(**info)))
    got = aug.augment_batch(torch.from_numpy(x), aug.AugmentationInfo(**info),
                            draws=_jax_draws(key, x.shape[0], x.shape[-1], 0.05))
    np.testing.assert_array_equal(got.numpy(), expected)


def test_generator_draws_have_the_jax_distribution():
    x = torch.from_numpy(_patches(4, batch=4000, k=3, channels=5))
    gen = torch.Generator().manual_seed(0)
    k = torch.randint(0, 3, (4000,), generator=torch.Generator().manual_seed(0))
    assert set(k.tolist()) == {0, 1, 2}  # never a 270-degree turn
    rotated = aug.rotate_batch(x, torch.Generator().manual_seed(0))
    assert torch.equal(rotated, aug.rotate_batch(x, k=k))
    out = aug.spectral_batch(x, 0.05, gen) - x
    assert float(out.max()) <= 0.0 and float(out.min()) >= -0.05 - 1e-6
    # one delta per example and channel (up to the rounding of x + d - x)
    torch.testing.assert_close(out[:, :1, :1], out[:, 2:, 2:], rtol=0, atol=1e-6)
    flipped = aug.reflect_batch(x, torch.Generator().manual_seed(1))
    share = float((flipped != x).flatten(1).any(1).float().mean())
    assert 0.7 < share < 0.8  # 3/4 of the examples flip at least one way


def test_shadow_augmentation_is_not_ported_yet():
    """Shadow augmentation is ported now (tests/test_torch_gan_augment.py);
    without a shadow op it does nothing, as in the JAX package."""
    x = torch.from_numpy(_patches(5, batch=4, k=3, channels=4))
    info = dict(perform_shadow_augmentation=True)
    expected = np.asarray(jax_aug.augment_batch(jnp.asarray(x.numpy()), jax.random.PRNGKey(0),
                                                jax_aug.AugmentationInfo(**info)))
    got = aug.augment_batch(x, aug.AugmentationInfo(**info), generator=torch.Generator())
    np.testing.assert_array_equal(got.numpy(), expected)
    assert torch.equal(got, x)
