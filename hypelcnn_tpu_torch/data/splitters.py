"""Target extraction and train/validation/test splitting, without scikit-learn.

The functions and their results are those of ``hypelcnn_tpu/data/splitters.py``,
which splits with scikit-learn's ``StratifiedShuffleSplit``. The port has no
scikit-learn, so :func:`stratified_shuffle_splits` repeats in numpy the three
pieces that ``StratifiedShuffleSplit`` runs for each split, with the same
random draws in the same order:

1. the sizes (``_validate_shuffle_split``): a float train size gives
   ``floor(train_size * n)`` and a float test size ``ceil(test_size * n)``; the
   other side is the rest;
2. per class, how many rows go to train and to test (``_approximate_mode``,
   once for train, then once for test on what is left);
3. one permutation of each class's rows, in class order, then one
   permutation of the train list and one of the test list
   (``StratifiedShuffleSplit._iter_indices``).

The random state is scikit-learn's: the global ``np.random`` state when no
seed is given, ``np.random.RandomState(seed)`` otherwise. ``RandomState``'s
``choice`` and ``permutation`` are stable across numpy versions.
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np


def read_targets_from_image(targets: np.ndarray, class_range: Iterable[int]) -> np.ndarray:
    """Ground-truth image -> ``[N, 3]`` rows of (x, y, class_id)."""
    result = np.array([], dtype=int).reshape(0, 3)
    for target_index in class_range:
        ys, xs = np.where(targets == target_index)
        locs = np.stack([xs.astype(int), ys.astype(int)], axis=1)
        cls = np.full((len(locs), 1), target_index)
        result = np.vstack([result, np.hstack([locs, cls])])
    return result


def _split_sizes(n_samples: int, train_size=None, test_size=None) -> Tuple[int, int]:
    """``(n_train, n_test)`` as scikit-learn's ``_validate_shuffle_split`` gives them."""
    if train_size is None and test_size is None:
        test_size = 0.1
    for name, size in (("train_size", train_size), ("test_size", test_size)):
        if size is None:
            continue
        if isinstance(size, (float, np.floating)):
            if not 0 < size < 1:
                raise ValueError(f"{name}={size} should be a float in the (0, 1) range")
        elif isinstance(size, (int, np.integer)):
            if not 0 < size < n_samples:
                raise ValueError(f"{name}={size} should be positive and smaller than "
                                 f"the number of samples {n_samples}")
        else:
            raise ValueError(f"Invalid value for {name}: {size}")
    n_test = n_train = None
    if test_size is not None:
        n_test = math.ceil(test_size * n_samples) if isinstance(test_size, (float, np.floating)) \
            else float(test_size)
    if train_size is not None:
        n_train = math.floor(train_size * n_samples) \
            if isinstance(train_size, (float, np.floating)) else float(train_size)
    if train_size is None:
        n_train = n_samples - n_test
    elif test_size is None:
        n_test = n_samples - n_train
    if n_train + n_test > n_samples:
        raise ValueError(f"The sum of train_size and test_size = {int(n_train + n_test)}, "
                         f"should be smaller than the number of samples {n_samples}")
    n_train, n_test = int(n_train), int(n_test)
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size={test_size} and "
                         f"train_size={train_size}, the resulting train set will be empty")
    return n_train, n_test


def approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """Per-class draw counts summing to ``n_draws``, proportional to
    ``class_counts``; the rounding remainders go to the largest fractions
    first, ties broken by ``rng.choice`` (scikit-learn's ``_approximate_mode``)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_shuffle_splits(y: np.ndarray, n_splits: int = 1, train_size=None,
                              test_size=None, random_state: Optional[int] = None
                              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The ``(train_index, test_index)`` pairs of ``StratifiedShuffleSplit(
    n_splits=..., train_size=..., test_size=..., random_state=...).split(X, y)``:
    one random state for all the splits, drawn in scikit-learn's order."""
    y = np.asarray(y)
    n_train, n_test = _split_sizes(y.shape[0], train_size, test_size)
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is too "
                         f"few. Classes with too few members are: "
                         f"{classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or equal to the "
                         f"number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or equal to the "
                         f"number of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random if random_state is None else np.random.RandomState(random_state)
    for _ in range(n_splits):
        n_i = approximate_mode(class_counts, n_train, rng)
        t_i = approximate_mode(class_counts - n_i, n_test, rng)
        train, test = [], []
        for i in range(n_classes):
            permutation = rng.permutation(class_counts[i])
            perm_indices_class_i = class_indices[i].take(permutation, mode="clip")
            train.append(perm_indices_class_i[: n_i[i]])
            test.append(perm_indices_class_i[n_i[i]: n_i[i] + t_i[i]])
        yield rng.permutation(np.concatenate(train)), rng.permutation(np.concatenate(test))


def stratified_shuffle_split(y: np.ndarray, train_size=None, test_size=None,
                             random_state: Optional[int] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """``(train_index, test_index)`` of ``StratifiedShuffleSplit(n_splits=1,
    train_size=..., test_size=..., random_state=...).split(X, y)``."""
    return next(stratified_shuffle_splits(y, 1, train_size, test_size, random_state))


def shuffle_training_data_using_ratio(result: np.ndarray, train_data_ratio: float
                                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Stratified (train, validation) ratio split."""
    train_index, validation_index = stratified_shuffle_split(result[:, 2],
                                                             train_size=train_data_ratio)
    return result[train_index], result[validation_index]


def shuffle_training_data_using_size(class_range: Iterable[int], result: np.ndarray,
                                     train_data_size: int,
                                     validation_size: Optional[int]
                                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class fixed-count split; classes with fewer samples than the quota
    contribute 90% of what they have. As in the JAX package, a class that
    clamps ``validation_size`` lowers it for every later class too."""
    sample_ids = result[:, 2]
    train_set = np.empty([0, result.shape[1]], dtype=int)
    validation_set = np.empty([0, result.shape[1]], dtype=int)
    for sample_class in class_range:
        ids_for_class = np.where(sample_ids == sample_class)[0]
        count = ids_for_class.shape[0]
        if count == 0:
            continue
        if count < train_data_size:
            train_index = np.random.choice(count, (count * 9) // 10, replace=False)
        else:
            train_index = np.random.choice(count, train_data_size, replace=False)
        mask = np.ones(count, dtype=bool)
        mask[train_index] = False
        validation_index = np.nonzero(mask)[0]
        if validation_size is not None:
            validation_size = min(validation_size, validation_index.shape[0])
            validation_index = validation_index[
                np.random.choice(validation_index.shape[0], validation_size, replace=False)]
        train_set = np.vstack([train_set, result[ids_for_class[train_index], :]])
        validation_set = np.vstack([validation_set, result[ids_for_class[validation_index], :]])
    return train_set, validation_set


def shuffle_test_data_using_ratio(train_set: np.ndarray, test_data_ratio: float
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Carve a stable test set out of training (``random_state=0``);
    returns ``(test_set, train_set)``."""
    test_set = np.empty([0, train_set.shape[1]])
    if test_data_ratio > 0:
        train_index, test_index = stratified_shuffle_split(train_set[:, 2],
                                                           test_size=test_data_ratio,
                                                           random_state=0)
        test_set = train_set[test_index]
        train_set = train_set[train_index]
    return test_set, train_set
