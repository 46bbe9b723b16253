"""scikit-learn's ``StratifiedShuffleSplit`` and the SVM grid search of the
classic-ML trainer, without scikit-learn.

:class:`StratifiedShuffleSplit` gives the same index arrays as
scikit-learn's: one ``RandomState`` for all splits, ``_approximate_mode`` and
the permutations in its order (:mod:`hypelcnn_tpu_torch.data.splitters`).

:func:`grid_search` does what ``GridSearchCV(SVC(), param_grid, cv=cv)`` does
in ``hypelcnn_tpu/apps/classic_ml_trainer.py``: the grid in
``ParameterGrid``'s order (keys sorted, so ``C`` is the outer loop and
``gamma`` the inner), each cell scored by the mean accuracy over the splits,
and the first best cell wins. Every SVM of one split is solved at once on the
card (:func:`hypelcnn_tpu_torch.classic.svm.fit_many`).
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hypelcnn_tpu_torch.classic.svm import fit_many
from hypelcnn_tpu_torch.data.splitters import stratified_shuffle_splits


class StratifiedShuffleSplit:
    """``sklearn.model_selection.StratifiedShuffleSplit`` with the train
    size left to be the rest of the test size."""

    def __init__(self, n_splits: int = 10, test_size=0.1,
                 random_state: Optional[int] = None) -> None:
        self.n_splits = n_splits
        self.test_size = test_size
        self.random_state = random_state

    def split(self, x, y) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        del x  # scikit-learn splits on the labels alone
        return stratified_shuffle_splits(y, self.n_splits, None, self.test_size,
                                         self.random_state)


def grid_search(x: torch.Tensor, y: np.ndarray, c_range: Sequence[float],
                gamma_range: Sequence[float], cv: StratifiedShuffleSplit) -> dict:
    """The RBF SVM grid search: ``{"params": [...], "mean_test_score": [...],
    "best_params": {...}, "best_score": ...}``, each cell's score the mean
    test accuracy over ``cv``'s splits. ``x`` is the ``[N, F]`` float32 data
    on the device that solves."""
    y = np.asarray(y)
    params: List[dict] = [{"C": c, "gamma": g}
                          for c, g in itertools.product(c_range, gamma_range)]
    scores = np.zeros(len(params), dtype=np.float64)
    splits = list(cv.split(x, y))
    for train, test in splits:
        train_t = torch.from_numpy(train).to(x.device)
        test_t = torch.from_numpy(test).to(x.device)
        models = fit_many(x.index_select(0, train_t), y[train],
                          [float(p["C"]) for p in params], [float(p["gamma"]) for p in params])
        predicted = models.predict(x.index_select(0, test_t))
        scores += (predicted == y[test][None, :]).mean(axis=1)
    scores /= len(splits)
    best = int(np.argmax(scores))
    return {"params": params, "mean_test_score": scores, "best_params": params[best],
            "best_score": float(scores[best])}
