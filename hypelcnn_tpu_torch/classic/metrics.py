"""Classification metrics with scikit-learn's definitions, in numpy.

The JAX package's ``apps/classic_ml_trainer.py`` scores with
``sklearn.metrics``; the card's machine has no scikit-learn, so these repeat
its arithmetic operation for operation:

- the labels are the sorted union of the true and the predicted labels;
- :func:`balanced_accuracy_score` is the mean recall over the classes present
  in ``y_true`` (a class only predicted has no recall and is left out);
- :func:`cohen_kappa_score` is unweighted kappa from the confusion matrix and
  the outer product of its marginals.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(y_true, y_pred) -> np.ndarray:
    """``C[i, j]``: how many samples of label ``i`` were predicted ``j``, int64,
    over the sorted union of the labels."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    n = labels.shape[0]
    true_ids = np.searchsorted(labels, y_true)
    pred_ids = np.searchsorted(labels, y_pred)
    return np.bincount(true_ids * n + pred_ids, minlength=n * n).reshape(n, n).astype(np.int64)


def accuracy_score(y_true, y_pred) -> float:
    return float(np.average(np.asarray(y_true) == np.asarray(y_pred)))


def balanced_accuracy_score(y_true, y_pred) -> float:
    conf = confusion_matrix(y_true, y_pred)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(conf) / conf.sum(axis=1)
    return float(np.mean(per_class[~np.isnan(per_class)]))


def cohen_kappa_score(y1, y2) -> float:
    conf = confusion_matrix(y1, y2)
    n_classes = conf.shape[0]
    sum0 = np.sum(conf, axis=0)
    sum1 = np.sum(conf, axis=1)
    expected = np.outer(sum0, sum1) / np.sum(sum0)
    w_mat = np.ones([n_classes, n_classes], dtype=int)
    w_mat.flat[:: n_classes + 1] = 0
    k = np.sum(w_mat * conf) / np.sum(w_mat * expected)
    return float(1 - k)
