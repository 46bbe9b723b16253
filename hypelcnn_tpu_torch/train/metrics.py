"""Classification metrics (``hypelcnn_tpu/train/metrics.py``).

One accumulator, the integer confusion matrix, is updated on the device
inside the eval drain (:func:`confusion_update`, an integer ``index_add_``:
no float atomics, no host read). OA, AA and kappa are numpy functions of
the finished matrix (:func:`compute_metrics`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class MetricsResult(NamedTuple):
    overall_accuracy: float
    mean_per_class_accuracy: float
    kappa: float
    confusion: np.ndarray
    class_recall: np.ndarray
    class_precision: np.ndarray


def confusion_update(confusion: torch.Tensor, labels: torch.Tensor, predictions: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add a batch to an integer ``[C, C]`` confusion matrix in place (rows =
    truth) and return it. ``mask`` leaves padding rows out."""
    num_classes = confusion.shape[0]
    flat_idx = labels.long() * num_classes + predictions.long()
    weights = torch.ones_like(flat_idx, dtype=confusion.dtype) if mask is None \
        else mask.to(confusion.dtype)
    confusion.view(-1).index_add_(0, flat_idx, weights)
    return confusion


def compute_metrics(confusion: np.ndarray) -> MetricsResult:
    """OA, AA (mean over ALL classes, an absent class counting 0), Cohen's
    kappa and per-class recall and precision from a confusion matrix."""
    confusion = np.asarray(confusion, dtype=np.float64)
    total = confusion.sum()
    if total == 0:
        z = np.zeros(confusion.shape[0])
        return MetricsResult(0.0, 0.0, 0.0, confusion.astype(np.int64), z, z)
    diag = np.diag(confusion)
    overall = float(diag.sum() / total)

    row_sums = confusion.sum(axis=1)
    col_sums = confusion.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        recall = np.where(row_sums > 0, diag / row_sums, 0.0)
        precision = np.where(col_sums > 0, diag / col_sums, 0.0)
    mean_per_class = float(recall.mean())

    expected = float((row_sums * col_sums).sum() / (total * total))
    kappa = float((overall - expected) / (1.0 - expected)) if expected < 1.0 else 0.0

    return MetricsResult(overall, mean_per_class, kappa,
                         confusion.astype(np.int64), recall, precision)
