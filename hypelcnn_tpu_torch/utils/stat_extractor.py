"""Confusion-matrix set -> OA/AA/kappa mean±std report (``hypelcnn_tpu/utils/stat_extractor.py``).

The reference's own kappa and its Fisher-z mean of kappas. Input: a
directory of confusion-matrix ``.csv`` files, one a run, as the trainer
writes them at validation (``validation_confusion_<step>.csv``).

CLI: ``python -m hypelcnn_tpu_torch.utils.stat_extractor <directory>``
"""

from __future__ import annotations

import glob
import os
import sys
from collections import namedtuple

import numpy as np

MetricsHolder = namedtuple("MetricsHolder", ["aa_array", "kappa_array", "oa_array",
                                             "sample_count"])


def histogram(confusion_matrix: np.ndarray, index: int) -> np.ndarray:
    return confusion_matrix.sum(axis=1 - index).astype(int)


def calc_kappa(conf_mat: np.ndarray) -> float:
    """Cohen's kappa from a confusion matrix."""
    conf_mat = np.asarray(conf_mat, dtype=float)
    num_ratings = len(conf_mat)
    hist_a = histogram(conf_mat, 0)
    hist_b = histogram(conf_mat, 1)
    num_scored = float(hist_a.sum())
    numerator = 0.0
    denominator = 0.0
    for i in range(num_ratings):
        for j in range(num_ratings):
            expected = float(hist_a[i]) * float(hist_b[j]) / num_scored
            d = 0.0 if i == j else 1.0
            numerator += d * conf_mat[i][j] / num_scored
            denominator += d * expected / num_scored
    return 1.0 - numerator / denominator


def calc_mean_quadratic_weighted_kappa(kappas, weights=None) -> float:
    """Fisher r-to-z mean of kappas."""
    kappas = np.array(kappas, dtype=float)
    weights = np.ones(np.shape(kappas)) if weights is None else weights / np.mean(weights)
    kappas = np.clip(kappas, -0.999, 0.999)
    z = np.mean(0.5 * np.log((1 + kappas) / (1 - kappas)) * weights)
    return (np.exp(2 * z) - 1) / (np.exp(2 * z) + 1)


def extract_accuracy_metrics(confusion_matrix: np.ndarray):
    total = np.sum(confusion_matrix)
    overall_accuracy = np.trace(confusion_matrix) / total
    row_sums = confusion_matrix.sum(axis=1)
    class_accuracy = np.diag(confusion_matrix) / row_sums
    kappa = calc_kappa(confusion_matrix)
    return overall_accuracy, class_accuracy, kappa, row_sums.astype(int)


def extract_statistics_info(confusion_matrix_list) -> MetricsHolder:
    count = len(confusion_matrix_list)
    oa_array = np.zeros(count)
    kappa_array = np.zeros(count)
    aa_array = None
    sample_count = None
    for index, confusion_matrix in enumerate(confusion_matrix_list):
        oa, aa, kappa, samples = extract_accuracy_metrics(confusion_matrix)
        if aa_array is None:
            aa_array = np.zeros([count, aa.shape[0]])
            sample_count = samples
        oa_array[index] = oa
        aa_array[index, :] = aa
        kappa_array[index] = kappa
    return MetricsHolder(aa_array=aa_array, kappa_array=kappa_array,
                         oa_array=oa_array, sample_count=sample_count)


def get_conf_list_from_directory(directory: str):
    return [np.loadtxt(fn, dtype=int, delimiter=",")
            for fn in sorted(glob.glob(os.path.join(directory, "*.csv")))]


def calculate_mean_std_metrics(oa_array, aa_array, kappa_array):
    return (np.mean(oa_array), np.std(oa_array),
            np.mean(np.mean(aa_array, axis=1)), np.std(np.mean(aa_array, axis=1)),
            np.mean(kappa_array), np.std(kappa_array))


def print_statistics_info(metrics_holder: MetricsHolder) -> None:
    for oa, aa, kappa in zip(metrics_holder.oa_array, metrics_holder.aa_array,
                             metrics_holder.kappa_array):
        print("OA: %.4f AA: %.4f Kappa: %.4f" % (oa, np.mean(aa), kappa))
    print("#Metrics statistics:")
    m_oa, s_oa, m_aa, s_aa, m_k, s_k = calculate_mean_std_metrics(
        metrics_holder.oa_array, metrics_holder.aa_array, metrics_holder.kappa_array)
    print("OA:    %.4f +- %.4f" % (m_oa, s_oa))
    print("AA:    %.4f +- %.4f" % (m_aa, s_aa))
    print("Kappa: %.4f +- %.4f" % (m_k, s_k))
    print("#Class based accuracy")
    for aa_mean, aa_std, n in zip(np.mean(metrics_holder.aa_array, axis=0),
                                  np.std(metrics_holder.aa_array, axis=0),
                                  metrics_holder.sample_count):
        print("%.4f +- %.4f %d" % (aa_mean, aa_std, n))


def main() -> None:
    directory = sys.argv[1]
    print_statistics_info(extract_statistics_info(get_conf_list_from_directory(directory)))


if __name__ == "__main__":
    main()
