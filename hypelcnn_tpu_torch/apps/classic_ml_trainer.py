"""Classic-ML baselines: a random forest and an RBF SVM grid search on
flattened windows (``hypelcnn_tpu/apps/classic_ml_trainer.py``).

The same flags (``--hyperparamopt``, ``--fullscene``, ``--split_count`` and
the loader, logger and trainer groups), plus ``--device`` (``cuda`` unless
asked for ``cpu``), the same prints and the same files in
``--base_log_path``: ``confusion_matrix_<loader>_run<i>.csv``,
``metrics_<loader>_run<i>.txt`` and ``params_<loader>_run<i>.json``; with
``--fullscene``, ``result_raw.tif`` and ``result_colorized.tif`` in
``--output_path``::

    python -m hypelcnn_tpu_torch.apps.classic_ml_trainer \\
        --loader_name=SyntheticDataLoader --path="synthetic://?h=349&w=1905&bands=144&classes=15" \\
        --neighborhood=0 --fullscene --batch_size=65536

Each run loads the scene unnormalized, splits ``load_samples(0.1, 0)`` and
cuts the windows on the device from the scene held there as float32: a
``Scene`` with the CUDA window gather, a ``DualResScene`` with
``gather_patches_dual`` and a ``MultiScene`` with ``gather_from_multi`` (its
members drawn from ``np.random``, one a window, as the JAX package's host
loop draws them). The windows equal the JAX package's host windows bit for
bit. The estimators are the port's own (:mod:`hypelcnn_tpu_torch.classic`):
the forest and the SVMs are fitted and predict on the device; the metrics
are scikit-learn's, in numpy.
"""

from __future__ import annotations

import argparse
import os
import time
from math import sqrt

import numpy as np
import torch

from hypelcnn_tpu_torch.classic.forest import RandomForestClassifier
from hypelcnn_tpu_torch.classic.metrics import (
    accuracy_score,
    balanced_accuracy_score,
    cohen_kappa_score,
    confusion_matrix,
)
from hypelcnn_tpu_torch.classic.model_selection import StratifiedShuffleSplit, grid_search
from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
    add_parse_cmds_for_trainers,
    type_ensure_strtobool,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_loader_from_name
from hypelcnn_tpu_torch.data.importers import ScenePatchSource
from hypelcnn_tpu_torch.data.scene import DualResScene
from hypelcnn_tpu_torch.infer.scene_inference import create_colored_image
from hypelcnn_tpu_torch.utils.tiff_io import imwrite

C_RANGE = np.logspace(-2, 10, 13)
GAMMA_RANGE = np.logspace(-9, 3, 13)


def add_parse_cmds_for_app(parser) -> None:
    parser.add_argument("--hyperparamopt", nargs="?", const=True, type=type_ensure_strtobool,
                        default=False, help="If true, performs hyper parameter optimization.")
    parser.add_argument("--fullscene", nargs="?", const=True, type=type_ensure_strtobool,
                        default=False, help="If true, performs full scene classification.")
    parser.add_argument("--split_count", nargs="?", type=int, default=1, help="Split count")


def _through_dtype(values: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """float32 values cast to an integer ``dtype`` and back, as numpy's
    ``astype`` does on the host: truncated toward zero, wrapped to its width."""
    info = np.iinfo(dtype)
    span = int(info.max) - int(info.min) + 1
    whole = torch.trunc(values).to(torch.int64)
    return (torch.remainder(whole - int(info.min), span) + int(info.min)).to(values.dtype)


def gather_windows(scene, coords_xy: np.ndarray, device) -> torch.Tensor:
    """``[B, k * k * C]`` float32 windows at the ``(x, y)`` rows of
    ``coords_xy``, cut on ``device`` from the scene held there, flattened in
    (row, column, channel) order."""
    coords = torch.from_numpy(np.ascontiguousarray(coords_xy[:, :2], dtype=np.int32)).to(device)
    source = ScenePatchSource(scene)
    member = None
    if source.draws_members:
        # one member a window from np.random, as the host loop draws them
        member = torch.from_numpy(np.random.randint(0, len(scene.scenes), size=coords.shape[0]))
        member = member.to(device)
    windows = source.gather(source.device_arrays(device), None, coords, member=member)
    if isinstance(scene, DualResScene) and np.issubdtype(scene.casi.dtype, np.integer):
        # the host window concatenates LiDAR cast to CASI's type
        windows[..., -1] = _through_dtype(windows[..., -1], scene.casi.dtype)
    return windows.reshape(windows.shape[0], -1)


def print_output(algorithm_params, average_accuracy, conf_matrix, kappa,
                 overall_accuracy, index, name, base_log_path) -> None:
    print("OA:%5.5f" % overall_accuracy)
    print("AA:%5.5f" % average_accuracy)
    print("KAPPA:%5.5f" % kappa)
    print("Confusion Matrix:")
    print(conf_matrix)
    file_id = f"{name}_run{index}"
    os.makedirs(base_log_path, exist_ok=True)
    np.savetxt(os.path.join(base_log_path, f"confusion_matrix_{file_id}.csv"),
               conf_matrix, fmt="%d", delimiter=",")
    with open(os.path.join(base_log_path, f"metrics_{file_id}.txt"), "w") as fid:
        print("OA,AA,KAPPA", file=fid)
        print("%.6f,%.6f,%.6f" % (overall_accuracy, average_accuracy, kappa), file=fid)
    with open(os.path.join(base_log_path, f"params_{file_id}.json"), "w") as fid:
        print(algorithm_params, file=fid)


def perform_hyperparamopt(train_x: torch.Tensor, labels: np.ndarray) -> dict:
    """The RBF SVM grid over C in 1e-2..1e10 and gamma in 1e-9..1e3, two
    stratified 10% splits (seed 42); prints the best cell as the JAX CLI does."""
    cv = StratifiedShuffleSplit(n_splits=2, test_size=0.1, random_state=42)
    cells = C_RANGE.shape[0] * GAMMA_RANGE.shape[0]
    print(f"Fitting {cv.n_splits} folds for each of {cells} candidates, "
          f"totalling {cv.n_splits * cells} fits")
    grid = grid_search(train_x, labels, C_RANGE, GAMMA_RANGE, cv)
    print("The best parameters are %s with a score of %0.2f"
          % (grid["best_params"], grid["best_score"]))
    return grid


def perform_full_scene_classification(data_path, loader_name, neighborhood, estimator,
                                      batch_size, device, output_path=".") -> np.ndarray:
    """Classify every pixel in row-major batches of ``batch_size`` on the
    device; writes ``result_raw.tif`` and ``result_colorized.tif``."""
    loader = get_loader_from_name(loader_name, data_path)
    scene = loader.load_data(neighborhood, False)
    h, w = scene.get_scene_shape()
    prediction = np.empty([h * w], dtype=np.uint8)
    for start in range(0, h * w, batch_size):
        index = np.arange(start, min(start + batch_size, h * w))
        coords = np.stack([index % w, index // w], axis=1)
        prediction[index] = estimator.predict(gather_windows(scene, coords, device), batch_size)
    scene_as_image = prediction.reshape(h, w)
    imwrite(os.path.join(output_path, "result_raw.tif"), scene_as_image)
    imwrite(os.path.join(output_path, "result_colorized.tif"),
            create_colored_image(scene_as_image, loader.get_samples_color_list()))
    return scene_as_image


def main(argv=None) -> list:
    """Runs the CLI; returns one dict a run (the estimator, the validation
    windows, labels and predictions, and the seconds of each stage)."""
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_app(parser)
    add_parse_cmds_for_trainers(parser)
    add_parse_cmds_for_device(parser)
    flags, _ = parser.parse_known_args(argv)
    device = resolve_device(flags.device)

    runs = []
    for run_index in range(flags.split_count):
        print("Starting episode#%d" % run_index)
        loader = get_loader_from_name(flags.loader_name, flags.path)
        scene = loader.load_data(flags.neighborhood, False)
        sample_set = loader.load_samples(0.1, 0)

        train_x = gather_windows(scene, sample_set.training_targets, device)
        train_y = sample_set.training_targets[:, 2].astype(int)
        val_x = gather_windows(scene, sample_set.validation_targets, device)
        val_y = sample_set.validation_targets[:, 2].astype(int)

        start_time = time.time()
        estimator = RandomForestClassifier(n_estimators=50, max_features=int(2 * sqrt(144)))
        estimator.fit(train_x, train_y)
        fit_seconds = time.time() - start_time
        print("Completed training(%.3f sec)" % fit_seconds)
        start_time = time.time()
        predicted = estimator.predict(val_x)
        predict_seconds = time.time() - start_time

        overall_accuracy = accuracy_score(val_y, predicted)
        average_accuracy = balanced_accuracy_score(val_y, predicted)
        kappa = cohen_kappa_score(val_y, predicted)
        conf_matrix = confusion_matrix(val_y, predicted)
        print_output(estimator.get_params(), average_accuracy, conf_matrix, kappa,
                     overall_accuracy, run_index, flags.loader_name, flags.base_log_path)
        run = {"estimator": estimator, "train_x": train_x, "train_y": train_y, "val_x": val_x,
               "val_y": val_y, "predicted": predicted, "overall_accuracy": overall_accuracy,
               "fit_seconds": fit_seconds, "predict_seconds": predict_seconds}
        if flags.hyperparamopt:
            start_time = time.time()
            run["grid"] = perform_hyperparamopt(train_x, train_y)
            run["grid_seconds"] = time.time() - start_time
        if flags.fullscene:
            start_time = time.time()
            run["scene_map"] = perform_full_scene_classification(
                flags.path, flags.loader_name, flags.neighborhood, estimator, flags.batch_size,
                device, flags.output_path)
            run["full_scene_seconds"] = time.time() - start_time
        runs.append(run)
    return runs


if __name__ == "__main__":
    main()
