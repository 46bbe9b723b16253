"""A MUUFL shadow map from the building-shadow class; each shadow contour
reassigned to its neighbours' class; the shadow-corrected HSI and GT
(``hypelcnn_tpu/utils/reveal_shadow_targets.py``).

The same flags, plus ``--device`` (``cuda`` unless asked for ``cpu``): the
shadow correction, arithmetic over the scene, runs there; the contours are
host work with the port's copy of OpenCV's border following
(:mod:`hypelcnn_tpu_torch.utils.cv_ops`). Writes ``muulf_shadow_map.tif``,
``muulf_hsi_shadow_corrected.tif`` and ``muulf_gt_shadow_corrected.tif``
(1-indexed again) to ``--output_path``, and the two target figures where
matplotlib is installed::

    python -m hypelcnn_tpu_torch.utils.reveal_shadow_targets \\
        --loader_name=GULFPORTDataLoader --path=DATA --output_path=OUT --device=cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_loader_from_name
from hypelcnn_tpu_torch.data.loaders.base import calculate_shadow_ratio
from hypelcnn_tpu_torch.infer.scene_inference import (
    INVALID_TARGET_VALUE,
    create_colored_image,
    create_target_image_via_samples,
)
from hypelcnn_tpu_torch.utils.cv_ops import fill_contour, find_contours
from hypelcnn_tpu_torch.utils.plotting import pyplot
from hypelcnn_tpu_torch.utils.tiff_io import imwrite

BUILDING_CLASS = 7
BUILDING_SHADOW_CLASS = 6

# as in the JAX package, which keeps the reference's list: (1, 0) appears
# twice and (-1, 0) is missing, so the south neighbour votes twice and the
# north one never; the votes start at -1. Changing either changes which
# class a contour takes.
_NEIGHBOR_DELTAS = [(0, 1), (0, -1), (1, 0), (1, 1), (1, -1), (1, 0), (-1, 1), (-1, -1)]


def get_shadow_map(target_image: np.ndarray) -> np.ndarray:
    return (target_image == BUILDING_SHADOW_CLASS).astype(np.uint8)


def shadow_corrected_image(casi: np.ndarray, shadow_map: np.ndarray, device) -> np.ndarray:
    """``casi + casi * shadow * (ratio - 1)`` in float32, computed over the
    scene on ``device``. ``ratio`` is each band's mean over the lit pixels
    over its mean over the shadow, from ``calculate_shadow_ratio`` on the
    host: numpy's own summation, so the ratio is the JAX package's bit for
    bit."""
    ratio = calculate_shadow_ratio(casi, shadow_map, np.logical_not(shadow_map).astype(int))
    scene = torch.from_numpy(np.ascontiguousarray(casi)).to(device).to(torch.float32)
    shadow = torch.from_numpy(shadow_map).to(device)
    add_coef = shadow[:, :, None].to(torch.float32) * (torch.from_numpy(ratio).to(device) - 1)
    return (scene + scene * add_coef).cpu().numpy()


def _contour_neighbor_votes(contour: np.ndarray, target_image: np.ndarray) -> dict:
    """Votes of the classes around a contour's ``(x, y)`` points, repeats
    counted; plain numpy indexing, so a row or column of -1 wraps."""
    votes = {}
    for col, row in contour:
        for dx, dy in _NEIGHBOR_DELTAS:
            t = int(target_image[row + dx, col + dy])
            votes[t] = votes.get(t, -1) + 1
    return votes


def reassign_shadow_contours(shadow_map: np.ndarray, target_image: np.ndarray) -> np.ndarray:
    """Fill each shadow contour, in place, with the class most of its
    neighbours have (shadow, building and unlabelled excluded); later
    contours overwrite earlier ones."""
    for contour in find_contours(shadow_map):
        votes = _contour_neighbor_votes(contour, target_image)
        for excluded in (BUILDING_SHADOW_CLASS, INVALID_TARGET_VALUE, BUILDING_CLASS):
            votes.pop(excluded, None)
        if not votes:
            print("found contour with no proper neighbors")
            continue
        winner = max(votes, key=votes.get)
        target_image[fill_contour(shadow_map.shape, contour)] = winner
        print(f"shadow converted to neighboring target {winner:d}")
    return target_image


def draw_targets(color_list, target_image, figure_name, output_path=".") -> None:
    path = os.path.join(output_path, figure_name.replace(" ", "_") + ".png")
    plt = pyplot(path)
    if plt is None:
        return
    plt.imshow(create_colored_image(target_image, color_list))
    plt.title(figure_name), plt.xticks([]), plt.yticks([])
    plt.savefig(path)
    plt.clf()


def main(argv=None) -> dict:
    """Runs the CLI; returns the arrays it wrote, by file name."""
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_device(parser)
    flags, _ = parser.parse_known_args(argv)
    device = resolve_device(flags.device)
    out = flags.output_path

    loader = get_loader_from_name(flags.loader_name, flags.path)
    sample_set = loader.load_samples(0.1, 0.1)
    data_set = loader.load_data(0, True)
    target_image = create_target_image_via_samples(sample_set, data_set.get_scene_shape())

    shadow_map = get_shadow_map(target_image)
    imwrite(os.path.join(out, "muulf_shadow_map.tif"), shadow_map)

    casi_unnormalized = loader.load_data(0, False).casi
    corrected = shadow_corrected_image(casi_unnormalized, shadow_map, device)
    imwrite(os.path.join(out, "muulf_hsi_shadow_corrected.tif"), corrected)
    draw_targets(loader.get_samples_color_list(), target_image, "Targets", out)

    target_image = reassign_shadow_contours(shadow_map, target_image)
    draw_targets(loader.get_samples_color_list(), target_image,
                 "Targets after shadow correction", out)
    valid = target_image != INVALID_TARGET_VALUE
    target_image[valid] = target_image[valid] + 1  # back to 1-indexed GT
    imwrite(os.path.join(out, "muulf_gt_shadow_corrected.tif"), target_image)
    return {"muulf_shadow_map.tif": shadow_map, "muulf_hsi_shadow_corrected.tif": corrected,
            "muulf_gt_shadow_corrected.tif": target_image}


if __name__ == "__main__":
    main()
