"""Synthetic datasets in the real loaders' file layouts.

Each writer fills ``root`` (the loader's ``--path``) with the files its
loader opens, under the names it opens them, as TIFF (and BMP) through
:mod:`hypelcnn_tpu_torch.utils.tiff_io`. The content comes from the
class-separable synthetic generator
(:class:`~hypelcnn_tpu_torch.data.loaders.synthetic.SyntheticDataLoader`),
cast to the real files' dtypes; the defaults are the datasets' published
sizes where they are known. Each returns the arrays it wrote, by role, so a
caller can build the scene its loader should read from them.
"""

from __future__ import annotations

import os

import numpy as np

from hypelcnn_tpu_torch.data.loaders.avon import BLANK_OFFSET, SCENE_FILE, SHADOW_FILE, TARGET_FILE
from hypelcnn_tpu_torch.data.loaders.grss2013 import GRSS2013DataLoader
from hypelcnn_tpu_torch.data.loaders.grss2018 import GRSS2018DataLoader
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.utils.tiff_io import imwrite, write_bmp

UNLABELLED = 255
# GRSS2013's sample images label 2,832 (TR) and 12,197 (VA) of 349 x 1905 pixels
GRSS2013_TRAINING_FRACTION = 2832 / (349 * 1905)
GRSS2013_VALIDATION_FRACTION = 12197 / (349 * 1905)


def _generated(height: int, width: int, bands: int, classes: int, seed: int):
    return SyntheticDataLoader(f"synthetic://?h={height}&w={width}&bands={bands}"
                               f"&classes={classes}&seed={seed}").scene_arrays()


def _directory(root: str, name: str) -> str:
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    return path


def _blocky_mask(rng, height: int, width: int, fraction: float, block: int = 16) -> np.ndarray:
    coarse = rng.random((-(-height // block), -(-width // block))) < fraction
    return np.kron(coarse, np.ones((block, block), dtype=bool))[:height, :width]


def write_grss2013(root: str, height: int = 349, width: int = 1905, bands: int = 144,
                   seed: int = 7, training_fraction: float = GRSS2013_TRAINING_FRACTION,
                   validation_fraction: float = GRSS2013_VALIDATION_FRACTION) -> dict:
    """``2013_DFTC/``: a ``bands``-page uint16 CASI, a float32 LiDAR, the TR
    and VA uint8 sample images (classes 0..14, 255 unlabelled, disjoint) and
    a uint8 shadow map."""
    gt, casi, lidar = _generated(height, width, bands, 15, seed)
    rng = np.random.default_rng(seed + 1)
    draw = rng.random(gt.shape)
    training = np.where(draw < training_fraction, gt, UNLABELLED).astype(np.uint8)
    validation = np.where((draw >= training_fraction)
                          & (draw < training_fraction + validation_fraction),
                          gt, UNLABELLED).astype(np.uint8)
    arrays = {"casi": casi, "lidar": lidar[:, :, 0], "training": training,
              "validation": validation,
              "shadow_map": _blocky_mask(rng, height, width, 0.2).astype(np.uint8)}
    folder = _directory(root, "2013_DFTC")
    for role, name in (("casi", GRSS2013DataLoader.CASI_FILE),
                       ("lidar", GRSS2013DataLoader.LIDAR_FILE),
                       ("training", GRSS2013DataLoader.TRAINING_FILE),
                       ("validation", GRSS2013DataLoader.VALIDATION_FILE),
                       ("shadow_map", GRSS2013DataLoader.SHADOW_FILE)):
        imwrite(os.path.join(folder, name), arrays[role])
    return arrays


def write_grss2018(root: str, casi_height: int = 1202, casi_width: int = 4172, bands: int = 50,
                   gt_width: int = 4768, seed: int = 7, labelled_fraction: float = 0.1,
                   outlier_fraction: float = 0.001) -> dict:
    """``2018_DFTC/``: CASI ``casi_height x casi_width x bands`` uint16 at
    half the LiDAR's resolution, LiDAR ``2 casi_height x 2 casi_width``
    float32 with some values above 300, and the GT ``casi_height x gt_width``
    uint8 (classes 1..20, 0 unlabelled), which the loader shifts by
    (1194, 1202) into LiDAR space, so ``casi_height`` must be at least 1202.

    The class map at LiDAR resolution is the CASI's, doubled."""
    x_delta, y_delta = GRSS2018DataLoader.X_DELTA, GRSS2018DataLoader.Y_DELTA
    if casi_height < y_delta or x_delta + gt_width > 2 * casi_width:
        raise ValueError(f"a {casi_height} x {casi_width} CASI cannot hold the GT at "
                         f"({x_delta}, {y_delta}) + {casi_height} x {gt_width} in LiDAR space")
    gt, casi, lidar = _generated(casi_height, casi_width, bands, 20, seed)
    rng = np.random.default_rng(seed + 1)
    lidar = np.repeat(np.repeat(lidar[:, :, 0], 2, axis=0), 2, axis=1)
    lidar[rng.random(lidar.shape) < outlier_fraction] = np.float32(500)
    classes = np.repeat(np.repeat(gt, 2, axis=0), 2, axis=1)[
        y_delta:y_delta + casi_height, x_delta:x_delta + gt_width]
    labels = np.where(rng.random(classes.shape) < labelled_fraction, classes + 1, 0)
    arrays = {"casi": casi, "lidar": lidar, "gt": labels.astype(np.uint8)}
    folder = _directory(root, "2018_DFTC")
    for role, name in (("casi", GRSS2018DataLoader.CASI_FILE),
                       ("lidar", GRSS2018DataLoader.LIDAR_FILE),
                       ("gt", GRSS2018DataLoader.GT_FILE)):
        imwrite(os.path.join(folder, name), arrays[role])
    return arrays


def write_gulfport(root: str, height: int = 325, width: int = 220, bands: int = 64,
                   seed: int = 7, labelled_fraction: float = 0.75) -> dict:
    """``GULFPORT/`` (MUUFL Gulfport): float32 reflectance-like HSI and its
    shadowed (x 0.4) and deshadowed (x 2.5 in the shadow) variants, a float32
    LiDAR, the GT and the shadow-corrected GT (classes 1..11, 255
    unlabelled) and a uint8 shadow map."""
    gt, casi, lidar = _generated(height, width, bands, 11, seed)
    rng = np.random.default_rng(seed + 1)
    hsi = (casi / np.float32(10000)).astype(np.float32)
    shadow = _blocky_mask(rng, height, width, 0.25)
    labels = np.where(rng.random(gt.shape) < labelled_fraction, gt + 1, UNLABELLED)
    arrays = {"hsi": hsi, "lidar": lidar[:, :, 0], "gt": labels.astype(np.uint8),
              "hsi_shadowed": hsi * np.float32(0.4),
              "hsi_deshadowed": hsi * np.where(shadow, np.float32(2.5), np.float32(1))[:, :, None],
              "shadow_map": shadow.astype(np.uint8)}
    folder = _directory(root, "GULFPORT")
    for role, name in (("hsi", "muulf_hsi"), ("lidar", "muulf_lidar"), ("gt", "muulf_gt"),
                       ("hsi_shadowed", "muulf_hsi_shadowed"),
                       ("hsi_deshadowed", "muulf_hsi_deshadowed"),
                       ("gt", "muulf_gt_shadow_corrected"), ("shadow_map", "muulf_shadow_map")):
        imwrite(os.path.join(folder, name + ".tif"), arrays[role])
    return arrays


def write_avon(root: str, height: int = 500, width: int = 300, bands: int = 360,
               seed: int = 7) -> dict:
    """``AVON/``: the uint16 cube stored ``(bands, width, height + 110)``
    (``BLANK_OFFSET`` blank rows at each end of the last axis, one page per
    row), a uint8 shadow map, and four 1-bit BMP masks of ``height + 110``
    rows: targets 1 and 2 (classes 1 and 2 of a 3-class map), each split
    into its lit (``nsh``) and shadowed (``sh``) pixels."""
    gt, casi, _ = _generated(height, width, bands, 3, seed)
    rng = np.random.default_rng(seed + 1)
    shadow = _blocky_mask(rng, height, width, 0.3)
    cube = np.zeros((bands, width, height + 2 * BLANK_OFFSET), dtype=np.uint16)
    cube[:, :, BLANK_OFFSET:-BLANK_OFFSET] = np.swapaxes(casi, 0, 2)
    arrays = {"casi": casi, "cube": cube, "shadow_map": shadow.astype(np.uint8)}
    folder = _directory(root, "AVON")
    imwrite(os.path.join(folder, SCENE_FILE), cube)
    imwrite(os.path.join(folder, SHADOW_FILE), arrays["shadow_map"])
    for target in (1, 2):
        for suffix, in_shadow in (("nsh", False), ("sh", True)):
            mask = np.zeros((height + 2 * BLANK_OFFSET, width), dtype=bool)
            mask[BLANK_OFFSET:-BLANK_OFFSET] = (gt == target) & (shadow == in_shadow)
            arrays[f"{target}_{suffix}"] = mask
            write_bmp(os.path.join(folder, TARGET_FILE.format(f"{target}_{suffix}")), mask)
    return arrays
