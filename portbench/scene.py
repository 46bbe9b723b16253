"""The benchmark's scene, made from the seed with NumPy.

GRSS2013's size (349 x 1905 pixels, 144 CASI bands plus one LiDAR band,
15 classes); the real TIFFs are not in the repository, so the content is
synthetic, by the recipe of the repository's synthetic loader: a blocky
class map (coarse noise upsampled by 8), a spectral signature per class
uniform in [500, 8000) plus Gaussian noise, clipped and stored as uint16,
and a LiDAR band of 3.7 per class id plus noise of deviation 0.3. The
noise is drawn in float32 (the loader draws float64 and rounds), which
halves the time; every draw comes from one generator in a fixed order.

Training targets: a seeded draw of distinct pixels, each labelled with its
class. Nothing here touches the program under test.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SceneArrays(NamedTuple):
    gt: np.ndarray      # [H, W] uint8 class map
    casi: np.ndarray    # [H, W, bands] uint16
    lidar: np.ndarray   # [H, W, 1] float32


def make_scene(spec: dict, seed: int) -> SceneArrays:
    """The scene of ``spec`` (``height``, ``width``, ``casi_bands``,
    ``classes``, ``noise``) drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    h, w, b, c = spec["height"], spec["width"], spec["casi_bands"], spec["classes"]
    coarse = rng.integers(0, c, size=(-(-h // 8), -(-w // 8)))
    gt = np.kron(coarse, np.ones((8, 8), dtype=np.int64))[:h, :w].astype(np.uint8)
    signatures = rng.uniform(500, 8000, size=(c, b)).astype(np.float32)
    casi = rng.standard_normal(size=(h, w, b), dtype=np.float32)
    casi *= np.float32(spec["noise"])
    casi += signatures[gt]
    casi = np.clip(casi, 0, None).astype(np.uint16)
    lidar = (gt.astype(np.float32)[:, :, None] * np.float32(3.7)
             + np.float32(0.3) * rng.standard_normal(size=(h, w, 1), dtype=np.float32))
    return SceneArrays(gt, casi, lidar)


def training_targets(gt: np.ndarray, count: int, seed: int) -> np.ndarray:
    """``[count, 3]`` int32 rows (x, y, class) of distinct pixels drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(gt.size, size=count, replace=False)
    ys, xs = np.divmod(flat, gt.shape[1])
    return np.stack([xs, ys, gt[ys, xs]], axis=1).astype(np.int32)


def sample_pixels(height: int, width: int, count: int, seed: int) -> np.ndarray:
    """``[count, 2]`` int64 (x, y) of distinct pixels drawn from ``seed``
    (every pixel where ``count`` reaches the scene's size)."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(height * width, size=min(count, height * width), replace=False)
    ys, xs = np.divmod(flat, width)
    return np.stack([xs, ys], axis=1)
