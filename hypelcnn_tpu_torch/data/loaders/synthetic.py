"""Synthetic dataset loader (``hypelcnn_tpu/data/loaders/synthetic.py``).

A deterministic procedurally generated scene whose classes are separable.
The arrays are bit for bit those of the JAX package: the same
``default_rng`` calls in the same order. The ``path`` argument is a spec
string: ``synthetic://?h=64&w=96&bands=144&classes=15&seed=7`` (all keys
optional).
"""

from __future__ import annotations

from urllib.parse import parse_qs, urlparse

import numpy as np

from hypelcnn_tpu_torch.core.registry import register_loader
from hypelcnn_tpu_torch.data.loaders.base import DataLoader, SampleSet, calculate_shadow_ratio
from hypelcnn_tpu_torch.data.scene import Scene
from hypelcnn_tpu_torch.data.splitters import (
    read_targets_from_image,
    shuffle_test_data_using_ratio,
    shuffle_training_data_using_ratio,
)


@register_loader("SyntheticDataLoader")
class SyntheticDataLoader(DataLoader):
    def __init__(self, path: str = "synthetic://"):
        path = str(path) if path else "synthetic://"
        if not path.startswith("synthetic:") or "//" not in path:
            raise ValueError(
                f"SyntheticDataLoader path must look like "
                f"'synthetic://?h=..&w=..&bands=..', got {path!r}")
        q = parse_qs(urlparse(path).query)
        self.height = int(q.get("h", [64])[0])
        self.width = int(q.get("w", [96])[0])
        self.bands = int(q.get("bands", [144])[0])
        self.classes = int(q.get("classes", [15])[0])
        self.seed = int(q.get("seed", [7])[0])
        self.noise = float(q.get("noise", [120.0])[0])
        self.base_dir = q.get("base", ["."])[0]
        self._gt = None
        self._casi = None
        self._lidar = None

    def _materialize(self):
        if self._gt is not None:
            return
        rng = np.random.default_rng(self.seed)
        h, w, b, c = self.height, self.width, self.bands, self.classes
        # blocky class map: coarse noise upsampled, so classes form regions
        coarse = rng.integers(0, c, size=(max(1, -(-h // 8)), max(1, -(-w // 8))))
        gt = np.kron(coarse, np.ones((8, 8), dtype=int))[:h, :w].astype(np.uint8)
        # distinct spectral signature per class + noise
        signatures = rng.uniform(500, 8000, size=(c, b)).astype(np.float32)
        casi = signatures[gt] + rng.normal(0, self.noise, size=(h, w, b)).astype(np.float32)
        casi = np.clip(casi, 0, None).astype(np.uint16)
        lidar = (gt.astype(np.float32)[:, :, None] * 3.7
                 + rng.normal(0, 0.3, size=(h, w, 1)).astype(np.float32))
        self._gt, self._casi, self._lidar = gt, casi, lidar

    def scene_arrays(self):
        """``(gt, casi, lidar)``: the ``[H, W]`` uint8 class map, the
        ``[H, W, bands]`` uint16 CASI and the ``[H, W, 1]`` float32 LiDAR."""
        self._materialize()
        return self._gt, self._casi, self._lidar

    def load_data(self, neighborhood: int, normalize: bool) -> Scene:
        self._materialize()
        return Scene(casi=self._casi.copy(), lidar=self._lidar.copy(),
                     neighborhood=neighborhood, normalize=normalize)

    def load_samples(self, train_data_ratio: float, test_data_ratio: float) -> SampleSet:
        """Every labelled pixel, split stratified into train / validation, then
        a stable test set carved out of train (draws from ``np.random``)."""
        self._materialize()
        result = read_targets_from_image(self._gt, self.get_class_count())
        train_set, validation_set = shuffle_training_data_using_ratio(result, train_data_ratio)
        test_set, train_set = shuffle_test_data_using_ratio(train_set, test_data_ratio)
        return SampleSet(training_targets=train_set, test_targets=test_set,
                         validation_targets=validation_set)

    def load_shadow_map(self, neighborhood: int, data_set):
        """The left third of the scene is in shadow."""
        self._materialize()
        shadow_map = np.zeros((self.height, self.width), dtype=np.uint8)
        shadow_map[:, : self.width // 3] = 1
        shadow_map = np.pad(shadow_map, neighborhood, mode="symmetric")
        ratio = None
        if data_set is not None:
            ratio = calculate_shadow_ratio(data_set.casi, shadow_map,
                                           np.logical_not(shadow_map).astype(int))
        return shadow_map, ratio

    def get_class_count(self) -> range:
        return range(0, self.classes)

    def get_model_base_dir(self) -> str:
        return self.base_dir if self.base_dir.endswith("/") else self.base_dir + "/"

    def get_shadow_checkpoints(self):
        """The real loaders' relative layout, so the frozen-generator shadow
        augmentation can run on a synthetic scene."""
        return {name: f"shadow_gen_model/{name}"
                for name in ("cycle_gan", "dcl_gan", "dcl_cycle_gan", "gan_x2y", "cut_x2y")}

    def get_samples_color_list(self) -> np.ndarray:
        rng = np.random.default_rng(3)
        return rng.integers(0, 255, size=(self.classes, 3)).astype(np.uint8)

    def get_band_measurements(self) -> np.ndarray:
        return np.linspace(380, 1050, num=self.bands)
