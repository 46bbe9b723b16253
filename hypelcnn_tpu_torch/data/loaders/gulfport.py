"""GULFPORT (MUUFL) loader: 64-band HSI + LiDAR, 11 classes
(``hypelcnn_tpu/data/loaders/gulfport.py``).

The GT's classes 1..11 become 0..10; splits by ratio or by size.
"""

from __future__ import annotations

import numpy as np

from hypelcnn_tpu_torch.core.registry import register_loader
from hypelcnn_tpu_torch.data.loaders.base import DataLoader, SampleSet
from hypelcnn_tpu_torch.data.scene import Scene
from hypelcnn_tpu_torch.data.splitters import (
    read_targets_from_image,
    shuffle_test_data_using_ratio,
    shuffle_training_data_using_ratio,
    shuffle_training_data_using_size,
)
from hypelcnn_tpu_torch.utils.tiff_io import find_scene_file, imread

GULFPORT_COLORS = np.array([
    [0, 128, 0],      # trees
    [25, 255, 25],    # grass_pure
    [0, 255, 255],    # grass_groundsurface
    [255, 204, 0],    # dirt_and_sand
    [255, 20, 67],    # road_materials
    [0, 0, 204],      # water
    [102, 0, 204],    # shadow_building
    [255, 132, 156],  # buildings
    [204, 102, 0],    # sidewalk
    [255, 255, 207],  # yellowcurb
    [208, 45, 115],   # cloth_panels
], dtype=np.uint8)


@register_loader("GULFPORTDataLoader")
class GULFPORTDataLoader(DataLoader):
    def __init__(self, base_dir: str):
        self._base_dir = base_dir
        self._hsi_file = "muulf_hsi"
        self._lidar_file = "muulf_lidar"
        self._file_ext = ".tif"

    def load_data(self, neighborhood: int, normalize: bool) -> Scene:
        return self._load_data_utility(self._hsi_file + self._file_ext,
                                       self._lidar_file + self._file_ext,
                                       neighborhood, normalize)

    def _load_data_utility(self, hsi_file, lidar_file, neighborhood, normalize,
                           casi_min=None, casi_max=None) -> Scene:
        casi = imread(find_scene_file(self.get_model_base_dir() + hsi_file))
        lidar = np.expand_dims(
            imread(find_scene_file(self.get_model_base_dir() + lidar_file)), axis=2)
        return Scene(casi=casi, lidar=lidar, neighborhood=neighborhood,
                     normalize=normalize, casi_min=casi_min, casi_max=casi_max)

    def load_samples(self, train_data_ratio: float, test_data_ratio: float) -> SampleSet:
        result = self.read_targets("muulf_gt.tif")
        if train_data_ratio < 1.0:
            train_set, validation_set = shuffle_training_data_using_ratio(result, train_data_ratio)
        else:
            train_set, validation_set = shuffle_training_data_using_size(
                self.get_class_count(), result, int(train_data_ratio), None)
        test_set, train_set = shuffle_test_data_using_ratio(train_set, test_data_ratio)
        return SampleSet(training_targets=train_set, test_targets=test_set,
                         validation_targets=validation_set)

    def read_targets(self, target_image_path: str) -> np.ndarray:
        targets = imread(find_scene_file(self.get_model_base_dir() + target_image_path))
        return self._convert_targets_aux(targets)

    @staticmethod
    def _convert_targets_aux(targets: np.ndarray) -> np.ndarray:
        """GT classes 1..11 -> (x, y, 0..10) rows."""
        return read_targets_from_image(targets, range(1, 12)) - [0, 0, 1]

    def load_shadow_map(self, neighborhood: int, data_set):
        return None, None

    def get_class_count(self) -> range:
        return range(0, 11)

    def get_samples_color_list(self) -> np.ndarray:
        return GULFPORT_COLORS.copy()

    def get_model_base_dir(self) -> str:
        return self._base_dir + "/GULFPORT/"

    def get_band_measurements(self) -> np.ndarray:
        return np.linspace(405, 1005, 64)
