"""GRSS2018 (Houston) loader: 48-band CASI at 0.5x the LiDAR's resolution,
20 classes (``hypelcnn_tpu/data/loaders/grss2018.py``).

Drops the last two CASI bands, zeroes LiDAR values above 300, shifts the GT
by x + 1194, y + 1202 into LiDAR space, and splits by ratio or by size. The
scene is a :class:`~hypelcnn_tpu_torch.data.scene.DualResScene`.
"""

from __future__ import annotations

import numpy as np

from hypelcnn_tpu_torch.core.registry import register_loader
from hypelcnn_tpu_torch.data.loaders.base import DataLoader, SampleSet
from hypelcnn_tpu_torch.data.scene import DualResScene
from hypelcnn_tpu_torch.data.splitters import (
    shuffle_test_data_using_ratio,
    shuffle_training_data_using_ratio,
    shuffle_training_data_using_size,
)
from hypelcnn_tpu_torch.utils.tiff_io import find_scene_file, imread

GRSS2018_COLORS = np.array([
    [0, 180, 0], [0, 124, 0], [0, 137, 69], [0, 69, 0], [255, 0, 0],
    [172, 125, 11], [0, 190, 194], [120, 0, 0], [216, 217, 247], [121, 121, 121],
    [255, 255, 0], [0, 155, 50], [0, 55, 55], [205, 172, 127], [220, 175, 120],
    [100, 100, 100], [185, 175, 94], [0, 237, 0], [207, 18, 56], [0, 0, 255],
], dtype=np.uint8)


@register_loader("GRSS2018DataLoader")
class GRSS2018DataLoader(DataLoader):
    X_DELTA = 1194
    Y_DELTA = 1202
    CASI_FILE = "20170218_UH_CASI_S4_NAD83.tiff"
    LIDAR_FILE = "UH17c_GEF051.tif"
    GT_FILE = "2018_IEEE_GRSS_DFC_GT_TR.tif"
    LIDAR_LIMIT = 300  # LiDAR values above it are set to 0

    def __init__(self, base_dir: str):
        self.base_dir = base_dir

    def load_data(self, neighborhood: int, normalize: bool) -> DualResScene:
        casi = imread(find_scene_file(self.get_model_base_dir() + self.CASI_FILE))[:, :, 0:-2]
        lidar = imread(find_scene_file(self.get_model_base_dir() + self.LIDAR_FILE))
        lidar = lidar[:, :, np.newaxis].copy()
        lidar[np.where(lidar > self.LIDAR_LIMIT)] = 0
        return DualResScene(casi=casi, lidar=lidar, neighborhood=neighborhood,
                            normalize=normalize)

    def load_samples(self, train_data_ratio: float, test_data_ratio: float) -> SampleSet:
        targets = imread(find_scene_file(self.get_model_base_dir() + self.GT_FILE))
        result = np.array([], dtype=int).reshape(0, 3)
        for target_index in range(1, 21):
            ys, xs = np.where(targets == target_index)
            locs = np.stack([xs.astype(int) + self.X_DELTA,
                             ys.astype(int) + self.Y_DELTA], axis=1)
            cls = np.full((len(locs), 1), target_index - 1)  # classes 0..19
            result = np.vstack([result, np.hstack([locs, cls])])

        if train_data_ratio < 1.0:
            train_set, validation_set = shuffle_training_data_using_ratio(result, train_data_ratio)
        else:
            train_set, validation_set = shuffle_training_data_using_size(
                self.get_class_count(), result, int(train_data_ratio), None)
        test_set, train_set = shuffle_test_data_using_ratio(train_set, test_data_ratio)
        return SampleSet(training_targets=train_set, test_targets=test_set,
                         validation_targets=validation_set)

    def load_shadow_map(self, neighborhood: int, data_set):
        return None, None

    def get_class_count(self) -> range:
        return range(0, 20)

    def get_model_base_dir(self) -> str:
        return self.base_dir + "/2018_DFTC/"

    def get_samples_color_list(self) -> np.ndarray:
        return GRSS2018_COLORS.copy()

    def get_band_measurements(self) -> np.ndarray:
        return np.linspace(380, 1050, num=48)
