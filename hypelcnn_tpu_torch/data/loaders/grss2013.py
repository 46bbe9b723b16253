"""GRSS2013 (Houston) loader: 144-band CASI + LiDAR, 15 classes
(``hypelcnn_tpu/data/loaders/grss2013.py``).

Fixed TR/VA sample images, a test split carved from training with the run
seed, the class colors and band wavelengths of the reference.
"""

from __future__ import annotations

import numpy as np

from hypelcnn_tpu_torch.core.registry import register_loader
from hypelcnn_tpu_torch.data.loaders.base import DataLoader, SampleSet, load_shadow_map_common
from hypelcnn_tpu_torch.data.scene import Scene
from hypelcnn_tpu_torch.data.splitters import read_targets_from_image, shuffle_test_data_using_ratio
from hypelcnn_tpu_torch.utils.tiff_io import find_scene_file, imread

GRSS2013_COLORS = np.array([
    [0, 180, 0],      # Grass Healthy
    [0, 124, 0],      # Grass Stressed
    [0, 137, 69],     # Grass Synthetic
    [0, 69, 0],       # Tree
    [172, 125, 11],   # Soil
    [0, 190, 194],    # Water
    [120, 0, 0],      # Residential
    [216, 217, 247],  # Commercial
    [121, 121, 121],  # Road
    [205, 172, 127],  # Highway
    [220, 175, 120],  # Railway
    [100, 100, 100],  # Parking lot 1
    [185, 175, 94],   # Parking lot 2
    [0, 237, 0],      # Tennis lot
    [207, 18, 56],    # Running track
], dtype=np.uint8)


@register_loader("GRSS2013DataLoader")
class GRSS2013DataLoader(DataLoader):
    CASI_FILE = "2013_IEEE_GRSS_DF_Contest_CASI.tif"
    LIDAR_FILE = "2013_IEEE_GRSS_DF_Contest_LiDAR.tif"
    TRAINING_FILE = "2013_IEEE_GRSS_DF_Contest_Samples_TR.tif"
    VALIDATION_FILE = "2013_IEEE_GRSS_DF_Contest_Samples_VA.tif"
    SHADOW_FILE = "shadow_map.tif"

    def __init__(self, base_dir: str):
        self.base_dir = base_dir

    def load_data(self, neighborhood: int, normalize: bool) -> Scene:
        casi = imread(find_scene_file(self.get_model_base_dir() + self.CASI_FILE))
        lidar = imread(find_scene_file(self.get_model_base_dir() + self.LIDAR_FILE))
        lidar = lidar[:, :, np.newaxis]
        return Scene(casi=casi, lidar=lidar, neighborhood=neighborhood, normalize=normalize)

    def load_shadow_map(self, neighborhood: int, data_set):
        return load_shadow_map_common(data_set, neighborhood,
                                      find_scene_file(self.get_model_base_dir() + self.SHADOW_FILE))

    def load_samples(self, train_data_ratio: float, test_data_ratio: float) -> SampleSet:
        train_set = self.read_targets(self.TRAINING_FILE)
        validation_set = self.read_targets(self.VALIDATION_FILE)
        test_set, train_set = shuffle_test_data_using_ratio(train_set, test_data_ratio)
        return SampleSet(training_targets=train_set, test_targets=test_set,
                         validation_targets=validation_set)

    def read_targets(self, target_image_name: str) -> np.ndarray:
        targets = imread(find_scene_file(self.get_model_base_dir() + target_image_name))
        return read_targets_from_image(targets, self.get_class_count())

    def get_class_count(self) -> range:
        return range(0, 15)

    def get_model_base_dir(self) -> str:
        return self.base_dir + "/2013_DFTC/"

    def get_samples_color_list(self) -> np.ndarray:
        return GRSS2013_COLORS.copy()

    def get_band_measurements(self) -> np.ndarray:
        return np.linspace(380, 1050, num=144)

    def get_shadow_checkpoints(self):
        return {
            "cycle_gan": "shadow_gen_model/cycle_gan/model.ckpt-5000",
            "dcl_gan": "shadow_gen_model/dcl_gan/model.ckpt-3000",
            "dcl_cycle_gan": "shadow_gen_model/dcl_cycle_gan/model.ckpt-5000",
        }
