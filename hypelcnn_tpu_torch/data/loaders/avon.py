"""AVON loader: 360-band scene, no LiDAR, 2 classes from BMP target masks
with shadow and non-shadow variants (``hypelcnn_tpu/data/loaders/avon.py``).

The raw cube is stored ``(bands, W, H)``; ``BLANK_OFFSET`` trims the last
(spatial) axis before the axis swap to ``(H', W, bands)``, and the same trim
applies to the masks' leading axis. Each band is clipped at its 95th
percentile and normalized with ``casi_min = 0``; ``load_shadow_corrected``
reads the shadow-corrected cube instead. Shadow targets go to validation.
"""

from __future__ import annotations

import numpy as np

from hypelcnn_tpu_torch.core.registry import register_loader
from hypelcnn_tpu_torch.data.loaders.base import DataLoader, SampleSet, load_shadow_map_common
from hypelcnn_tpu_torch.data.scene import Scene
from hypelcnn_tpu_torch.data.splitters import (
    read_targets_from_image,
    shuffle_test_data_using_ratio,
    shuffle_training_data_using_size,
)
from hypelcnn_tpu_torch.utils.tiff_io import find_scene_file, imread, read_bmp

BLANK_OFFSET = 55
SCENE_FILE = "0920-1857.georef_cropped.tif"
CORRECTED_SCENE_FILE = "0920-1857.georef_cropped_shcorrected.tif"
SHADOW_FILE = "0920-1857.georef_cropped_shadow.tif"
TARGET_FILE = "0920-1857.georef_cropped_rgb_with_targets_{}.bmp"  # 1_nsh, 1_sh, 2_nsh, 2_sh


@register_loader("AVONDataLoader")
@register_loader("AVONDATALoader")  # the reference's help-string spelling
class AVONDataLoader(DataLoader):
    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self.load_shadow_corrected = False

    def load_data(self, neighborhood: int, normalize: bool) -> Scene:
        if self.load_shadow_corrected:
            casi = imread(find_scene_file(self.get_model_base_dir() + CORRECTED_SCENE_FILE))
        else:
            casi = imread(find_scene_file(
                self.get_model_base_dir() + SCENE_FILE))[:, :, BLANK_OFFSET:-BLANK_OFFSET]
            casi = np.swapaxes(casi, 0, 2)
        casi = casi.astype(np.uint16)
        upper = np.percentile(casi, 95, axis=[0, 1]).astype(casi.dtype)
        np.clip(casi, None, upper, out=casi)
        return Scene(casi=casi, lidar=None, neighborhood=neighborhood,
                     normalize=normalize, casi_min=0)

    def load_shadow_map(self, neighborhood: int, data_set):
        return load_shadow_map_common(
            data_set, neighborhood, find_scene_file(self.get_model_base_dir() + SHADOW_FILE))

    def load_samples(self, train_data_ratio: float, test_data_ratio: float) -> SampleSet:
        non_shadow_t1 = self.read_each_target(TARGET_FILE.format("1_nsh"), target_no=1)
        shadow_t1 = self.read_each_target(TARGET_FILE.format("1_sh"), target_no=1)
        non_shadow_t2 = self.read_each_target(TARGET_FILE.format("2_nsh"), target_no=2)
        shadow_t2 = self.read_each_target(TARGET_FILE.format("2_sh"), target_no=2)

        if train_data_ratio < 1.0:
            # the reference splits these with the test-set splitter
            train_t1, val_t1 = shuffle_test_data_using_ratio(non_shadow_t1, train_data_ratio)
            train_t2, val_t2 = shuffle_test_data_using_ratio(non_shadow_t2, train_data_ratio)
        else:
            train_t1, val_t1 = shuffle_training_data_using_size(
                self.get_class_count(), non_shadow_t1, int(train_data_ratio), None)
            train_t2, val_t2 = shuffle_training_data_using_size(
                self.get_class_count(), non_shadow_t2, int(train_data_ratio), None)

        train_set = np.vstack([train_t1, train_t2])
        validation_set = np.vstack([shadow_t1, shadow_t2, val_t1, val_t2])
        test_set, train_set = shuffle_test_data_using_ratio(train_set, test_data_ratio)
        return SampleSet(training_targets=train_set, test_targets=test_set,
                         validation_targets=validation_set)

    def read_each_target(self, target_image_path: str, target_no: int) -> np.ndarray:
        """A target mask (white = target) -> (x, y, target_no - 1) rows."""
        path = find_scene_file(self.get_model_base_dir() + target_image_path)
        image = np.load(path) if path.endswith(".npy") else read_bmp(path)
        image = image[BLANK_OFFSET:-BLANK_OFFSET, :]
        if image.dtype == bool:
            image = image.astype(np.uint8) * 255
        targets = ((image / 255).astype(int) * target_no) - 1
        return read_targets_from_image(targets, self.get_class_count())

    def read_targets(self, target_image_path: str) -> np.ndarray:
        targets = imread(find_scene_file(self.get_model_base_dir() + target_image_path))
        return read_targets_from_image(targets, self.get_class_count())

    def get_class_count(self) -> range:
        return range(0, 2)

    def get_samples_color_list(self) -> np.ndarray:
        return np.array([[0, 0, 255], [255, 0, 0]], dtype=np.uint8)

    def get_model_base_dir(self) -> str:
        return self.base_dir + "/AVON/"

    def get_band_measurements(self) -> np.ndarray:
        return np.linspace(400, 2500, num=360)

    def get_shadow_checkpoints(self):
        return {
            "cycle_gan": "shadow_gen_model/cycle_gan/model.ckpt-7000",
            "dcl_gan": "shadow_gen_model/dcl_gan/model.ckpt-6000",
            "dcl_cycle_gan": "shadow_gen_model/dcl_cycle_gan/model.ckpt-3000",
        }
