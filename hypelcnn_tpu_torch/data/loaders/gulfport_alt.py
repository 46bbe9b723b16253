"""Shadow-aware GULFPORT loader (``hypelcnn_tpu/data/loaders/gulfport_alt.py``).

- ``load_mode`` picks the original scene, the pre-translated
  ``muulf_hsi_shadowed`` or ``_deshadowed`` variant (normalized with the
  original's ``casi_min``/``casi_max``), or MIXED: a
  :class:`~hypelcnn_tpu_torch.data.scene.MultiScene` of the original and
  the shadowed variant three times, so that a window comes from the
  shadowed one with probability 3/4.
- ``load_samples`` splits the shadow-corrected GT by the shadow map:
  training targets from the lit area only, the shadow targets added to
  validation, and an empty test set.
"""

from __future__ import annotations

import numpy as np

from hypelcnn_tpu_torch.core.registry import register_loader
from hypelcnn_tpu_torch.data.loaders.base import LoadingMode, SampleSet, load_shadow_map_common
from hypelcnn_tpu_torch.data.loaders.gulfport import GULFPORTDataLoader
from hypelcnn_tpu_torch.data.scene import MultiScene
from hypelcnn_tpu_torch.data.splitters import (
    shuffle_training_data_using_ratio,
    shuffle_training_data_using_size,
)
from hypelcnn_tpu_torch.utils.tiff_io import find_scene_file, imread

INVALID_TARGET_VALUE = 255


@register_loader("GULFPORTALTDataLoader")
class GULFPORTALTDataLoader(GULFPORTDataLoader):
    def __init__(self, base_dir: str):
        super().__init__(base_dir)
        self.load_mode = LoadingMode.ORIGINAL

    def load_data(self, neighborhood: int, normalize: bool):
        def _load_original():
            return self._load_data_utility(self._hsi_file + self._file_ext,
                                           self._lidar_file + self._file_ext,
                                           neighborhood, normalize)

        def _load_augmented(mode_val, casi_min, casi_max):
            return self._load_data_utility(
                self._hsi_file + "_" + mode_val + self._file_ext,
                self._lidar_file + self._file_ext,
                neighborhood, normalize, casi_min=casi_min, casi_max=casi_max)

        if self.load_mode in (LoadingMode.SHADOWED, LoadingMode.DESHADOWED):
            original = _load_original()
            return _load_augmented(self.load_mode.value, original.casi_min, original.casi_max)
        if self.load_mode is LoadingMode.MIXED:
            original = _load_original()
            shadowed = _load_augmented(LoadingMode.SHADOWED.value,
                                       original.casi_min, original.casi_max)
            return MultiScene([original, shadowed, shadowed, shadowed])
        return _load_original()

    def load_samples(self, train_data_ratio: float, test_data_ratio: float) -> SampleSet:
        shadow_map, _ = self.load_shadow_map(0, None)
        targets = imread(find_scene_file(
            self.get_model_base_dir() + "muulf_gt_shadow_corrected.tif"))

        targets_with_shadow = np.copy(targets)
        targets_with_shadow[np.logical_not(shadow_map)] = INVALID_TARGET_VALUE
        result_with_shadow = self._convert_targets_aux(targets_with_shadow)

        targets_in_clear_area = np.copy(targets)
        targets_in_clear_area[shadow_map.astype(bool)] = INVALID_TARGET_VALUE
        result_in_clear_area = self._convert_targets_aux(targets_in_clear_area)

        if train_data_ratio < 1.0:
            train_set, validation_set = shuffle_training_data_using_ratio(
                result_in_clear_area, train_data_ratio)
        else:
            train_set, validation_set = shuffle_training_data_using_size(
                self.get_class_count(), result_in_clear_area, int(train_data_ratio), None)

        test_set = np.empty([0, train_set.shape[1]])
        validation_set = np.vstack([validation_set, result_with_shadow])
        return SampleSet(training_targets=train_set, test_targets=test_set,
                         validation_targets=validation_set)

    def load_shadow_map(self, neighborhood: int, data_set):
        return load_shadow_map_common(
            data_set, neighborhood,
            find_scene_file(self.get_model_base_dir() + "muulf_shadow_map.tif"))

    def get_shadow_checkpoints(self):
        return {
            "cycle_gan": "shadow_gen_model/cycle_gan/model.ckpt-3000",
            "dcl_gan": "shadow_gen_model/dcl_gan/model.ckpt-3000",
            "dcl_cycle_gan": "shadow_gen_model/dcl_cycle_gan/v1/model.ckpt-3000",
        }
