"""Dataset loader protocol (``hypelcnn_tpu/data/loaders/base.py``).

Loaders declare their pretrained shadow-generator checkpoints through
:meth:`DataLoader.get_shadow_checkpoints` and construct no GAN themselves;
the GAN slice of the port injects the augmenters.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import Dict, Optional, Tuple

import numpy as np

from hypelcnn_tpu_torch.utils.tiff_io import imread


@dataclass
class SampleSet:
    """Train/validation/test target arrays of (x, y, class) rows."""
    training_targets: np.ndarray
    test_targets: np.ndarray
    validation_targets: np.ndarray


class LoadingMode(Enum):
    ORIGINAL = ""
    SHADOWED = "shadowed"
    DESHADOWED = "deshadowed"
    MIXED = "mixed"


class DataLoader(ABC):
    @abstractmethod
    def load_data(self, neighborhood: int, normalize: bool):
        ...

    @abstractmethod
    def load_samples(self, train_data_ratio: float, test_data_ratio: float) -> SampleSet:
        ...

    @abstractmethod
    def load_shadow_map(self, neighborhood: int, data_set
                        ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        ...

    @abstractmethod
    def get_class_count(self) -> range:
        ...

    @abstractmethod
    def get_model_base_dir(self) -> str:
        ...

    @abstractmethod
    def get_samples_color_list(self) -> np.ndarray:
        ...

    @abstractmethod
    def get_band_measurements(self) -> np.ndarray:
        ...

    def get_shadow_checkpoints(self) -> Dict[str, str]:
        """name -> checkpoint path (relative to the model base dir) of the
        pretrained shadow generators; empty when the dataset has none."""
        return {}


def calculate_shadow_ratio(casi: np.ndarray, shadow_map: np.ndarray,
                           shadow_map_inverse: np.ndarray) -> np.ndarray:
    """Per-band mean(lit) / mean(shadow) ratio, as float32."""
    shadow_mask = shadow_map != 0
    lit_mask = shadow_map_inverse != 0
    flat = casi.reshape(-1, casi.shape[2])
    sh = flat[shadow_mask.reshape(-1)]
    lit = flat[lit_mask.reshape(-1)]
    ratio = lit.mean(axis=0) / sh.mean(axis=0)
    return np.asarray(ratio, dtype=np.float32)


def load_shadow_map_common(data_set, neighborhood: int, shadow_file_name: str):
    """The shadow map padded by the neighborhood, and its band ratio against
    ``data_set``'s CASI (``None`` without a data set)."""
    shadow_map = np.pad(imread(shadow_file_name), neighborhood, mode="symmetric")
    shadow_ratio = None
    if data_set is not None:
        shadow_ratio = calculate_shadow_ratio(
            data_set.casi, shadow_map, np.logical_not(shadow_map).astype(int))
    return shadow_map, shadow_ratio
