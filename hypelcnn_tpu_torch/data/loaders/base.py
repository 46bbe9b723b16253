"""Dataset loader protocol (``hypelcnn_tpu/data/loaders/base.py``).

The shadow-map side of the protocol (``load_shadow_map``,
``calculate_shadow_ratio``) comes with the GAN slice of the port.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass

import numpy as np


@dataclass
class SampleSet:
    """Train/validation/test target arrays of (x, y, class) rows."""
    training_targets: np.ndarray
    test_targets: np.ndarray
    validation_targets: np.ndarray


class DataLoader(ABC):
    @abstractmethod
    def load_data(self, neighborhood: int, normalize: bool):
        ...

    @abstractmethod
    def load_samples(self, train_data_ratio: float, test_data_ratio: float) -> SampleSet:
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
