"""Pairing samplers for unpaired shadow / lit GAN training sets
(``hypelcnn_tpu/gan/sampling.py``, copied: numpy and scipy only).

Four strategies (random, neighbour, target, dummy) with row-major pixel
order and the same trim and repeat rules; the windows are cut with numpy
fancy indexing over a sliding-window view of the padded scene.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Tuple

import numpy as np
from scipy import ndimage


def _window_view(scene, ys, xs) -> np.ndarray:
    """Gather [N, k, k, C] windows at (row, col) positions from the padded
    scene (equivalent of per-pixel get_data_point calls)."""
    k = 2 * scene.neighborhood + 1
    parts = []
    for plane in (scene.casi, scene.lidar):
        if plane is None:
            continue
        if k == 1:
            parts.append(plane[ys, xs][:, None, None, :])
        else:
            win = np.lib.stride_tricks.sliding_window_view(plane, (k, k), axis=(0, 1))
            parts.append(np.transpose(win[ys, xs], (0, 2, 3, 1)))
    return np.concatenate(parts, axis=-1).astype(np.float32)


def _unpadded_shadow_map(shadow_map: np.ndarray, neighborhood: int) -> np.ndarray:
    if neighborhood > 0:
        return shadow_map[neighborhood:-neighborhood, neighborhood:-neighborhood]
    return shadow_map


class Sampler(ABC):
    @abstractmethod
    def get_sample_pairs(self, data_set, loader, shadow_map
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (normal_data, shadow_data) as [N, k, k, C] float32."""


class RandomBasedSampler(Sampler):
    """All shadow pixels paired against all lit pixels, shadow data repeated
    to match the lit count."""

    def __init__(self, multiply_shadowed_data: bool) -> None:
        self._multiply_shadowed_data = multiply_shadowed_data

    def get_sample_pairs(self, data_set, loader, shadow_map):
        sm = _unpadded_shadow_map(np.asarray(shadow_map), data_set.neighborhood)
        sh_rows, sh_cols = np.nonzero(sm == 1)
        no_rows, no_cols = np.nonzero(sm != 1)
        shadow = _window_view(data_set, sh_rows, sh_cols)
        normal = _window_view(data_set, no_rows, no_cols)
        if self._multiply_shadowed_data and shadow.shape[0] > 0:
            shadow = np.repeat(shadow, repeats=normal.shape[0] // shadow.shape[0], axis=0)
        normal = normal[: shadow.shape[0]]
        return normal, shadow


class NeighborhoodBasedSampler(Sampler):
    """Lit samples from a dilation ring around the shadow mask."""

    def __init__(self, neighborhood_size: int, margin: int) -> None:
        self._neighborhood_size = neighborhood_size
        self._margin = margin

    def get_sample_pairs(self, data_set, loader, shadow_map):
        sm = _unpadded_shadow_map(np.asarray(shadow_map), data_set.neighborhood)
        ring = (ndimage.binary_dilation(sm, iterations=self._neighborhood_size).astype(sm.dtype)
                - ndimage.binary_dilation(sm, iterations=self._margin).astype(sm.dtype))
        sh_rows, sh_cols = np.nonzero(sm == 1)
        no_rows, no_cols = np.nonzero(ring == 1)
        shadow = _window_view(data_set, sh_rows, sh_cols)
        normal = _window_view(data_set, no_rows, no_cols)
        normal = normal[: shadow.shape[0]]
        return normal, shadow


class TargetBasedSampler(Sampler):
    """Class-balanced pairing from a classification map, margin-filtered."""

    def __init__(self, margin: int) -> None:
        self._margin = margin

    def get_sample_pairs(self, data_set, loader, shadow_map):
        targets = loader.read_targets("shadow_gen_model/class_result.tif")
        # target coordinates are scene-frame; trim the neighborhood padding
        # off the shadow map like the sibling samplers do, or membership
        # shifts by `neighborhood` pixels
        sm = _unpadded_shadow_map(np.asarray(shadow_map), data_set.neighborhood)
        h, w = data_set.get_scene_shape()
        valid = ((targets[:, 1] > self._margin) & (targets[:, 1] < h - self._margin)
                 & (targets[:, 0] > self._margin) & (targets[:, 0] < w - self._margin)
                 & (targets[:, 2] >= 0))
        targets = targets[valid]
        in_shadow = sm[targets[:, 1], targets[:, 0]] == 1

        class_count = loader.get_class_count().stop
        normal_list, shadow_list = [], []
        for cls in range(class_count):
            cls_mask = targets[:, 2] == cls
            sh = targets[cls_mask & in_shadow]
            no = targets[cls_mask & ~in_shadow]
            if sh.shape[0] == 0:
                continue
            if no.shape[0] == 0:
                print(f"Target key is not found in read target image during "
                      f"target based sampling:{cls}")
                continue
            mult, rem = divmod(no.shape[0], sh.shape[0])
            sh_data = _window_view(data_set, sh[:, 1], sh[:, 0])
            no_data = _window_view(data_set, no[:, 1], no[:, 0])
            sh_exp = np.vstack([np.repeat(sh_data, mult, axis=0), sh_data[:rem]])
            normal_list.append(no_data)
            shadow_list.append(sh_exp)
        return np.vstack(normal_list), np.vstack(shadow_list)


class DummySampler(Sampler):
    """Constant-valued smoke-test pairs."""

    def __init__(self, element_count: int, fill_value: float, coefficient: float) -> None:
        self._element_count = element_count
        self._fill_value = fill_value
        self._coefficient = coefficient

    def get_sample_pairs(self, data_set, loader, shadow_map):
        shape = [self._element_count] + data_set.get_data_shape()
        shadow = np.full(shape, self._fill_value, dtype=np.float32)
        return shadow * self._coefficient, shadow


def read_hsi_data(loader, data_set, shadow_map, pairing_method: str,
                  sampling_method_map) -> Tuple[np.ndarray, np.ndarray]:
    """Sample pairs trimmed to CASI bands only."""
    if pairing_method not in sampling_method_map:
        raise ValueError(f"Wrong sampling parameter value ({pairing_method}).")
    normal, shadow = sampling_method_map[pairing_method].get_sample_pairs(
        data_set, loader, shadow_map)
    bands = data_set.get_casi_band_count()
    return normal[:, :, :, :bands], shadow[:, :, :, :bands]
