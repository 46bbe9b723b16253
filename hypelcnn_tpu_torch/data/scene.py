"""The scene container: padding, normalization and residence on the device.

Port of ``Scene`` in ``hypelcnn_tpu/data/scene.py``: symmetric-pads CASI and
LiDAR by the neighborhood, min/max-normalizes CASI per band and LiDAR as a
whole, in the same numpy code, so the host arrays are bit for bit the JAX
ones. :meth:`Scene.device_scene` fuses them into one contiguous NHWC float32
``[Hp, Wp, C + 1]`` tensor on a device, from which
:mod:`hypelcnn_tpu_torch.ops.window_gather` cuts the windows.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class Scene:
    """A padded, normalized scene with an optional LiDAR band."""

    def __init__(self, casi: Optional[np.ndarray], lidar: Optional[np.ndarray],
                 neighborhood: int, normalize: bool) -> None:
        self.neighborhood = neighborhood

        pad = ((neighborhood, neighborhood), (neighborhood, neighborhood), (0, 0))
        if lidar is not None:
            lidar = np.pad(lidar, pad, mode="symmetric")
        if casi is not None:
            casi = np.pad(casi, pad, mode="symmetric")

        self.casi_min, self.casi_max = 0, 1
        self.lidar_min, self.lidar_max = 0, 1
        if normalize:
            if lidar is not None:
                self.lidar_min = np.min(lidar)
                lidar = lidar - self.lidar_min
                self.lidar_max = np.max(lidar)
                lidar = lidar / self.lidar_max
            if casi is not None:
                self.casi_min = np.min(casi, axis=(0, 1))
                casi = casi - self.casi_min
                self.casi_max = np.max(casi, axis=(0, 1))
                casi = casi / np.asarray(self.casi_max, dtype=np.float32)

        self.casi = casi
        self.lidar = lidar
        self._device_scenes: Dict[torch.device, torch.Tensor] = {}

    def get_data_shape(self) -> list:
        dim = self.neighborhood * 2 + 1
        channels = self.casi.shape[2] + (0 if self.lidar is None else 1)
        return [dim, dim, channels]

    def get_scene_shape(self) -> list:
        padding = self.neighborhood * 2
        primary = self.lidar if self.lidar is not None else self.casi
        return [primary.shape[0] - padding, primary.shape[1] - padding]

    def get_data_point(self, point_x: int, point_y: int) -> np.ndarray:
        """The ``[k, k, C]`` window at (x, y), cut on the host (the in-memory importer)."""
        k = 2 * self.neighborhood + 1
        window = self.casi[point_y:point_y + k, point_x:point_x + k, :]
        if self.lidar is None:
            return window
        return np.concatenate(
            [window, self.lidar[point_y:point_y + k, point_x:point_x + k, :]], axis=2)

    def device_scene(self, device) -> torch.Tensor:
        """The fused float32 ``[Hp, Wp, C]`` scene on ``device``, built once per device."""
        device = torch.device(device)
        scene = self._device_scenes.get(device)
        if scene is None:
            parts = []
            if self.casi is not None:
                parts.append(np.asarray(self.casi, dtype=np.float32))
            if self.lidar is not None:
                parts.append(np.asarray(self.lidar, dtype=np.float32))
            fused = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=2)
            scene = torch.from_numpy(np.ascontiguousarray(fused)).to(device).contiguous()
            self._device_scenes[device] = scene
        return scene
