"""Scene containers: padding, normalization and residence on the device.

Port of ``hypelcnn_tpu/data/scene.py``. The host arrays come from the same
numpy code, so they are bit for bit the JAX ones.

- :class:`Scene` symmetric-pads CASI and LiDAR by the neighborhood and
  min/max-normalizes CASI per band and LiDAR as a whole (statistics may be
  injected, so a shadowed variant keeps the original's range). It carries
  the shadow augmenters it is given (``shadow_creator_dict``), as the JAX
  package's does.
  :meth:`Scene.device_scene` fuses them into one contiguous NHWC float32
  ``[Hp, Wp, C + 1]`` tensor, from which the CUDA window gather cuts windows.
- :class:`DualResScene` (GRSS2018) holds CASI at half the LiDAR's resolution;
  its two modalities stay separate on the device
  (:meth:`DualResScene.device_modalities`) and
  :func:`~hypelcnn_tpu_torch.ops.window_gather.gather_patches_dual` samples
  them. It has no fused scene, so it cannot be swept (neither can the JAX
  package's: its inherited ``device_scene`` fails to concatenate).
- :class:`MultiScene` (GULFPORT-ALT's MIXED mode) picks a random member per
  window; duplicate members go on the device once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _to_device(array: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)).to(device).contiguous()


class Scene:
    """A padded, normalized scene with an optional LiDAR band."""

    def __init__(self, casi: Optional[np.ndarray], lidar: Optional[np.ndarray],
                 neighborhood: int, normalize: bool,
                 casi_min=None, casi_max=None, lidar_min=None, lidar_max=None,
                 shadow_creator_dict=None) -> None:
        self.neighborhood = neighborhood
        self.shadow_creator_dict = shadow_creator_dict
        self.casi_unnormalized_dtype = None if casi is None else casi.dtype

        pad = ((neighborhood, neighborhood), (neighborhood, neighborhood), (0, 0))
        if lidar is not None:
            lidar = np.pad(lidar, pad, mode="symmetric")
        if casi is not None:
            casi = np.pad(casi, pad, mode="symmetric")

        self.casi_min, self.casi_max = 0, 1
        self.lidar_min, self.lidar_max = 0, 1
        if normalize:
            if lidar is not None:
                self.lidar_min = np.min(lidar) if lidar_min is None else lidar_min
                lidar = lidar - self.lidar_min
                self.lidar_max = np.max(lidar) if lidar_max is None else lidar_max
                lidar = lidar / self.lidar_max
            if casi is not None:
                self.casi_min = np.min(casi, axis=(0, 1)) if casi_min is None else casi_min
                casi = casi - self.casi_min
                self.casi_max = np.max(casi, axis=(0, 1)) if casi_max is None else casi_max
                casi = casi / np.asarray(self.casi_max, dtype=np.float32)

        self.casi = casi
        self.lidar = lidar
        self._device_scenes: Dict[torch.device, torch.Tensor] = {}

    def get_data_shape(self) -> list:
        dim = self.neighborhood * 2 + 1
        channels = self.casi.shape[2] + (0 if self.lidar is None else 1)
        return [dim, dim, channels]

    def get_casi_band_count(self) -> int:
        return self.casi.shape[2]

    def get_scene_shape(self) -> list:
        padding = self.neighborhood * 2
        primary = self.lidar if self.lidar is not None else self.casi
        return [primary.shape[0] - padding, primary.shape[1] - padding]

    def get_unnormalized_casi_dtype(self):
        return self.casi_unnormalized_dtype

    def get_data_point(self, point_x: int, point_y: int) -> np.ndarray:
        """The ``[k, k, C]`` window at (x, y), cut on the host (the in-memory importer)."""
        k = 2 * self.neighborhood + 1
        window = self.casi[point_y:point_y + k, point_x:point_x + k, :]
        if self.lidar is None:
            return window
        return np.concatenate(
            [window, self.lidar[point_y:point_y + k, point_x:point_x + k, :]], axis=2)

    def fused_host(self) -> np.ndarray:
        """CASI and LiDAR as one float32 ``[Hp, Wp, C]`` host array."""
        parts = [np.asarray(a, dtype=np.float32) for a in (self.casi, self.lidar) if a is not None]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=2)

    def device_scene(self, device) -> torch.Tensor:
        """The fused float32 ``[Hp, Wp, C]`` scene on ``device``, built once per device."""
        device = torch.device(device)
        scene = self._device_scenes.get(device)
        if scene is None:
            scene = _to_device(self.fused_host(), device)
            self._device_scenes[device] = scene
        return scene


class DualResScene(Scene):
    """GRSS2018's scene: CASI at 0.5x the LiDAR resolution.

    CASI is padded by the neighborhood like LiDAR; only its sampling
    differs: a window reads CASI at ``int(i * 0.5)`` offsets from
    ``int(x * 0.5) + n - int(n * 0.5)``, and LiDAR at full resolution.
    """

    CASI_SCALE = 0.5

    def get_data_point(self, point_x: int, point_y: int) -> np.ndarray:
        n = self.neighborhood
        k = 2 * n + 1
        actual_pad = int(n * self.CASI_SCALE)
        sx = int(point_x * self.CASI_SCALE) + n - actual_pad
        sy = int(point_y * self.CASI_SCALE) + n - actual_pad
        offs = (np.arange(k) * self.CASI_SCALE).astype(int)
        casi_patch = self.casi[np.ix_(sy + offs, sx + offs)]
        lidar_patch = self.lidar[point_y:point_y + k, point_x:point_x + k, :]
        return np.concatenate([casi_patch, lidar_patch.astype(casi_patch.dtype)], axis=2)

    def device_modalities(self, device):
        """``(casi, lidar)``: each padded modality as its own contiguous
        float32 tensor on ``device``, built once per device."""
        device = torch.device(device)
        modalities = self._device_scenes.get(device)
        if modalities is None:
            modalities = (_to_device(self.casi, device), _to_device(self.lidar, device))
            self._device_scenes[device] = modalities
        return modalities

    def device_scene(self, device):
        raise NotImplementedError(
            "a dual-resolution scene has no fused device scene, so it cannot be swept: its "
            "CASI and LiDAR differ in size. The JAX package cannot sweep one either (its "
            "device_scene fails to concatenate them); --domain gt works")


class MultiScene:
    """Picks a random member scene per window (GULFPORT-ALT's MIXED mode).

    Every other attribute is member 0's, so a sweep classifies member 0.
    """

    def __init__(self, scenes: Sequence[Scene]):
        if not scenes:
            raise ValueError("a MultiScene needs at least one member")
        self.scenes = list(scenes)
        self.neighborhood = scenes[0].neighborhood
        self._stacked: Dict[torch.device, tuple] = {}

    def __getattr__(self, item):
        return getattr(self.scenes[0], item)

    def get_data_point(self, point_x: int, point_y: int) -> np.ndarray:
        """The window of a member drawn from the global ``np.random`` state."""
        idx = np.random.randint(0, len(self.scenes))
        return self.scenes[idx].get_data_point(point_x, point_y)

    def device_scenes(self, device):
        """``(stacked_unique, lookup)`` on ``device``: the distinct members'
        fused scenes as one ``[S, Hp, Wp, C]`` tensor, each stored once, and
        the int64 member -> stored-scene table the draws index, which carries
        the weighting (``[0, 1, 1, 1]`` for MIXED)."""
        device = torch.device(device)
        stacked = self._stacked.get(device)
        if stacked is None:
            unique: list = []
            lookup = []
            for scene in self.scenes:
                for i, seen in enumerate(unique):
                    if seen is scene:
                        lookup.append(i)
                        break
                else:
                    lookup.append(len(unique))
                    unique.append(scene)
            stacked = (_to_device(np.stack([s.fused_host() for s in unique]), device),
                       torch.tensor(lookup, dtype=torch.int64, device=device))
            self._stacked[device] = stacked
        return stacked
