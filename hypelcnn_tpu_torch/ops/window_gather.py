"""Batched neighborhood window gather.

The padded scene lives on the device as one ``[Hp, Wp, C]`` float32 tensor
and a batch of (x, y) coordinates becomes a batch of ``[k, k, C]`` windows
there, as in ``hypelcnn_tpu/ops/window_gather.py``.

- :func:`gather_patches_torch` is the plain PyTorch version. It runs on the
  CPU and is the oracle the CUDA kernel is held against.
- :func:`gather_patches` launches the hand-written CUDA kernel
  (:mod:`hypelcnn_tpu_torch.kernels.window_gather`) for a CUDA scene and takes
  the plain version only for a CPU scene.

:func:`gather_patches_dual` (GRSS2018's two resolutions) and
:func:`gather_from_multi` (a random member scene per window) are plain
PyTorch indexing on every device: the JAX package computes them with XLA,
not with its Pallas kernel.

Out-of-range coordinates follow JAX's gather (``gather_patches_xla``): each
index below 0 is wrapped once by the dimension (``i + dim``), then every
index is clamped into ``[0, dim - 1]``. On a 5x6 scene with k = 3, x = -1
reads columns 5, 0, 1 and x = 5 reads 5, 5, 5.
"""

from __future__ import annotations

from typing import Optional

import torch

from hypelcnn_tpu_torch.kernels.window_gather import window_gather_cuda


def _clamp_wrap(index: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.where(index < 0, index + dim, index).clamp_(0, dim - 1)


def gather_patches_torch(scene: torch.Tensor, coords: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Gather ``[B, k, k, C]`` windows with PyTorch indexing.

    Args:
      scene: ``[Hp, Wp, C]`` padded scene (pad = neighborhood on each side).
      coords: ``[B, 2]`` integer (x, y) in unpadded scene space; the padding
        offset cancels the neighborhood back-step, so the window starts at
        ``scene[y, x]``.
      patch_size: k = 2 * neighborhood + 1.
    """
    hp, wp, _ = scene.shape
    offs = torch.arange(patch_size, device=scene.device, dtype=torch.int64)
    coords = coords.to(device=scene.device, dtype=torch.int64)
    ys = _clamp_wrap(coords[:, 1, None] + offs, hp)
    xs = _clamp_wrap(coords[:, 0, None] + offs, wp)
    return scene[ys[:, :, None], xs[:, None, :]]


def gather_patches(scene: torch.Tensor, coords: torch.Tensor, patch_size: int) -> torch.Tensor:
    """The CUDA kernel for a CUDA scene, the plain version for a CPU scene."""
    if scene.device.type == "cpu":
        return gather_patches_torch(scene, coords, patch_size)
    return window_gather_cuda(scene, coords, patch_size)


def gather_patches_dual(casi: torch.Tensor, lidar: torch.Tensor, coords: torch.Tensor,
                        neighborhood: int, casi_scale: float = 0.5) -> torch.Tensor:
    """Dual-resolution windows (GRSS2018): CASI sampled at ``casi_scale``,
    LiDAR at full resolution, as ``gather_patches_dual`` of the JAX package.

    A window at (x, y), in LiDAR space, reads CASI from
    ``int(float32(x) * scale) + n - int(n * scale)`` at offsets
    ``int(i * scale)``, and LiDAR from ``(x, y)`` at offsets ``i``. Returns
    ``[B, k, k, C_casi + 1]`` with LiDAR last. Plain PyTorch indexing, on
    any device; out-of-range indices wrap, then clamp, per modality.
    """
    k = 2 * neighborhood + 1
    device = casi.device
    coords = coords.to(device=device, dtype=torch.int64)
    start = neighborhood - int(neighborhood * casi_scale)
    casi_offs = (torch.arange(k, device=device) * casi_scale).to(torch.int64)
    cxy = (coords.to(torch.float32) * casi_scale).to(torch.int64) + start
    ys = _clamp_wrap(cxy[:, 1, None] + casi_offs, casi.shape[0])
    xs = _clamp_wrap(cxy[:, 0, None] + casi_offs, casi.shape[1])
    casi_patch = casi[ys[:, :, None], xs[:, None, :]]
    offs = torch.arange(k, device=device)
    ys = _clamp_wrap(coords[:, 1, None] + offs, lidar.shape[0])
    xs = _clamp_wrap(coords[:, 0, None] + offs, lidar.shape[1])
    lidar_patch = lidar[ys[:, :, None], xs[:, None, :]]
    return torch.cat([casi_patch, lidar_patch.to(casi_patch.dtype)], dim=-1)


def gather_from_multi(arrays, coords: torch.Tensor, neighborhood: int,
                      member: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Windows of a :class:`~hypelcnn_tpu_torch.data.scene.MultiScene`, each
    from one member, as ``gather_from_multi`` of the JAX package.

    ``arrays`` is ``(stacked_unique [S, Hp, Wp, C], lookup [M])``. Each
    window's member (``[B]`` ids in ``[0, M)``) is ``member`` if given, else
    drawn uniformly from ``generator``, else member 0; the lookup maps it to
    its stored scene. Plain PyTorch indexing; out-of-range coordinates wrap,
    then clamp.
    """
    stacked, lookup = arrays
    k = 2 * neighborhood + 1
    device = stacked.device
    coords = coords.to(device=device, dtype=torch.int64)
    batch = coords.shape[0]
    if member is None:
        if generator is None:
            member = torch.zeros((batch,), dtype=torch.int64, device=device)
        else:
            member = torch.randint(0, lookup.shape[0], (batch,), generator=generator,
                                   device=device)
    src = lookup[member.to(device=device, dtype=torch.int64)]
    offs = torch.arange(k, device=device)
    ys = _clamp_wrap(coords[:, 1, None] + offs, stacked.shape[1])
    xs = _clamp_wrap(coords[:, 0, None] + offs, stacked.shape[2])
    return stacked[src[:, None, None], ys[:, :, None], xs[:, None, :]]
