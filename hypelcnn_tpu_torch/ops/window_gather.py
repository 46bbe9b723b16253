"""Batched neighborhood window gather.

The padded scene lives on the device as one ``[Hp, Wp, C]`` float32 tensor
and a batch of (x, y) coordinates becomes a batch of ``[k, k, C]`` windows
there, as in ``hypelcnn_tpu/ops/window_gather.py``.

- :func:`gather_patches_torch` is the plain PyTorch version. It runs on the
  CPU and is the oracle the CUDA kernel is held against.
- :func:`gather_patches` launches the hand-written CUDA kernel
  (:mod:`hypelcnn_tpu_torch.kernels.window_gather`) for a CUDA scene and takes
  the plain version only for a CPU scene.

Out-of-range coordinates follow JAX's gather (``gather_patches_xla``): each
index below 0 is wrapped once by the dimension (``i + dim``), then every
index is clamped into ``[0, dim - 1]``. On a 5x6 scene with k = 3, x = -1
reads columns 5, 0, 1 and x = 5 reads 5, 5, 5.
"""

from __future__ import annotations

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
