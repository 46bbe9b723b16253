"""Batch data augmentation on the device (``hypelcnn_tpu/data/augmentation.py``).

Each op works on a ``[B, k, k, C]`` NHWC batch, with one random draw per
example, and takes its draws either from a ``torch.Generator`` or injected
(``k``, ``u``, ``flips``, ``deltas``), so that a test can feed both
frameworks the same numbers. Kept as in the JAX package:

- the order rotation -> shadow -> reflection -> spectral;
- rotation turns by 0, 90 or 180 degrees, never 270;
- the shadow op (a :class:`ShadowOps` from ``gan/shadow_ops.py``: the
  simple ratio or a frozen generator) replaces an example where its draw
  ``u`` is below ``augmentation_random_threshold``;
- reflection draws left-right first, then up-down;
- spectral deltas are negative only, uniform in ``[-amount, 0)``, one per
  example and channel.

An op that is off draws nothing, so the draws of the others do not depend
on it. :func:`draw_augmentations` takes every draw of a batch up front, in
that order, so that a rank of a data-parallel run can draw over the global
batch and keep its rows (:func:`select_rows`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch


@dataclass
class ShadowOps:
    """A pair of batch translations, shadow and de-shadow."""
    shadow_fn: Callable[[torch.Tensor], torch.Tensor]
    deshadow_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@dataclass
class AugmentationInfo:
    shadow_struct: Optional[ShadowOps] = None
    perform_shadow_augmentation: bool = False
    perform_rotation_augmentation: bool = False
    perform_spectral_augmentation: float = 0.0  # 0 disables; else max negative delta
    perform_reflection_augmentation: bool = False
    augmentation_random_threshold: float = 0.5


def rotate_batch(patches: torch.Tensor, generator: Optional[torch.Generator] = None,
                 k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quarter-turns in {0, 1, 2} per example, over the spatial dims (1, 2)."""
    if k is None:
        k = torch.randint(0, 3, (patches.shape[0],), generator=generator, device=patches.device)
    sel = k.to(patches.device).view(-1, 1, 1, 1)
    rot90 = torch.rot90(patches, 1, dims=(1, 2))
    rot180 = torch.rot90(patches, 2, dims=(1, 2))
    return torch.where(sel == 1, rot90, torch.where(sel == 2, rot180, patches))


def reflect_batch(patches: torch.Tensor, generator: Optional[torch.Generator] = None,
                  flips: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Left-right, then up-down flips, each with probability 1/2 per example.
    ``flips`` is ``(flip_lr, flip_ud)``, boolean ``[B]``."""
    if flips is None:
        shape = (patches.shape[0],)
        flip_lr = torch.rand(shape, generator=generator, device=patches.device) < 0.5
        flip_ud = torch.rand(shape, generator=generator, device=patches.device) < 0.5
    else:
        flip_lr, flip_ud = flips
    patches = torch.where(flip_lr.to(patches.device).view(-1, 1, 1, 1), patches.flip(2), patches)
    return torch.where(flip_ud.to(patches.device).view(-1, 1, 1, 1), patches.flip(1), patches)


def shadow_batch(patches: torch.Tensor, shadow_fn, threshold: float,
                 generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``shadow_fn(patches)`` where an example's draw ``u`` (uniform in
    ``[0, 1)``, ``[B]``) is below ``threshold``, the example as it is elsewhere."""
    if u is None:
        u = torch.rand((patches.shape[0],), generator=generator, device=patches.device)
    shadowed = shadow_fn(patches)
    return torch.where(u.to(patches.device).view(-1, 1, 1, 1) < threshold, shadowed, patches)


def spectral_batch(patches: torch.Tensor, amount: float,
                   generator: Optional[torch.Generator] = None,
                   deltas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add a delta in ``[-amount, 0)`` per example and channel; ``deltas`` is
    ``[B, 1, 1, C]``."""
    if deltas is None:
        shape = (patches.shape[0], 1, 1, patches.shape[-1])
        deltas = torch.rand(shape, generator=generator, device=patches.device,
                            dtype=patches.dtype) * amount - amount
    return patches + deltas.to(patches.device)


def _shadows(info: AugmentationInfo) -> bool:
    return info.perform_shadow_augmentation and info.shadow_struct is not None


def draw_augmentations(info: AugmentationInfo, shape: Sequence[int],
                       generator: Optional[torch.Generator], device,
                       dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The draws of the enabled augmentations for a ``[B, k, k, C]`` batch
    of ``shape``, taken from ``generator`` in the order the ops take them:
    ``k`` (rotation), ``u`` (shadow), ``flips`` (reflection), ``deltas``
    (spectral)."""
    batch, channels = shape[0], shape[-1]
    draws: Dict[str, Any] = {}
    if info.perform_rotation_augmentation:
        draws["k"] = torch.randint(0, 3, (batch,), generator=generator, device=device)
    if _shadows(info):
        draws["u"] = torch.rand((batch,), generator=generator, device=device)
    if info.perform_reflection_augmentation:
        draws["flips"] = (torch.rand((batch,), generator=generator, device=device) < 0.5,
                          torch.rand((batch,), generator=generator, device=device) < 0.5)
    if info.perform_spectral_augmentation:
        amount = float(info.perform_spectral_augmentation)
        draws["deltas"] = torch.rand((batch, 1, 1, channels), generator=generator,
                                     device=device, dtype=dtype) * amount - amount
    return draws


def select_rows(draws: Dict[str, Any], rows: slice) -> Dict[str, Any]:
    """The draws of the batch rows ``rows``."""
    return {key: tuple(v[rows] for v in value) if isinstance(value, tuple) else value[rows]
            for key, value in draws.items()}


def augment_batch(patches: torch.Tensor, info: AugmentationInfo,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Apply the enabled augmentations in the JAX package's order.

    Draws come from ``generator`` (:func:`draw_augmentations`) unless
    ``draws`` injects them under the keys ``k``, ``u``, ``flips`` and
    ``deltas``. Shadow augmentation runs only with a ``shadow_struct``.
    """
    if draws is None:
        draws = draw_augmentations(info, patches.shape, generator, patches.device,
                                   patches.dtype)
    if info.perform_rotation_augmentation:
        patches = rotate_batch(patches, generator, k=draws.get("k"))
    if _shadows(info):
        patches = shadow_batch(patches, info.shadow_struct.shadow_fn,
                               info.augmentation_random_threshold, generator, u=draws.get("u"))
    if info.perform_reflection_augmentation:
        patches = reflect_batch(patches, generator, flips=draws.get("flips"))
    if info.perform_spectral_augmentation:
        patches = spectral_batch(patches, float(info.perform_spectral_augmentation), generator,
                                 deltas=draws.get("deltas"))
    return patches
