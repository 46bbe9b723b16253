"""Shadow augmentation ops for classification training (``hypelcnn_tpu/gan/shadow_ops.py``).

- ``simple`` divides a window by the loader's per-band shadow ratio (a 1
  appended for the LiDAR channel); its inverse multiplies.
- A GAN entry translates a window's HSI channels through a frozen trained
  generator, pixel by pixel, and passes the LiDAR channel through. It is
  restored from what is at the path the loader declares: a params snapshot
  directory (``gan_train_for_shadow``'s ``gan_params`` or
  ``ckpt_params_N``, the port's or the JAX package's orbax one), or a TF
  checkpoint (``model.ckpt-N``, as the reference's trained generators are),
  whose generators are imported with ``utils/tf_checkpoint_import.py``.

A creator that fails to restore is reported and left out, as in the JAX
package, so the train CLI's unknown-method error then names the creators
that are available; one whose checkpoint is in a format or with an option
the port does not read (:class:`~hypelcnn_tpu_torch.compat.FormatNotRead`)
raises instead.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from hypelcnn_tpu_torch.compat import FormatNotRead
from hypelcnn_tpu_torch.data.augmentation import ShadowOps
from hypelcnn_tpu_torch.models.layers import init_parameters
from hypelcnn_tpu_torch.utils.tf_checkpoint_import import (
    import_gan_generator_state_dict,
    is_tf_checkpoint,
)


def create_simple_shadow_struct(shadow_ratio: np.ndarray, device) -> ShadowOps:
    """Divide (shadow) or multiply (de-shadow) by the per-band ratio; the
    LiDAR channel is left as it is."""
    ratio = torch.from_numpy(np.append(shadow_ratio, 1).astype(np.float32)).to(device)
    return ShadowOps(shadow_fn=lambda patches: patches / ratio,
                     deshadow_fn=lambda patches: patches * ratio)


def create_gan_shadow_struct(trainer, nets, band_count: int) -> ShadowOps:
    """A frozen generator as a ``[B, k, k, C]`` batch augmentation: the first
    ``band_count`` channels translated, the rest passed through."""

    def _translate(patches: torch.Tensor, is_shadow: bool) -> torch.Tensor:
        hsi, rest = patches[..., :band_count], patches[..., band_count:]
        return torch.cat([trainer.translate(nets, hsi, is_shadow), rest], dim=-1)

    return ShadowOps(shadow_fn=lambda p: _translate(p, True),
                     deshadow_fn=lambda p: _translate(p, False))


def build_shadow_creators(loader, scene, neighborhood: int, device,
                          max_steps: int = 100000) -> Dict[str, ShadowOps]:
    """The dataset's shadow augmenters on ``device``: ``simple`` where the
    loader has a shadow ratio, and each loader-declared generator whose
    params snapshot or TF checkpoint restores."""
    creators: Dict[str, ShadowOps] = {}
    _, shadow_ratio = loader.load_shadow_map(neighborhood, scene)
    if shadow_ratio is not None:
        creators["simple"] = create_simple_shadow_struct(shadow_ratio, device)

    band_count = scene.get_casi_band_count()
    checkpoints = loader.get_shadow_checkpoints()
    if checkpoints:
        from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict
        trainers = get_trainer_dict({}, band_count, max_steps)
        for name, rel_path in checkpoints.items():
            path = os.path.join(loader.get_model_base_dir(), rel_path)
            trainer = trainers.get(name)
            if trainer is None:
                continue
            try:
                if is_tf_checkpoint(path):
                    # the other networks keep a seeded init; only the
                    # generators translate
                    nets = trainer.build_nets()
                    init_parameters(nets, torch.Generator().manual_seed(0))
                    nets.load_state_dict(import_gan_generator_state_dict(name, nets, path),
                                         strict=True)
                    nets = nets.to(device).eval()
                elif os.path.isdir(path):
                    nets = trainer.restore_nets(path, device)
                else:
                    continue
                nets.requires_grad_(False)
                creators[name] = create_gan_shadow_struct(trainer, nets, band_count)
            except FormatNotRead:
                raise  # a declared generator the port cannot read is not left out
            except Exception as exc:  # a corrupt or foreign checkpoint: reported, left out
                print(f"shadow creator {name}: failed to restore {path}: {exc}")
    return creators
