"""GAN trainer and pairing-sampler registries (``hypelcnn_tpu/gan/wrapper_registry.py``):
the seven trainable GAN types and the four samplers, under the same names
and parameters. A trainer serves training and translation both; with a
``mesh`` every trainer trains data-parallel over it (``use_mesh``).
"""

from __future__ import annotations

from typing import Any, Dict

from hypelcnn_tpu_torch.gan.sampling import (
    DummySampler,
    NeighborhoodBasedSampler,
    RandomBasedSampler,
    TargetBasedSampler,
)
from hypelcnn_tpu_torch.gan.wrappers.cut import CUTTrainer
from hypelcnn_tpu_torch.gan.wrappers.cyclegan import CycleGANTrainer
from hypelcnn_tpu_torch.gan.wrappers.dclgan import DCLCycleGANTrainer, DCLGANTrainer
from hypelcnn_tpu_torch.gan.wrappers.vanilla import VanillaGANTrainer


def get_sampling_map() -> Dict[str, Any]:
    return {"target": TargetBasedSampler(margin=5),
            "random": RandomBasedSampler(multiply_shadowed_data=True),
            "neighbour": NeighborhoodBasedSampler(neighborhood_size=20, margin=2),
            "dummy": DummySampler(element_count=2000, fill_value=0.5, coefficient=2)}


def get_trainer_dict(config: Dict[str, Any], band_count: int, max_steps: int,
                     mesh=None) -> Dict[str, Any]:
    trainers = {
        "cycle_gan": CycleGANTrainer(band_count, config, max_steps),
        "gan_x2y": VanillaGANTrainer(band_count, config, max_steps, swap_inputs=False),
        "gan_y2x": VanillaGANTrainer(band_count, config, max_steps, swap_inputs=True),
        "cut_x2y": CUTTrainer(band_count, config, max_steps, swap_inputs=False),
        "cut_y2x": CUTTrainer(band_count, config, max_steps, swap_inputs=True),
        "dcl_gan": DCLGANTrainer(band_count, config, max_steps),
        "dcl_cycle_gan": DCLCycleGANTrainer(band_count, config, max_steps),
    }
    if mesh is not None:
        for trainer in trainers.values():
            trainer.use_mesh(mesh)
    return trainers
