"""Vanilla GAN shadow trainer, x2y or y2x (``hypelcnn_tpu/gan/wrappers/vanilla.py``).

Wasserstein losses, a pool feeding the discriminator, a generator update
then a discriminator update that sees the updated generator. ``swap_inputs``
(``gan_y2x``) trains the generator from the shadowed pixels to the lit ones.
Its one generator translates both ways: ``is_shadow`` is ignored.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from hypelcnn_tpu_torch.gan.losses import (
    l2_regularization,
    wasserstein_discriminator_loss,
    wasserstein_generator_loss,
)
from hypelcnn_tpu_torch.gan.models import ShadowDiscriminator, ShadowGenerator
from hypelcnn_tpu_torch.gan.wrappers.base import GanAdam, GANTrainerBase


class VanillaGANTrainer(GANTrainerBase):
    pool_names = ("pool",)

    def __init__(self, band_count: int, config: Dict[str, Any], max_steps: int,
                 swap_inputs: bool):
        super().__init__(band_count, config, max_steps)
        self.swap_inputs = swap_inputs
        self.disc_reg_scale = config.get("discriminator_reg_scale", 1e-5)
        self.optimizers = {
            "generator": (GanAdam(config.get("generator_lr", 2e-4), max_steps), ["generator"]),
            "discriminator": (GanAdam(config.get("discriminator_lr", 1e-4), max_steps),
                              ["discriminator"])}

    def build_nets(self) -> nn.ModuleDict:
        return nn.ModuleDict({"generator": ShadowGenerator(self.band_count, self.impl),
                              "discriminator": ShadowDiscriminator(self.band_count)})

    def step(self, state, x, y, generator=None, draws=None):
        gen, disc = state.nets["generator"], state.nets["discriminator"]
        gen_inputs, real_data = (y, x) if self.swap_inputs else (x, y)

        g_loss = wasserstein_generator_loss(disc(gen(gen_inputs), gen_inputs))
        self.update(state, "generator", g_loss)

        with torch.no_grad():
            gen_data = gen(gen_inputs)
        pooled_data, pooled_inputs = self.apply_pool(
            state, "pool", gen_data, gen_inputs, generator, (draws or {}).get("pool"))
        d_loss = (wasserstein_discriminator_loss(disc(real_data, gen_inputs),
                                                 disc(pooled_data, pooled_inputs))
                  + l2_regularization([disc], self.disc_reg_scale, exclude=("fc3",)))
        self.update(state, "discriminator", d_loss)
        state.step += 1
        return {"generator_loss": g_loss.detach(), "discriminator_loss": d_loss.detach()}

    def generator_for(self, nets, is_shadow):
        return nets["generator"]
