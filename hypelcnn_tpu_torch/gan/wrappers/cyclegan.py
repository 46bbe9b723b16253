"""CycleGAN shadow trainer (``hypelcnn_tpu/gan/wrappers/cyclegan.py``).

Two generator / discriminator pairs, ``x2y`` (lit -> shadowed) and ``y2x``;
least-squares adversarial losses. Kept as in the JAX package:

- one joint update of both generators, then one of both discriminators;
- the aux loss (cycle consistency, plus identity when on) is counted in
  both partial generator losses, so the joint update counts it twice;
- "identity" compares each generator's output with its own input domain;
- the discriminators see the updated generators' outputs, through the
  pools, as constants.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from hypelcnn_tpu_torch.gan.losses import (
    cycle_consistency_loss,
    identity_loss,
    l2_regularization,
    least_squares_discriminator_loss,
    least_squares_generator_loss,
)
from hypelcnn_tpu_torch.gan.models import ShadowDiscriminator, ShadowGenerator
from hypelcnn_tpu_torch.gan.wrappers.base import GanAdam, GANTrainerBase


class CycleGANTrainer(GANTrainerBase):
    pool_names = ("x2y", "y2x")

    def __init__(self, band_count: int, config: Dict[str, Any], max_steps: int):
        super().__init__(band_count, config, max_steps)
        self.cycle_weight = config.get("cycle_consistency_loss_weight", 10.0)
        self.use_identity = config.get("use_identity_loss", True)
        self.identity_weight = config.get("identity_loss_weight", 0.5)
        self.disc_reg_scale = config.get("discriminator_reg_scale", 1e-5)
        self.optimizers = {
            "generators": (GanAdam(config.get("generator_lr", 2e-4), max_steps),
                           ["gen_x2y", "gen_y2x"]),
            "discriminators": (GanAdam(config.get("discriminator_lr", 1e-4), max_steps),
                               ["disc_x2y", "disc_y2x"])}

    def build_nets(self) -> nn.ModuleDict:
        return nn.ModuleDict({
            "gen_x2y": ShadowGenerator(self.band_count, self.impl),
            "gen_y2x": ShadowGenerator(self.band_count, self.impl),
            "disc_x2y": ShadowDiscriminator(self.band_count),
            "disc_y2x": ShadowDiscriminator(self.band_count)})

    def step(self, state, x, y, generator=None, draws=None):
        draws = draws or {}
        nets = state.nets
        g_x2y, g_y2x, d_x2y, d_y2x = (nets["gen_x2y"], nets["gen_y2x"], nets["disc_x2y"],
                                      nets["disc_y2x"])

        gen_y, gen_x = g_x2y(x), g_y2x(y)                      # G(x), F(y)
        aux = self.cycle_weight * cycle_consistency_loss(x, g_y2x(gen_y), y, g_x2y(gen_x))
        if self.use_identity:
            aux = aux + self.identity_weight * (identity_loss(x, gen_y) + identity_loss(y, gen_x))
        g_loss = ((least_squares_generator_loss(d_x2y(gen_y, x)) + aux)
                  + (least_squares_generator_loss(d_y2x(gen_x, y)) + aux))
        self.update(state, "generators", g_loss)

        with torch.no_grad():
            gen_y, gen_x = g_x2y(x), g_y2x(y)
        pooled_y, _ = self.apply_pool(state, "x2y", gen_y, x, generator, draws.get("x2y"))
        pooled_x, _ = self.apply_pool(state, "y2x", gen_x, y, generator, draws.get("y2x"))
        d_loss = (least_squares_discriminator_loss(d_x2y(y, x), d_x2y(pooled_y, x))
                  + least_squares_discriminator_loss(d_y2x(x, y), d_y2x(pooled_x, y))
                  + l2_regularization([d_x2y, d_y2x], self.disc_reg_scale, exclude=("fc3",)))
        self.update(state, "discriminators", d_loss)
        state.step += 1
        return {"generator_loss": g_loss.detach(), "discriminator_loss": d_loss.detach()}

    def generator_for(self, nets, is_shadow):
        return nets["gen_x2y"] if is_shadow else nets["gen_y2x"]
