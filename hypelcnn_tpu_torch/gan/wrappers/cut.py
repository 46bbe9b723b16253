"""CUT (Contrastive Unpaired Translation) shadow trainer
(``hypelcnn_tpu/gan/wrappers/cut.py``).

Three updates a step, in order, each seeing the previous one's parameters:
the generator (least-squares adversarial loss plus ``nce_loss_weight`` times
the NCE of ``emb(G(x))`` against ``emb(x)``, plus ``identity_weight`` times
the NCE of ``emb(G(y))`` against ``emb(y)``), the discriminator, then the
feature discriminator (the first NCE term plus its l2 regularization; the
JAX package computes the identity term there too and throws it away).
``emb`` is the feature discriminator over the generator's encoder.

:func:`cut_update` is shared with the DCL trainers, which run two CUT units.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from hypelcnn_tpu_torch.gan.losses import (
    l2_regularization,
    least_squares_discriminator_loss,
    least_squares_generator_loss,
    nce_loss,
)
from hypelcnn_tpu_torch.gan.models import (
    ShadowDiscriminator,
    ShadowFeatureDiscriminator,
    ShadowGenerator,
)
from hypelcnn_tpu_torch.gan.wrappers.base import GanAdam, GANTrainerBase

UNIT = ("gen", "disc", "featd")


def cut_unit(band_count: int, config: Dict[str, Any], impl: str) -> nn.ModuleDict:
    return nn.ModuleDict({
        "gen": ShadowGenerator(band_count, impl),
        "disc": ShadowDiscriminator(band_count),
        "featd": ShadowFeatureDiscriminator(band_count, config.get("patches", 6),
                                            config.get("embedded_feat_size", 2))})


def cut_optimizers(config: Dict[str, Any], max_steps: int, prefix: str = "",
                   t_stride: int = 1, t_phase: int = 1) -> Dict[str, tuple]:
    lrs = {"gen": config.get("generator_lr", 2e-4),
           "disc": config.get("discriminator_lr", 1e-4),
           "featd": config.get("gen_discriminator_lr", 1e-4)}
    return {prefix + role: (GanAdam(lrs[role], max_steps, t_stride=t_stride, t_phase=t_phase),
                            [prefix + role]) for role in UNIT}


def cut_update(trainer: GANTrainerBase, state, prefix: str, x: torch.Tensor,
               y: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One G -> D -> featD pass of the unit whose networks and optimizers are
    named ``prefix + "gen"`` etc."""
    config = trainer.config
    nce_w = config.get("nce_loss_weight", 10.0)
    id_w = config.get("identity_loss_weight", 0.5) if config.get("use_identity_loss", True) \
        else 0.0
    tau = config.get("tau", 0.07)
    nets = state.nets
    gen, disc, featd = (nets.get_submodule(prefix + role) for role in UNIT)

    def embeddings(data):
        return featd(gen(data, encoder_only=True))

    gen_data = gen(x)
    g_loss = (least_squares_generator_loss(disc(gen_data, x))
              + nce_w * nce_loss(embeddings(gen_data), embeddings(x), tau))
    if id_w:
        g_loss = g_loss + id_w * nce_loss(embeddings(gen(y)), embeddings(y), tau)
    trainer.update(state, prefix + "gen", g_loss)

    with torch.no_grad():
        gen_data = gen(x)
        gen_feats, x_feats = gen(gen_data, encoder_only=True), gen(x, encoder_only=True)
    d_loss = (least_squares_discriminator_loss(disc(y, x), disc(gen_data, x))
              + l2_regularization([disc], config.get("discriminator_reg_scale", 1e-5),
                                  exclude=("fc3",)))
    trainer.update(state, prefix + "disc", d_loss)

    f_loss = (nce_loss(featd(gen_feats), featd(x_feats), tau)
              + l2_regularization([featd], config.get("gen_disc_reg_scale", 1e-4)))
    trainer.update(state, prefix + "featd", f_loss)
    return {"generator_loss": g_loss.detach(), "discriminator_loss": d_loss.detach(),
            "gen_discriminator_loss": f_loss.detach()}


class CUTTrainer(GANTrainerBase):
    def __init__(self, band_count: int, config: Dict[str, Any], max_steps: int,
                 swap_inputs: bool):
        super().__init__(band_count, config, max_steps)
        self.swap_inputs = swap_inputs
        self.optimizers = cut_optimizers(config, max_steps)

    def build_nets(self) -> nn.ModuleDict:
        return cut_unit(self.band_count, self.config, self.impl)

    def step(self, state, x, y, generator=None, draws=None):
        gen_inputs, real_data = (y, x) if self.swap_inputs else (x, y)
        metrics = cut_update(self, state, "", gen_inputs, real_data)
        state.step += 1
        return metrics

    def generator_for(self, nets, is_shadow):
        return nets["gen"]
