"""DCLGAN and DCL-CycleGAN shadow trainers (``hypelcnn_tpu/gan/wrappers/dclgan.py``).

DCLGAN runs two CUT units a step, ``x2y`` on ``(x, y)`` and then ``y2x`` on
``(y, x)``, each G -> D -> featD. Kept as in the JAX package:

- the units do not couple (the reference's coupling is written with
  discarded ``namedtuple._replace`` results);
- each role's optimizer is one TF Adam shared by both units, so its bias
  correction runs at ``t = 2k + 1`` in ``x2y`` and ``2k + 2`` in ``y2x``;
- the unprefixed losses are the sums over the two units.

DCL-CycleGAN trains exactly as DCLGAN (its cycle term is discarded the same
way) unless ``apply_cycle_loss_fix`` is set: then one more joint update of
both generators on the cycle-consistency loss follows, each with an
optimizer state of its own (``x2y.cycle_gen``, ``y2x.cycle_gen``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from hypelcnn_tpu_torch.gan.losses import cycle_consistency_loss
from hypelcnn_tpu_torch.gan.wrappers.base import GanAdam, GANTrainerBase
from hypelcnn_tpu_torch.gan.wrappers.cut import cut_optimizers, cut_unit, cut_update

LOSSES = ("generator_loss", "discriminator_loss", "gen_discriminator_loss")


class DCLGANTrainer(GANTrainerBase):
    def __init__(self, band_count: int, config: Dict[str, Any], max_steps: int):
        super().__init__(band_count, config, max_steps)
        self.optimizers = {**cut_optimizers(config, max_steps, "x2y.", t_stride=2, t_phase=1),
                           **cut_optimizers(config, max_steps, "y2x.", t_stride=2, t_phase=2)}

    def build_nets(self) -> nn.ModuleDict:
        return nn.ModuleDict({unit: cut_unit(self.band_count, self.config, self.impl)
                              for unit in ("x2y", "y2x")})

    def step(self, state, x, y, generator=None, draws=None):
        m_x2y = cut_update(self, state, "x2y.", x, y)
        m_y2x = cut_update(self, state, "y2x.", y, x)
        metrics = {f"x2y_{k}": v for k, v in m_x2y.items()}
        metrics.update({f"y2x_{k}": v for k, v in m_y2x.items()})
        for k in LOSSES:
            metrics[k] = m_x2y[k] + m_y2x[k]
        state.step += 1
        return metrics

    def generator_for(self, nets, is_shadow):
        return nets["x2y"]["gen"] if is_shadow else nets["y2x"]["gen"]


class DCLCycleGANTrainer(DCLGANTrainer):
    def __init__(self, band_count: int, config: Dict[str, Any], max_steps: int):
        super().__init__(band_count, config, max_steps)
        self.apply_cycle_loss_fix = config.get("apply_cycle_loss_fix", False)
        self.cycle_weight = config.get("cycle_consistency_loss_weight", 10.0)
        if self.apply_cycle_loss_fix:
            # the x2y generator's optimizer settings, with states of their own
            for unit in ("x2y", "y2x"):
                self.optimizers[f"{unit}.cycle_gen"] = (
                    GanAdam(config.get("generator_lr", 2e-4), max_steps, t_stride=2, t_phase=1),
                    [f"{unit}.gen"])

    def step(self, state, x, y, generator=None, draws=None):
        metrics = super().step(state, x, y, generator, draws)
        if not self.apply_cycle_loss_fix:
            return metrics
        g_x2y, g_y2x = state.nets["x2y"]["gen"], state.nets["y2x"]["gen"]
        gen_y, gen_x = g_x2y(x), g_y2x(y)
        c_loss = self.cycle_weight * cycle_consistency_loss(x, g_y2x(gen_y), y, g_x2y(gen_x))
        # one backward over both generators, then each applies its own part
        names = ("x2y.cycle_gen", "y2x.cycle_gen")
        params = [self.params(state.nets, self.optimizers[name][1]) for name in names]
        grads = self.mean_over_ranks(torch.autograd.grad(c_loss, params[0] + params[1]))
        split = len(params[0])
        for name, ps, gs in zip(names, params, (grads[:split], grads[split:])):
            self.optimizers[name][0].apply(ps, gs, state.opt_states[name])
        metrics["cycle_loss"] = c_loss.detach()
        return metrics
