"""Shared GAN training infrastructure (``hypelcnn_tpu/gan/wrappers/base.py``).

- :func:`gan_lr_schedule`: constant for the first half of training, then
  linear to zero, read at the update count before its increment.
- :class:`GanAdam`: TF's Adam, not ``torch.optim.Adam``: eps is added to the
  uncorrected ``sqrt(v)`` and the bias correction is folded into the step
  size, ``lr(k) * sqrt(1 - b2^c) / (1 - b1^c)`` with ``c = t_stride * k +
  t_phase`` computed in float32, as JAX computes ``b2 ** c``. The count is a
  host integer, so an update reads nothing from the device.
- :class:`Pool`: the discriminators' history pool. While it fills, each
  generated sample passes through and is appended; once full, each is
  swapped with a pool slot with probability 1/2, the slots drawn without
  replacement when the batch fits the pool. Its fill count depends only on
  the step, so the host tracks it.
- :class:`GANState`: the step, the networks (an ``nn.ModuleDict`` named as
  the JAX package's params tree, so the weight bridge maps it), every
  optimizer's state and the pools. It restores the JAX package's
  ``GANState`` too (an orbax checkpoint, converted by the weight bridge),
  and saves as one (:meth:`GANState.checkpoint_tree`).
- :class:`GANTrainerBase`: ``init_state``, ``train_step`` and the
  translations; :func:`translate_patch` folds ``k x k`` cells into the batch.

Data parallelism (:meth:`GANTrainerBase.use_mesh`, the JAX package's
``use_mesh``): every rank is given the same global ``(x, y)`` batch and
keeps its data index's rows; each optimizer averages the gradients over the
data axis before its step, the reported losses are the global means, and a
pool holds and swaps over the global batch of fakes, which every rank
rebuilds by an all-reduce of zero-filled rows. The feature discriminator's
norm is global (``gan/models.py``). The networks, optimizer states and pools
stay equal on every rank: on a mesh with a model axis they stay replicated,
as JAX's ``use_mesh`` places them, and the model ranks of one data index
compute the same rows.

Each sub-network's update differentiates only that sub-network's
parameters (``torch.autograd.grad`` over its own tensors) and holds the
others constant, as ``jax.value_and_grad`` of one argument does. Random
draws (the pools') come from the ``torch.Generator`` given to a step, or
are injected, so a test can feed JAX's draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hypelcnn_tpu_torch.compat.flax_to_torch import (
    ORBAX_TREE,
    gan_state_payload,
    gan_state_tree,
)
from hypelcnn_tpu_torch.models.layers import init_parameters
from hypelcnn_tpu_torch.parallel.mesh import Mesh, bind_mesh
from hypelcnn_tpu_torch.train.checkpoint import restore_params


def gan_lr_schedule(base_lr: float, max_steps: int):
    """``count -> lr`` (float32): ``base_lr`` below half of ``max_steps``,
    then linear decay to zero."""
    half = max_steps // 2
    decay_steps = max(max_steps - half, 1)

    def schedule(count: int) -> np.float32:
        if count < half:
            return np.float32(base_lr)
        frac = np.clip(np.float32(count - half) / np.float32(decay_steps), np.float32(0),
                       np.float32(1))
        return np.float32(base_lr) * (np.float32(1) - frac)
    return schedule


@dataclass
class AdamState:
    count: int
    m: List[torch.Tensor]
    v: List[torch.Tensor]


class GanAdam:
    """TF's Adam over a list of parameters, updated in place."""

    def __init__(self, base_lr: float, max_steps: int, b1: float = 0.5, b2: float = 0.999,
                 eps: float = 1e-8, t_stride: int = 1, t_phase: int = 1):
        self.schedule = gan_lr_schedule(base_lr, max_steps)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.t_stride, self.t_phase = t_stride, t_phase

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(count=0, m=[torch.zeros_like(p) for p in params],
                         v=[torch.zeros_like(p) for p in params])

    def step_size(self, count: int) -> float:
        """``lr(count) * sqrt(1 - b2^c) / (1 - b1^c)`` in float32."""
        c = np.float32(self.t_stride * count + self.t_phase)
        one = np.float32(1)
        scaled = self.schedule(count) * np.sqrt(one - np.power(np.float32(self.b2), c))
        return float(scaled / (one - np.power(np.float32(self.b1), c)))

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: AdamState) -> None:
        """``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``, then
        ``p += -lr_t m / (sqrt(v) + eps)``, each product rounded where JAX
        rounds it."""
        params, grads = list(params), list(grads)
        b1, b2 = self.b1, self.b2
        m = torch._foreach_add(torch._foreach_mul(state.m, b1), torch._foreach_mul(grads, 1 - b1))
        g2 = torch._foreach_mul(torch._foreach_mul(grads, 1 - b2), grads)
        v = torch._foreach_add(torch._foreach_mul(state.v, b2), g2)
        denominators = torch._foreach_add(torch._foreach_sqrt(v), self.eps)
        updates = torch._foreach_div(torch._foreach_mul(m, -self.step_size(state.count)),
                                     denominators)
        torch._foreach_add_(params, updates)
        state.m, state.v, state.count = m, v, state.count + 1


POOL_SIZE = 50


@dataclass
class Pool:
    """A history pool of generated samples and the inputs they came from."""
    buffer: torch.Tensor         # [pool_size, ...]
    inputs_buffer: torch.Tensor
    count: int = 0               # filled slots

    @classmethod
    def create(cls, pool_size: int, element_shape, device) -> "Pool":
        shape = (pool_size, *element_shape)
        return cls(buffer=torch.zeros(shape, device=device),
                   inputs_buffer=torch.zeros(shape, device=device))

    def apply(self, gen_data: torch.Tensor, gen_inputs: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pooled ``(data, inputs)`` for the discriminator; updates the pool.

        ``draws`` injects ``(slots, swap)``: the ``[b]`` pool slots and the
        ``[b]`` boolean swap mask, used only once the pool is full."""
        p, b = self.buffer.shape[0], gen_data.shape[0]
        if self.count < p:
            n = min(b, p - self.count)
            self.buffer[self.count:self.count + n] = gen_data[:n]
            self.inputs_buffer[self.count:self.count + n] = gen_inputs[:n]
            self.count = min(self.count + b, p)
            return gen_data, gen_inputs
        if draws is None:
            device = gen_data.device
            if b <= p:
                slots = torch.randperm(p, generator=generator, device=device)[:b]
            else:
                slots = torch.randint(0, p, (b,), generator=generator, device=device)
            swap = torch.rand((b,), generator=generator, device=device) < 0.5
        else:
            slots, swap = (d.to(gen_data.device) for d in draws)
        swap = swap.view((b,) + (1,) * (gen_data.dim() - 1))
        held, held_inputs = self.buffer[slots], self.inputs_buffer[slots]
        self.buffer[slots] = torch.where(swap, gen_data, held)
        self.inputs_buffer[slots] = torch.where(swap, gen_inputs, held_inputs)
        return torch.where(swap, held, gen_data), torch.where(swap, held_inputs, gen_inputs)


def _to_cpu(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_to_cpu(v) for v in value]
    return value


@dataclass
class GANState:
    step: int
    nets: nn.ModuleDict
    opt_states: Dict[str, AdamState]
    pools: Dict[str, Pool] = field(default_factory=dict)
    opt_paths: Dict[str, List[str]] = field(default_factory=dict)  # each optimizer's networks

    def checkpoint(self) -> Dict[str, Any]:
        """The whole state, on the CPU."""
        return {"step": self.step, "state_dict": _to_cpu(dict(self.nets.state_dict())),
                "opt_states": _to_cpu({name: {"count": s.count, "m": s.m, "v": s.v}
                                       for name, s in self.opt_states.items()}),
                "pools": _to_cpu({name: {"buffer": p.buffer, "inputs_buffer": p.inputs_buffer,
                                         "count": p.count} for name, p in self.pools.items()})}

    def checkpoint_tree(self) -> Dict[str, Any]:
        """:meth:`checkpoint` as the JAX package's ``GANState`` tree, what
        ``save_checkpoint`` writes."""
        return gan_state_tree(self.checkpoint(), self.nets, self.opt_paths, list(self.pools))

    @torch.no_grad()
    def restore(self, saved: Dict[str, Any]) -> None:
        """Load a :meth:`checkpoint` dict, or the JAX package's
        (``restore_checkpoint`` of an orbax step), into this state's tensors;
        the optimizers and pools must be the ones it was saved from."""
        if ORBAX_TREE in saved:
            saved = gan_state_payload(saved[ORBAX_TREE], self.nets, self.opt_paths,
                                      list(self.pools))
        self.nets.load_state_dict(saved["state_dict"], strict=True)
        if set(saved["opt_states"]) != set(self.opt_states) or \
                set(saved["pools"]) != set(self.pools):
            raise ValueError(f"the checkpoint's optimizers {sorted(saved['opt_states'])} and "
                             f"pools {sorted(saved['pools'])} are not this trainer's")
        for name, opt in self.opt_states.items():
            entry = saved["opt_states"][name]
            opt.count = int(entry["count"])
            for mine, theirs in zip(opt.m + opt.v, entry["m"] + entry["v"]):
                mine.copy_(theirs)
        for name, pool in self.pools.items():
            entry = saved["pools"][name]
            pool.buffer.copy_(entry["buffer"])
            pool.inputs_buffer.copy_(entry["inputs_buffer"])
            pool.count = int(entry["count"])
        self.step = int(saved["step"])


def translate_patch(generator: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a per-pixel spectral generator to every cell of ``[B, k, k, bands]``
    by folding the cells into the batch."""
    b, h, w, c = x.shape
    return generator(x.reshape(b * h * w, 1, 1, c)).reshape(b, h, w, c)


class GANTrainerBase:
    """``init_state``, ``train_step`` and the translations of one GAN family.

    A subclass builds its networks (:meth:`build_nets`), names its
    optimizers and the networks each one updates (``self.optimizers``:
    name -> ``(GanAdam, [dotted paths in the nets])``), its pools
    (``self.pool_names``), runs a step on its rows (:meth:`step`) and names
    the generator that translates each way (:meth:`generator_for`).
    """

    pool_names: Tuple[str, ...] = ()

    def __init__(self, band_count: int, config: Dict[str, Any], max_steps: int):
        self.band_count = band_count
        self.config = dict(config)
        self.impl = "toeplitz" if config.get("fused_generator") else "conv"
        self.optimizers: Dict[str, Tuple[GanAdam, List[str]]] = {}
        self.mesh: Optional[Mesh] = None

    def use_mesh(self, mesh: Optional[Mesh]) -> "GANTrainerBase":
        """Train data-parallel over ``mesh`` (states made after this call)."""
        self.mesh = mesh
        return self

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.sharded

    def build_nets(self) -> nn.ModuleDict:
        raise NotImplementedError

    def init_state(self, device, generator: Optional[torch.Generator] = None,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None) -> GANState:
        """A fresh state on ``device``: the networks from ``state_dict`` when
        given, else the JAX package's initializers drawn from ``generator``;
        optimizer moments and pools zero."""
        nets = self.build_nets()
        if state_dict is None:
            init_parameters(nets, generator)
        else:
            nets.load_state_dict(state_dict, strict=True)
        bind_mesh(nets, self.mesh)
        nets.to(device)
        opt_states = {name: tx.init(self.params(nets, paths))
                      for name, (tx, paths) in self.optimizers.items()}
        pools = {name: Pool.create(POOL_SIZE, (1, 1, self.band_count), device)
                 for name in self.pool_names}
        return GANState(step=0, nets=nets, opt_states=opt_states, pools=pools,
                        opt_paths={name: list(paths)
                                   for name, (_, paths) in self.optimizers.items()})

    def restore_nets(self, path: str, device) -> nn.ModuleDict:
        """The networks of the params snapshot directory ``path`` (written by
        ``gan_train_for_shadow``), on ``device``, in evaluation mode."""
        nets = self.build_nets()
        nets.load_state_dict(restore_params(path), strict=True)
        return nets.to(device).eval()

    @staticmethod
    def params(nets: nn.Module, paths: Sequence[str]) -> List[torch.Tensor]:
        return [p for path in paths for p in nets.get_submodule(path).parameters()]

    def mean_over_ranks(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor averaged over the mesh's ranks (one all-reduce); as
        given on one rank."""
        return list(tensors) if self.mesh is None else self.mesh.mean(tensors)

    def update(self, state: GANState, name: str, loss: torch.Tensor) -> None:
        """One ``name`` optimizer step on ``loss``, differentiated with respect
        to that optimizer's parameters only, the gradients averaged over the ranks."""
        tx, paths = self.optimizers[name]
        params = self.params(state.nets, paths)
        grads = self.mean_over_ranks(torch.autograd.grad(loss, params))
        tx.apply(params, grads, state.opt_states[name])

    def apply_pool(self, state: GANState, name: str, data: torch.Tensor, inputs: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pool ``name`` over the global batch of ``(data, inputs)``; returns this rank's rows."""
        pool = state.pools[name]
        if not self._sharded():
            return pool.apply(data, inputs, generator, draws)
        total = data.shape[0] * self.mesh.data_size
        rows = self.mesh.rows(total)
        both = self.mesh.gather_rows(torch.stack([data, inputs], dim=1), total, rows)
        pooled, pooled_inputs = pool.apply(both[:, 0], both[:, 1], generator, draws)
        return pooled[rows], pooled_inputs[rows]

    def train_step(self, state: GANState, x: torch.Tensor, y: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """One step on the ``[B, 1, 1, bands]`` pairs ``(x, y)`` (on a mesh,
        the global batch, of which this rank keeps its rows); updates
        ``state`` in place and returns the losses, means over the global
        batch, on the device, unread. ``draws`` injects the pools' draws."""
        if self._sharded():
            rows = self.mesh.rows(x.shape[0])
            x, y = x[rows], y[rows]
        metrics = self.step(state, x, y, generator, draws)
        names = sorted(metrics)
        return dict(zip(names, self.mean_over_ranks([metrics[n] for n in names])))

    def step(self, state: GANState, x: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """One step on this rank's rows; returns its losses."""
        raise NotImplementedError

    def generator_for(self, nets: nn.Module, is_shadow: bool) -> nn.Module:
        raise NotImplementedError

    @torch.no_grad()
    def translate(self, nets: nn.Module, x: torch.Tensor, is_shadow: bool) -> torch.Tensor:
        """``[B, k, k, bands]`` (``k = 1`` for pixels) through the generator
        of the direction ``is_shadow`` names."""
        return translate_patch(self.generator_for(nets, is_shadow), x)

    def host_translator(self, nets: nn.Module, is_shadow: bool):
        """:meth:`translate` as a numpy-in, numpy-out function (the validator's
        translator), run on the networks' device."""
        device = next(nets.parameters()).device
        return lambda samples: self.translate(nets, torch.from_numpy(samples).to(device),
                                              is_shadow).cpu().numpy()

    def translate_scene(self, nets: nn.Module, pixels: np.ndarray, is_shadow: bool,
                        block: int = 65536) -> np.ndarray:
        """Translate an ``[H, W, bands]`` host scene on the networks' device, in
        blocks of ``block`` pixels, the last one zero-padded; returns the host
        result."""
        h, w, c = pixels.shape
        total = h * w
        n_blocks = math.ceil(total / block)
        device = next(nets.parameters()).device
        flat = np.ascontiguousarray(pixels, dtype=np.float32).reshape(total, 1, 1, c)
        padded = torch.zeros((n_blocks * block, 1, 1, c), device=device)
        padded[:total] = torch.from_numpy(flat).to(device)
        out = torch.cat([self.translate(nets, chunk, is_shadow)
                         for chunk in padded.split(block)])
        return out[:total].reshape(h, w, c).cpu().numpy()
