"""The data-parallel mesh and its collectives (``hypelcnn_tpu/parallel/mesh.py``).

In JAX several devices form one logical program over a global batch, and
XLA inserts every reduction over the batch. In the port each rank holds its
rows of the global batch and the reductions are explicit, through a
:class:`Mesh`:

- batch norm's moments (``Σx``, ``Σx²`` and the count), CAP's routing
  agreement and the feature discriminator's norm are summed over the ranks
  in the forward pass by :meth:`Mesh.all_reduce_sum`, whose backward sums
  the gradient the same way;
- every optimizer step averages the ranks' gradients in one flat
  all-reduce (:meth:`Mesh.mean`), the loss riding in the same buffer;
- a rank's rows are :meth:`Mesh.rows` (equal shares) or :meth:`Mesh.split`
  (a sweep band, whose shares may differ by one).

Every collective is an ``all_reduce`` (and a barrier after a save): gloo
offers only ``all_reduce`` and ``broadcast`` on CUDA tensors, so the same
code runs on NCCL across cards and on gloo with ranks sharing one card. A
mesh of one rank runs no collective at all, whether or not a process group
exists (one plain process, or one rank under torchrun), and the layers take
their batch-coupled global forms only on more than one rank. Collectives
run on the default process group, whose size must be the mesh's.

Only the data axis is ported. The model axis (tensor parallelism,
``shard_params_for_tp``) raises; ROADMAP.md lists it.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from hypelcnn_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TP_NOT_PORTED = ("tensor parallelism (the mesh's model axis, shard_params_for_tp) is not "
                  "ported; ROADMAP.md lists it as a later slice")


class Mesh:
    """A data axis of ``world_size`` ranks, of which this process is ``rank``."""

    def __init__(self, world_size: int = 1, rank: int = 0):
        self.world_size = int(world_size)
        self.rank = int(rank)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world_size, MODEL_AXIS: 1}

    @property
    def sharded(self) -> bool:
        """More than one rank: the collectives run and batch-coupled layers
        take their global forms."""
        return self.world_size > 1

    def rows(self, total: int) -> slice:
        """This rank's rows of ``total`` in equal shares; raises when they are not."""
        if total % self.world_size:
            raise ValueError(f"batch {total} not divisible by the data axis {self.world_size}")
        share = total // self.world_size
        return slice(self.rank * share, (self.rank + 1) * share)

    def split(self, total: int) -> slice:
        """This rank's rows of ``total`` as ``torch.tensor_split`` deals them
        (the first ``total % world_size`` shares one longer)."""
        share, extra = divmod(total, self.world_size)
        start = self.rank * share + min(self.rank, extra)
        return slice(start, start + share + (self.rank < extra))

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks in place (no autograd); nothing on one rank.
        An inference tensor (made under ``torch.inference_mode``) is reduced in
        that mode: gloo copies a CUDA tensor's result back into it in place."""
        if self.sharded:
            self._check_group()
            with torch.inference_mode(tensor.is_inference()):
                dist.all_reduce(tensor)
        return tensor

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum of ``tensor`` over the ranks, differentiable: the backward
        sums the incoming gradient over the ranks too."""
        return _AllReduceSum.apply(tensor, self)

    def mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks of each tensor, in one flat all-reduce;
        returns views of the reduced buffer, shaped as the inputs (on one
        rank, the tensors themselves)."""
        if not self.sharded:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_(flat).div_(self.world_size)
        return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                   tensors)]

    def gather_rows(self, local: torch.Tensor, total: int, rows: slice) -> torch.Tensor:
        """The ``[total, ...]`` tensor whose ``rows`` are this rank's ``local``
        and whose other rows are the other ranks': an all-reduce of a
        zero-filled tensor, exact since each row has one nonzero owner."""
        out = torch.zeros((total, *local.shape[1:]), dtype=local.dtype, device=local.device)
        out[rows] = local
        return self.all_reduce_(out)

    def barrier(self) -> None:
        if self.sharded:
            self._check_group()
            dist.barrier()

    def _check_group(self) -> None:
        if not dist.is_initialized() or dist.get_world_size() != self.world_size:
            raise RuntimeError(f"a mesh of {self.world_size} ranks needs a default process "
                               f"group of {self.world_size} ranks")


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce_(tensor.clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.mesh.all_reduce_(grad.contiguous().clone()), None


def create_mesh(model_parallel: int = 1) -> Mesh:
    """The data axis over every rank of the process group (one rank without one)."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be at least 1, got {model_parallel}")
    if model_parallel > 1:
        raise NotImplementedError(_TP_NOT_PORTED)
    return Mesh(distributed.world_size(), distributed.rank())


def bind_mesh(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Give every layer under ``module`` that reduces over the batch (a class
    with a ``mesh`` attribute) the mesh to reduce over; ``None`` unbinds."""
    for layer in module.modules():
        if hasattr(type(layer), "mesh"):
            layer.mesh = mesh
    return module


@contextlib.contextmanager
def bound_mesh(module: torch.nn.Module, mesh: Optional[Mesh]):
    """:func:`bind_mesh` for the ``with`` block; the layers' meshes before it
    are given back after it."""
    before = {layer: layer.mesh for layer in module.modules() if hasattr(type(layer), "mesh")}
    bind_mesh(module, mesh)
    try:
        yield module
    finally:
        for layer, previous in before.items():
            layer.mesh = previous


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_params_for_tp(params, mesh: Mesh, min_width: int = 64):
    raise NotImplementedError(_TP_NOT_PORTED)
