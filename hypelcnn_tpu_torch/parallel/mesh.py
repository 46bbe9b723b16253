"""The (data, model) mesh and its collectives (``hypelcnn_tpu/parallel/mesh.py``).

In JAX several devices form one logical program over a global batch, and
XLA inserts every collective from the sharding annotations. In the port
each rank holds its rows of the global batch, and its shard of the wide
kernels, and the collectives are explicit, through a :class:`Mesh` of
``data x model`` ranks. Rank ``r`` has data index ``r // model`` and model
index ``r % model``, as JAX's ``create_mesh`` reshapes the devices.

The data axis (data parallelism):

- batch norm's moments (``Σx``, ``Σx²`` and the count), CAP's routing
  agreement and the feature discriminator's norm are summed over the data
  axis in the forward pass by :meth:`Mesh.all_reduce_sum`, whose backward
  sums the gradient the same way;
- every optimizer step averages the gradients over the data axis in one
  flat all-reduce (:meth:`Mesh.mean`), the loss riding in the same buffer;
- a rank's rows are :meth:`Mesh.rows` (equal shares) or :meth:`Mesh.split`
  (a sweep band, whose shares may differ by one), dealt by data index: the
  model ranks of one data index hold the same rows.

The model axis (tensor parallelism): :func:`shard_params_for_tp` keeps on
each rank its slice of the output channels of every wide ``Conv_0`` and
``Dense_0`` kernel, JAX's rule. A layer with such a kernel
(``models/layers.py``) computes its channels from the full input, whose
gradient is summed over the model axis (:meth:`Mesh.model_input`), and
gathers the channels of the other model ranks (:meth:`Mesh.gather_channels`,
whose backward hands each rank the gradient of its own channels), so that
everything after it is replicated.

Every collective is an ``all_reduce`` (a gather is an all-reduce of a
zero-filled tensor, exact since each element has one nonzero owner), a
``broadcast`` (:func:`~hypelcnn_tpu_torch.parallel.distributed.from_chief`)
or a barrier after a save: gloo offers only ``all_reduce`` and
``broadcast`` on CUDA tensors, so the same code runs on NCCL across cards
and on gloo with ranks sharing one card. A mesh of one rank runs no
collective at all, whether or not a process group exists (one plain
process, or one rank under torchrun), and the layers take their
batch-coupled global forms only on more than one data rank. Without a model
axis the data axis is the default process group, whose size must be the
mesh's; with one, :func:`create_mesh` makes every data and model subgroup
on every rank, in the same order.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from hypelcnn_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the port's names of flax's ``.../Conv_0/kernel`` and ``.../Dense_0/kernel``
TP_KERNELS = ("Conv_0.weight", "Dense_0.weight")


class Mesh:
    """``world_size`` ranks as ``data x model_parallel``, of which this
    process is ``rank``; ``groups`` are this rank's (data, model) subgroups,
    which a model axis needs for its collectives (:func:`create_mesh`)."""

    def __init__(self, world_size: int = 1, rank: int = 0, model_parallel: int = 1,
                 groups: Optional[Tuple[object, object]] = None):
        if model_parallel < 1 or world_size % model_parallel:
            raise ValueError(f"model_parallel={model_parallel} does not divide device count "
                             f"{world_size}")
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.model_parallel = int(model_parallel)
        self.data_size = self.world_size // self.model_parallel
        self.data_rank, self.model_rank = divmod(self.rank, self.model_parallel)
        self.groups = groups
        self.channel_gathers = 0  # model-axis collectives run, forward gathers
        self.gradient_sums = 0    # and input-gradient sums

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_parallel}

    @property
    def sharded(self) -> bool:
        """More than one data rank: the data collectives run and
        batch-coupled layers take their global forms."""
        return self.data_size > 1

    @property
    def tensor_parallel(self) -> bool:
        return self.model_parallel > 1

    def rows(self, total: int) -> slice:
        """This data index's rows of ``total`` in equal shares; raises when they are not."""
        if total % self.data_size:
            raise ValueError(f"batch {total} not divisible by the data axis {self.data_size}")
        share = total // self.data_size
        return slice(self.data_rank * share, (self.data_rank + 1) * share)

    def split(self, total: int) -> slice:
        """This data index's rows of ``total`` as ``torch.tensor_split`` deals
        them (the first ``total % data_size`` shares one longer)."""
        share, extra = divmod(total, self.data_size)
        start = self.data_rank * share + min(self.data_rank, extra)
        return slice(start, start + share + (self.data_rank < extra))

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the data axis in place (no autograd); nothing
        on one data rank."""
        if self.sharded:
            self._reduce(tensor, self._group(0))
        return tensor

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum of ``tensor`` over the data axis, differentiable: the
        backward sums the incoming gradient over the data axis too."""
        return _AllReduceSum.apply(tensor, self)

    def mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the data axis of each tensor, in one flat all-reduce;
        returns views of the reduced buffer, shaped as the inputs (on one
        data rank, the tensors themselves)."""
        if not self.sharded:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_(flat).div_(self.data_size)
        return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                   tensors)]

    def gather_rows(self, local: torch.Tensor, total: int, rows: slice) -> torch.Tensor:
        """The ``[total, ...]`` tensor whose ``rows`` are this data index's
        ``local`` and whose other rows are the other data indices'."""
        out = torch.zeros((total, *local.shape[1:]), dtype=local.dtype, device=local.device)
        out[rows] = local
        return self.all_reduce_(out)

    # ---- the model axis ----

    def model_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it is, whose gradient is summed over the model axis: the
        input of a product each model rank computes on its own channels."""
        return _ModelInput.apply(x, self)

    def gather_channels(self, local: torch.Tensor) -> torch.Tensor:
        """The channels (dim 1) of every model rank, this rank's ``local``
        in its own slot; the backward hands each rank its slot's gradient."""
        return _GatherChannels.apply(local, self)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This model rank's slice of ``full``'s dim 0."""
        share = full.shape[0] // self.model_parallel
        return full.narrow(0, self.model_rank * share, share)

    def gather_shards(self, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The full tensor of which every model rank holds its equal slice of
        ``dim`` (its :meth:`shard` for dim 0), in the model rank's order."""
        share = local.shape[dim]
        shape = list(local.shape)
        shape[dim] = share * self.model_parallel
        out = local.new_zeros(shape)
        out.narrow(dim, self.model_rank * share, share).copy_(local)
        return self._reduce(out, self._group(1))

    def barrier(self) -> None:
        if self.world_size > 1:
            self._check_world()
            dist.barrier()

    def _group(self, axis: int):
        """This rank's subgroup of ``axis`` (0 data, 1 model); the default
        group for the data axis of a mesh without a model axis."""
        if not self.tensor_parallel and axis == 0:
            self._check_world()
            return None
        if self.groups is None:
            raise RuntimeError(f"a mesh of {self.data_size} x {self.model_parallel} ranks needs "
                               "its data and model subgroups (create_mesh makes them)")
        return self.groups[axis]

    @staticmethod
    def _reduce(tensor: torch.Tensor, group) -> torch.Tensor:
        """All-reduce in place. An inference tensor (made under
        ``torch.inference_mode``) is reduced in that mode: gloo copies a CUDA
        tensor's result back into it in place."""
        with torch.inference_mode(tensor.is_inference()):
            dist.all_reduce(tensor, group=group)
        return tensor

    def _check_world(self) -> None:
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


class _ModelInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        mesh.gradient_sums += 1
        return mesh._reduce(grad.contiguous().clone(), mesh._group(1)), None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh, ctx.share = mesh, local.shape[1]
        mesh.channel_gathers += 1
        return mesh.gather_shards(local, dim=1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        # what follows the gather is replicated, so every model rank holds
        # the whole gradient already: each keeps its own channels' (a sum
        # would give model_parallel times the gradient)
        return grad.narrow(1, ctx.mesh.model_rank * ctx.share, ctx.share).contiguous(), None


def _subgroups(world: int, model_parallel: int) -> Tuple[object, object]:
    """Every data and every model subgroup, made in the same order on every
    rank (``dist.new_group`` is collective); returns this rank's two."""
    data = [dist.new_group(list(range(m, world, model_parallel)))
            for m in range(model_parallel)]
    model = [dist.new_group(list(range(d * model_parallel, (d + 1) * model_parallel)))
             for d in range(world // model_parallel)]
    rank = distributed.rank()
    return data[rank % model_parallel], model[rank // model_parallel]


def create_mesh(model_parallel: int = 1) -> Mesh:
    """A (data, model) mesh over every rank of the process group (one rank
    without one); ``model_parallel`` must divide the rank count, as in JAX."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be at least 1, got {model_parallel}")
    world = distributed.world_size()
    if world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide device count {world}")
    groups = _subgroups(world, model_parallel) if model_parallel > 1 else None
    return Mesh(world, distributed.rank(), model_parallel, groups)


def bind_mesh(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Give every layer under ``module`` that reduces over the batch or may
    hold a sharded kernel (a class with a ``mesh`` attribute) the mesh to
    reduce and gather over; ``None`` unbinds."""
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


def tp_sharded_keys(state_dict: Mapping[str, torch.Tensor], model_parallel: int,
                    min_width: int = 64) -> List[str]:
    """The keys of the full-width ``state_dict`` whose tensors a model axis of
    ``model_parallel`` shards: JAX's rule (``shard_params_for_tp``) on the
    port's names, a ``Conv_0`` or ``Dense_0`` kernel whose output channels
    (torch's dim 0, flax's last) number at least ``min_width`` and divide
    over the axis. Biases, batch norm, fused levels' ``conv{k}x{k}_kernel``
    and CAP's ``digitcaps_w`` stay replicated."""
    if model_parallel <= 1:
        return []
    return [key for key, value in state_dict.items()
            if key.endswith(TP_KERNELS) and value.dim() >= 2
            and value.shape[0] >= min_width and value.shape[0] % model_parallel == 0]


def shard_params_for_tp(state_dict: Mapping[str, torch.Tensor], mesh: Mesh,
                        min_width: int = 64) -> Dict[str, torch.Tensor]:
    """The full-width ``state_dict`` with each kernel of :func:`tp_sharded_keys`
    cut to this rank's slice of its output channels (a view); every other
    tensor as it is. A no-op on a mesh without a model axis."""
    keys = set(tp_sharded_keys(state_dict, mesh.model_parallel, min_width))
    return {key: mesh.shard(value) if key in keys else value
            for key, value in state_dict.items()}


@torch.no_grad()
def shard_module_(module: torch.nn.Module, mesh: Mesh, min_width: int = 64) -> List[str]:
    """Replace each of ``module``'s full-width kernels that :func:`tp_sharded_keys`
    names by this rank's slice (a parameter of its own); returns the keys."""
    params = dict(module.named_parameters())
    keys = tp_sharded_keys(params, mesh.model_parallel, min_width)
    for key in keys:
        owner, _, leaf = key.rpartition(".")
        setattr(module.get_submodule(owner), leaf,
                torch.nn.Parameter(mesh.shard(params[key]).clone()))
    return keys
