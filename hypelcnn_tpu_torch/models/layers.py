"""Layers with tf-slim semantics (``hypelcnn_tpu/models/layers.py``).

tf-slim composes linear (bias only when unnormalized) -> optional batch norm
-> activation, and its batch norm has a bias and no scale, with eps 1e-3.
Submodules keep the flax names (``Conv_0``, ``Dense_0``, ``BatchNorm_0``), so
a flax variable path maps to a ``state_dict`` key by name
(:mod:`hypelcnn_tpu_torch.compat.flax_to_torch`). Tensors are NCHW inside the
models (channels on dim 1) and ``[B, features]`` for the dense layers.

Each layer with weights carries its kernel initializer by name, as the flax
layers carry theirs: ``"xavier"`` (flax's ``xavier_uniform()``, the slim
layers' default) or ``"he_truncated"`` (HYPELCNN's). :func:`init_parameters`
draws every layer's weights from one generator.

``dtype`` is flax's ``dtype=``: with ``torch.bfloat16`` a layer casts its
input and float32 parameters to bfloat16 and computes there (the bias added
after the product, rounded as JAX rounds it); with ``None`` it computes in
the promotion of its input with float32. Parameters stay float32. Batch norm
takes its moments in float32 and normalizes in its ``dtype``.

Under a :class:`~hypelcnn_tpu_torch.parallel.mesh.Mesh` of more than one
data rank (bound with ``bind_mesh``) batch norm's moments are those of the
global batch, and dropout draws its mask over the global batch and keeps
this data index's rows, so that the ranks compute what one process computes.
A ``SlimConv`` or ``SlimDense`` whose kernel holds a slice of its output
channels (``shard_module_``, on a mesh with a model axis) computes those
channels from the full input and gathers the others' before its bias,
batch norm and activation, which see the full width on every model rank.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from hypelcnn_tpu_torch.ops.nn import weak_scalar
from hypelcnn_tpu_torch.parallel.mesh import Mesh

# the JAX package's he_truncated: variance_scaling(2.0, "fan_in",
# "truncated_normal"); the stddev of a unit normal truncated to [-2, 2]
_TRUNCATED_STDDEV = 0.87962566103423978


def he_truncated_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Truncated-normal fan-in init with scale 2 (the JAX package's ``he_truncated``)."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(2.0 / fan_in) / _TRUNCATED_STDDEV
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def xavier_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot-uniform init. On an OIHW or ``[out, in]`` weight torch's fans
    (``I*kh*kw``, ``O*kh*kw``) are flax's ``xavier_uniform()`` fans on the
    HWIO or ``[in, out]`` kernel."""
    return nn.init.xavier_uniform_(weight, generator=generator)


KERNEL_INITS: Dict[str, Callable] = {"xavier": xavier_, "he_truncated": he_truncated_}

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(params: Mapping) -> torch.dtype:
    """The torch dtype of ``params["compute_dtype"]`` (``float32`` by default)."""
    name = params.get("compute_dtype", "float32")
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


def _promote(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    """A layer's ``dtype``, or with ``None`` its input's promotion with float32."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


def _cast_product(op: Callable, x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], dtype: torch.dtype,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``op(x, weight) + bias`` with every operand cast to ``dtype``, the bias
    added after the product as flax adds it. With ``mesh``, ``weight`` is
    this model rank's slice of the output channels: the product's channels
    are gathered over the model axis before the (full, replicated) bias."""
    if mesh is None:
        y = op(x.to(dtype), weight.to(dtype))
    else:
        y = mesh.gather_channels(op(mesh.model_input(x).to(dtype), weight.to(dtype)))
    if bias is None:
        return y
    return y + bias.to(dtype).view((1, -1) + (1,) * (y.dim() - 2))


def _column_mesh(layer: nn.Module, weight: torch.Tensor, features: int) -> Optional[Mesh]:
    """The mesh whose model axis ``layer``'s kernel is sharded over, or None
    for a full kernel; a sliced kernel without such a mesh is an error."""
    if weight.shape[0] == features:
        return None
    mesh = layer.mesh
    if mesh is None or weight.shape[0] * mesh.model_parallel != features:
        raise RuntimeError(f"a kernel of {weight.shape[0]} of {features} output channels needs "
                           "a mesh whose model axis shards it")
    return mesh


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Every batch norm under ``module`` leaves its running statistics as
    they are inside: a forward recomputed for the backward pass (``remat``)
    must not move them a second time."""
    norms = [layer for layer in module.modules() if isinstance(layer, SlimBatchNorm)]
    for norm in norms:
        norm.frozen = True
    try:
        yield
    finally:
        for norm in norms:
            norm.frozen = False


class SlimBatchNorm(nn.Module):
    """Batch norm with a bias and no scale.

    Evaluation normalizes with the running statistics:
    ``(x - mean) * rsqrt(var + eps) + bias``. Training normalizes with the
    biased batch variance and folds the Bessel-corrected one into the
    running variance, as TF's fused batch norm and the JAX package do.
    With ``always_batch_stats`` (CAP) evaluation normalizes with the batch
    statistics too and leaves the running ones as they are: in the JAX
    package they move only where ``batch_stats`` is mutable, in training.
    The moments are ``E[x]`` and ``E[x^2] - E[x]^2`` in float32; on a mesh
    of several ranks, of the sums ``Σx``, ``Σx²`` and the count over them.
    """

    mesh = None
    frozen = False  # True while running_stats_frozen holds

    def __init__(self, features: int, momentum: float = 0.95, epsilon: float = 1e-3,
                 always_batch_stats: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.always_batch_stats = always_batch_stats
        self.dtype = dtype
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def _moments(self, x: torch.Tensor):
        """(mean, biased variance, count) of ``x`` per channel, in float32."""
        dims = [0, *range(2, x.dim())]
        x32 = x.float()
        if self.mesh is None or not self.mesh.sharded:
            mean = x32.mean(dims)
            return mean, (x32 * x32).mean(dims) - mean * mean, x.numel() // x.shape[1]
        features = x.shape[1]
        local = torch.cat([x32.sum(dims), (x32 * x32).sum(dims),
                           x32.new_full((1,), x.numel() // features)])
        sums = self.mesh.all_reduce_sum(local)
        count = sums[-1]
        mean = sums[:features] / count
        return mean, sums[features:2 * features] / count - mean * mean, count

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training or self.always_batch_stats:
            mean, var, n = self._moments(x)
        else:
            mean, var = self.mean, self.var
        if self.training and not self.frozen:
            with torch.no_grad():
                bessel = n / max(n - 1, 1) if isinstance(n, int) else n / (n - 1).clamp(min=1)
                m = self.momentum
                self.mean.mul_(m).add_((1 - m) * mean)
                self.var.mul_(m).add_((1 - m) * var * bessel)
        dtype = self.dtype or x.dtype
        var = var.to(dtype).view(shape)
        # the reciprocal root in float32, rounded once to ``dtype`` as XLA
        # rounds it: torch's bfloat16 rsqrt on the CPU rounds twice
        scale = torch.rsqrt((var + weak_scalar(self.epsilon, var)).float()).to(dtype)
        return (x - mean.to(dtype).view(shape)) * scale + self.bias.to(dtype).view(shape)

    @torch.no_grad()
    def init_parameters_(self, generator: Optional[torch.Generator] = None) -> None:
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)


class SlimConv(nn.Module):
    """conv (SAME padding with an odd kernel, or VALID) -> [batch norm] -> activation."""

    mesh = None

    def __init__(self, in_features: int, features: int, kernel: int,
                 activation: Optional[Callable] = torch.relu, use_batch_norm: bool = False,
                 bn_momentum: float = 0.95, padding: str = "SAME", kernel_init: str = "xavier",
                 always_batch_stats: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if padding == "SAME":
            if kernel % 2 != 1:
                raise ValueError(f"SAME padding is symmetric only for odd kernels, got {kernel}")
            pad = kernel // 2
        elif padding == "VALID":
            pad = 0
        else:
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, padding=pad,
                                bias=not use_batch_norm)
        self.BatchNorm_0 = SlimBatchNorm(features, bn_momentum,
                                         always_batch_stats=always_batch_stats, dtype=dtype) \
            if use_batch_norm else None
        self.activation = activation
        self.kernel_init = kernel_init
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promote(x, self.dtype)
        conv = self.Conv_0
        mesh = _column_mesh(self, conv.weight, conv.out_channels)
        if dtype == torch.float32 and mesh is None:
            x = conv(x.to(dtype))
        else:
            x = _cast_product(lambda a, w: F.conv2d(a, w, padding=conv.padding), x, conv.weight,
                              conv.bias, dtype, mesh)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        if self.activation is not None:
            x = self.activation(x)
        return x

    @torch.no_grad()
    def init_parameters_(self, generator: Optional[torch.Generator] = None) -> None:
        KERNEL_INITS[self.kernel_init](self.Conv_0.weight, generator)
        if self.Conv_0.bias is not None:
            self.Conv_0.bias.zero_()


class SlimDense(nn.Module):
    """dense -> [batch norm] -> activation."""

    mesh = None

    def __init__(self, in_features: int, features: int,
                 activation: Optional[Callable] = torch.relu, use_batch_norm: bool = False,
                 bn_momentum: float = 0.95, kernel_init: str = "xavier",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=not use_batch_norm)
        self.BatchNorm_0 = SlimBatchNorm(features, bn_momentum, dtype=dtype) \
            if use_batch_norm else None
        self.activation = activation
        self.kernel_init = kernel_init
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promote(x, self.dtype)
        dense = self.Dense_0
        mesh = _column_mesh(self, dense.weight, dense.out_features)
        if dtype == torch.float32 and mesh is None:
            x = dense(x.to(dtype))
        else:
            x = _cast_product(F.linear, x, dense.weight, dense.bias, dtype, mesh)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        if self.activation is not None:
            x = self.activation(x)
        return x

    @torch.no_grad()
    def init_parameters_(self, generator: Optional[torch.Generator] = None) -> None:
        KERNEL_INITS[self.kernel_init](self.Dense_0.weight, generator)
        if self.Dense_0.bias is not None:
            self.Dense_0.bias.zero_()


class Dropout(nn.Module):
    """Dropout as flax computes it (``where(keep, x / keep_prob, 0)``, and
    zeros at rate 1), with its mask drawn from an explicit generator, never
    from torch's global state, in float32 whatever ``x``'s dtype. In
    training with a rate strictly between 0 and 1, a missing generator is an
    error. On a mesh of several data ranks the mask is drawn over the global
    batch (this rank's rows times the data axis) and this data index's rows
    are kept: the model ranks of one data index draw the same mask."""

    mesh = None

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("train-mode dropout needs a generator")
        keep_prob = 1.0 - self.rate
        mesh = self.mesh or Mesh()
        total = x.shape[0] * mesh.data_size
        u = torch.rand((total, *x.shape[1:]), generator=generator, device=x.device,
                       dtype=torch.float32)[mesh.rows(total)]
        keep = u < keep_prob
        return torch.where(keep, x / weak_scalar(keep_prob, x), torch.zeros_like(x))


def multi_scale_level(x: torch.Tensor, convs: Sequence[nn.Module]) -> torch.Tensor:
    """Parallel SAME convolutions, one per odd kernel size, concatenated on channels."""
    outs = [conv(x) for conv in convs]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def level_kernel_sizes(patch: int) -> range:
    """The odd kernel sizes of a multi-scale level over a ``patch``-wide input."""
    return range(1, patch + 1, 2)


class FusedMultiScaleLevel(nn.Module):
    """A whole multi-scale level as one ``k_max x k_max`` SAME convolution
    (``hypelcnn_tpu/models/layers.py:FusedMultiScaleLevel``).

    Each branch kernel, zero-padded to ``k_max``, is a block of output
    channels of one weight, rebuilt from the branch parameters at every
    forward so that gradients reach them; the output is the branches'
    concatenation. Parameters keep the flax names ``conv{k}x{k}_kernel``
    (OIHW here) and ``conv{k}x{k}_bias``; with batch norm there are no
    biases and one ``BatchNorm_0`` normalizes the concatenated channels.
    """

    def __init__(self, in_features: int, features: int, patch: int,
                 activation: Optional[Callable] = torch.relu, use_batch_norm: bool = False,
                 bn_momentum: float = 0.95, kernel_init: str = "xavier",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel_sizes = tuple(level_kernel_sizes(patch))
        for k in self.kernel_sizes:
            self.register_parameter(f"conv{k}x{k}_kernel",
                                    nn.Parameter(torch.zeros(features, in_features, k, k)))
            if not use_batch_norm:
                self.register_parameter(f"conv{k}x{k}_bias", nn.Parameter(torch.zeros(features)))
        self.BatchNorm_0 = SlimBatchNorm(features * len(self.kernel_sizes), bn_momentum,
                                         dtype=dtype) if use_batch_norm else None
        self.activation = activation
        self.kernel_init = kernel_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kmax = self.kernel_sizes[-1]
        kernels = []
        for k in self.kernel_sizes:
            pad = (kmax - k) // 2
            kernels.append(F.pad(getattr(self, f"conv{k}x{k}_kernel"), (pad, pad, pad, pad)))
        bias = None if self.BatchNorm_0 is not None else torch.cat(
            [getattr(self, f"conv{k}x{k}_bias") for k in self.kernel_sizes])
        dtype = _promote(x, self.dtype)
        if dtype == torch.float32:
            y = F.conv2d(x.to(dtype), torch.cat(kernels, dim=0), bias, padding=kmax // 2)
        else:
            y = _cast_product(lambda a, w: F.conv2d(a, w, padding=kmax // 2), x,
                              torch.cat(kernels, dim=0), bias, dtype)
        if self.BatchNorm_0 is not None:
            y = self.BatchNorm_0(y)
        if self.activation is not None:
            y = self.activation(y)
        return y

    @torch.no_grad()
    def init_parameters_(self, generator: Optional[torch.Generator] = None) -> None:
        for k in self.kernel_sizes:
            KERNEL_INITS[self.kernel_init](getattr(self, f"conv{k}x{k}_kernel"), generator)
            if self.BatchNorm_0 is None:
                getattr(self, f"conv{k}x{k}_bias").zero_()


_BRANCH = re.compile(r"^(.+)_(conv\d+x\d+)$")


def fuse_level_params(branches: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-branch ``SlimConv`` state dicts (``conv{k}x{k}`` -> ``{"Conv_0.weight",
    ["Conv_0.bias"], ["BatchNorm_0.bias|mean|var"]}``) -> one
    :class:`FusedMultiScaleLevel` state dict; batch-norm vectors are
    concatenated in ascending k, as the branch outputs are."""
    names = sorted(branches, key=lambda name: int(name[len("conv"):].split("x", 1)[0]))
    fused: Dict[str, torch.Tensor] = {}
    for name in names:
        sub = branches[name]
        fused[f"{name}_kernel"] = sub["Conv_0.weight"]
        if "Conv_0.bias" in sub:
            fused[f"{name}_bias"] = sub["Conv_0.bias"]
    for leaf in ("bias", "mean", "var"):
        parts = [branches[n][f"BatchNorm_0.{leaf}"] for n in names
                 if f"BatchNorm_0.{leaf}" in branches[n]]
        if parts:
            fused[f"BatchNorm_0.{leaf}"] = torch.cat(parts)
    return fused


def fuse_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An unfused model's ``state_dict`` in the fused-level layout.

    Top-level modules named ``{base}_conv{k}x{k}`` (HYPELCNN's
    ``connector_{i}_conv{k}x{k}``, DUALCNN's ``level{i}_conv{k}x{k}``) merge
    into one ``{base}_fused`` :class:`FusedMultiScaleLevel` per base; every
    other key passes through, so a checkpoint trained unfused loads into a
    model built with ``fuse_level_convs``.
    """
    out: Dict[str, torch.Tensor] = {}
    groups: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}
    for key, value in state_dict.items():
        module, _, rest = key.partition(".")
        match = _BRANCH.match(module)
        if match:
            groups.setdefault(match.group(1), {}).setdefault(match.group(2), {})[rest] = value
        else:
            out[key] = value
    for base, branches in groups.items():
        for leaf, value in fuse_level_params(branches).items():
            out[f"{base}_fused.{leaf}"] = value
    return out


@torch.no_grad()
def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Initialize every layer under ``module`` as the JAX package does: each
    layer's kernels with its own initializer, zero biases, running mean 0 and
    variance 1, drawn in module order from ``generator``. A module with
    weights of its own (CAP's capsule transform) defines ``init_parameters_``
    too."""
    for layer in module.modules():
        init = getattr(layer, "init_parameters_", None)
        if init is not None:
            init(generator)
