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

Every convolution goes through :func:`conv2d`, which routes by shape alone.
A SAME convolution whose odd kernel ``k > 1`` covers its input (``H <= k``
and ``W <= k``) is a dense linear map from ``Cin*H*W`` inputs to
``Cout*H*W`` outputs: one GEMM against its Toeplitz weight
(:func:`toeplitz_weight`), which does the work of the convolution's taps,
SAME padding included. Without autograd (a sweep) the forward is that GEMM;
under autograd (a training step) the forward stays ``F.conv2d``'s and the
input and weight gradients are the two GEMMs of its backward. A 1x1
convolution is a product over pixels: under autograd its forward stays
``F.conv2d``'s and its gradients are two GEMMs over the pixel rows
(:class:`_PointwiseGradients`). Everything else (a 1x1 without autograd,
VALID, a kernel smaller than its window) goes to ``F.conv2d``.
``conv2d.gemm``, ``conv2d.pointwise`` and ``conv2d.cudnn`` count the
convolutions of each route.
"""

from __future__ import annotations

import contextlib
import functools
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


@functools.lru_cache(maxsize=None)
def _reversed(n: int, device: torch.device) -> torch.Tensor:
    """``[n - 1, ..., 0]`` on ``device``, made once."""
    return torch.arange(n - 1, -1, -1, device=device)


def _taps(weight_shape: Sequence[int], height: int, width: int):
    """The crop of the kernel's taps that a ``height x width`` window reaches,
    and the unfold's padding that makes its positions the output pixels."""
    kh, kw = weight_shape[2:]
    pad_h, pad_w = height - 1 - kh // 2, width - 1 - kw // 2
    return (max(-pad_h, 0), max(-pad_w, 0)), (max(pad_h, 0), max(pad_w, 0))


def toeplitz_weight(weight: torch.Tensor, height: int, width: int,
                    channels_last: bool = False) -> torch.Tensor:
    """The matrix of a SAME convolution by ``weight`` (``[Cout, Cin, k, k]``, odd
    ``k``) over a ``height x width`` input: ``T[(co, i, j), (ci, p, q)] =
    weight[co, ci, p - i + k // 2, q - j + k // 2]``, and 0 where the tap falls
    outside the kernel. With ``channels_last`` its rows are ``(i, j, co)`` and
    its columns ``(p, q, ci)``.

    Two kernels whatever the shape: one unfold of the weight with a
    ``height x width`` kernel, its taps padded (or cropped) so that the
    unfold's positions are the output pixels in reverse, then one
    ``index_select`` that reverses them into ``T``'s layout.
    :func:`_toeplitz_adjoint` is its transpose.
    """
    cout, cin, kh, kw = weight.shape
    hw = height * width
    (crop_h, crop_w), padding = _taps(weight.shape, height, width)
    weight = weight[:, :, crop_h:kh - crop_h, crop_w:kw - crop_w]
    # [co, (ci, p, q), (s, t)]: position (s, t) is the output pixel (H - 1 - s, W - 1 - t)
    cols = F.unfold(weight.reshape(1, cout * cin, *weight.shape[2:]), (height, width),
                    padding=padding).view(cout, cin, hw, hw)
    rev = _reversed(hw, weight.device)
    if channels_last:
        return cols.permute(3, 0, 2, 1).index_select(0, rev).view(hw * cout, hw * cin)
    return cols.permute(0, 3, 1, 2).index_select(1, rev).view(cout * hw, cin * hw)


def _toeplitz_adjoint(grad: torch.Tensor, weight_shape: Sequence[int], height: int,
                      width: int, channels_last: bool) -> torch.Tensor:
    """The weight's gradient from ``T``'s: the transpose of
    :func:`toeplitz_weight`, one ``index_select`` and one fold (each output a
    sum in a fixed order, no atomic adds)."""
    cout, cin, kh, kw = weight_shape
    hw = height * width
    (crop_h, crop_w), padding = _taps(weight_shape, height, width)
    if channels_last:
        rows = grad.view(hw, cout, hw, cin).permute(1, 3, 2, 0)
    else:
        rows = grad.view(cout, hw, cin, hw).permute(0, 2, 3, 1)
    cols = rows.index_select(3, _reversed(hw, grad.device))  # [co, ci, (p, q), (s, t)]
    taps = (kh - 2 * crop_h, kw - 2 * crop_w)
    out = F.fold(cols.view(1, cout * cin * hw, hw), taps, (height, width),
                 padding=padding).view(cout, cin, *taps)
    return F.pad(out, (crop_w, crop_w, crop_h, crop_h)) if crop_h or crop_w else out


def _pixel_rows(x: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, C*H*W]`` in the column order of :func:`toeplitz_weight`."""
    if channels_last:
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return x.reshape(x.shape[0], -1)


def _image(rows: torch.Tensor, shape: Sequence[int], channels_last: bool) -> torch.Tensor:
    """The inverse of :func:`_pixel_rows`: a view of ``rows`` as ``shape`` (NCHW)."""
    batch, channels, height, width = shape
    if channels_last:
        return rows.view(batch, height, width, channels).permute(0, 3, 1, 2)
    return rows.view(batch, channels, height, width)


def _channel_rows(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B*H*W, C]``, a row a pixel: a view where the
    channels vary fastest in ``x``'s memory, one copy otherwise."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def _channels_last(x: torch.Tensor) -> bool:
    """Whether the channels vary faster than the columns in ``x``'s memory
    (an NHWC tensor's NCHW view): the GEMM then runs channels last, so that
    neither side is transposed."""
    return x.stride(1) < x.stride(3)


def conv2d_gemm(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, padding=k // 2)`` as one GEMM of the input's
    pixels against :func:`toeplitz_weight`, in the input's memory order (the
    output keeps it), the bias added after the product. A forward only: the
    route under autograd is :class:`_GemmGradients`."""
    cl = _channels_last(x)
    y = F.linear(_pixel_rows(x, cl), toeplitz_weight(weight, *x.shape[2:], cl))
    y = _image(y, (x.shape[0], weight.shape[0], *x.shape[2:]), cl)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


class _GemmGradients(torch.autograd.Function):
    """``F.conv2d(x, weight, bias, padding=k // 2)``, whose gradients are
    GEMMs against :func:`toeplitz_weight`: ``grad @ T`` for the input and
    ``gradᵀ @ x`` for ``T``, taken onto the weight by its transpose."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv2d(x, weight, bias, padding=weight.shape[-1] // 2)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        cl = _channels_last(x)
        size = x.shape[2:]
        rows = _pixel_rows(grad, cl)
        grad_x = grad_w = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_x = _image(rows @ toeplitz_weight(weight, *size, cl), x.shape, cl)
        if ctx.needs_input_grad[1]:
            grad_w = _toeplitz_adjoint(rows.t() @ _pixel_rows(x, cl), weight.shape, *size, cl)
        if ctx.needs_input_grad[2]:
            grad_b = grad.sum((0, 2, 3))
        return grad_x, grad_w, grad_b


class _PointwiseGradients(torch.autograd.Function):
    """``F.conv2d(x, weight, bias)`` for a 1x1 ``weight``, whose gradients are
    two GEMMs over the pixel rows (:func:`_channel_rows`) of the output's
    gradient ``G`` and the input ``X``: ``G @ W`` for the input (in ``x``'s
    memory order), ``Gᵀ @ X`` for the weight, and ``G``'s column sums for
    the bias."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv2d(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        rows = _channel_rows(grad)
        grad_x = grad_w = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_x = _image(rows @ weight.reshape(weight.shape[:2]), x.shape, True)
            if not _channels_last(x):
                grad_x = grad_x.contiguous()
        if ctx.needs_input_grad[1]:
            grad_w = (rows.t() @ _channel_rows(x)).view(weight.shape)
        if ctx.needs_input_grad[2]:
            grad_b = rows.sum(0)
        return grad_x, grad_w, grad_b


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           padding: int) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, padding=padding)``, routed by shape and
    grad mode: where the padding is SAME, the kernel is wider than 1 and it
    covers the input, the GEMMs against :func:`toeplitz_weight`; a 1x1
    convolution that autograd records (grad mode on, ``x`` or ``weight``
    requiring grad), :class:`_PointwiseGradients`; ``F.conv2d`` (cuDNN on
    the card) otherwise. ``conv2d.gemm``, ``conv2d.pointwise`` and
    ``conv2d.cudnn`` count the calls of each route.

    A forward that autograd records stays ``F.conv2d``'s and only its
    gradients are GEMMs: a training step then rounds its forward as the plain
    convolution does. DUALCNN's training amplifies a change of the forward's
    float32 summation order alone (not of the backward's) into its parameters'
    change over three steps (PERF.md §6)."""
    k = weight.shape[-1]
    if k > 1 and padding == k // 2 and x.shape[-2] <= k and x.shape[-1] <= k:
        conv2d.gemm += 1
        if torch.is_grad_enabled():
            return _GemmGradients.apply(x, weight, bias)
        return conv2d_gemm(x, weight, bias)
    if (weight.shape[-2:] == (1, 1) and padding == 0 and torch.is_grad_enabled()
            and (x.requires_grad or weight.requires_grad)):
        conv2d.pointwise += 1
        return _PointwiseGradients.apply(x, weight, bias)
    conv2d.cudnn += 1
    return F.conv2d(x, weight, bias, padding=padding)


def reset_conv_counts() -> None:
    """Set each of :func:`conv2d`'s counts to 0."""
    conv2d.gemm = 0
    conv2d.pointwise = 0
    conv2d.cudnn = 0


reset_conv_counts()


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (stride 1, zero padding) that convolves through :func:`conv2d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.padding[0])


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
        self.Conv_0 = Conv2d(in_features, features, kernel, padding=pad,
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
            x = _cast_product(lambda a, w: conv2d(a, w, None, conv.padding[0]), x, conv.weight,
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
            y = conv2d(x.to(dtype), torch.cat(kernels, dim=0), bias, kmax // 2)
        else:
            y = _cast_product(lambda a, w: conv2d(a, w, None, kmax // 2), x,
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
