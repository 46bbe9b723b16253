"""A SAME convolution whose kernel covers its input, as one GEMM against its
Toeplitz weight (``hypelcnn_tpu_torch/models/layers.py`` ``conv2d``).

- The lowering equals ``F.conv2d``, forward and the gradients of the
  input, the weight and the bias, in float64 (to rounding) and float32, on
  NCHW tensors and on the permuted NHWC views the models hand it: the GEMM
  forward of a sweep, and the route under autograd (``F.conv2d``'s forward,
  the GEMMs' gradients).
- The route depends on the shapes alone: SAME, a kernel wider than 1 that
  covers the input takes the GEMM; 1x1, VALID and a kernel smaller than its
  window go to ``F.conv2d``.
- The counts of a forward of HYPELCNN-480 and DUALCNN at their published
  widths.
- The bfloat16 cast path rounds as ``F.conv2d`` in bfloat16 does.
"""

import pytest
import torch
from torch.nn import functional as F

from hypelcnn_tpu_torch.core.registry import get_model_from_name
from hypelcnn_tpu_torch.models.layers import (
    FusedMultiScaleLevel,
    SlimConv,
    _toeplitz_adjoint,
    conv2d,
    conv2d_gemm,
    init_parameters,
    reset_conv_counts,
    toeplitz_weight,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# float64: rounding alone; float32: sums of up to 6 * 25 products in two orders
TOLERANCES = {torch.float64: dict(rtol=1e-12, atol=1e-12),
              torch.float32: dict(rtol=1e-5, atol=1e-5)}


def _input(batch, channels, height, width, dtype, nhwc, gen):
    x = torch.randn(batch, height, width, channels, generator=gen, dtype=torch.float64).to(dtype)
    # an NHWC tensor's NCHW view, as the models permute their patches
    return x.permute(0, 3, 1, 2) if nhwc else x.permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc_view"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("height, kernel", [(3, 3), (5, 5), (3, 5), (1, 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("route", ["sweep", "autograd"])
def test_lowering_matches_conv2d(route, dtype, height, kernel, with_bias, nhwc):
    """``sweep``: the GEMM forward; ``autograd``: ``conv2d`` under autograd,
    its forward and the gradients of the input, the weight and the bias."""
    gen = torch.Generator().manual_seed(height * 10 + kernel)
    x = _input(4, 6, height, height, dtype, nhwc, gen).requires_grad_()
    weight = torch.randn(5, 6, kernel, kernel, generator=gen, dtype=torch.float64).to(dtype)
    weight.requires_grad_()
    bias = torch.randn(5, generator=gen, dtype=torch.float64).to(dtype).requires_grad_() \
        if with_bias else None
    leaves = [t for t in (x, weight, bias) if t is not None]
    expected = F.conv2d(x, weight, bias, padding=kernel // 2)
    layout = torch.channels_last if nhwc else torch.contiguous_format
    if route == "sweep":
        with torch.no_grad():
            got = conv2d_gemm(x, weight, bias)
        torch.testing.assert_close(got, expected, **TOLERANCES[dtype])
        assert got.is_contiguous(memory_format=layout)  # the input's memory order
        return
    got = conv2d(x, weight, bias, kernel // 2)
    torch.testing.assert_close(got, expected, **TOLERANCES[dtype])
    upstream = torch.randn(expected.shape, generator=gen, dtype=torch.float64).to(dtype)
    grads = torch.autograd.grad(got, leaves, upstream)
    for g, e in zip(grads, torch.autograd.grad(expected, leaves, upstream)):
        torch.testing.assert_close(g, e, **TOLERANCES[dtype])
    assert grads[0].is_contiguous(memory_format=layout)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("height, width, kernel", [(3, 3, 3), (5, 5, 5), (3, 2, 5), (1, 1, 5)])
def test_toeplitz_adjoint_is_the_transpose(channels_last, height, width, kernel):
    """<T(w), G> = <w, T*(G)> for any w and G, in float64."""
    gen = torch.Generator().manual_seed(height + width + kernel)
    weight = torch.randn(4, 3, kernel, kernel, generator=gen, dtype=torch.float64)
    t = toeplitz_weight(weight, height, width, channels_last)
    grad = torch.randn(t.shape, generator=gen, dtype=torch.float64)
    adjoint = _toeplitz_adjoint(grad, weight.shape, height, width, channels_last)
    assert adjoint.shape == weight.shape
    torch.testing.assert_close((t * grad).sum(), (weight * adjoint).sum(), rtol=1e-12, atol=1e-12)


def test_forward_under_autograd_is_conv2d_and_without_it_the_gemm():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(8, 6, 3, 3, generator=gen)
    weight = torch.randn(4, 6, 3, 3, generator=gen, requires_grad=True)
    bias = torch.randn(4, generator=gen, requires_grad=True)
    assert torch.equal(conv2d(x, weight, bias, 1), F.conv2d(x, weight, bias, padding=1))
    with torch.no_grad():
        assert torch.equal(conv2d(x, weight, bias, 1), conv2d_gemm(x, weight, bias))


@pytest.mark.parametrize("channels_last", [False, True])
def test_toeplitz_weight_entries(channels_last):
    """Each entry is the tap its pixel pair reaches, 0 past the kernel."""
    weight = torch.arange(2 * 3 * 25, dtype=torch.float64).view(2, 3, 5, 5) + 1
    h, w = 3, 2
    t = toeplitz_weight(weight, h, w, channels_last)
    assert t.shape == (2 * h * w, 3 * h * w)
    for co in range(2):
        for i in range(h):
            for j in range(w):
                row = (i * w + j) * 2 + co if channels_last else (co * h + i) * w + j
                for ci in range(3):
                    for p in range(h):
                        for q in range(w):
                            col = (p * w + q) * 3 + ci if channels_last else (ci * h + p) * w + q
                            a, b = p - i + 2, q - j + 2
                            tap = weight[co, ci, a, b] if 0 <= a < 5 and 0 <= b < 5 else 0.0
                            assert t[row, col] == tap


# (input height, width, kernel, padding, route)
ROUTES = [
    (3, 3, 3, 1, "gemm"),    # HYPELCNN's and DUALCNN's HSI 3x3 levels
    (5, 5, 5, 2, "gemm"),    # DUALCNN's LiDAR and CONCNN's 5x5
    (3, 3, 5, 2, "gemm"),    # a kernel wider than its window
    (1, 1, 3, 1, "gemm"),
    (2, 3, 3, 1, "gemm"),
    (3, 3, 1, 0, "cudnn"),   # 1x1
    (3, 3, 3, 0, "cudnn"),   # VALID (CAP)
    (5, 5, 3, 1, "cudnn"),   # a kernel smaller than its window (DUALCNN's LiDAR 3x3)
    (5, 3, 3, 1, "cudnn"),   # taller than the kernel
]


@pytest.mark.parametrize("height, width, kernel, padding, route", ROUTES)
def test_route_by_shape(height, width, kernel, padding, route):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 4, height, width, generator=gen)
    weight = torch.randn(3, 4, kernel, kernel, generator=gen)
    reset_conv_counts()
    got = conv2d(x, weight, None, padding)
    assert {"gemm": conv2d.gemm, "cudnn": conv2d.cudnn} == \
        {"gemm": int(route == "gemm"), "cudnn": int(route == "cudnn")}
    torch.testing.assert_close(got, F.conv2d(x, weight, padding=padding), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padding, kernel, window, gemm", [
    ("SAME", 3, 3, 1), ("SAME", 5, 5, 1), ("SAME", 1, 3, 0), ("VALID", 3, 3, 0),
    ("SAME", 3, 5, 0)])
def test_slim_conv_routes_by_shape(padding, kernel, window, gemm):
    layer = SlimConv(4, 3, kernel, padding=padding)
    init_parameters(layer, torch.Generator().manual_seed(0))
    x = torch.rand(2, 4, window, window)
    reset_conv_counts()
    got = layer(x)
    assert (conv2d.gemm, conv2d.cudnn) == (gemm, 1 - gemm)
    expected = F.leaky_relu(F.conv2d(x, layer.Conv_0.weight, layer.Conv_0.bias,
                                     padding=layer.Conv_0.padding), 0.0)
    torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("patch, gemm", [(3, 1), (5, 1), (1, 0)])
def test_fused_level_routes_by_its_widest_kernel(patch, gemm):
    level = FusedMultiScaleLevel(4, 3, patch)
    init_parameters(level, torch.Generator().manual_seed(0))
    reset_conv_counts()
    level(torch.rand(2, 4, patch, patch))
    assert (conv2d.gemm, conv2d.cudnn) == (gemm, 1 - gemm)


# (model, published params plus, patch, GEMM, F.conv2d) a forward
COUNTS = [
    ("HYPELCNNModel", {}, 3, 3, 12),
    ("DUALCNNModel", {}, 5, 11, 25),
    ("HYPELCNNModel", {"fuse_level_convs": True}, 3, 3, 9),
    ("DUALCNNModel", {"fuse_level_convs": True}, 5, 11, 11),
]


@pytest.mark.parametrize("model_name, params, patch, gemm, cudnn", COUNTS,
                         ids=["hypelcnn480", "dualcnn", "hypelcnn480_fused", "dualcnn_fused"])
def test_counts_of_a_forward(model_name, params, patch, gemm, cudnn):
    model = get_model_from_name(model_name)
    module = model.create_module(15, {**model.default_params(), **params}, (patch, patch, 145))
    module.eval()
    reset_conv_counts()
    with torch.no_grad():
        module(torch.rand(2, patch, patch, 145))
    assert (conv2d.gemm, conv2d.cudnn) == (gemm, cudnn)


@pytest.mark.parametrize("height, kernel", [(3, 3), (5, 5)])
def test_bfloat16_cast_path_rounds_as_conv2d(height, kernel):
    """Both round one float32 sum per output to bfloat16, in other orders:
    at most one bfloat16 step apart (2^-7 of the value)."""
    gen = torch.Generator().manual_seed(3)
    layer = SlimConv(16, 8, kernel, activation=None, dtype=torch.bfloat16)
    init_parameters(layer, gen)  # a zero bias: the sum alone is compared
    x = torch.randn(32, height, height, 16, generator=gen).permute(0, 3, 1, 2)
    reset_conv_counts()
    with torch.no_grad():  # the GEMM forward, as a sweep runs it
        got = layer(x)
    assert got.dtype == torch.bfloat16 and conv2d.gemm == 1
    expected = F.conv2d(x.to(torch.bfloat16), layer.Conv_0.weight.to(torch.bfloat16),
                        layer.Conv_0.bias.to(torch.bfloat16), padding=kernel // 2)
    gap = (got.float() - expected.float()).abs()
    scale = torch.maximum(got.float().abs(), expected.float().abs())
    assert bool((gap <= 2.0 ** -7 * scale).all())
    # and most outputs round alike
    assert float((gap == 0).float().mean()) > 0.9
