"""A SAME convolution whose kernel covers its input, as one GEMM against its
Toeplitz weight (``hypelcnn_tpu_torch/models/layers.py`` ``conv2d``).

- The lowering equals ``F.conv2d``, forward and the gradients of the
  input, the weight and the bias, in float64 (to rounding) and float32, on
  NCHW tensors and on the permuted NHWC views the models hand it: the GEMM
  forward of a sweep, and the route under autograd (``F.conv2d``'s forward,
  the GEMMs' gradients).
- The route depends on the shapes and grad mode alone: SAME, a kernel wider
  than 1 that covers the input takes the GEMM; a 1x1 that autograd records
  takes the pointwise route (``F.conv2d``'s forward, GEMMs over pixel rows
  for its gradients), which equals ``F.conv2d`` as the GEMM route does;
  any other 1x1, VALID and a kernel smaller than its window go to
  ``F.conv2d``.
- The counts of an inference forward and of a training forward of
  HYPELCNN-480 and DUALCNN at their published widths.
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


@pytest.mark.parametrize("x_grad", [True, False], ids=["x_grad", "no_x_grad"])
@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc_view"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_pointwise_route_matches_conv2d(dtype, with_bias, nhwc, x_grad):
    """A 1x1 ``conv2d`` under autograd: its forward ``F.conv2d``'s bit for
    bit, its input, weight and bias gradients the GEMMs', the input's in
    ``x``'s memory order and none where ``x`` needs none."""
    gen = torch.Generator().manual_seed(11)
    x = _input(4, 6, 3, 3, dtype, nhwc, gen).requires_grad_(x_grad)
    weight = torch.randn(5, 6, 1, 1, generator=gen, dtype=torch.float64).to(dtype)
    weight.requires_grad_()
    bias = torch.randn(5, generator=gen, dtype=torch.float64).to(dtype).requires_grad_() \
        if with_bias else None
    leaves = [t for t in (x, weight, bias) if t is not None and t.requires_grad]
    reset_conv_counts()
    got = conv2d(x, weight, bias, 0)
    assert (conv2d.gemm, conv2d.pointwise, conv2d.cudnn) == (0, 1, 0)
    expected = F.conv2d(x, weight, bias)
    assert torch.equal(got, expected)
    upstream = torch.randn(expected.shape, generator=gen, dtype=torch.float64).to(dtype)
    grads = torch.autograd.grad(got, leaves, upstream)
    for g, e in zip(grads, torch.autograd.grad(expected, leaves, upstream)):
        torch.testing.assert_close(g, e, **TOLERANCES[dtype])
    if x_grad:
        layout = torch.channels_last if nhwc else torch.contiguous_format
        assert grads[0].is_contiguous(memory_format=layout)


@pytest.mark.parametrize("grad_mode, x_grad, weight_grad, route", [
    (True, True, True, "pointwise"), (True, False, True, "pointwise"),
    (True, True, False, "pointwise"), (True, False, False, "cudnn"),
    (False, True, True, "cudnn")])
def test_pointwise_route_by_grad_mode(grad_mode, x_grad, weight_grad, route):
    """A 1x1 takes the pointwise route where autograd records it: grad mode
    on and ``x`` or the weight requiring grad."""
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(2, 4, 3, 3, generator=gen).requires_grad_(x_grad)
    weight = torch.randn(3, 4, 1, 1, generator=gen).requires_grad_(weight_grad)
    reset_conv_counts()
    with torch.set_grad_enabled(grad_mode):
        got = conv2d(x, weight, None, 0)
    assert (conv2d.pointwise, conv2d.cudnn) == (int(route == "pointwise"), int(route == "cudnn"))
    assert torch.equal(got.detach(), F.conv2d(x, weight).detach())


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
    got = conv2d(x, weight, None, padding)  # grad mode on, nothing requires grad
    assert {"gemm": conv2d.gemm, "pointwise": conv2d.pointwise, "cudnn": conv2d.cudnn} == \
        {"gemm": int(route == "gemm"), "pointwise": 0, "cudnn": int(route == "cudnn")}
    torch.testing.assert_close(got, F.conv2d(x, weight, padding=padding), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padding, kernel, window, gemm", [
    ("SAME", 3, 3, 1), ("SAME", 5, 5, 1), ("SAME", 1, 3, 0), ("VALID", 3, 3, 0),
    ("SAME", 3, 5, 0)])
def test_slim_conv_routes_by_shape(padding, kernel, window, gemm):
    layer = SlimConv(4, 3, kernel, padding=padding)
    init_parameters(layer, torch.Generator().manual_seed(0))
    x = torch.rand(2, 4, window, window)
    reset_conv_counts()
    got = layer(x)  # the weight requires grad: a 1x1 takes the pointwise route
    pointwise = int(kernel == 1)
    assert (conv2d.gemm, conv2d.pointwise, conv2d.cudnn) == \
        (gemm, pointwise, 1 - gemm - pointwise)
    expected = F.leaky_relu(F.conv2d(x, layer.Conv_0.weight, layer.Conv_0.bias,
                                     padding=layer.Conv_0.padding), 0.0)
    torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("patch, gemm", [(3, 1), (5, 1), (1, 0)])
def test_fused_level_routes_by_its_widest_kernel(patch, gemm):
    level = FusedMultiScaleLevel(4, 3, patch)
    init_parameters(level, torch.Generator().manual_seed(0))
    reset_conv_counts()
    level(torch.rand(2, 4, patch, patch))  # under autograd: patch 1 is one 1x1
    pointwise = int(patch == 1)
    assert (conv2d.gemm, conv2d.pointwise, conv2d.cudnn) == \
        (gemm, pointwise, 1 - gemm - pointwise)


# (model, published params plus, patch, GEMM, F.conv2d) a forward
COUNTS = [
    ("HYPELCNNModel", {}, 3, 3, 12),
    ("DUALCNNModel", {}, 5, 11, 25),
    ("HYPELCNNModel", {"fuse_level_convs": True}, 3, 3, 9),
    ("DUALCNNModel", {"fuse_level_convs": True}, 5, 11, 11),
]
COUNT_IDS = ["hypelcnn480", "dualcnn", "hypelcnn480_fused", "dualcnn_fused"]


def _published_module(model_name, params, patch):
    model = get_model_from_name(model_name)
    return model.create_module(15, {**model.default_params(), **params}, (patch, patch, 145))


@pytest.mark.parametrize("model_name, params, patch, gemm, cudnn", COUNTS, ids=COUNT_IDS)
def test_counts_of_a_forward(model_name, params, patch, gemm, cudnn):
    module = _published_module(model_name, params, patch)
    module.eval()
    reset_conv_counts()
    with torch.no_grad():
        module(torch.rand(2, patch, patch, 145))
    assert (conv2d.gemm, conv2d.pointwise, conv2d.cudnn) == (gemm, 0, cudnn)


@pytest.mark.parametrize("model_name, params, patch, gemm, cudnn", COUNTS, ids=COUNT_IDS)
def test_counts_of_an_inference_mode_forward(model_name, params, patch, gemm, cudnn):
    """Sweeps, drains and ``predict_targets`` run under ``inference_mode``:
    no 1x1 takes the pointwise route."""
    module = _published_module(model_name, params, patch)
    module.eval()
    reset_conv_counts()
    with torch.inference_mode():
        module(torch.rand(2, patch, patch, 145))
    assert (conv2d.gemm, conv2d.pointwise, conv2d.cudnn) == (gemm, 0, cudnn)


# (model, published params plus, patch, GEMM, pointwise, F.conv2d) a training
# forward: every 1x1 takes the pointwise route; DUALCNN's LiDAR 3x3s on their
# 5x5 window stay on F.conv2d unfused and join a 5x5 GEMM fused
TRAINING_COUNTS = [
    ("HYPELCNNModel", {}, 3, 3, 12, 0),
    ("DUALCNNModel", {}, 5, 11, 22, 3),
    ("HYPELCNNModel", {"fuse_level_convs": True}, 3, 3, 9, 0),
    ("DUALCNNModel", {"fuse_level_convs": True}, 5, 11, 11, 0),
]


@pytest.mark.parametrize("model_name, params, patch, gemm, pointwise, cudnn", TRAINING_COUNTS,
                         ids=COUNT_IDS)
def test_counts_of_a_training_forward(model_name, params, patch, gemm, pointwise, cudnn):
    module = _published_module(model_name, params, patch)
    module.train()
    reset_conv_counts()
    out = module(torch.rand(2, patch, patch, 145),
                 dropout_generator=torch.Generator().manual_seed(0))
    assert (conv2d.gemm, conv2d.pointwise, conv2d.cudnn) == (gemm, pointwise, cudnn)
    loss = out.y_conv.sum() + (0 if out.image_output is None else out.image_output.sum())
    loss.backward()
    assert all(p.grad is not None for p in module.parameters())


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


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_bfloat16_cast_path_pointwise_gradients(with_bias):
    """A bfloat16 1x1 ``SlimConv`` in training casts through
    ``_cast_product`` onto the pointwise route: its forward is ``F.conv2d``'s
    in bfloat16 bit for bit, and its input, weight and bias gradients lie
    within one bfloat16 step (2^-7) of the largest magnitude of the
    gradients that ``F.conv2d``'s own backward gives (both round float32
    sums in other orders)."""
    gen = torch.Generator().manual_seed(17)
    layer = SlimConv(16, 8, 1, activation=None, use_batch_norm=not with_bias,
                     dtype=torch.bfloat16)
    init_parameters(layer, gen)
    x = torch.randn(32, 3, 3, 16, generator=gen).permute(0, 3, 1, 2).requires_grad_()
    conv = layer.Conv_0
    leaves = [x, conv.weight] + ([conv.bias] if with_bias else [])
    reset_conv_counts()
    got = conv2d(x.to(torch.bfloat16), conv.weight.to(torch.bfloat16), None, 0)
    assert conv2d.pointwise == 1
    expected = F.conv2d(x.to(torch.bfloat16), conv.weight.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and torch.equal(got, expected)
    upstream = torch.randn(got.shape, generator=gen).to(torch.bfloat16)
    reset_conv_counts()
    routed = torch.autograd.grad(layer(x), leaves, upstream)
    assert conv2d.pointwise == 1
    bias = conv.bias.to(torch.bfloat16).view(1, -1, 1, 1) if with_bias else 0
    plain = F.conv2d(x.to(torch.bfloat16), conv.weight.to(torch.bfloat16)) + bias
    if not with_bias:
        plain = layer.BatchNorm_0(plain)
    for g, e in zip(routed, torch.autograd.grad(plain, leaves, upstream)):
        scale = float(e.float().abs().max())
        assert float((g.float() - e.float()).abs().max()) <= 2.0 ** -7 * scale
