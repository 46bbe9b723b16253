"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA device and ``nvcc`` and skips without them.
The file imports no JAX, so that it runs where only PyTorch is installed;
``tests/conftest.py`` imports JAX, so run it there with::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_importer_from_name, get_model_from_name
from hypelcnn_tpu_torch.data.augmentation import AugmentationInfo
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.data.scene import Scene
from hypelcnn_tpu_torch.gan.shadow_ops import create_gan_shadow_struct
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene
from hypelcnn_tpu_torch.kernels import build
from hypelcnn_tpu_torch.kernels.window_gather import reset_launches, window_gather_cuda
from hypelcnn_tpu_torch.models.cap import CAPModel
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
from hypelcnn_tpu_torch.models.layers import (
    conv2d,
    conv2d_gemm,
    init_parameters,
    reset_conv_counts,
)
from hypelcnn_tpu_torch.ops.nn import squash
from hypelcnn_tpu_torch.ops.window_gather import gather_patches_torch
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError as err:
        pytest.skip(str(err))
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("channels", [12, 65, 145, 360])
def test_window_gather_matches_plain(cuda, k, channels):
    """Bit for bit, out-of-range and negative coordinates included."""
    rng = np.random.default_rng(k * channels)
    scene = torch.from_numpy(rng.normal(size=(40, 60, channels)).astype(np.float32)).to(cuda)
    for batch in (1, 129, 3001):
        coords = torch.from_numpy(np.stack([rng.integers(-70, 130, batch),
                                            rng.integers(-50, 90, batch)],
                                           axis=1).astype(np.int32)).to(cuda)
        got = window_gather_cuda(scene, coords, k)
        torch.cuda.synchronize()
        assert torch.equal(got, gather_patches_torch(scene, coords, k))


def _wild_coords(rng, batch, hp, wp, cuda):
    """Coordinates from far below 0 to far past the scene's edge."""
    return torch.from_numpy(np.stack([rng.integers(-2 * wp, 2 * wp, batch),
                                      rng.integers(-2 * hp, 2 * hp, batch)],
                                     axis=1).astype(np.int32)).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 5, 9])
@pytest.mark.parametrize("channels", [1, 2, 3, 5])
def test_window_gather_matches_plain_at_every_alignment(cuda, k, channels):
    """Fewer channels than a 16-byte chunk holds (a chunk spans up to four
    pixels) and, over the batches, every residue of B*k*k*C mod 4 that C
    allows (the scalar tail), out-of-range coordinates included, bit for bit."""
    rng = np.random.default_rng(100 * k + channels)
    scene = torch.from_numpy(rng.normal(size=(9, 11, channels)).astype(np.float32)).to(cuda)
    residues = set()
    for batch in (1, 2, 3, 4, 5, 129, 1000):
        coords = _wild_coords(rng, batch, 9, 11, cuda)
        got = window_gather_cuda(scene, coords, k)
        torch.cuda.synchronize()
        assert torch.equal(got, gather_patches_torch(scene, coords, k))
        residues.add(batch * k * k * channels % 4)
    assert residues == {b * channels % 4 for b in range(4)}


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 145])
def test_window_gather_of_no_windows(cuda, channels):
    """B = 0: an empty [0, k, k, C] tensor, and no launch."""
    scene = torch.ones((5, 6, channels), device=cuda)
    coords = torch.zeros((0, 2), dtype=torch.int32, device=cuda)
    before = window_gather_cuda.launches
    got = window_gather_cuda(scene, coords, 3)
    assert got.shape == (0, 3, 3, channels) and got.is_cuda
    assert torch.equal(got, gather_patches_torch(scene, coords, 3))
    assert window_gather_cuda.launches == before


@pytest.mark.cuda
def test_window_gather_past_2_31_output_elements(cuda):
    """k = 9, C = 360, B = 73,700: 2,149,092,000 output floats (8.6 GB), so
    the 64-bit index path; bit for bit, out-of-range coordinates included,
    compared a slice of windows at a time."""
    rng = np.random.default_rng(9)
    batch, k, channels = 73_700, 9, 360
    scene = torch.from_numpy(rng.normal(size=(40, 60, channels)).astype(np.float32)).to(cuda)
    coords = _wild_coords(rng, batch, 40, 60, cuda)
    got = window_gather_cuda(scene, coords, k)
    torch.cuda.synchronize()
    assert got.numel() > 2 ** 31
    for start in range(0, batch, 8192):
        part = coords[start:start + 8192]
        assert torch.equal(got[start:start + 8192], gather_patches_torch(scene, part, k))
    del got
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [48, 8192])
def test_window_gather_matches_plain_at_training_shapes(cuda, batch):
    """The training step's batch (48) and the eval drain's (8192), k = 3,
    C = 145, coordinates inside a GRSS2013-size scene, bit for bit."""
    rng = np.random.default_rng(batch)
    scene = torch.from_numpy(rng.normal(size=(351, 1907, 145)).astype(np.float32)).to(cuda)
    coords = torch.from_numpy(np.stack([rng.integers(0, 1905, batch), rng.integers(0, 349, batch)],
                                       axis=1).astype(np.int32)).to(cuda)
    got = window_gather_cuda(scene, coords, 3)
    torch.cuda.synchronize()
    assert got.shape == (batch, 3, 3, 145)
    assert torch.equal(got, gather_patches_torch(scene, coords, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("batch, k", [(30480, 5), (10, 5), (48, 5), (16, 3), (1, 3)])
def test_window_gather_matches_plain_at_family_shapes(cuda, batch, k):
    """The shapes the other families add: the k = 5 sweep band (CONCNN,
    DUALCNN), CONCNN's step of 10 and DUALCNN's of 48 at k = 5, CAP's step
    of 16 at k = 3, and a single window."""
    rng = np.random.default_rng(batch * k)
    pad = k // 2
    scene = torch.from_numpy(rng.normal(size=(349 + 2 * pad, 1905 + 2 * pad, 145))
                             .astype(np.float32)).to(cuda)
    coords = torch.from_numpy(np.stack([rng.integers(0, 1905, batch), rng.integers(0, 349, batch)],
                                       axis=1).astype(np.int32)).to(cuda)
    got = window_gather_cuda(scene, coords, k)
    torch.cuda.synchronize()
    assert got.shape == (batch, k, k, 145)
    assert torch.equal(got, gather_patches_torch(scene, coords, k))


@pytest.mark.cuda
@pytest.mark.parametrize("channels, height, width", [(65, 325, 220), (360, 500, 300)])
@pytest.mark.parametrize("batch", [48, 8192])
def test_window_gather_matches_plain_at_loader_shapes(cuda, channels, height, width, batch):
    """GULFPORT's 64 bands plus LiDAR and AVON's 360 bands, at the training
    step's batch and the eval drain's, k = 3, bit for bit."""
    rng = np.random.default_rng(channels + batch)
    scene = torch.from_numpy(rng.normal(size=(height + 2, width + 2, channels))
                             .astype(np.float32)).to(cuda)
    coords = torch.from_numpy(np.stack([rng.integers(0, width, batch),
                                        rng.integers(0, height, batch)],
                                       axis=1).astype(np.int32)).to(cuda)
    got = window_gather_cuda(scene, coords, 3)
    torch.cuda.synchronize()
    assert got.shape == (batch, 3, 3, channels)
    assert torch.equal(got, gather_patches_torch(scene, coords, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("model_name, params, neighborhood", [
    ("CONCNNModel", {"filter_count": 16}, 2),
    ("DUALCNNModel", {"filter_count": 32}, 2),
    ("CAPModel", {"feature_count": 16, "primary_capsule_count": 4}, 1),
])
def test_family_training_and_sweep_go_through_the_kernel(cuda, model_name, params, neighborhood):
    """Every family: one launch per training step and eval batch, one per
    sweep band, and the plain gather's class map."""
    np.random.seed(0)
    data = get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", "synthetic://?h=48&w=64&bands=12&classes=5&seed=3",
        train_ratio=0.5, test_ratio=0.1, neighborhood=neighborhood)
    model = get_model_from_name(model_name)
    trainer = ClassificationTrainer(
        model=model, class_count=data.class_count,
        algorithm_params={**model.default_params(), **params}, scene=data.scene,
        sample_set=data.sample_set, sources=data.sources, data_shape=data.data_shape,
        device=cuda, test_cadence=4)
    reset_launches()
    result = trainer.fit(6, 16, log_every=3)
    assert window_gather_cuda.launches_by_batch[16] == 6
    assert window_gather_cuda.launches == 6 + 1 + 1 + -(-data.sample_set.validation_targets.shape[0]
                                                         // 8192)
    assert np.isfinite(result.loss)
    module = result.final_state.module
    reset_launches()
    got = predict_full_scene(module, data.scene, batch_rows=16, device=cuda)
    assert window_gather_cuda.launches == 3
    np.testing.assert_array_equal(got, predict_full_scene(module, data.scene, batch_rows=16,
                                                          device=cuda, gather=gather_patches_torch))


@pytest.mark.cuda
def test_training_step_and_eval_drain_go_through_the_kernel(cuda):
    """One launch per training step plus one per eval batch."""
    np.random.seed(0)
    data = get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", "synthetic://?h=48&w=64&bands=12&classes=5&seed=3",
        train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    params = {**HYPELCNNModel().default_params(), "filter_count": 32}
    trainer = ClassificationTrainer(
        model=HYPELCNNModel(), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, device=cuda, test_cadence=4)
    reset_launches()
    result = trainer.fit(10, 16, log_every=5)
    n_test = data.sample_set.test_targets.shape[0]
    n_val = data.sample_set.validation_targets.shape[0]
    evals = 2 + 1 + -(-n_val // 8192)  # test drains at 4 and 8, the final test and validation
    assert n_test <= 8192 and 16 not in (n_test, min(n_val, 8192))
    assert window_gather_cuda.launches == 10 + evals
    assert window_gather_cuda.launches_by_batch[16] == 10
    assert np.isfinite(result.loss)


@pytest.mark.cuda
def test_full_scene_sweep_goes_through_the_kernel(cuda):
    """One launch per row band, and the class map of the plain gather."""
    scene = SyntheticDataLoader("synthetic://?h=48&w=64&bands=12&classes=5&seed=3").load_data(1, True)
    module = HYPELCNNModel().create_module(5, {"filter_count": 32}, scene.get_data_shape())
    init_parameters(module, torch.Generator().manual_seed(0))
    module.to(cuda)
    before = window_gather_cuda.launches
    got = predict_full_scene(module, scene, batch_rows=20, device=cuda)
    assert window_gather_cuda.launches - before == 3
    expected = predict_full_scene(module, scene, batch_rows=20, device=cuda,
                                  gather=gather_patches_torch)
    np.testing.assert_array_equal(got, expected)


GAN_FAMILIES = ["cycle_gan", "gan_x2y", "gan_y2x", "cut_x2y", "cut_y2x", "dcl_gan", "dcl_cycle_gan"]


@pytest.mark.cuda
@pytest.mark.parametrize("family", GAN_FAMILIES)
def test_gan_step_on_the_card_matches_the_cpu(cuda, family):
    """One step of each GAN family from the same weights on the same pairs:
    losses within 1e-4 (relative) of the CPU's, parameters finite."""
    bands = 16
    trainer = get_trainer_dict({"patches": 3}, bands, 10)[family]
    weights = trainer.init_state("cpu", torch.Generator().manual_seed(0)).nets.state_dict()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0.2, 1.0, (32, 1, 1, bands)).astype(np.float32))
    y = x * 0.5
    losses = {}
    for where in (cuda, torch.device("cpu")):
        state = trainer.init_state(where, state_dict=weights)
        metrics = trainer.train_step(state, x.to(where), y.to(where))
        losses[where.type] = {k: float(v) for k, v in metrics.items()}
        assert all(bool(torch.isfinite(p).all()) for p in state.nets.parameters())
    for name, value in losses["cpu"].items():
        assert losses["cuda"][name] == pytest.approx(value, rel=1e-4, abs=1e-6), name


@pytest.mark.cuda
def test_gan_augmented_step_launches_the_gather_once(cuda):
    """A classifier step with a frozen generator shadowing half the windows:
    one gather launch, a finite loss."""
    np.random.seed(0)
    data = get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", "synthetic://?h=48&w=64&bands=12&classes=5&seed=3",
        train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    gan = get_trainer_dict({}, 12, 10)["cycle_gan"]
    nets = gan.init_state(cuda, torch.Generator().manual_seed(0)).nets.requires_grad_(False)
    draws = torch.Generator().manual_seed(1)
    for p in nets.parameters():
        p.copy_(0.05 * torch.randn(p.shape, generator=draws).to(cuda))
    info = AugmentationInfo(shadow_struct=create_gan_shadow_struct(gan, nets, 12),
                            perform_shadow_augmentation=True, augmentation_random_threshold=0.5)
    params = {**HYPELCNNModel().default_params(), "filter_count": 32}
    trainer = ClassificationTrainer(
        model=HYPELCNNModel(), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, augmentation_info=info, device=cuda)
    state = trainer.init_state()
    tables = trainer.training_tables(2, 16)
    reset_launches()
    loss = trainer.train_step(state, tables, 0)
    assert window_gather_cuda.launches == 1 and window_gather_cuda.launches_by_batch[16] == 1
    assert np.isfinite(float(loss))


@pytest.mark.cuda
def test_classic_forest_on_the_card_is_the_cpu_forest(cuda):
    """The classic-ML CLI's windows on the card (one gather launch, k = 1) are
    the plain gather's, and its forest is, node for node, the one grown on
    the CPU from the same ``np.random`` state; so are the predictions."""
    from hypelcnn_tpu_torch.apps.classic_ml_trainer import gather_windows
    from hypelcnn_tpu_torch.classic.forest import RandomForestClassifier
    loader = SyntheticDataLoader("synthetic://?h=48&w=64&bands=12&classes=5&noise=3000")
    scene = loader.load_data(0, False)
    np.random.seed(0)
    targets = loader.load_samples(0.1, 0).training_targets
    reset_launches()
    windows = gather_windows(scene, targets, cuda)
    torch.cuda.synchronize()
    assert window_gather_cuda.launches == 1
    plain = gather_windows(scene, targets, torch.device("cpu"))
    assert torch.equal(windows.cpu(), plain)
    forests = []
    for data in (windows, plain):
        np.random.seed(1)
        forests.append(RandomForestClassifier(n_estimators=10, max_features=5).fit(
            data, targets[:, 2]))
    for a, b in zip(*(forest.trees for forest in forests)):
        for name in ("feature", "threshold", "left", "right", "value"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name))
    np.testing.assert_array_equal(forests[0].predict(windows), forests[1].predict(plain))


@pytest.mark.cuda
def test_classic_svm_grid_on_the_card_is_the_cpu_grid(cuda):
    """The SVM grid's cells on the card score as on the CPU (within 0.01) and
    pick the same best cell."""
    from hypelcnn_tpu_torch.classic.model_selection import StratifiedShuffleSplit, grid_search
    loader = SyntheticDataLoader("synthetic://?h=24&w=48&bands=144&classes=3")
    scene = loader.load_data(0, False)
    np.random.seed(1)
    targets = loader.load_samples(0.1, 0).training_targets
    x = torch.from_numpy(scene.fused_host()[targets[:, 1], targets[:, 0]])
    grids = [grid_search(x.to(device), targets[:, 2], np.logspace(-2, 10, 13),
                         np.logspace(-9, 3, 13),
                         StratifiedShuffleSplit(n_splits=2, test_size=0.1, random_state=42))
             for device in (cuda, torch.device("cpu"))]
    assert grids[0]["best_params"] == grids[1]["best_params"]
    np.testing.assert_allclose(grids[0]["mean_test_score"], grids[1]["mean_test_score"],
                               rtol=0, atol=0.01)


# (batch, in, out channels): HYPELCNN-480's three 3x3 levels at batch 16,384,
# DUALCNN's widest HSI levels (480 -> 480, 960 -> 240) at batch 4,096
CONV_GEMM_SHAPES = [(16384, 120, 60), (16384, 120, 30), (16384, 60, 15),
                    (4096, 480, 480), (4096, 960, 240)]


def _conv_gemm_inputs(cuda, batch, cin, cout):
    gen = torch.Generator(device=cuda).manual_seed(batch + cin + cout)
    # an NHWC tensor's NCHW view, as the models hand it over
    x = torch.randn(batch, 3, 3, cin, generator=gen, device=cuda).permute(0, 3, 1, 2)
    weight = torch.randn(cout, cin, 3, 3, generator=gen, device=cuda) / (3 * cin ** 0.5)
    bias = torch.randn(cout, generator=gen, device=cuda)
    upstream = torch.randn(batch, cout, 3, 3, generator=gen, device=cuda)
    return x, weight, bias, upstream


def _cudnn(x, weight, bias):
    return torch.nn.functional.conv2d(x, weight, bias, padding=1)


def _routed(x, weight, bias):
    return conv2d(x, weight, bias, 1)


def _conv_and_grads(sweep, step, x, weight, bias, upstream):
    """A sweep's forward (without autograd), then a training step's forward
    and its input, weight and bias gradients (under autograd)."""
    with torch.no_grad():
        swept = sweep(x, weight, bias)
    leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
    y = step(*leaves)
    return [swept, y.detach(), *torch.autograd.grad(y, leaves, upstream)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch, cin, cout", CONV_GEMM_SHAPES)
def test_conv_gemm_matches_cudnn_at_the_cells_shapes(cuda, batch, cin, cout):
    """The sweep's GEMM forward, and a training step's forward (cuDNN's own)
    and input, weight and bias gradients (GEMMs), float32 with TF32 off,
    against cuDNN in float64, beside cuDNN in float32. Tolerance 1e-5 of the
    largest float64 magnitude: float32 sums of up to 8,640 products (output,
    input gradient) and 147,456 (the weight gradient, 16,384 x 9) in two
    orders, whose rounding grows like sqrt(terms) x 2^-24 of the terms."""
    x, weight, bias, upstream = _conv_gemm_inputs(cuda, batch, cin, cout)
    got = _conv_and_grads(conv2d_gemm, _routed, x, weight, bias, upstream)
    cudnn = _conv_and_grads(_cudnn, _cudnn, x, weight, bias, upstream)
    exact = _conv_and_grads(_cudnn, _cudnn, x.double(), weight.double(), bias.double(),
                            upstream.double())
    names = ("sweep output", "step output", "input", "weight", "bias")
    for name, g, c, e in zip(names, got, cudnn, exact):
        scale = float(e.abs().max())
        err = float((g.double() - e).abs().max()) / scale
        cudnn_err = float((c.double() - e).abs().max()) / scale
        print(f"{batch}x{cin}->{cout} {name}: {err:.3g}, cuDNN {cudnn_err:.3g}")
        assert err < 1e-5, (name, err, cudnn_err)
    assert torch.equal(got[1], cudnn[1])  # a training step's forward is cuDNN's own


@pytest.mark.cuda
@pytest.mark.parametrize("batch, cin, cout", [CONV_GEMM_SHAPES[0], CONV_GEMM_SHAPES[3]])
def test_conv_gemm_repeats_bit_for_bit(cuda, batch, cin, cout):
    """No atomic adds: two passes on the same inputs give the same bits."""
    inputs = _conv_gemm_inputs(cuda, batch, cin, cout)
    first = _conv_and_grads(conv2d_gemm, _routed, *inputs)
    second = _conv_and_grads(conv2d_gemm, _routed, *inputs)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# (batch, in, out channels) of 1x1 convolutions on 3 x 3 windows: HYPELCNN-480's
# encoder 240 -> 480, decoder 480 -> 480 and narrowest level branch 60 -> 15
# at batch 16,384; DUALCNN's widest HSI 1x1s (960 -> 960, 960 -> 240) at 4,096
POINTWISE_SHAPES = [(16384, 240, 480), (16384, 480, 480), (16384, 60, 15),
                    (4096, 960, 960), (4096, 960, 240)]


def _pointwise_inputs(cuda, batch, cin, cout):
    gen = torch.Generator(device=cuda).manual_seed(batch + cin + cout)
    # NHWC tensors' NCHW views, the input and the output's gradient as the
    # models hand them over
    x = torch.randn(batch, 3, 3, cin, generator=gen, device=cuda).permute(0, 3, 1, 2)
    weight = torch.randn(cout, cin, 1, 1, generator=gen, device=cuda) / cin ** 0.5
    bias = torch.randn(cout, generator=gen, device=cuda)
    upstream = torch.randn(batch, 3, 3, cout, generator=gen, device=cuda).permute(0, 3, 1, 2)
    return x, weight, bias, upstream


def _pointwise_step(step, x, weight, bias, upstream):
    """A training step's forward and its input, weight and bias gradients."""
    leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
    y = step(*leaves)
    return [y.detach(), *torch.autograd.grad(y, leaves, upstream)]


def _pointwise_routed(x, weight, bias):
    return conv2d(x, weight, bias, 0)


def _pointwise_cudnn(x, weight, bias):
    return torch.nn.functional.conv2d(x, weight, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("batch, cin, cout", POINTWISE_SHAPES)
def test_pointwise_gradients_match_cudnn_at_the_cells_shapes(cuda, batch, cin, cout):
    """A training step's 1x1 convolution: its forward cuDNN's own, bit for
    bit, and its input, weight and bias gradients (GEMMs over pixel rows,
    float32 with TF32 off) against cuDNN in float64, beside cuDNN in float32.
    Tolerance 1e-5 of the largest float64 magnitude: float32 sums of up to
    960 products (output, input gradient) and 147,456 (the weight and bias
    gradients, 16,384 x 9 pixel rows) in two orders."""
    x, weight, bias, upstream = _pointwise_inputs(cuda, batch, cin, cout)
    reset_conv_counts()
    got = _pointwise_step(_pointwise_routed, x, weight, bias, upstream)
    assert conv2d.pointwise == 1
    cudnn = _pointwise_step(_pointwise_cudnn, x, weight, bias, upstream)
    exact = _pointwise_step(_pointwise_cudnn, x.double(), weight.double(), bias.double(),
                            upstream.double())
    assert torch.equal(got[0], cudnn[0])  # a training step's forward is cuDNN's own
    for name, g, c, e in zip(("output", "input", "weight", "bias"), got, cudnn, exact):
        scale = float(e.abs().max())
        err = float((g.double() - e).abs().max()) / scale
        cudnn_err = float((c.double() - e).abs().max()) / scale
        print(f"{batch}x{cin}->{cout} {name}: {err:.3g}, cuDNN {cudnn_err:.3g}")
        assert err < 1e-5, (name, err, cudnn_err)
    assert got[1].is_contiguous(memory_format=torch.channels_last)  # the input's order


@pytest.mark.cuda
@pytest.mark.parametrize("batch, cin, cout", [POINTWISE_SHAPES[1], POINTWISE_SHAPES[3]])
def test_pointwise_gradients_repeat_bit_for_bit(cuda, batch, cin, cout):
    """No atomic adds: two passes on the same inputs give the same bits."""
    inputs = _pointwise_inputs(cuda, batch, cin, cout)
    first = _pointwise_step(_pointwise_routed, *inputs)
    second = _pointwise_step(_pointwise_routed, *inputs)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


CAP_CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                         / "cap.json").read_text())


def _cap_band(cuda, seed):
    """CAP at its published widths with the benchmark's weight recipe, and
    the primary capsules of one sweep band (16 rows of 1,905 windows of 3x3)
    of a synthetic scene drawn by the benchmark's recipe."""
    from portbench import scene as scene_lib
    from portbench import weights as weights_lib
    from portbench.drivers.band_sweep import capsule_weights
    from portbench.reference.cap import Model

    spec = {**CAP_CONFIG["scene"], "height": 18}  # a band's 16 rows and one above and below
    arrays = scene_lib.make_scene(spec, seed)
    shape = [3, 3, spec["casi_bands"] + spec["lidar_bands"]]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    weights = weights_lib.make_weights(Model(CAP_CONFIG["params"], spec["classes"], shape),
                                       gen, cuda)
    capsule_weights(weights, gen)
    module = CAPModel().create_module(spec["classes"], CAP_CONFIG["params"], shape)
    module.load_state_dict(weights)
    module = module.to(cuda).eval()
    cols = torch.arange(spec["width"], dtype=torch.int32, device=cuda)
    rows = torch.arange(1, 17, dtype=torch.int32, device=cuda)
    coords = torch.stack([cols.repeat(16), rows.repeat_interleave(spec["width"])], dim=1)
    x = gather_patches_torch(Scene(arrays.casi, arrays.lidar, 1, True).device_scene(cuda),
                             coords, 3)
    with torch.inference_mode():
        net = module.PrimaryCaps_layer(module.Conv1_layer(x.permute(0, 3, 1, 2)))
        u = net.permute(0, 2, 3, 1).reshape(x.shape[0], module.data_size, module.pco)
    return module, u


@torch.no_grad()
def _cap_round64(module, u, logits):
    """One routing round in float64 from routing logits ``logits``, one class
    at a time (a band's float64 ``u_hat`` would take 16.9 GB): the round's
    agreement and the class scores."""
    d, p, j, c = module.data_size, module.pco, module.classes, module.dco
    w = module.digitcaps_w.double().view(d, p, j, c)
    bias = module.digitcaps_b.double().view(d, j, c)
    by_capsule = u.double().permute(1, 0, 2)  # [D, B, P]
    couplings = torch.softmax(logits.double(), dim=1)
    agreement = torch.zeros(d, j, dtype=torch.float64, device=u.device)
    scores = torch.empty(u.shape[0], j, dtype=torch.float64, device=u.device)
    for cls in range(j):
        u_hat = torch.baddbmm(bias[:, cls].unsqueeze(1), by_capsule, w[:, :, cls])  # [D, B, C]
        v = squash(torch.einsum("dbc,d->bc", u_hat, couplings[:, cls]), dim=-1)
        scores[:, cls] = torch.linalg.vector_norm(v, dim=-1)
        agreement[:, cls] = torch.einsum("dbc,bc->d", u_hat, v)
    return agreement, scores


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [4_900_000_003, 4_910_000_019, 4_920_000_041])
def test_cap_folded_route_at_a_sweep_band(cuda, seed):
    """At a sweep band of 30,480 windows, float32 with TF32 off, each round of
    each route against the same round in float64 from the route's own routing
    logits: the folded route's round-1 and round-2 agreements are no further
    off than the ``u_hat`` route's, and its class scores no further off
    either, or within four float32 roundings of the largest score (the
    scores' own arithmetic rounds them by about two). Where no capsule's
    last-round logits nearly tie (``band_sweep.near_tie``), the two routes
    give every window the same class.

    Each round is held from the route's own logits because a round's error
    is passed on: where two logits of a capsule nearly tie, the couplings
    amplify one round's rounding ~1,000 times into the next round's, in
    either route (PERF.md §2). The routing chained in float64 is printed
    beside, not held."""
    from portbench.drivers.band_sweep import near_tie

    module, u = _cap_band(cuda, seed)
    zeros = torch.zeros(module.data_size, module.classes, device=cuda)
    first64, _ = _cap_round64(module, u, zeros)
    second64, _ = _cap_round64(module, u, first64)
    _, chained64 = _cap_round64(module, u, first64 + second64)

    def gap(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    errors, classes = {}, {}
    for name in ("u_hat_route", "folded_route"):
        route = getattr(module, name)
        with torch.inference_mode():
            module.iter_routing = 2
            _, _, first = route(u, 0)
            module.iter_routing = 3
            _, scores, second = route(u, 0)
        errors[name] = {
            "round 1": gap(first, first64),
            "round 2": gap(second - first, _cap_round64(module, u, first)[0]),
            "scores": gap(scores, _cap_round64(module, u, second)[1]),
            "chained: logits after round 2": gap(second, first64 + second64),
            "chained: scores": gap(scores, chained64)}
        classes[name] = scores.argmax(1)
        del scores
        torch.cuda.empty_cache()
    for what in errors["u_hat_route"]:
        print(f"seed {seed} {what}: u_hat {errors['u_hat_route'][what]:.3g}, "
              f"folded {errors['folded_route'][what]:.3g}")
    folded, u_hat = errors["folded_route"], errors["u_hat_route"]
    assert folded["round 1"] <= u_hat["round 1"]
    assert folded["round 2"] <= u_hat["round 2"]
    assert folded["scores"] <= max(u_hat["scores"], 4 * torch.finfo(torch.float32).eps)
    if not near_tie(first64 + second64):
        assert torch.equal(classes["folded_route"], classes["u_hat_route"])
