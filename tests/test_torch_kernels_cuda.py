"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA device and ``nvcc`` and skips without them.
The file imports no JAX, so that it runs where only PyTorch is installed;
``tests/conftest.py`` imports JAX, so run it there with::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene
from hypelcnn_tpu_torch.kernels import build
from hypelcnn_tpu_torch.kernels.window_gather import window_gather_cuda
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
from hypelcnn_tpu_torch.models.layers import init_parameters
from hypelcnn_tpu_torch.ops.window_gather import gather_patches_torch


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
@pytest.mark.parametrize("channels", [12, 145])
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
