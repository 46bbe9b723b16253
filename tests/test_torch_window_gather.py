"""The port's window gather against the JAX package's gathers.

Exact equality: a gather copies floats and does no arithmetic.

- ``gather_patches_torch`` equals ``gather_patches_xla`` everywhere, out-of-
  range and negative coordinates included (an index below 0 wraps once,
  then clamps).
- ``gather_patches_pallas`` (interpret mode, as ``tests/test_data.py`` runs
  it) equals both for windows inside the padded scene. Outside it the Pallas
  kernel moves the whole window back into range (a DMA slice start clamps),
  which the XLA gather and the port do not do.
The CUDA kernel against the plain version is in ``test_torch_kernels_cuda.py``,
which imports no JAX so that it runs on a machine with a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypelcnn_tpu.ops.window_gather import gather_patches_pallas, gather_patches_xla
from hypelcnn_tpu_torch.kernels.window_gather import window_gather_cuda
from hypelcnn_tpu_torch.ops.window_gather import gather_patches, gather_patches_torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

HP, WP, C = 11, 14, 5


def _scene():
    return np.random.default_rng(0).normal(size=(HP, WP, C)).astype(np.float32)


def _coords(batch, low, high, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(low, high + WP - HP, batch),
                     rng.integers(low, high, batch)], axis=1).astype(np.int32)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("batch", [1, 7, 129])
def test_plain_matches_xla_including_out_of_range(k, batch):
    scene = _scene()
    coords = _coords(batch, -2 * HP, 2 * HP, seed=batch + k)
    coords[0] = (-1, -1)
    expected = np.asarray(gather_patches_xla(jnp.asarray(scene), jnp.asarray(coords), k))
    got = gather_patches_torch(torch.from_numpy(scene), torch.from_numpy(coords), k).numpy()
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("batch", [1, 7, 129])
def test_plain_matches_pallas_interpret_in_range(k, batch):
    scene = _scene()
    rng = np.random.default_rng(batch * 10 + k)
    coords = np.stack([rng.integers(0, WP - k + 1, batch),
                       rng.integers(0, HP - k + 1, batch)], axis=1).astype(np.int32)
    expected = np.asarray(gather_patches_pallas(jnp.asarray(scene), jnp.asarray(coords), k,
                                                interpret=True))
    got = gather_patches_torch(torch.from_numpy(scene), torch.from_numpy(coords), k).numpy()
    np.testing.assert_array_equal(got, expected)


def test_out_of_range_semantics_on_a_small_scene():
    # on a 5x6 scene with k = 3, x = -1 reads columns 5, 0, 1 and x = 5 reads 5, 5, 5
    scene = torch.arange(5 * 6, dtype=torch.float32).reshape(5, 6, 1)
    coords = torch.tensor([[-1, 0], [5, 0]], dtype=torch.int32)
    got = gather_patches_torch(scene, coords, 3)
    assert got[0, 0, :, 0].tolist() == [5.0, 0.0, 1.0]
    assert got[1, 0, :, 0].tolist() == [5.0, 5.0, 5.0]


def test_dispatcher_takes_the_plain_version_on_the_cpu():
    scene = torch.from_numpy(_scene())
    coords = torch.from_numpy(_coords(9, 0, HP - 3, seed=4))
    torch.testing.assert_close(gather_patches(scene, coords, 3),
                               gather_patches_torch(scene, coords, 3), rtol=0, atol=0)


def test_cuda_wrapper_refuses_a_cpu_scene():
    scene = torch.from_numpy(_scene())
    coords = torch.zeros((4, 2), dtype=torch.int32)
    before = window_gather_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        window_gather_cuda(scene, coords, 3)
    assert window_gather_cuda.launches == before
