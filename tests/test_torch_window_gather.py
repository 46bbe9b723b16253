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
which imports no JAX so that it runs on a machine with a card. What surrounds
the kernel's arithmetic is held here: ``launch_plan``'s partition of the
output (every float owned by exactly one 16-byte chunk or the tail, emulated
in numpy in the kernel's loop order), its index width, the multiply-high
divisors, and the wrapper's refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypelcnn_tpu.ops.window_gather import gather_patches_pallas, gather_patches_xla
from hypelcnn_tpu_torch.kernels.window_gather import (
    CHUNKS_PER_THREAD,
    INDEX_LIMIT,
    L2_BYTES,
    THREADS,
    THREADS_PER_SM,
    check_inputs,
    fast_divisor,
    launch_plan,
    window_gather_cuda,
)
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


SM_COUNT = 132  # an H100's


def _span_bases(plan):
    """The chunk each block's span starts at, block by block, as the kernel
    computes it (``blockIdx.x * span``)."""
    return np.arange(plan.blocks, dtype=np.int64) * (THREADS * plan.chunks_per_thread)


def _span_offsets(plan):
    """Chunk ``base + u * THREADS + t`` of thread t, ``u < chunks_per_thread``."""
    u = np.arange(plan.chunks_per_thread)[:, None]
    t = np.arange(THREADS)[None, :]
    return (u * THREADS + t).reshape(-1)


@pytest.mark.parametrize("batch", [0, 1, 7, 48, 8192, 30480])
@pytest.mark.parametrize("channels", [1, 2, 3, 65, 145, 360])
@pytest.mark.parametrize("k", [1, 3, 5, 9])
def test_launch_plan_owns_every_float_once(k, channels, batch):
    plan = launch_plan(batch, k, channels, 351 * 1907 * channels, SM_COUNT)
    n = batch * k * k * channels
    assert plan.elements == n and plan.chunks * 4 + plan.tail == n and 0 <= plan.tail < 4
    assert not plan.wide
    # one chunk a thread while the chunks fit one wave of the card's threads
    one_wave = plan.chunks <= SM_COUNT * THREADS_PER_SM
    assert plan.chunks_per_thread == (1 if one_wave else CHUNKS_PER_THREAD)
    # as many blocks as cover the chunks, or one block for a tail alone
    assert plan.blocks == max(-(-plan.chunks // (plan.chunks_per_thread * THREADS)), int(n > 0))
    span = THREADS * plan.chunks_per_thread
    bases, offsets = _span_bases(plan), _span_offsets(plan)
    # the blocks' spans start at every multiple of the span below the chunks'
    # end and nowhere else (a tail alone takes block 0) ...
    np.testing.assert_array_equal(bases, np.arange(0, max(plan.chunks, int(n > 0)), span))
    # ... and within a span the threads' chunks are the span's, each once
    np.testing.assert_array_equal(np.sort(offsets), np.arange(span))
    # the tail's threads exist: block 0's first `tail`
    assert plan.tail == 0 or (plan.blocks >= 1 and plan.tail <= THREADS)
    if n <= 1 << 22:  # every float, counted
        chunks = (bases[:, None] + offsets[None, :]).reshape(-1)
        chunks = chunks[chunks < plan.chunks]
        floats = np.concatenate([(4 * chunks[:, None] + np.arange(4)).reshape(-1),
                                 4 * plan.chunks + np.arange(plan.tail)])
        np.testing.assert_array_equal(np.bincount(floats, minlength=n), np.ones(n, np.int64))


@pytest.mark.parametrize("batch, k, channels, scene_elements, wide", [
    (INDEX_LIMIT - 1, 1, 1, 1000, False),
    (INDEX_LIMIT, 1, 1, 1000, True),
    (1, 1, 1, INDEX_LIMIT - 1, False),
    (1, 1, 1, INDEX_LIMIT, True),
    (73_600, 9, 360, 40 * 60 * 360, False),  # 2,146,176,000 floats
    (73_700, 9, 360, 40 * 60 * 360, True),  # 2,149,092,000 floats
])
def test_index_width_turns_64_bit_at_2_31(batch, k, channels, scene_elements, wide):
    plan = launch_plan(batch, k, channels, scene_elements, SM_COUNT)
    assert plan.wide is wide
    assert plan.blocks * plan.chunks_per_thread * THREADS >= plan.chunks
    assert plan.divisors == tuple(fast_divisor(d, wide) for d in (channels, k * k, k))


@pytest.mark.parametrize("batch, k, channels, streaming", [
    (30480, 3, 145, True),   # the sweep band: 159 MB
    (8192, 3, 145, False),   # the eval batch: 43 MB
    (48, 3, 145, False),
])
def test_plan_stores_evict_first_only_past_the_l2(batch, k, channels, streaming):
    plan = launch_plan(batch, k, channels, 10 ** 6, SM_COUNT)
    assert plan.streaming is streaming is (plan.elements * 4 > L2_BYTES)


def _divide(n, mul, shift, bits):
    return n if mul == 0 else (n * mul) >> bits >> shift


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 9, 25, 65, 81, 145, 360, 1305, 2 ** 20 + 1,
                               INDEX_LIMIT - 1])
def test_fast_divisor_divides_exactly(d, wide):
    bits = 64 if wide else 32
    mul, shift = fast_divisor(d, wide)
    assert 0 <= mul < 2 ** bits and shift >= 0
    top = 2 ** (bits - 1)
    rng = np.random.default_rng(d)
    edges = [0, 1, d - 1, d, d + 1, top - 1, top - 2, top - 1 - (top - 1) % d,
             top - 2 - (top - 1) % d]
    if wide:  # Python integers: the 128-bit product
        values = edges + [int(v) for v in rng.integers(0, top, 2000, dtype=np.uint64)]
        assert [_divide(v, mul, shift, 64) for v in values] == [v // d for v in values]
    else:  # numpy: n * mul < 2^63 fits 64 bits
        values = np.concatenate([np.array(edges, np.uint64) % np.uint64(top),
                                 rng.integers(0, top, 200_000, dtype=np.uint64)])
        got = values if mul == 0 else (values * np.uint64(mul)) >> np.uint64(32 + shift)
        np.testing.assert_array_equal(got, values // np.uint64(d))


@pytest.mark.parametrize("chunks, per_thread", [
    (SM_COUNT * THREADS_PER_SM, 1),
    (SM_COUNT * THREADS_PER_SM + 1, CHUNKS_PER_THREAD),
])
def test_plan_takes_more_chunks_a_thread_past_one_wave(chunks, per_thread):
    plan = launch_plan(chunks, 1, 4, 10 ** 6, SM_COUNT)
    assert plan.chunks == chunks and plan.chunks_per_thread == per_thread
    assert plan.blocks == -(-chunks // (per_thread * THREADS))


def test_fast_divisor_refuses_zero():
    with pytest.raises(ValueError, match="at least 1"):
        fast_divisor(0, False)


def _refusal_inputs(case):
    scene = torch.zeros((6, 7, 5))
    coords = torch.zeros((4, 2), dtype=torch.int32)
    if case == "scene float64":
        scene = scene.double()
    elif case == "scene 2-D":
        scene = scene[0]
    elif case == "scene strided":
        scene = scene.transpose(0, 1)
    elif case == "coords int64":
        coords = coords.long()
    elif case == "coords [B, 3]":
        coords = torch.zeros((4, 3), dtype=torch.int32)
    elif case == "coords strided":
        coords = torch.zeros((2, 4), dtype=torch.int32).t()
    elif case == "coords elsewhere":
        coords = coords.to("meta")
    elif case == "empty scene":
        scene = torch.zeros((0, 7, 5))
    return scene, coords


@pytest.mark.parametrize("case, patch_size, message", [
    ("scene float64", 3, "scene must be a contiguous 3-D float32 tensor"),
    ("scene 2-D", 3, "scene must be a contiguous 3-D float32 tensor"),
    ("scene strided", 3, "scene must be a contiguous 3-D float32 tensor"),
    ("coords int64", 3, r"coords must be a contiguous int32 \[B, 2\] tensor"),
    ("coords [B, 3]", 3, r"coords must be a contiguous int32 \[B, 2\] tensor"),
    ("coords strided", 3, r"coords must be a contiguous int32 \[B, 2\] tensor"),
    ("coords elsewhere", 3, r"coords must be a contiguous int32 \[B, 2\] tensor"),
    ("valid", 0, "patch_size must be at least 1"),
    ("empty scene", 3, "cannot gather windows from an empty scene"),
])
def test_wrapper_refusals(case, patch_size, message):
    """The checks the wrapper makes after the CUDA one, on CPU tensors; the
    wrapper itself refuses a CPU scene before any of them, without a launch."""
    scene, coords = _refusal_inputs(case)
    with pytest.raises(ValueError, match=message):
        check_inputs(scene, coords, patch_size)
    before = window_gather_cuda.launches
    with pytest.raises(ValueError, match="needs a CUDA scene"):
        window_gather_cuda(scene, coords, patch_size)
    assert window_gather_cuda.launches == before


def test_wrapper_checks_pass_what_the_kernel_takes():
    scene, coords = _refusal_inputs("valid")
    assert check_inputs(scene, coords, 3) == 3
    assert check_inputs(torch.zeros((0, 7, 5)), coords[:0], 5) == 5  # no windows, no scene needed
