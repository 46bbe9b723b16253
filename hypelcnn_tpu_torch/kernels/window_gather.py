"""ctypes wrapper of the CUDA window gather (``csrc/window_gather.cu``).

Replaces the TPU kernel ``hypelcnn_tpu/ops/window_gather.py:gather_patches_pallas``.
The kernel is memory-bound (no arithmetic: it writes ``B*k*k*C*4`` bytes and
reads the scene rows the windows touch); the source says how its design
follows from that. The plain PyTorch version of the same function is
:func:`hypelcnn_tpu_torch.ops.window_gather.gather_patches_torch`.

Everything around the kernel's arithmetic is here, in Python the CPU tests
reach: :func:`launch_plan` cuts the output into 16-byte chunks and a tail,
sizes the grid, picks the index width and the stores, and precomputes the
multiply-high constants (:func:`fast_divisor`) the kernel divides by.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from hypelcnn_tpu_torch.kernels import build

SOURCE = "window_gather"
THREADS = 256            # kThreads in the source
CHUNKS_PER_THREAD = 4    # kLargeChunksPerThread in the source: U above one wave
THREADS_PER_SM = 2048    # the most threads an H100 SM holds at once
INDEX_LIMIT = 2 ** 31    # 32-bit index math below this many elements
L2_BYTES = 50 * 2 ** 20  # H100: outputs larger than its L2 are stored evict-first


class LaunchPlan(NamedTuple):
    elements: int           # n = B * k * k * C floats
    chunks: int             # n // 4 aligned 16-byte chunks
    tail: int               # n % 4 floats stored one by one
    chunks_per_thread: int
    blocks: int             # of THREADS threads; 0 launches nothing
    wide: bool              # 64-bit index math
    streaming: bool         # evict-first stores
    divisors: Tuple[Tuple[int, int], ...]  # (mul, shift) for C, k * k and k


def fast_divisor(d: int, wide: bool) -> Tuple[int, int]:
    """``(mul, shift)`` such that ``n // d == (n * mul) >> (bits + shift)``
    for every ``0 <= n < 2 ** (bits - 1)``, ``bits`` being 64 if ``wide``
    else 32; ``mul = 0`` stands for ``d = 1``, which the kernel passes through.

    ``mul = ceil(2 ** (bits - 1 + l) / d)`` with ``l = ceil(log2(d))``: its
    excess over ``2 ** (bits - 1 + l) / d`` is below 1, so for ``n`` below
    ``2 ** (bits - 1)`` the product overshoots ``n / d`` by less than
    ``1 / d`` and the floor is exact.
    """
    if d < 1:
        raise ValueError(f"divisor must be at least 1, got {d}")
    if d == 1:
        return 0, 0
    bits = 64 if wide else 32
    log = (d - 1).bit_length()
    return ((1 << (bits - 1 + log)) + d - 1) // d, log - 1


def launch_plan(batch: int, k: int, channels: int, scene_elements: int,
                sm_count: int) -> LaunchPlan:
    """How to launch the kernel for ``batch`` windows of ``k x k x channels``
    from a scene of ``scene_elements`` floats, on a card of ``sm_count`` SMs.

    Each thread owns one chunk while the chunks fit one wave of the card's
    threads, else ``CHUNKS_PER_THREAD``. Block g covers the span of
    ``THREADS * chunks_per_thread`` chunks from ``base = g * span``: its
    thread t owns the chunks ``base + u * THREADS + t`` for
    ``u < chunks_per_thread``, and the grid is as many blocks as cover the
    chunks. Block 0's first ``tail`` threads store the last ``tail`` floats.
    """
    elements = batch * k * k * channels
    chunks, tail = divmod(elements, 4)
    wide = elements >= INDEX_LIMIT or scene_elements >= INDEX_LIMIT
    per_thread = 1 if chunks <= sm_count * THREADS_PER_SM else CHUNKS_PER_THREAD
    blocks = -(-chunks // (THREADS * per_thread))
    if elements and not blocks:
        blocks = 1  # the tail alone
    divisors = tuple(fast_divisor(d, wide) for d in (channels, k * k, k)) if elements else \
        ((0, 0),) * 3
    return LaunchPlan(elements, chunks, tail, per_thread, blocks, wide,
                      elements * 4 > L2_BYTES, divisors)


class _Plan(ctypes.Structure):
    """``GatherPlan`` in the source."""
    _fields_ = [("elements", ctypes.c_longlong), ("chunks", ctypes.c_longlong),
                ("mul", ctypes.c_ulonglong * 3), ("shift", ctypes.c_int * 3),
                ("tail", ctypes.c_int), ("chunks_per_thread", ctypes.c_int),
                ("blocks", ctypes.c_int), ("wide", ctypes.c_int), ("streaming", ctypes.c_int)]


def _c_plan(plan: LaunchPlan) -> _Plan:
    muls, shifts = zip(*plan.divisors)
    return _Plan(plan.elements, plan.chunks, (ctypes.c_ulonglong * 3)(*muls),
                 (ctypes.c_int * 3)(*shifts), plan.tail, plan.chunks_per_thread, plan.blocks,
                 int(plan.wide), int(plan.streaming))


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.window_gather.argtypes is None:
        lib.window_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_Plan),
            ctypes.c_void_p]
        lib.window_gather.restype = ctypes.c_int
        lib.window_gather_sm_count.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.window_gather_sm_count.restype = ctypes.c_int
        lib.window_gather_error_string.argtypes = [ctypes.c_int]
        lib.window_gather_error_string.restype = ctypes.c_char_p
    return lib


_SM_COUNTS: Dict[int, int] = {}


def device_sm_count(lib: ctypes.CDLL, device: int) -> int:
    """The card's SM count, asked of the runtime once a device."""
    if device not in _SM_COUNTS:
        count = ctypes.c_int()
        code = lib.window_gather_sm_count(device, ctypes.byref(count))
        if code != 0:
            raise RuntimeError("window_gather_sm_count failed: "
                               + lib.window_gather_error_string(code).decode())
        _SM_COUNTS[device] = count.value
    return _SM_COUNTS[device]


def check_inputs(scene: torch.Tensor, coords: torch.Tensor, patch_size: int) -> int:
    """Raise ``ValueError`` on what the kernel does not take, wherever the
    tensors lie; return k."""
    if scene.dtype != torch.float32 or scene.dim() != 3 or not scene.is_contiguous():
        raise ValueError("scene must be a contiguous 3-D float32 tensor, got "
                         f"{scene.dtype} of shape {tuple(scene.shape)}")
    if (coords.device != scene.device or coords.dtype != torch.int32
            or coords.dim() != 2 or coords.shape[1] != 2 or not coords.is_contiguous()):
        raise ValueError("coords must be a contiguous int32 [B, 2] tensor on "
                         f"{scene.device}, got {coords.dtype} of shape "
                         f"{tuple(coords.shape)} on {coords.device}")
    k = int(patch_size)
    if k < 1:
        raise ValueError(f"patch_size must be at least 1, got {patch_size}")
    hp, wp, _ = scene.shape
    if coords.shape[0] and (hp == 0 or wp == 0):
        raise ValueError(f"cannot gather windows from an empty scene of shape {tuple(scene.shape)}")
    return k


def window_gather_cuda(scene: torch.Tensor, coords: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``[B, k, k, C]`` windows of a CUDA ``[Hp, Wp, C]`` float32 scene.

    ``coords`` is a contiguous int32 ``[B, 2]`` tensor of (x, y) on the
    scene's device. Launches on the current stream and does not synchronise.
    Raises on any other input; there is no fallback.
    """
    if not scene.is_cuda:
        raise ValueError(f"window_gather_cuda needs a CUDA scene, got {scene.device}")
    k = check_inputs(scene, coords, patch_size)
    hp, wp, channels = scene.shape
    batch = coords.shape[0]
    out = torch.empty((batch, k, k, channels), dtype=scene.dtype, device=scene.device)
    if out.numel() == 0:
        return out
    if out.data_ptr() % 16:
        raise RuntimeError(f"window_gather needs a 16-byte aligned output, got {out.data_ptr():#x}")
    lib = _library()
    with torch.cuda.device(scene.device):
        plan = _c_plan(launch_plan(batch, k, channels, scene.numel(),
                                   device_sm_count(lib, scene.device.index)))
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.window_gather(scene.data_ptr(), coords.data_ptr(), out.data_ptr(),
                                 batch, k, hp, wp, channels, ctypes.byref(plan), stream)
    if code != 0:
        raise RuntimeError("window_gather launch failed: "
                           + lib.window_gather_error_string(code).decode())
    window_gather_cuda.launches += 1
    window_gather_cuda.launches_by_batch[batch] += 1
    return out


def reset_launches() -> None:
    """Set the launch count and the per-batch-size counts to 0."""
    window_gather_cuda.launches = 0
    window_gather_cuda.launches_by_batch = collections.Counter()


reset_launches()
