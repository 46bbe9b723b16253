"""ctypes wrapper of the CUDA window gather (``csrc/window_gather.cu``).

Replaces the TPU kernel ``hypelcnn_tpu/ops/window_gather.py:gather_patches_pallas``.
The kernel is memory-bound (no arithmetic: it writes ``B*k*k*C*4`` bytes and
reads the scene rows the windows touch); the source says how its design
follows from that. The plain PyTorch version of the same function is
:func:`hypelcnn_tpu_torch.ops.window_gather.gather_patches_torch`.
"""

from __future__ import annotations

import ctypes

import torch

from hypelcnn_tpu_torch.kernels import build

SOURCE = "window_gather"


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.window_gather.argtypes is None:
        lib.window_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.window_gather.restype = ctypes.c_int
        lib.window_gather_error_string.argtypes = [ctypes.c_int]
        lib.window_gather_error_string.restype = ctypes.c_char_p
    return lib


def window_gather_cuda(scene: torch.Tensor, coords: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``[B, k, k, C]`` windows of a CUDA ``[Hp, Wp, C]`` float32 scene.

    ``coords`` is a contiguous int32 ``[B, 2]`` tensor of (x, y) on the
    scene's device. Launches on the current stream and does not synchronise.
    Raises on any other input; there is no fallback.
    """
    if not scene.is_cuda:
        raise ValueError(f"window_gather_cuda needs a CUDA scene, got {scene.device}")
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
    hp, wp, channels = scene.shape
    batch = coords.shape[0]
    if batch and (hp == 0 or wp == 0):
        raise ValueError(f"cannot gather windows from an empty scene of shape {tuple(scene.shape)}")
    out = torch.empty((batch, k, k, channels), dtype=scene.dtype, device=scene.device)
    if batch == 0:
        return out
    lib = _library()
    with torch.cuda.device(scene.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.window_gather(scene.data_ptr(), coords.data_ptr(), out.data_ptr(),
                                 batch, k, hp, wp, channels, stream)
    if code != 0:
        raise RuntimeError("window_gather launch failed: "
                           + lib.window_gather_error_string(code).decode())
    window_gather_cuda.launches += 1
    return out


window_gather_cuda.launches = 0
