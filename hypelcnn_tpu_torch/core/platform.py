"""Device selection and the float32 policy.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; asking for
CUDA where there is none raises, and nothing falls back to the CPU quietly.

Float32 policy: the models compute in float32, as the JAX package does by
default (``hypelcnn_tpu/models/hypelcnn.py`` ``compute_dtype``). cuDNN runs
float32 convolutions in TF32 by default, which keeps about three decimal
digits, so :func:`resolve_device` turns TF32 off for both cuDNN and cuBLAS.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``, after checking that it exists and setting the float32 policy."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} was asked for but CUDA is not available; "
                           "pass --device=cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device
