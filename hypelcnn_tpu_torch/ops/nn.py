"""Small neural-net ops shared across model families (NCHW: channels on dim 1)."""

from __future__ import annotations

import torch


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """JAX's convention: ``x`` where ``x >= 0``, so the gradient at 0 is 1
    (``torch.nn.functional.leaky_relu`` gives ``alpha`` there)."""
    return torch.where(x >= 0, x, alpha * x)


def scale_in_to_out(input_data: torch.Tensor, output_data: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Match ``input_data``'s channel count to ``output_data``'s so a residual
    add is shape-legal (``hypelcnn_tpu/ops/nn.py:scale_in_to_out``).

    When the output count is a multiple of the input's, each channel is
    repeated in place (``[a, a, b, b]``: ``repeat_interleave``, as
    ``jnp.repeat``; ``Tensor.repeat`` would tile ``[a, b, a, b]``). Otherwise
    the nearest input channel is taken for each output position.
    """
    in_ch = input_data.shape[dim]
    out_ch = output_data.shape[dim]
    if in_ch == out_ch:
        return input_data
    if out_ch % in_ch == 0:
        return torch.repeat_interleave(input_data, out_ch // in_ch, dim=dim)
    scale_ratio = in_ch / out_ch
    idx = [min(round(i * scale_ratio), in_ch - 1) for i in range(out_ch)]
    return torch.index_select(input_data, dim,
                              torch.tensor(idx, dtype=torch.int64, device=input_data.device))
