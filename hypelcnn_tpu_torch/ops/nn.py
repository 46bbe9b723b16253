"""Small neural-net ops shared across model families (NCHW: channels on dim 1)."""

from __future__ import annotations

import torch


def weak_scalar(value: float, like: torch.Tensor) -> float:
    """``value`` as JAX applies a Python scalar to ``like``: rounded to its
    dtype first (a weakly typed constant takes the array's dtype), where
    torch would compute with the unrounded scalar and round once. Unchanged
    for float32."""
    return value if like.dtype == torch.float32 else float(torch.tensor(value, dtype=like.dtype))


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """JAX's convention: ``x`` where ``x >= 0``, so the gradient at 0 is 1
    (``torch.nn.functional.leaky_relu`` gives ``alpha`` there)."""
    return torch.where(x >= 0, x, weak_scalar(alpha, x) * x)


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
    # the JAX package's [min(round(i * in_ch / out_ch), in_ch - 1)], made on the
    # device: float64 products and round-half-to-even are Python's, and no
    # host list is copied over (a copy from pageable memory waits for the queue)
    positions = torch.arange(out_ch, dtype=torch.float64, device=input_data.device)
    idx = torch.round(positions * (in_ch / out_ch)).clamp_(max=in_ch - 1).to(torch.int64)
    return torch.index_select(input_data, dim, idx)


def local_response_normalization(x: torch.Tensor, depth_radius: int = 5, bias: float = 1.0,
                                 alpha: float = 1.0, beta: float = 0.5,
                                 dim: int = 1) -> torch.Tensor:
    """LRN over channel dim ``dim`` with TF's semantics
    (``hypelcnn_tpu/ops/nn.py:local_response_normalization``):
    ``x / (bias + alpha * sum(x**2 over the 2r+1 channels around c)) ** beta``.

    The window sum is a plain sum, clipped at the edges, taken as a difference
    of cumulative sums as the JAX package takes it.
    ``torch.nn.functional.local_response_norm`` divides ``alpha`` by the
    window size and pads differently, so it computes another function.

    ``local_response_normalization.calls`` and ``.elements`` count the calls
    and the elements they normalized since :func:`reset_lrn_counts`.
    """
    local_response_normalization.calls += 1
    local_response_normalization.elements += x.numel()
    sq = torch.square(x).movedim(dim, -1)
    padded = torch.nn.functional.pad(sq, (depth_radius + 1, depth_radius))
    cs = torch.cumsum(padded, dim=-1) if x.dtype == torch.float32 else _scan_sum(padded)
    win = 2 * depth_radius + 1
    window_sums = (cs[..., win:] - cs[..., :-win]).movedim(-1, dim)
    return x / torch.pow(bias + alpha * window_sums, beta)


def reset_lrn_counts() -> None:
    """Set :func:`local_response_normalization`'s counts to 0."""
    local_response_normalization.calls = 0
    local_response_normalization.elements = 0


reset_lrn_counts()


def _scan_sum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """The cumulative sum over the last dim as XLA takes a reduced-precision
    ``jnp.cumsum`` off the TPU, every partial sum rounded to ``x``'s dtype:
    a running sum within each block of ``block``, then the blocks' running
    totals added to the next blocks. ``torch.cumsum`` accumulates bfloat16
    in float32, which rounds differently."""
    n = x.shape[-1]
    if n <= block:
        out, acc = torch.empty_like(x), torch.zeros_like(x[..., 0])
        for i in range(n):
            acc = acc + x[..., i]
            out[..., i] = acc
        return out
    blocks = -(-n // block)
    inner = _scan_sum(torch.nn.functional.pad(x, (0, blocks * block - n))
                      .reshape(*x.shape[:-1], blocks, block), block)
    before = torch.nn.functional.pad(_scan_sum(inner[..., -1], block)[..., :-1], (1, 0))
    return (inner + before.unsqueeze(-1)).reshape(*x.shape[:-1], blocks * block)[..., :n]


def squash(s: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    """Capsule squash (``hypelcnn_tpu/ops/nn.py:squash``), with the JAX
    package's MEAN of squares, not the sum, as its norm term."""
    norm_sq = torch.mean(torch.square(s), dim=dim, keepdim=True)
    return norm_sq * s / ((1.0 + norm_sq) * torch.sqrt(norm_sq + eps))
