"""The work a cell asks of the card, counted from the benchmark's own
reference models and shapes (never from the program's modules), and the
card's peaks.

- A forward pass: every convolution's output elements times its taps,
  SAME padding counted as the model's equations pad, and every dense
  layer's weights, at 2 FLOP a multiply-add.
- A training step: 3 forward passes of the training-mode model, less the
  input gradient of the layers that read the model's input (which no one
  needs).
- The window gather of one sweep band: its output written once, plus the
  distinct scene pixels of the band's rows and the coordinates read once.
"""

from __future__ import annotations

from typing import Optional

# NVIDIA's H100 SXM data sheet, dense rates: float32 outside the tensor
# cores (the port computes float32 with TF32 off), and HBM3 bandwidth
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flop_per_s": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(device_kind: str, key: str) -> Optional[float]:
    """A peak of the card named ``device_kind``, or None for a card not in the table."""
    return PEAKS.get(device_kind, {}).get(key)


def forward_flop(model, train: bool = False) -> int:
    """FLOP of one window's forward pass, in training mode if ``train``."""
    return 2 * sum(op.macs for op in model.ops() if train or not op.train_only)


def train_flop(model) -> int:
    """FLOP of one window's training step: forward, input and weight gradients."""
    return 3 * forward_flop(model, train=True) - 2 * sum(
        op.macs for op in model.ops() if op.reads_input)


def gather_band_bytes(batch_rows: int, width: int, k: int, channels: int) -> int:
    """Bytes that one band's window gather must move at the least: the
    ``[batch_rows * width, k, k, channels]`` float32 output written once,
    the ``(batch_rows + k - 1) x (width + k - 1)`` padded scene pixels it
    covers read once, and the int32 (x, y) coordinates read once."""
    windows = batch_rows * width
    return 4 * (windows * k * k * channels
                + (batch_rows + k - 1) * (width + k - 1) * channels
                + windows * 2)
