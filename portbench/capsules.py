"""The work of CAP's capsule layer (the prediction vectors and the routing
rounds), counted from the reference model (``reference/cap.py``), never
from the program's modules, and the least time the card needs for it.

- FLOP: the reference's ``transform`` and ``routing`` products
  (``D*P*J*C`` and ``(2r - 1)*D*J*C`` multiply-adds a window), at 2 FLOP a
  multiply-add, as ``counts.py`` counts.
- Least bytes: the primary capsules ``u`` (``D*P`` float32 a window) and the
  weights (``W`` and its bias) read once, the digit capsules (``J*C`` a
  window) written once. Whatever implements the layer, the prediction
  vectors need not reach memory, so they are not counted.
"""

from __future__ import annotations

from typing import Optional

from portbench import counts

KINDS = ("transform", "routing")  # the reference's Op kinds of the layer


def layer_flop(model) -> int:
    """FLOP of the capsule layer for one window."""
    return 2 * sum(op.macs for op in model.ops() if op.kind in KINDS)


def layer_least_bytes(model, windows: int) -> int:
    """Bytes that the capsule layer must move at the least for ``windows`` windows."""
    q = model.classes * model.dco
    weights = model.data_size * model.pco * q + model.data_size * q
    return 4 * (windows * (model.data_size * model.pco + q) + weights)


def layer_least_s(model, windows: int, device_kind: str) -> Optional[float]:
    """The least time of the layer for ``windows`` windows on the card
    ``device_kind``: its FLOP at the float32 peak or its least bytes at the
    HBM bandwidth, the larger; None for a card not in ``counts.PEAKS``."""
    flop_rate = counts.peak(device_kind, "fp32_flop_per_s")
    byte_rate = counts.peak(device_kind, "hbm_bytes_per_s")
    if flop_rate is None or byte_rate is None:
        return None
    return max(layer_flop(model) * windows / flop_rate,
               layer_least_bytes(model, windows) / byte_rate)
