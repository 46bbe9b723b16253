"""The work of CONCNN's local response normalizations (LRN), counted from the
reference model (``reference/concnn.py``), never from the program's modules,
so that it reads the same work whatever implements LRN, and the least time
the card needs for it.

- Least bytes: each LRN reads its input once and writes its result once,
  4 bytes (float32) an element; ``model.lrn_calls`` LRNs a window, each over
  ``model.lrn_elements()`` elements. The window sums of squares need not
  reach memory, so they are not counted.
- LRN does a few FLOP a byte: the card's HBM bandwidth bounds it.
"""

from __future__ import annotations

from typing import Optional

from portbench import counts


def least_bytes(model, windows: int) -> int:
    """Bytes that the LRNs of ``windows`` windows must move at the least."""
    return 2 * 4 * model.lrn_calls * model.lrn_elements() * windows


def least_s(model, windows: int, device_kind: str) -> Optional[float]:
    """The least time of the LRNs of ``windows`` windows on the card
    ``device_kind``: their least bytes at the HBM bandwidth; None for a card
    not in ``counts.PEAKS``."""
    rate = counts.peak(device_kind, "hbm_bytes_per_s")
    return None if rate is None else least_bytes(model, windows) / rate

