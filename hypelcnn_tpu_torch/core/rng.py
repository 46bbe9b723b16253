"""RNG discipline (``hypelcnn_tpu/core/rng.py``).

Host-side streams are the JAX package's bit for bit: ``set_run_seed`` seeds
the global ``np.random`` state that the splitters draw from, and
:meth:`RngPool.numpy_rng` derives ``default_rng(seed ^ blake2s(purpose))``.

Device-side randomness (augmentation, dropout) comes from ``torch.Generator``
objects seeded from (seed, purpose, step), so a run resumed at step N draws
what an uninterrupted run draws at step N without any generator state being
saved, as JAX's ``fold_in(key, step)`` does. The numbers cannot equal JAX's
threefry draws; parity tests inject the draws instead.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np
import torch

DEFAULT_SEED = 1234


def set_run_seed(seed: int = DEFAULT_SEED) -> None:
    """Seed the global numpy state for host-side sampling (the splitters)."""
    np.random.seed(seed)


def _purpose_to_int(purpose: str) -> int:
    return int.from_bytes(hashlib.blake2s(purpose.encode(), digest_size=4).digest(), "little")


class RngPool:
    """Deterministic per-purpose random streams.

    ``pool.generator("dropout", step, device)`` is seeded from the same
    (seed, purpose, step) triple whatever was drawn before it. One generator
    object is kept per (purpose, device) and re-seeded on each call, so a
    caller must take its draws before asking for the same purpose again.
    """

    def __init__(self, seed: int = DEFAULT_SEED):
        self.seed = seed
        self._generators: Dict[Tuple[str, torch.device], torch.Generator] = {}

    def numpy_rng(self, purpose: str) -> np.random.Generator:
        return np.random.default_rng(np.uint32(self.seed) ^ np.uint32(_purpose_to_int(purpose)))

    def _generator_seed(self, purpose: str, step: int) -> int:
        digest = hashlib.blake2s(f"{self.seed}/{purpose}/{int(step)}".encode(),
                                 digest_size=8).digest()
        return int.from_bytes(digest, "little") & ((1 << 63) - 1)

    def generator(self, purpose: str, step: int = 0, device="cpu") -> torch.Generator:
        device = torch.device(device)
        gen = self._generators.get((purpose, device))
        if gen is None:
            gen = torch.Generator(device=device)
            self._generators[(purpose, device)] = gen
        return gen.manual_seed(self._generator_seed(purpose, step))
