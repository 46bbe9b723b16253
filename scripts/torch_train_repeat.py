#!/usr/bin/env python3
"""Whether DUALCNN's training on one CUDA card repeats run to run, with
cuDNN's default algorithms and with its deterministic ones.

    python3 scripts/torch_train_repeat.py

Runs the PyTorch port's train CLI as ``chip_smoke.py``'s ``family_dualcnn``
phase does (the published width, batch 48, k = 5, augmentation, seed and
300 steps; a fresh log dir each time) in three modes:

- ``default``, twice: as the port runs;
- ``cudnn_deterministic``, twice: ``torch.backends.cudnn.deterministic =
  True`` and ``benchmark = False``;
- ``strict``, once: ``torch.use_deterministic_algorithms(True,
  warn_only=True)``, whose warnings name any operation that has no
  deterministic implementation.

Prints the card's name and power limit, one JSON line a run (logged losses,
test OA, seconds, distinct warnings), then one line comparing the runs of
each mode: whether the losses and test OA repeat, and the largest absolute
difference between the final weights. Needs one CUDA device; exits 1
without one.
"""

from __future__ import annotations

import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

RUNS = [("default", 0), ("default", 1), ("cudnn_deterministic", 0),
        ("cudnn_deterministic", 1), ("strict", 0)]


def _set_mode(mode: str) -> None:
    torch.backends.cudnn.deterministic = mode != "default"
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(mode == "strict", warn_only=True)


def _train(family, log_root: Path) -> tuple:
    result, _ = chip_smoke._run_train_cli(chip_smoke._train_args(log_root, family.steps, family))
    (log_dir,) = [p for p in log_root.iterdir() if p.is_dir()]
    weights = {name: value.detach().cpu().clone()
               for name, value in result.final_state.module.state_dict().items()}
    return chip_smoke._logged_losses(log_dir), result.test_accuracy, weights


def _max_weight_diff(a: dict, b: dict) -> float:
    return max(float((a[name] - b[name]).abs().max()) for name in a)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_repeat: no CUDA device", file=sys.stderr)
        return 1
    (family,) = [f for f in chip_smoke.FAMILIES if f.phase == "family_dualcnn"]
    chip_smoke.phase_device()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="train_repeat_") as work:
        for mode, index in RUNS:
            _set_mode(mode)
            start = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                losses, oa, weights = _train(family, Path(work) / f"{mode}_{index}")
            runs.setdefault(mode, []).append((losses, oa, weights))
            chip_smoke.emit({"model": family.model, "mode": mode, "run": index,
                             "steps": family.steps, "logged_losses": losses, "test_oa": oa,
                             "seconds": time.perf_counter() - start,
                             "warnings": sorted({str(w.message)[:300] for w in caught})})
    _set_mode("default")
    summary = {}
    pairs = {"default": runs["default"], "cudnn_deterministic": runs["cudnn_deterministic"],
             "strict_vs_cudnn_deterministic": [runs["strict"][0], runs["cudnn_deterministic"][0]]}
    for name, (first, second) in pairs.items():
        summary[name] = {"losses_equal": first[0] == second[0],
                         "test_oa_equal": first[1] == second[1],
                         "max_abs_weight_diff": _max_weight_diff(first[2], second[2])}
    chip_smoke.emit({"model": family.model, "repeat": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
