"""Training summaries (``hypelcnn_tpu/train/summaries.py``): every record goes
to ``summaries.jsonl``; TensorBoard events are written too when
``torch.utils.tensorboard`` imports (it needs the ``tensorboard`` package,
which is optional)."""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _tensorboard_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter as TBWriter
    except ImportError:
        return None
    return TBWriter(log_dir)


class SummaryWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "summaries.jsonl"), "a", encoding="utf-8")
        self._tb = _tensorboard_writer(log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"ts": time.time(), "tag": tag,
                                      "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()
        if self._tb:
            self._tb.add_scalar(tag, float(value), int(step))

    def text(self, tag: str, value: str, step: int = 0) -> None:
        """Start-of-run config dump."""
        self._jsonl.write(json.dumps({"ts": time.time(), "tag": tag,
                                      "text": value, "step": int(step)}) + "\n")
        self._jsonl.flush()
        if self._tb:
            self._tb.add_text(tag, f"<pre>{value}</pre>", int(step))

    def histogram(self, tag: str, values, step: int) -> None:
        if self._tb:
            self._tb.add_histogram(tag, np.asarray(values), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb:
            self._tb.close()
