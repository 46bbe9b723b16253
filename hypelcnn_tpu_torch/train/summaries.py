"""Training summaries (``hypelcnn_tpu/train/summaries.py``): every record goes
to ``summaries.jsonl`` and to a TensorBoard event file.

The event file is written here, with no TensorBoard or TensorFlow package:
TFRecord-framed ``Event`` protos (``utils/tfrecord_write.py``'s framing and
encoders), the first holding ``file_version``, then one a record:

    Event { 1: double wall_time; 2: int64 step; 3: string file_version;
            5: Summary summary }
    Summary { 1: repeated Value }
    Value { 1: string tag; 2: float simple_value; 5: HistogramProto histo;
            8: TensorProto tensor; 9: SummaryMetadata metadata }

Scalars are ``simple_value``; text is a one-element ``DT_STRING`` tensor with
the ``text`` plugin's metadata; histograms are ``HistogramProto``.
``utils/tb_events.py`` reads the files back, as TensorBoard does.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time

import numpy as np

from hypelcnn_tpu_torch.utils.tfrecord_write import _len_delimited, _tag, _varint, frame_records

_DT_STRING = 7


def _double(field_number: int, value: float) -> bytes:
    return _tag(field_number, 1) + struct.pack("<d", float(value))


def _event(step: int, value: bytes = b"", file_version: str = "") -> bytes:
    event = _double(1, time.time()) + _tag(2, 0) + _varint(int(step))
    if file_version:
        event += _len_delimited(3, file_version.encode("utf-8"))
    if value:
        event += _len_delimited(5, _len_delimited(1, value))
    return event


def _scalar_value(tag: str, value: float) -> bytes:
    return _len_delimited(1, tag.encode("utf-8")) + _tag(2, 5) + struct.pack("<f", float(value))


def _text_value(tag: str, text: str) -> bytes:
    shape = _len_delimited(2, _len_delimited(2, _tag(1, 0) + _varint(1)))
    tensor = _tag(1, 0) + _varint(_DT_STRING) + shape + _len_delimited(8, text.encode("utf-8"))
    metadata = _len_delimited(1, _len_delimited(1, b"text"))
    return (_len_delimited(1, tag.encode("utf-8")) + _len_delimited(8, tensor)
            + _len_delimited(9, metadata))


def _histogram_value(tag: str, values: np.ndarray, bins: int = 30) -> bytes:
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    if values.size == 0:
        values = np.zeros(1)
    counts, edges = np.histogram(values, bins=bins)
    histo = (_double(1, values.min()) + _double(2, values.max()) + _double(3, values.size)
             + _double(4, values.sum()) + _double(5, np.square(values).sum())
             + _len_delimited(6, edges[1:].astype("<f8").tobytes())
             + _len_delimited(7, counts.astype("<f8").tobytes()))
    return _len_delimited(1, tag.encode("utf-8")) + _len_delimited(5, histo)


class SummaryWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "summaries.jsonl"), "a", encoding="utf-8")
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self._events = open(os.path.join(log_dir, name), "ab")
        self._write_event(_event(0, file_version="brain.Event:2"))

    def _write_event(self, event: bytes) -> None:
        self._events.write(frame_records([event]))
        self._events.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"ts": time.time(), "tag": tag,
                                      "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()
        self._write_event(_event(step, _scalar_value(tag, value)))

    def text(self, tag: str, value: str, step: int = 0) -> None:
        """Start-of-run config dump."""
        self._jsonl.write(json.dumps({"ts": time.time(), "tag": tag,
                                      "text": value, "step": int(step)}) + "\n")
        self._jsonl.flush()
        self._write_event(_event(step, _text_value(tag, value)))

    def histogram(self, tag: str, values, step: int) -> None:
        self._write_event(_event(step, _histogram_value(tag, values)))

    def close(self) -> None:
        self._jsonl.close()
        self._events.close()
