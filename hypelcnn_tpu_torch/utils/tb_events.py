"""TensorBoard event-file reader with no TensorFlow (``hypelcnn_tpu/utils/tb_events.py``).

Scrapes ``validation_confusion`` text-tensor summaries out of TF event files
and writes one CSV per step, then prints the aggregate statistics, so the
reference's experiment logs are readable here.

An event file is TFRecord-framed protobufs: each record is
``uint64 length | uint32 masked_crc32c(length) | data | uint32
masked_crc32c(data)``.  The payload is an ``Event`` proto.  Rather than
depending on tensorflow (or shipping generated pb2 modules), this reads the
protobuf wire format directly for just the fields the reference consumes:

    Event { 1: double wall_time; 2: int64 step; 5: Summary summary }
    Summary { 1: repeated Value }
    Value { 1: string tag; 2: float simple_value; 8: TensorProto tensor }
    TensorProto { 2: TensorShapeProto tensor_shape;
                  8: repeated bytes string_val }
    TensorShapeProto { 2: repeated Dim { 1: int64 size } }

Record CRCs are verified with a pure-python crc32c (the masked-crc scheme
from the TFRecord spec); a corrupt or truncated tail is skipped, as TF's
``DataLossError`` handler does. ``masked_crc32c_rows`` computes the same
checksum for many equal-length buffers at once with numpy, for the record
files, whose records share one length.

CLI: ``python -m hypelcnn_tpu_torch.utils.tb_events <event_dir> [step ...]``;
the CSVs land in the current directory named
``<grandparent>_<parent>_s<step>.csv``.
"""

from __future__ import annotations

import glob
import os
import struct
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------- crc32c ----

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def masked_crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """``masked_crc32c`` of every row of a ``[N, L]`` uint8 array, as ``[N]``
    uint32: one table step per byte position, over all rows at once."""
    table = np.asarray(_crc_table(), dtype=np.uint32)
    crc = np.full(rows.shape[0], 0xFFFFFFFF, dtype=np.uint32)
    for column in np.ascontiguousarray(rows, dtype=np.uint8).T:
        crc = table[(crc ^ column) & 0xFF] ^ (crc >> 8)
    crc ^= np.uint32(0xFFFFFFFF)
    return ((crc >> 15) | (crc << 17)) + np.uint32(0xA282EAD8)


def masked_crc32c_many(buffers: List[bytes]) -> List[int]:
    """``masked_crc32c`` of each buffer; those of one length go through
    :func:`masked_crc32c_rows` together."""
    crcs = [0] * len(buffers)
    by_length: Dict[int, List[int]] = {}
    for i, data in enumerate(buffers):
        by_length.setdefault(len(data), []).append(i)
    for length, rows in by_length.items():
        table = np.frombuffer(b"".join(buffers[i] for i in rows), dtype=np.uint8)
        for i, crc in zip(rows, masked_crc32c_rows(table.reshape(len(rows), length))):
            crcs[i] = int(crc)
    return crcs


def signed_int64(value: int) -> int:
    """A varint's unsigned 64 bits as the int64 they encode."""
    return value - (1 << 64) if value >= 1 << 63 else value


# ------------------------------------------------------- TFRecord framing ----

class DataLoss(Exception):
    """Truncated or corrupt record (parity with TF's DataLossError)."""


def iter_tfrecord_frames(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads; raises DataLoss on a corrupt frame."""
    with open(path, "rb") as fid:
        while True:
            header = fid.read(12)
            if not header:
                return
            if len(header) < 12:
                raise DataLoss(f"truncated length header in {path}")
            (length,), (len_crc,) = struct.unpack("<Q", header[:8]), \
                struct.unpack("<I", header[8:])
            if verify_crc and masked_crc32c(header[:8]) != len_crc:
                raise DataLoss(f"length crc mismatch in {path}")
            data = fid.read(length)
            footer = fid.read(4)
            if len(data) < length or len(footer) < 4:
                raise DataLoss(f"truncated record in {path}")
            if verify_crc and masked_crc32c(data) != struct.unpack("<I", footer)[0]:
                raise DataLoss(f"data crc mismatch in {path}")
            yield data


# ------------------------------------------------- protobuf wire decoding ----

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise DataLoss("varint too long")


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) for every field in a message.

    LEN fields yield raw bytes; VARINT yields int; I64/I32 yield raw bytes
    (caller unpacks).  Unknown wire types raise DataLoss.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val, pos = buf[pos:pos + 8], pos + 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wtype == 5:  # 32-bit
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise DataLoss(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


@dataclass
class TensorValue:
    shape: List[int] = field(default_factory=list)
    string_val: List[bytes] = field(default_factory=list)


@dataclass
class SummaryValue:
    tag: str = ""
    simple_value: Optional[float] = None
    tensor: Optional[TensorValue] = None


@dataclass
class Event:
    wall_time: float = 0.0
    step: int = 0
    values: List[SummaryValue] = field(default_factory=list)


def _parse_shape(buf: bytes) -> List[int]:
    dims = []
    for fnum, _, val in _iter_fields(buf):
        if fnum == 2:  # Dim
            size = 0
            for dnum, _, dval in _iter_fields(val):
                if dnum == 1:
                    size = dval
            dims.append(size)
    return dims


def _parse_tensor(buf: bytes) -> TensorValue:
    tensor = TensorValue()
    for fnum, _, val in _iter_fields(buf):
        if fnum == 2:
            tensor.shape = _parse_shape(val)
        elif fnum == 8:
            tensor.string_val.append(val)
    return tensor


def _parse_value(buf: bytes) -> SummaryValue:
    value = SummaryValue()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == 2:
            value.tag = val.decode("utf-8", "replace")
        elif fnum == 2 and wtype == 5:
            value.simple_value = struct.unpack("<f", val)[0]
        elif fnum == 8 and wtype == 2:
            value.tensor = _parse_tensor(val)
    return value


def parse_event(buf: bytes) -> Event:
    event = Event()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == 1:
            event.wall_time = struct.unpack("<d", val)[0]
        elif fnum == 2 and wtype == 0:
            # int64 varint (steps are non-negative; no zigzag in proto3 int64)
            event.step = signed_int64(val)
        elif fnum == 5 and wtype == 2:
            for snum, swtype, sval in _iter_fields(val):
                if snum == 1 and swtype == 2:
                    event.values.append(_parse_value(sval))
    return event


def iter_events(path: str) -> Iterator[Event]:
    """Parse every event in a file; stops (like the reference's
    DataLossError handler) at the first corrupt frame."""
    try:
        for frame in iter_tfrecord_frames(path):
            yield parse_event(frame)
    except DataLoss as exc:
        print("Error reading summary file:", path, f"({exc})")


# ------------------------------------------------------------ scraping ----

def extract_confusions(event_dir: str, filtered_steps: Sequence[int] = (),
                       output_dir: str = ".", tag: str = "validation_confusion",
                       ) -> List[Tuple[int, str, np.ndarray]]:
    """Scrape ``tag`` text tensors from every ``event*`` file in a directory.

    Returns (step, csv_path, matrix) per hit; the CSV naming and the tensor
    indexing are the reference reader's (``matrix[h][w] = string_val[width *
    h + w]``).
    """
    results = []
    for event_path in sorted(glob.glob(os.path.join(event_dir, "event*"))):
        parent_dir = Path(event_path).parent
        for event in iter_events(event_path):
            if filtered_steps and event.step not in filtered_steps:
                continue
            for val in event.values:
                if val.tag != tag or val.tensor is None:
                    continue
                if len(val.tensor.shape) != 2:
                    continue
                width, height = val.tensor.shape
                print("Step %i in %s" % (event.step, event_path))
                matrix = np.zeros([width, height], dtype=int)
                flat = val.tensor.string_val
                for h in range(height):
                    for w in range(width):
                        matrix[h][w] = int(flat[width * h + w])
                record = (parent_dir.parent.name + "_" + parent_dir.name
                          + "_s" + str(event.step) + ".csv")
                full_path = os.path.join(output_dir, record)
                print("Saving to file:", full_path)
                np.savetxt(full_path, matrix, fmt="%d", delimiter=",")
                results.append((event.step, full_path, matrix))
    return results


def read_scalars(event_dir: str) -> Dict[str, List[Tuple[int, float]]]:
    """All scalar summaries as tag -> [(step, value)] — handy for plotting
    reference training curves without tensorboard."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for event_path in sorted(glob.glob(os.path.join(event_dir, "event*"))):
        for event in iter_events(event_path):
            for val in event.values:
                if val.simple_value is not None:
                    out.setdefault(val.tag, []).append((event.step, val.simple_value))
    return out


def main() -> None:
    event_dir = sys.argv[1]
    filtered_steps = [int(v) for v in sys.argv[2:]]
    results = extract_confusions(event_dir, filtered_steps)
    from hypelcnn_tpu_torch.utils.stat_extractor import (
        extract_statistics_info, print_statistics_info)
    print_statistics_info(
        extract_statistics_info([matrix for _, _, matrix in results]))


if __name__ == "__main__":
    main()
