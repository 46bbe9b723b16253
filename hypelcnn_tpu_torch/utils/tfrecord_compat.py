"""Read the reference's ``.tfrecord`` datasets with numpy (``hypelcnn_tpu/utils/tfrecord_compat.py``).

The reference serializes patches as ``tf.train.Example`` records, an int64
``label`` and a flat float ``image``, plus a ``metadata.tfrecord`` holding
the three splits' shapes (``utils/tfrecord_write.py`` writes the same files).
``RecordImporter`` reads them through this module when it finds
``metadata.tfrecord`` instead of a ``patch_cache.npz``.

Where the JAX package reads through ``tf.data``, this reader has three
parts, numpy and the stdlib only:

- the TFRecord framing (``uint64 length | uint32 masked_crc32c(length) |
  data | uint32 masked_crc32c(data)``) with every checksum checked; a bad
  one raises ``DataLoss``;
- the GZIP variant: a file that does not frame as it is is read again
  through ``gzip``, as the JAX reader retries with ``GZIP``;
- a ``tf.train.Example`` decoder: the ``Features`` map's entries, each a
  ``bytes_list``, ``float_list`` or ``int64_list``, their values packed or
  unpacked.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from hypelcnn_tpu_torch.utils.tb_events import (
    DataLoss,
    _iter_fields,
    _read_varint,
    masked_crc32c_many,
    signed_int64,
)

SPLIT_FILES = {"training": "training.tfrecord", "test": "test.tfrecord",
               "validation": "validation.tfrecord"}


def _check_crcs(data: bytes, starts: List[int], lengths: List[int], crcs: List[int],
                what: str, path: str) -> None:
    """Check ``masked_crc32c(data[s:s + length]) == crc`` for every span."""
    spans = [data[s:s + length] for s, length in zip(starts, lengths)]
    if masked_crc32c_many(spans) != crcs:
        raise DataLoss(f"{what} crc mismatch in {path}")


def split_frames(data: bytes, path: str = "<buffer>") -> List[bytes]:
    """The payloads of a TFRecord buffer, every checksum checked."""
    pos, n = 0, len(data)
    header_starts, header_crcs, data_starts, lengths, data_crcs = [], [], [], [], []
    while pos < n:
        if n - pos < 12:
            raise DataLoss(f"truncated length header in {path}")
        (length,) = struct.unpack_from("<Q", data, pos)
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        if n - pos - 12 < length + 4:
            raise DataLoss(f"truncated record in {path}")
        header_starts.append(pos)
        header_crcs.append(len_crc)
        data_starts.append(pos + 12)
        lengths.append(length)
        (data_crc,) = struct.unpack_from("<I", data, pos + 12 + length)
        data_crcs.append(data_crc)
        pos += 16 + length
    _check_crcs(data, header_starts, [8] * len(lengths), header_crcs, "length", path)
    _check_crcs(data, data_starts, lengths, data_crcs, "data", path)
    return [data[s:s + length] for s, length in zip(data_starts, lengths)]


def read_records(path: str) -> List[bytes]:
    """Every record of a ``.tfrecord`` file, plain or GZIP."""
    with open(path, "rb") as fid:
        raw = fid.read()
    try:
        return split_frames(raw, path)
    except DataLoss as plain_error:
        try:
            unzipped = gzip.decompress(raw)
        except (OSError, EOFError) as exc:
            raise IOError(f"could not read tfrecord {path} (tried raw: {plain_error}; "
                          f"GZIP: {exc})") from exc
        return split_frames(unzipped, path)


def _parse_feature(buf: bytes) -> Tuple[str, object]:
    """``Feature`` -> (kind, values): bytes as a list, floats as float32 and
    int64s as int64 arrays."""
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            return "bytes_list", [v for f, _, v in _iter_fields(val) if f == 1]
        if fnum == 2:
            chunks = []
            for f, _, v in _iter_fields(val):
                if f == 1:  # packed (LEN) or one fixed32 value
                    chunks.append(np.frombuffer(v, dtype="<f4"))
            return "float_list", (np.concatenate(chunks) if chunks
                                  else np.zeros((0,), np.float32)).astype(np.float32)
        if fnum == 3:
            values = []
            for f, wtype, v in _iter_fields(val):
                if f != 1:
                    continue
                if wtype == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        item, pos = _read_varint(v, pos)
                        values.append(signed_int64(item))
                else:
                    values.append(signed_int64(v))
            return "int64_list", np.asarray(values, dtype=np.int64)
    return "empty", []


def parse_example(buf: bytes) -> Dict[str, Tuple[str, object]]:
    """A serialized ``tf.train.Example`` -> {name: (kind, values)}."""
    features: Dict[str, Tuple[str, object]] = {}
    for fnum, _, val in _iter_fields(buf):
        if fnum != 1:
            continue
        for entry_num, _, entry in _iter_fields(val):
            if entry_num != 1:
                continue
            name, feature = "", b""
            for f, _, v in _iter_fields(entry):
                if f == 1:
                    name = v.decode("utf-8")
                elif f == 2:
                    feature = v
            features[name] = _parse_feature(feature)
    return features


def _values(example, name: str, kind: str):
    got_kind, values = example.get(name, (kind, []))
    if got_kind not in (kind, "empty"):
        raise DataLoss(f"feature {name!r} is a {got_kind}, expected a {kind}")
    return values


def read_metadata(record_dir: str) -> Dict[str, np.ndarray]:
    shapes = {}
    for record in read_records(os.path.join(record_dir, "metadata.tfrecord")):
        example = parse_example(record)
        for split, key in (("training", "training_data_shape"),
                           ("test", "testing_data_shape"),
                           ("validation", "validation_data_shape")):
            shapes[split] = np.array(_values(example, key, "int64_list"))
    return shapes


def read_split(record_dir: str, split: str, shape: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (patches [N, k, k, C] float32, labels [N] int32)."""
    patches, labels = [], []
    element_shape = tuple(int(v) for v in shape[1:])
    for record in read_records(os.path.join(record_dir, SPLIT_FILES[split])):
        example = parse_example(record)
        labels.append(int(_values(example, "label", "int64_list")[0]))
        patches.append(np.asarray(_values(example, "image", "float_list"),
                                  dtype=np.float32).reshape(element_shape))
    if not patches:
        return (np.zeros((0, *element_shape), np.float32), np.zeros((0,), np.int32))
    return np.stack(patches), np.asarray(labels, dtype=np.int32)


def read_reference_tfrecords(record_dir: str):
    """-> dict split -> (patches, labels) for all three splits."""
    shapes = read_metadata(record_dir)
    return {split: read_split(record_dir, split, shapes[split])
            for split in ("training", "test", "validation")}
