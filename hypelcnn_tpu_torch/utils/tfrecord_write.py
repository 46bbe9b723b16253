"""The write side of the reference's ``.tfrecord`` dataset format, with no
TensorFlow (``hypelcnn_tpu/utils/tfrecord_write.py``).

The reference prepares a dataset as four files: training, test and
validation ``.tfrecord`` of ``tf.train.Example`` records (an int64 ``label``
and a packed float ``image``), plus an uncompressed ``metadata.tfrecord``
holding the three splits' shapes, with an optional GZIP variant of the
splits (one gzip stream a file, as ``TFRecordOptions(GZIP)`` writes).
``utils/tfrecord_compat.py`` reads them back, and so does TF's own
``TFRecordImporter``.

Wire layout (tensorflow/core/example/feature.proto, proto3):

- ``Example``  { ``Features features = 1`` }
- ``Features`` { ``map<string, Feature> feature = 1`` }: each map entry is
  a length-delimited submessage: key (field 1, string), value (field 2).
- ``Feature``  oneof: ``bytes_list=1`` | ``float_list=2`` | ``int64_list=3``
- ``FloatList.value = 1 [packed]`` (LE float32), ``Int64List.value = 1
  [packed]`` (varint): packed, as TF serializes them.

Framing (tensorflow/core/lib/io/record_writer.cc): ``uint64 length |
uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)``. The
checksums of records of one length are computed together
(``tb_events.masked_crc32c_many``); the bytes are those of one at a time.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, Iterable, Sequence

import numpy as np

from hypelcnn_tpu_torch.utils.tb_events import masked_crc32c_many

# ------------------------------------------------------ protobuf encoders ----


def _varint(value: int) -> bytes:
    """Unsigned LEB128.  Negative int64s ride as 10-byte two's complement
    (proto scalar varint rule); labels/shapes here are non-negative."""
    if value < 0:
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field_number: int, wire_type: int) -> bytes:
    return _varint((field_number << 3) | wire_type)


def _len_delimited(field_number: int, payload: bytes) -> bytes:
    return _tag(field_number, 2) + _varint(len(payload)) + payload


def encode_int64_list_feature(values: Sequence[int]) -> bytes:
    """``Feature{int64_list: Int64List{value: [..] packed}}``."""
    packed = b"".join(_varint(int(v)) for v in values)
    int64_list = _len_delimited(1, packed) if values else b""
    return _len_delimited(3, int64_list)


def encode_float_list_feature(values) -> bytes:
    """``Feature{float_list: FloatList{value: [..] packed LE f32}}``."""
    arr = np.ascontiguousarray(np.asarray(values, dtype="<f4").reshape(-1))
    packed = arr.tobytes()
    float_list = _len_delimited(1, packed) if arr.size else b""
    return _len_delimited(2, float_list)


def encode_bytes_list_feature(values: Iterable[bytes]) -> bytes:
    bytes_list = b"".join(_len_delimited(1, v) for v in values)
    return _len_delimited(1, bytes_list)


def encode_example(features: Dict[str, bytes]) -> bytes:
    """``Example{features: Features{feature: {name: <encoded Feature>}}}``.

    ``features`` maps name -> an already-encoded Feature message (from the
    ``encode_*_feature`` helpers).  Map entries are emitted in insertion
    order; proto map semantics make the order irrelevant to any parser.
    """
    entries = b"".join(
        _len_delimited(1, _len_delimited(1, name.encode("utf-8")) +
                       _len_delimited(2, feature))
        for name, feature in features.items())
    return _len_delimited(1, entries)


# ------------------------------------------------------- TFRecord framing ----


def frame_records(records: Iterable[bytes]) -> bytes:
    """The TFRecord framing of ``records``, as one buffer."""
    records = list(records)
    headers = [struct.pack("<Q", len(data)) for data in records]
    header_crcs = masked_crc32c_many(headers)
    data_crcs = masked_crc32c_many(records)
    return b"".join(header + struct.pack("<I", hcrc) + data + struct.pack("<I", dcrc)
                    for header, hcrc, data, dcrc in zip(headers, header_crcs, records,
                                                        data_crcs))


def write_tfrecord(path: str, records: Iterable[bytes],
                   gzip_compress: bool = False) -> None:
    """Write framed records; GZIP is one gzip stream over the file, as
    ``TFRecordOptions(GZIP)`` writes it."""
    opener = gzip.open if gzip_compress else open
    with opener(path, "wb") as f:
        f.write(frame_records(records))


# ------------------------------------------------- reference dataset files ----


def example_for_patch(patch, label: int) -> bytes:
    """One split record: the reference's two-feature Example."""
    return encode_example({
        "label": encode_int64_list_feature([int(label)]),
        "image": encode_float_list_feature(patch),
    })


def metadata_example(training_shape: Sequence[int], testing_shape: Sequence[int],
                     validation_shape: Sequence[int]) -> bytes:
    """The metadata record's three shape features."""
    return encode_example({
        "training_data_shape": encode_int64_list_feature(list(training_shape)),
        "testing_data_shape": encode_int64_list_feature(list(testing_shape)),
        "validation_data_shape": encode_int64_list_feature(list(validation_shape)),
    })


def write_reference_dataset(output_dir: str, splits, compressed: bool = False,
                            log_every: int = 1000) -> None:
    """Emit the reference's four-file set into ``output_dir``.

    ``splits``: dict with keys training/test/validation ->
    (patches [N,k,k,C] float32, labels [N]). ``metadata.tfrecord`` is
    always uncompressed: the reference writes it with a plain writer even
    under ``--compressed``.
    """
    names = {"training": "training.tfrecord", "test": "test.tfrecord",
             "validation": "validation.tfrecord"}
    os.makedirs(output_dir, exist_ok=True)
    write_tfrecord(
        os.path.join(output_dir, "metadata.tfrecord"),
        [metadata_example(np.shape(splits["training"][0]),
                          np.shape(splits["test"][0]),
                          np.shape(splits["validation"][0]))])
    for split, fname in names.items():
        patches, labels = splits[split]

        def records(patches=patches, labels=labels, split=split):
            n = len(patches)
            for i in range(n):
                if log_every and not i % log_every:
                    print(f"{split}: {i}/{n}")
                yield example_for_patch(patches[i], labels[i])

        write_tfrecord(os.path.join(output_dir, fname), records(),
                       gzip_compress=compressed)
