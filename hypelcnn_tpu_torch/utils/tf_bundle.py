"""Read a TensorFlow V2 checkpoint (``model.ckpt-N``) with numpy and the stdlib.

This takes the place of ``tf.train.load_checkpoint`` for the port. A
checkpoint prefix ``P`` names two kinds of file:

- ``P.index``: an SSTable (LevelDB's table format, as
  ``tensorflow/core/lib/io/table.cc`` writes it). The last 48 bytes are the
  footer: the metaindex and index blocks' handles (two varints each, offset
  and size), zero padding, and the magic ``0xdb4775248b80fb57``. Each block
  is followed by a 5-byte trailer: its compression type and the masked
  crc32c of the block and that byte. Type 0 is uncompressed; any other is
  refused by name. A block holds prefix-compressed entries (shared key
  length, unshared length, value length, key suffix, value), then its
  restart offsets, where the shared length is 0, then their count. The index
  block maps the last key of each data block to that block's handle. The
  data blocks map tensor names to ``BundleEntryProto`` (dtype, shape,
  shard_id, offset, size, crc32c) and the empty key to the
  ``BundleHeaderProto`` (num_shards, endianness, version).
- ``P.data-0000k-of-0000n``: the tensors' raw little-endian bytes, each at
  its entry's offset and size, checked against its entry's masked crc32c.

A directory stands for the checkpoint its ``checkpoint`` state file names
(``model_checkpoint_path: "..."``, relative to the directory unless
absolute), as ``tf.train.latest_checkpoint`` reads it. A sliced (partitioned)
variable, a big-endian bundle and a dtype other than the numeric ones raise.
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from hypelcnn_tpu_torch.utils.tb_events import (
    _iter_fields,
    _read_varint,
    masked_crc32c,
    signed_int64,
)

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48
BLOCK_TRAILER_SIZE = 5
COMPRESSION_NAMES = {1: "snappy", 2: "zlib"}

# tensorflow/core/framework/types.proto -> numpy, little-endian
DTYPES = {
    1: np.dtype("<f4"),    # DT_FLOAT
    2: np.dtype("<f8"),    # DT_DOUBLE
    3: np.dtype("<i4"),    # DT_INT32
    4: np.dtype("u1"),     # DT_UINT8
    5: np.dtype("<i2"),    # DT_INT16
    6: np.dtype("i1"),     # DT_INT8
    8: np.dtype("<c8"),    # DT_COMPLEX64
    9: np.dtype("<i8"),    # DT_INT64
    10: np.dtype("?"),     # DT_BOOL
    17: np.dtype("<u2"),   # DT_UINT16
    18: np.dtype("<c16"),  # DT_COMPLEX128
    19: np.dtype("<f2"),   # DT_HALF
    22: np.dtype("<u4"),   # DT_UINT32
    23: np.dtype("<u8"),   # DT_UINT64
}
DTYPE_NAMES = {7: "DT_STRING", 14: "DT_BFLOAT16", 20: "DT_RESOURCE", 21: "DT_VARIANT"}


class BundleError(ValueError):
    """A checkpoint this reader cannot read, or one that is corrupt."""


@dataclass
class BundleEntry:
    dtype: int = 0
    shape: Tuple[int, ...] = ()
    shard_id: int = 0
    offset: int = 0
    size: int = 0
    crc32c: int = 0
    sliced: bool = False


@dataclass
class BundleHeader:
    num_shards: int = 1
    endianness: int = 0  # LITTLE


# ---------------------------------------------------------------- the table ----

def _block_handle(buf: bytes, pos: int) -> Tuple[Tuple[int, int], int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return (offset, size), pos


def read_footer(table: bytes) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(metaindex handle, index handle) from the table's 48-byte footer."""
    if len(table) < FOOTER_SIZE:
        raise BundleError(f"index file of {len(table)} bytes has no footer")
    footer = table[-FOOTER_SIZE:]
    (magic,) = struct.unpack("<Q", footer[-8:])
    if magic != TABLE_MAGIC:
        raise BundleError(f"bad table magic {magic:#x}")
    metaindex, pos = _block_handle(footer, 0)
    index, _ = _block_handle(footer, pos)
    return metaindex, index


def read_block(table: bytes, handle: Tuple[int, int]) -> bytes:
    """A block's contents, its trailer's checksum checked; refuses compression."""
    offset, size = handle
    end = offset + size
    if end + BLOCK_TRAILER_SIZE > len(table):
        raise BundleError(f"block at {offset} (+{size}) runs past the index file's end")
    kind = table[end]
    (crc,) = struct.unpack("<I", table[end + 1:end + BLOCK_TRAILER_SIZE])
    if masked_crc32c(table[offset:end + 1]) != crc:
        raise BundleError(f"block at {offset}: checksum mismatch")
    if kind != 0:
        raise BundleError(f"block at {offset} is {COMPRESSION_NAMES.get(kind, f'type {kind}')}"
                          f"-compressed; only uncompressed blocks are read")
    return table[offset:end]


def block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) of every entry of a block, checking that each restart
    offset starts an entry with no shared prefix."""
    if len(block) < 4:
        raise BundleError("block too short for its restart count")
    (num_restarts,) = struct.unpack("<I", block[-4:])
    limit = len(block) - 4 - 4 * num_restarts
    if limit < 0:
        raise BundleError(f"block of {len(block)} bytes cannot hold {num_restarts} restarts")
    restarts = set(struct.unpack(f"<{num_restarts}I", block[limit:-4]))
    pos, key = 0, b""
    starts: List[int] = []
    while pos < limit:
        start = pos
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_length, pos = _read_varint(block, pos)
        if start in restarts and shared:
            raise BundleError(f"restart entry at {start} shares {shared} key bytes")
        if shared > len(key) or pos + non_shared + value_length > limit:
            raise BundleError(f"corrupt entry at {start}")
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + value_length]
        pos += value_length
        starts.append(start)
    if starts and not restarts <= set(starts):
        raise BundleError("a restart offset does not start an entry")


def table_entries(table: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Every (key, value) of an SSTable, in key order."""
    _, index_handle = read_footer(table)
    for _, handle_bytes in block_entries(read_block(table, index_handle)):
        handle, _ = _block_handle(handle_bytes, 0)
        yield from block_entries(read_block(table, handle))


# --------------------------------------------------------------- the protos ----

def parse_shape(buf: bytes) -> Tuple[int, ...]:
    """``TensorShapeProto``: ``dim = 2`` (``size = 1``), ``unknown_rank = 3``."""
    dims = []
    for fnum, _, val in _iter_fields(buf):
        if fnum == 2:
            size = 0
            for dnum, _, dval in _iter_fields(val):
                if dnum == 1:
                    size = signed_int64(dval)
            dims.append(size)
        elif fnum == 3 and val:
            raise BundleError("a tensor of unknown rank")
    return tuple(dims)


def parse_entry(buf: bytes) -> BundleEntry:
    """``BundleEntryProto``: dtype 1, shape 2, shard_id 3, offset 4, size 5,
    crc32c 6 (fixed32), slices 7."""
    entry = BundleEntry()
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            entry.dtype = val
        elif fnum == 2:
            entry.shape = parse_shape(val)
        elif fnum == 3:
            entry.shard_id = val
        elif fnum == 4:
            entry.offset = signed_int64(val)
        elif fnum == 5:
            entry.size = signed_int64(val)
        elif fnum == 6:
            (entry.crc32c,) = struct.unpack("<I", val)
        elif fnum == 7:
            entry.sliced = True
    return entry


def parse_header(buf: bytes) -> BundleHeader:
    """``BundleHeaderProto``: num_shards 1, endianness 2, version 3."""
    header = BundleHeader()
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            header.num_shards = val
        elif fnum == 2:
            header.endianness = val
    return header


# ---------------------------------------------------------------- the bundle ----

def latest_checkpoint(directory: str) -> Optional[str]:
    """The prefix a directory's ``checkpoint`` state file names, or ``None``
    when there is no state file or its prefix has no ``.index``."""
    state = os.path.join(directory, "checkpoint")
    if not os.path.isfile(state):
        return None
    with open(state, "r", encoding="utf-8") as fid:
        match = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"', fid.read(),
                          re.MULTILINE)
    if match is None:
        return None
    prefix = match.group(1).encode("utf-8").decode("unicode_escape")
    if not os.path.isabs(prefix):
        prefix = os.path.join(directory, prefix)
    return prefix if os.path.isfile(prefix + ".index") else None


class BundleReader:
    """The tensors of the checkpoint at ``prefix``."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(prefix + ".index", "rb") as fid:
            table = fid.read()
        self.header = BundleHeader()
        self.entries: Dict[str, BundleEntry] = {}
        for key, value in table_entries(table):
            if key == b"":
                self.header = parse_header(value)
            else:
                self.entries[key.decode("utf-8")] = parse_entry(value)
        if self.header.endianness != 0:
            raise BundleError(f"{prefix}: a big-endian bundle")
        self._shards: Dict[int, bytes] = {}

    def _shard(self, shard_id: int) -> bytes:
        if shard_id not in self._shards:
            path = f"{self.prefix}.data-{shard_id:05d}-of-{self.header.num_shards:05d}"
            with open(path, "rb") as fid:
                self._shards[shard_id] = fid.read()
        return self._shards[shard_id]

    def variable_to_shape_map(self) -> Dict[str, Tuple[int, ...]]:
        return {name: entry.shape for name, entry in self.entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        entry = self.entries[name]
        if entry.sliced:
            raise BundleError(f"{name}: a sliced (partitioned) variable")
        if entry.dtype not in DTYPES:
            raise BundleError(f"{name}: dtype {DTYPE_NAMES.get(entry.dtype, entry.dtype)} "
                              f"is not read")
        dtype = DTYPES[entry.dtype]
        count = int(np.prod(entry.shape, dtype=np.int64))
        if entry.size != count * dtype.itemsize:
            raise BundleError(f"{name}: {entry.size} bytes for {entry.shape} of {dtype}")
        raw = self._shard(entry.shard_id)[entry.offset:entry.offset + entry.size]
        if len(raw) != entry.size:
            raise BundleError(f"{name}: data shard {entry.shard_id} ends early")
        if masked_crc32c(raw) != entry.crc32c:
            raise BundleError(f"{name}: checksum mismatch")
        return np.frombuffer(raw, dtype=dtype).reshape(entry.shape).astype(dtype.newbyteorder("="))


def load_checkpoint(path: str) -> BundleReader:
    """A reader of the checkpoint prefix ``path``, or of the one that the
    directory ``path``'s state file names."""
    if os.path.isdir(path):
        prefix = latest_checkpoint(path)
        if prefix is None:
            raise FileNotFoundError(f"no TF checkpoint under {path}")
        path = prefix
    return BundleReader(path)
