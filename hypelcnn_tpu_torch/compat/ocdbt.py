"""A read-only OCDBT key-value store over a directory (tensorstore's
"optionally cooperative distributed B+tree", the store under every orbax
checkpoint).

The files it reads, each framed as ``magic (uint32 big-endian) | length
(uint64) | version (varint, 0) | compression (varint: 0 none, 1 zstd) |
body | crc32c (uint32)`` with the checksum over everything before it:

- ``manifest.ocdbt`` (magic ``0x0cdb3a2a``): the database's configuration
  and, for the single-file manifest orbax writes, the newest versions of
  the tree, each with its root node's location and height;
- b-tree nodes (magic ``0x0cdb20de``), stored in data files under ``d/`` at
  an offset and a length: a leaf holds its keys (prefix-compressed) and
  their values, each inline or indirect (a data file, an offset and a
  length); an interior node holds the first key of each child, the key
  prefix its whole subtree shares (which the child's own keys leave out)
  and the child's location.

Every location names its data file through the node's file table as a base
path and a relative path. The base paths are transitive: a table read from
a file whose base path is ``B`` prefixes ``B`` to its own, which is how the
top-level database orbax merges from its processes' databases
(``ocdbt.process_N/``) reaches their files. :class:`OcdbtStore` reads the
newest version of the tree.

:class:`OcdbtWriter` writes a new database of one version: the values and
then a single leaf node in one data file under ``d/``, each value up to
``max_inline_value_bytes`` inline in the leaf and each larger one indirect,
then the manifest. The node and the manifest are stored uncompressed; the
manifest's configuration is the one orbax writes (values inline up to 1 KiB,
nodes up to 100 MB decoded, version-tree arity 16, zstd for new nodes), so a
store it writes is one orbax would have written a merged database as.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

from hypelcnn_tpu_torch.compat import FormatNotRead, zstd
from hypelcnn_tpu_torch.utils.tb_events import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
# the configuration orbax gives its stores
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
ZSTD_COMPRESSION, ZSTD_LEVEL = 1, 0


class OcdbtError(ValueError):
    """A file of the store that is missing or corrupt (one of a kind not
    read raises :class:`~hypelcnn_tpu_torch.compat.FormatNotRead`)."""


class _Reader:
    """Cursor over a decoded body."""

    __slots__ = ("data", "offset", "where")

    def __init__(self, data: bytes, where: str):
        self.data, self.offset, self.where = data, 0, where

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if self.offset >= len(self.data):
                raise OcdbtError(f"{self.where}: truncated varint")
            byte = self.data[self.offset]
            self.offset += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.where}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.offset + n > len(self.data):
            raise OcdbtError(f"{self.where}: truncated")
        chunk = self.data[self.offset:self.offset + n]
        self.offset += n
        return chunk

    def byte(self) -> int:
        return self.raw(1)[0]


def _unframe(data: bytes, magic: int, where: str) -> bytes:
    """The body of one framed file or node, its checksum checked."""
    if len(data) < 18:
        raise OcdbtError(f"{where}: {len(data)} bytes, too short")
    (found,) = struct.unpack_from(">I", data, 0)
    if found != magic:
        raise OcdbtError(f"{where}: magic {found:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack_from("<Q", data, 4)
    if length != len(data):
        raise OcdbtError(f"{where}: its header says {length} bytes, it holds {len(data)}")
    (stored,) = struct.unpack_from("<I", data, len(data) - 4)
    if crc32c(data[:-4]) != stored:
        raise OcdbtError(f"{where}: crc32c mismatch")
    header = _Reader(data[:-4], where)
    header.offset = 12
    version, compression = header.varint(), header.varint()
    if version != 0:
        raise FormatNotRead(f"{where}: OCDBT format version {version} is not read")
    body = data[header.offset:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise FormatNotRead(f"{where}: OCDBT compression {compression} is not read")


DataFile = Tuple[str, str]  # (transitive base path, relative path)


def _file_table(reader: _Reader, base: str) -> List[DataFile]:
    """A data file table; ``base`` is the base path of the file it was read from."""
    count = reader.varint()
    prefix = [0] + reader.varints(count - 1) if count else []
    suffix = reader.varints(count)
    base_length = reader.varints(count)
    files: List[DataFile] = []
    previous = b""
    for i in range(count):
        path = previous[:prefix[i]] + reader.raw(suffix[i])
        previous = path
        text = path.decode()
        files.append((base + text[:base_length[i]], text[base_length[i]:]))
    return files


class OcdbtStore:
    """The newest version of the OCDBT database in directory ``root``:
    :meth:`list` its keys and :meth:`read` a value."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, MANIFEST_FILE)
        if not os.path.isfile(path):
            raise OcdbtError(f"{path}: no OCDBT manifest")
        with open(path, "rb") as f:
            body = _Reader(_unframe(f.read(), MANIFEST_MAGIC, path), path)
        body.raw(16)  # the database's uuid
        manifest_kind = body.varint()
        body.varints(2)  # max_inline_value_bytes, max_decoded_node_bytes
        body.byte()  # version_tree_arity_log2
        if body.varint() == 1:
            body.raw(4)  # the zstd level the writer used
        if manifest_kind != 0:
            raise FormatNotRead(f"{path}: OCDBT manifest kind {manifest_kind} (numbered) "
                                "is not read")
        files = _file_table(body, "")
        count = body.varint()
        generation = body.varints(count)
        height = [body.byte() for _ in range(count)]
        file_id, offset, length = body.varints(count), body.varints(count), body.varints(count)
        body.varints(3 * count)  # each version's key, tree-byte and indirect-byte counts
        # older versions, in version-tree nodes, are not needed for the newest
        self._root: Optional[Tuple[int, DataFile, int, int]] = None
        if count:
            newest = max(range(count), key=generation.__getitem__)
            self._root = (height[newest], files[file_id[newest]], offset[newest],
                          length[newest])
        self._blobs: Dict[str, bytes] = {}
        self._entries: Optional[Dict[bytes, tuple]] = None

    # ---- data files ----

    def _bytes(self, data_file: DataFile, offset: int, length: int) -> bytes:
        path = os.path.join(self.root, data_file[0] + data_file[1])
        blob = self._blobs.get(path)
        if blob is None:
            if not os.path.isfile(path):
                raise OcdbtError(f"{path}: data file missing")
            with open(path, "rb") as f:
                blob = self._blobs[path] = f.read()
        if offset + length > len(blob):
            raise OcdbtError(f"{path}: [{offset}, {offset + length}) past its "
                             f"{len(blob)} bytes")
        return blob[offset:offset + length]

    # ---- b-tree ----

    def _node(self, data_file: DataFile, offset: int, length: int, height: int,
              prefix: bytes) -> Iterator[Tuple[bytes, tuple]]:
        where = f"{data_file[0]}{data_file[1]}@{offset}"
        reader = _Reader(_unframe(self._bytes(data_file, offset, length), NODE_MAGIC, where),
                         where)
        if reader.byte() != height:
            raise OcdbtError(f"{where}: node height differs from its parent's record")
        files = _file_table(reader, data_file[0])
        count = reader.varint()
        key_prefix = [0] + reader.varints(count - 1) if count else []
        key_suffix = reader.varints(count)
        if height:
            subtree_prefix = reader.varints(count)
        keys: List[bytes] = []
        previous = b""
        for i in range(count):
            key = previous[:key_prefix[i]] + reader.raw(key_suffix[i])
            keys.append(key)
            previous = key
        if height:
            ids, offsets, lengths = reader.varints(count), reader.varints(count), \
                reader.varints(count)
            reader.varints(3 * count)  # each subtree's key, tree-byte and indirect-byte counts
            for i in range(count):
                yield from self._node(files[ids[i]], offsets[i], lengths[i], height - 1,
                                      prefix + keys[i][:subtree_prefix[i]])
            return
        value_length = reader.varints(count)
        kind = reader.varints(count)
        indirect = [i for i in range(count) if kind[i] == 1]
        if any(k not in (0, 1) for k in kind):
            raise FormatNotRead(f"{where}: OCDBT value kind {kind} is not read")
        ids, offsets = reader.varints(len(indirect)), reader.varints(len(indirect))
        where_indirect = dict(zip(indirect, zip(ids, offsets)))
        for i in range(count):
            if i in where_indirect:
                file_index, value_offset = where_indirect[i]
                value = ("indirect", files[file_index], value_offset, value_length[i])
            else:
                value = ("inline", reader.raw(value_length[i]))
            yield prefix + keys[i], value
        if reader.offset != len(reader.data):
            raise OcdbtError(f"{where}: bytes after the leaf's values")

    def _index(self) -> Dict[bytes, tuple]:
        if self._entries is None:
            self._entries = {}
            if self._root is not None:
                height, data_file, offset, length = self._root
                self._entries = dict(self._node(data_file, offset, length, height, b""))
        return self._entries

    def list(self) -> List[bytes]:
        """Every key, in order."""
        return sorted(self._index())

    def read(self, key) -> Optional[bytes]:
        """The value of ``key`` (``str`` or ``bytes``), or None when it is absent."""
        if isinstance(key, str):
            key = key.encode()
        value = self._index().get(key)
        if value is None:
            return None
        if value[0] == "inline":
            return value[1]
        _, data_file, offset, length = value
        return self._bytes(data_file, offset, length)


# ------------------------------------------------------------------ writer ----

def _varint(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _framed(magic: int, body: bytes) -> bytes:
    """``body`` framed as a file or node, uncompressed, with its checksum."""
    head = struct.pack(">I", magic)
    tail = _varint(0) + _varint(0) + body  # format version 0, compression 0
    length = len(head) + 8 + len(tail) + 4
    data = head + struct.pack("<Q", length) + tail
    return data + struct.pack("<I", crc32c(data))


def _one_file_table(relative_path: str) -> bytes:
    """The data file table of one file under the database root."""
    path = relative_path.encode()
    return _varint(1) + _varint(len(path)) + _varint(0) + path


class OcdbtWriter:
    """A new OCDBT database in directory ``root`` (which must not exist):
    :meth:`put` each key's value (indirect values go to the data file at
    once), then :meth:`close` writes the leaf node and the manifest. A writer
    left by an exception writes no manifest, so no store is there to read."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(os.path.join(self.root, "d"))
        self._data_path = "d/" + os.urandom(16).hex()
        self._file = open(os.path.join(self.root, self._data_path), "wb")
        self._offset = 0
        self._entries: Dict[bytes, tuple] = {}

    def put(self, key, value) -> None:
        """Store ``value`` (bytes-like) under ``key`` (``str`` or ``bytes``)."""
        if isinstance(key, str):
            key = key.encode()
        if key in self._entries:
            raise OcdbtError(f"{self.root}: key {key!r} written twice")
        size = memoryview(value).nbytes
        if size <= MAX_INLINE_VALUE_BYTES:
            self._entries[key] = ("inline", bytes(value))
            return
        self._file.write(value)
        self._entries[key] = ("indirect", self._offset, size)
        self._offset += size

    def _leaf(self) -> Tuple[bytes, int]:
        """The leaf node of every key, and the bytes of its indirect values."""
        keys = sorted(self._entries)
        prefixes, previous = [], b""
        for key in keys:
            common = 0
            for a, b in zip(previous, key):
                if a != b:
                    break
                common += 1
            prefixes.append(common)
            previous = key
        values = [self._entries[key] for key in keys]
        indirect = [v for v in values if v[0] == "indirect"]
        body = b"".join([
            bytes([0]),  # height: a leaf
            _one_file_table(self._data_path),
            _varint(len(keys)), _varints(prefixes[1:]),
            _varints(len(k) - p for k, p in zip(keys, prefixes)),
            b"".join(k[p:] for k, p in zip(keys, prefixes)),
            _varints(len(v[1]) if v[0] == "inline" else v[2] for v in values),
            _varints(0 if v[0] == "inline" else 1 for v in values),
            _varints(0 for _ in indirect), _varints(v[1] for v in indirect),
            b"".join(v[1] for v in values if v[0] == "inline")])
        return _framed(NODE_MAGIC, body), sum(v[2] for v in indirect)

    def close(self) -> None:
        """Write the leaf node after the values, then the manifest."""
        node, indirect_bytes = self._leaf()
        node_offset = self._offset
        self._file.write(node)
        self._file.close()
        config = b"".join([
            os.urandom(16),  # the database's uuid
            _varint(0),  # a single-file manifest
            _varint(MAX_INLINE_VALUE_BYTES), _varint(MAX_DECODED_NODE_BYTES),
            bytes([VERSION_TREE_ARITY_LOG2]),
            _varint(ZSTD_COMPRESSION), struct.pack("<i", ZSTD_LEVEL)])
        version = b"".join([
            _varint(1),  # one version, generation 1, its root the leaf (height 0)
            _varint(1), bytes([0]),
            _varint(0), _varint(node_offset), _varint(len(node)),
            _varints([len(self._entries), len(node), indirect_bytes]),
            struct.pack("<Q", time.time_ns()),  # its commit time
            _varint(0)])  # no version-tree nodes
        manifest = _framed(MANIFEST_MAGIC,
                           config + _one_file_table(self._data_path) + version)
        with open(os.path.join(self.root, MANIFEST_FILE), "wb") as f:
            f.write(manifest)

    def __enter__(self) -> "OcdbtWriter":
        return self

    def __exit__(self, kind, value, traceback) -> None:
        if kind is None:
            self.close()
        else:
            self._file.close()
