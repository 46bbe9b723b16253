"""Reads the orbax checkpoints the JAX package writes, into numpy.

Two layouts, both orbax ``StandardSave`` items:

- a checkpoint manager's step directory (``<log_dir>/checkpoints/<step>/``,
  the JAX package's ``save_checkpoint``), whose one item is ``default/``;
- a ``StandardCheckpointer`` directory (``save_params_pytree``: a GAN's
  ``gan_params`` or ``ckpt_params_N``), which is the item itself.

Each holds ``_CHECKPOINT_METADATA``. The item's ``_METADATA`` lists every
leaf by its key path (dict keys and sequence indices) and says that the
arrays live in an OCDBT store (:mod:`hypelcnn_tpu_torch.compat.ocdbt`) as
zarr v2 arrays. A leaf is stored under the key ``<path joined by '.'>``:
its ``.zarray`` (shape, chunks, dtype, fill value, compressor) and one value
per chunk (``<i>.<j>...``), each compressed with zstd (:mod:`~.zstd`) or
stored raw. The chunks are assembled in C order; a missing chunk holds the
fill value (zero when it is null).

An item without OCDBT, zarr v3, Fortran order, a compressor other than
zstd or none, zarr filters, and a dtype numpy does not name (bfloat16
among them) are refused by name, with the file, as
:class:`~hypelcnn_tpu_torch.compat.FormatNotRead`.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Any, Dict

import numpy as np

from hypelcnn_tpu_torch.compat import FormatNotRead, zstd
from hypelcnn_tpu_torch.compat.ocdbt import OcdbtStore

CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ITEM_METADATA = "_METADATA"
_SEQUENCE_KEY = 1  # orbax's key_type of a list or tuple index
_PORT_FILES = ("state.pt", "params.pt")


def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is an orbax checkpoint directory: it holds
    ``_CHECKPOINT_METADATA`` and none of the port's own files."""
    return (os.path.isfile(os.path.join(path, CHECKPOINT_METADATA))
            and not any(os.path.exists(os.path.join(path, name)) for name in _PORT_FILES))


def _item_dir(path: str) -> str:
    if not os.path.isfile(os.path.join(path, CHECKPOINT_METADATA)):
        raise FormatNotRead(f"{path}: no {CHECKPOINT_METADATA}, not an orbax checkpoint")
    for candidate in (path, os.path.join(path, "default")):
        if os.path.isfile(os.path.join(candidate, ITEM_METADATA)):
            return candidate
    raise FormatNotRead(f"{path}: no {ITEM_METADATA} in it or in its default/ item")


def _read_array(store, key: str, where: str) -> np.ndarray:
    """The zarr v2 array stored under ``key``."""
    raw = store.read(f"{key}/.zarray")
    if raw is None:
        raise FormatNotRead(f"{where}: no {key}/.zarray")
    spec = json.loads(raw)
    where = f"{where}:{key}/.zarray"
    if spec.get("zarr_format") != 2:
        raise FormatNotRead(f"{where}: zarr_format {spec.get('zarr_format')} is not read")
    try:
        dtype = np.dtype(spec["dtype"])
    except TypeError as exc:
        raise FormatNotRead(f"{where}: dtype {spec['dtype']!r} is not read") from exc
    if dtype.kind not in "biufc":
        raise FormatNotRead(f"{where}: dtype {spec['dtype']!r} is not read")
    if spec.get("filters"):
        raise FormatNotRead(f"{where}: zarr filters {spec['filters']} are not read")
    compressor = spec.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise FormatNotRead(f"{where}: compressor {compressor.get('id')!r} is not read "
                               "(zstd or none)")
    if spec.get("order", "C") != "C":
        raise FormatNotRead(f"{where}: order {spec['order']!r} is not read (C only)")
    shape = tuple(spec["shape"])
    chunks = tuple(spec["chunks"])
    separator = spec.get("dimension_separator", ".")
    fill = spec.get("fill_value")  # zarr writes NaN and the infinities as strings
    out = np.full(shape, 0 if fill is None else float(fill) if isinstance(fill, str) else fill,
                  dtype=dtype)
    if not shape:  # a scalar is one chunk named "0"
        grid, chunks = [(0,)], ()
    else:
        grid = itertools.product(*(range(math.ceil(s / c)) for s, c in zip(shape, chunks)))
    for index in grid:
        value = store.read(f"{key}/{separator.join(str(i) for i in index)}")
        if value is None:
            continue
        if compressor is not None:
            value = zstd.decompress(value)
        size = math.prod(chunks) * dtype.itemsize
        if len(value) != size:
            raise FormatNotRead(f"{where}: chunk {index} holds {len(value)} bytes, "
                                   f"expected {size}")
        chunk = np.frombuffer(value, dtype=dtype).reshape(chunks)
        if not shape:
            out[()] = chunk
            continue
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def _insert(tree: dict, keys, value) -> None:
    node = tree
    for key in keys[:-1]:
        node = node.setdefault(key, {})
    node[keys[-1]] = value


def _as_sequences(node, sequences: set, path=()):
    """Dicts whose keys were sequence indices become lists."""
    if not isinstance(node, dict):
        return node
    items = {k: _as_sequences(v, sequences, path + (k,)) for k, v in node.items()}
    if path in sequences:
        return [items[i] for i in sorted(items)]
    return items


_EMPTY = {"Dict": dict, "List": list, "Tuple": list, "None": lambda: None}


def tree_bytes(tree) -> int:
    """The bytes of the arrays in a tree :func:`read_orbax` returned."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return 0 if tree is None else int(tree.nbytes)


def read_orbax(path: str) -> Dict[str, Any]:
    """The tree of an orbax checkpoint directory: nested dicts (lists for
    sequences) of numpy arrays, as JAX's restore gives its leaves."""
    item = _item_dir(path)
    meta_path = os.path.join(item, ITEM_METADATA)
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise FormatNotRead(f"{meta_path}: use_zarr3 is true; zarr v3 arrays are not read")
    if not meta.get("use_ocdbt", True):
        raise FormatNotRead(f"{meta_path}: use_ocdbt is false; only OCDBT items are read")
    store = OcdbtStore(item)
    tree: dict = {}
    sequences = set()
    for name, entry in meta["tree_metadata"].items():
        keys = []
        for part in entry["key_metadata"]:
            if part["key_type"] == _SEQUENCE_KEY:
                sequences.add(tuple(keys))
                keys.append(int(part["key"]))
            else:
                keys.append(part["key"])
        keys = tuple(keys)
        value_meta = entry["value_metadata"]
        if value_meta.get("skip_deserialize"):
            kind = value_meta.get("value_type")
            if kind not in _EMPTY:
                raise FormatNotRead(f"{meta_path}: leaf {name} of type {kind!r} is not read")
            _insert(tree, keys, _EMPTY[kind]())
            continue
        _insert(tree, keys, _read_array(store, ".".join(str(k) for k in keys), item))
    return _as_sequences(tree, sequences)
