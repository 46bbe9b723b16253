"""Reads the orbax checkpoints the JAX package writes, into numpy, and
writes them.

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

:func:`write_orbax` writes either layout as orbax 0.11 writes it for a
process of one device: each leaf one zarr v2 array of one chunk (zstd frames
of raw blocks, :func:`~.zstd.encode`) in one OCDBT store
(:class:`~.ocdbt.OcdbtWriter`), the item's ``_METADATA`` and
``array_metadatas/process_0``, and ``_CHECKPOINT_METADATA``. A leaf's type
says what JAX held: a ``torch.Tensor`` is written as a ``jax.Array`` (with
its write shape), what a trainer's device state saves; a numpy array as an
``np.ndarray``, what a state fetched to the host (``jax.device_get``)
saves. ``None`` and an empty dict are written as orbax writes them. The
checkpoint is built in a temporary sibling directory
(``<name>.orbax-checkpoint-tmp-<ns>``, as orbax names it) and renamed into
place, so a write that dies leaves no directory a reader takes for a
checkpoint; the next write into the same directory removes what such a
write left (one writer to a directory, as orbax's manager assumes). bfloat16 is refused by name, as the reader refuses it.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hypelcnn_tpu_torch.compat import FormatNotRead, zstd
from hypelcnn_tpu_torch.compat.ocdbt import OcdbtStore, OcdbtWriter

CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ITEM_METADATA = "_METADATA"
ARRAY_METADATA = os.path.join("array_metadatas", "process_0")
TMP_MARK = ".orbax-checkpoint-tmp-"  # a checkpoint being written: <name><TMP_MARK><ns>
_SEQUENCE_KEY = 1  # orbax's key_type of a list or tuple index
_DICT_KEY = 2  # orbax's key_type of a dict key or a dataclass field
STANDARD_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                    "StandardCheckpointHandler")
ZARR_COMPRESSOR = {"id": "zstd", "level": 1}  # the spec orbax writes (this writer stores raw)
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


# ------------------------------------------------------------------ writer ----

_EMPTY_TYPES = ((type(None), "None"), (dict, "Dict"))  # a GAN's absent pool, no batch norm


def _flatten(node, keys=()) -> List[Tuple[tuple, Any]]:
    """``(key path, leaf)`` in order: dicts in their own order (the caller
    orders them as JAX flattens the tree), sequences by index; a path part
    is ``(key, key_type)``. An empty dict or None is a leaf."""
    if isinstance(node, dict) and node:
        return [pair for key, value in node.items()
                for pair in _flatten(value, keys + ((str(key), _DICT_KEY),))]
    if isinstance(node, (list, tuple)) and node:
        return [pair for index, value in enumerate(node)
                for pair in _flatten(value, keys + ((str(index), _SEQUENCE_KEY),))]
    return [(keys, node)]


def _host_array(leaf, where: str) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise FormatNotRead(f"{where}: dtype bfloat16 is not written")
        leaf = leaf.detach().cpu().numpy()
    array = np.asarray(leaf)
    if array.dtype.kind not in "biuf":
        raise FormatNotRead(f"{where}: dtype {array.dtype} is not written")
    return np.require(array, array.dtype.newbyteorder("<"), "C")  # keeps a scalar 0-d


def _write_item(item: str, tree) -> None:
    """The item directory ``item``: its OCDBT store of zarr arrays, ``_METADATA``
    and, when it holds a ``jax.Array``, ``array_metadatas/process_0``."""
    tree_metadata, array_metadatas = {}, []
    with OcdbtWriter(item) as store:
        for keys, leaf in _flatten(tree):
            name = ".".join(key for key, _ in keys)
            entry = {"key_metadata": [{"key": key, "key_type": kind} for key, kind in keys]}
            tree_metadata[str(tuple(key for key, _ in keys))] = entry
            empty = next((kind for cls, kind in _EMPTY_TYPES if isinstance(leaf, cls)), None)
            if empty is not None:
                entry["value_metadata"] = {"value_type": empty, "skip_deserialize": True}
                continue
            array = _host_array(leaf, f"{item}: leaf {name}")
            shape = list(array.shape)
            if isinstance(leaf, torch.Tensor):
                entry["value_metadata"] = {"value_type": "jax.Array", "skip_deserialize": False,
                                           "write_shape": shape}
                array_metadatas.append({"array_metadata": {
                    "param_name": name, "write_shape": shape, "chunk_shape": shape,
                    "ext_metadata": None}})
            else:
                entry["value_metadata"] = {"value_type": "np.ndarray", "skip_deserialize": False}
            spec = {"chunks": shape, "compressor": ZARR_COMPRESSOR, "dimension_separator": ".",
                    "dtype": array.dtype.str, "fill_value": None, "filters": None,
                    "order": "C", "shape": shape, "zarr_format": 2}
            store.put(f"{name}/.zarray", json.dumps(spec, separators=(",", ":"),
                                                    sort_keys=True).encode())
            chunk = ".".join("0" for _ in shape) or "0"
            store.put(f"{name}/{chunk}", zstd.encode(memoryview(array).cast("B")))
    with open(os.path.join(item, ITEM_METADATA), "w") as f:
        json.dump({"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    if array_metadatas:
        os.makedirs(os.path.dirname(os.path.join(item, ARRAY_METADATA)))
        with open(os.path.join(item, ARRAY_METADATA), "w") as f:
            json.dump({"array_metadatas": array_metadatas}, f)


def write_orbax(path: str, tree, item: Optional[str] = None, replace: bool = False) -> str:
    """Write ``tree`` (nested dicts and sequences of arrays) as the orbax
    checkpoint directory ``path``: a checkpoint manager's step whose one item
    is ``item`` (``"default"``), or, when ``item`` is None, a
    ``StandardCheckpointer`` directory. An existing ``path`` raises
    ``FileExistsError``, or with ``replace`` is replaced once the new one
    is whole. Returns ``path``."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not replace:
        raise FileExistsError(f"{path} exists; a checkpoint is written once")
    parent = os.path.dirname(path)
    if os.path.isdir(parent):
        for name in os.listdir(parent):
            if TMP_MARK in name:  # left by a write that died
                shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
    started = time.time_ns()
    tmp = f"{path}{TMP_MARK}{started}"
    os.makedirs(tmp)
    try:
        _write_item(tmp if item is None else os.path.join(tmp, item), tree)
        metadata = {"item_handlers": STANDARD_HANDLER if item is None
                    else {item: STANDARD_HANDLER},
                    "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": started,
                    "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
            json.dump(metadata, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path
