"""The port reads the JAX package's orbax checkpoints, on the CPU.

- ``compat/zstd.py`` equals ``zstandard`` on a corpus with a case for each
  path of the format (raw, RLE and compressed blocks; raw, RLE and Huffman
  literals in 1 and 4 streams, with direct and FSE-coded weights and
  treeless blocks; predefined, RLE, FSE and repeated sequence tables; long
  matches across blocks; frames without a content size, with a checksum,
  concatenated, and a skippable frame); a corrupt checksum and a dictionary
  are refused. The corpus is made from seeds alone, and each case's frame
  headers are read to show that it still takes the paths it declares, so a
  path cannot drop out of the corpus when the compressor chooses otherwise.
- ``compat/ocdbt.py`` lists the same keys with the same bytes as
  tensorstore: on a checkpoint the JAX package writes, on a leaf orbax
  stores in several chunks, on a two-process database merged as orbax
  merges it (interior nodes, each process's files reached through base
  paths), and on one with more versions than its manifest holds.
- ``compat/orbax.py`` equals the JAX package's restore bit for bit for each
  family's ``TrainState`` (each GAN family's in ``test_torch_orbax_gan.py``,
  with the GAN paths, so that the two files run on different test workers).
- A run the JAX trainer checkpointed at step 3 resumes in the port (Adam and
  Momentum) and continues as JAX's uninterrupted run does: losses to
  ``rtol=1e-4``, final weights to ``rtol=1e-3, atol=2e-3`` (as
  ``test_torch_train_loop.py``). The infer CLI on JAX's log dir writes the
  JAX infer CLI's TIFFs (``all``, ``sample``, ``gt``).
- Pruning to ``MAX_TO_KEEP`` counts the JAX and the port's steps together.
- Each refusal is tested: zarr v3, another compressor, bfloat16, zarr
  filters, a dictionary, the port writing into an orbax step, and a JAX step
  the trainer cannot read (raised, not skipped).

``write_jax_fixtures`` wrote ``tests/torch_fixtures/jax_hypelcnn_480`` and
``jax_cycle_gan_144`` once (JAX on the CPU); ``chip_smoke.py`` reads them on
the card, which has no JAX, and ``test_committed_fixtures_read_as_jax_restores``
holds them against JAX's restore here.
"""

import json
import os
import pathlib
import shutil
import statistics
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from hypelcnn_tpu.apps import infer_for_classification as jax_infer_app
from hypelcnn_tpu.core.registry import get_importer_from_name as jax_get_importer
from hypelcnn_tpu.core.registry import get_model_from_name as jax_get_model
from hypelcnn_tpu.gan.wrapper_registry import get_trainer_dict as jax_get_trainer_dict
from hypelcnn_tpu.parallel.mesh import create_mesh
from hypelcnn_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from hypelcnn_tpu.train.checkpoint import restore_params_pytree as jax_restore_params
from hypelcnn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from hypelcnn_tpu.train.checkpoint import save_params_pytree as jax_save_params
from hypelcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from hypelcnn_tpu.train.state import TrainState as JaxTrainState
from hypelcnn_tpu.train.trainer import ClassificationTrainer as JaxClassificationTrainer
from hypelcnn_tpu_torch.apps import infer_for_classification
from hypelcnn_tpu_torch.compat import FormatNotRead, ocdbt, orbax, zstd
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.core.registry import get_importer_from_name, get_model_from_name
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict
from hypelcnn_tpu_torch.train.checkpoint import (
    checkpoint_steps,
    holds_orbax_step,
    restore_checkpoint,
    save_checkpoint,
)
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer
from hypelcnn_tpu_torch.utils.tiff_io import imread
from torch_parity import init_jax, numpy_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

zstandard = pytest.importorskip("zstandard")
ts = pytest.importorskip("tensorstore")

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_fixtures"
SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
CLASSES, BATCH, SAVED, STEPS = 5, 16, 3, 6
PARAMS = {**jax_get_model("HYPELCNNModel").default_params(), "filter_count": 32,
          "drop_out_ratio": 0.0, "learning_rate": 1e-3, "batch_size": BATCH}
MOMENTUM = {**PARAMS, "optimizer": ["MomentumOptimizer", 0.9]}


# ------------------------------------------------------------------ zstd ----

SEQUENCE_MODES = ("predefined", "rle", "fse", "repeat")
# every path of the format that a frame's headers name; each is declared by a
# corpus case below and checked in that case's frame
FORMAT_PATHS = {
    "frame:single_segment", "frame:windowed", "frame:no_content_size", "frame:checksum",
    "block:raw", "block:rle", "block:compressed",
    "literals:raw", "literals:rle", "literals:huffman_1_stream", "literals:huffman_4_streams",
    "literals:treeless", "weights:direct", "weights:fse",
    "sequences:none", *(f"sequences:{mode}" for mode in SEQUENCE_MODES),
}


def _frame_paths(data: bytes) -> set:
    """The paths of RFC 8878 that the frames in ``data`` take, read from the
    frame, block, literals and sequences headers alone (no decoding)."""
    paths, offset = set(), 0
    while offset < len(data):
        magic = int.from_bytes(data[offset:offset + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            paths.add("frame:skippable")
            offset += 8 + int.from_bytes(data[offset + 4:offset + 8], "little")
            continue
        assert magic == 0xFD2FB528
        descriptor = data[offset + 4]
        single, checksum, size_flag = descriptor >> 5 & 1, descriptor >> 2 & 1, descriptor >> 6
        paths.add("frame:single_segment" if single else "frame:windowed")
        if checksum:
            paths.add("frame:checksum")
        if size_flag == 0 and not single:
            paths.add("frame:no_content_size")
        offset += 5 + (not single) + (0, 1, 2, 4)[descriptor & 3] + (single, 2, 4, 8)[size_flag]
        last = False
        while not last:
            header = int.from_bytes(data[offset:offset + 3], "little")
            last, kind, size = header & 1, header >> 1 & 3, header >> 3
            paths.add("block:" + ("raw", "rle", "compressed")[kind])
            offset += 3
            if kind == 2:
                paths |= _compressed_block_paths(data[offset:offset + size])
            offset += 1 if kind == 1 else size
        offset += 4 * checksum
    return paths


def _compressed_block_paths(block: bytes) -> set:
    kind, size_format = block[0] & 3, block[0] >> 2 & 3
    if kind < 2:  # raw or RLE literals: a 1, 2 or 3-byte header
        width = (1, 2, 1, 3)[size_format]
        regenerated = int.from_bytes(block[:width], "little") >> (3 if width == 1 else 4)
        paths = {"literals:" + ("raw", "rle")[kind]}
        offset = width + (regenerated if kind == 0 else 1)
    else:  # Huffman (2) or treeless (3): two sizes of 10, 10, 14 or 18 bits
        width, bits = (3, 3, 4, 5)[size_format], (10, 10, 14, 18)[size_format]
        compressed = int.from_bytes(block[:width], "little") >> (4 + bits) & ((1 << bits) - 1)
        if kind == 3:
            paths = {"literals:treeless"}
        else:
            paths = {"literals:huffman_1_stream" if size_format == 0
                     else "literals:huffman_4_streams",
                     "weights:" + ("fse" if block[width] < 128 else "direct")}
        offset = width + compressed
    count = block[offset]
    if count == 0:
        return paths | {"sequences:none"}
    modes = block[offset + (1 if count < 128 else 2 if count < 255 else 3)]
    return paths | {f"sequences:{SEQUENCE_MODES[modes >> shift & 3]}" for shift in (6, 4, 2)}


def _text(size: int) -> bytes:
    """Words of a seeded vocabulary at Zipf frequencies, with spaces,
    punctuation and line breaks: text that does not change with the code."""
    rng = np.random.default_rng(7)
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    zipf = 1.0 / np.arange(1, 3001)
    letter_p = zipf[:26] / zipf[:26].sum()
    vocabulary = [rng.choice(letters, int(rng.integers(1, 11)), p=letter_p).tobytes()
                  for _ in range(3000)]
    words = rng.choice(3000, size // 5, p=zipf / zipf.sum())
    breaks = rng.choice(np.frombuffer(b"       ,.\n", np.uint8), words.size)
    return b"".join(vocabulary[w] + bytes([b]) for w, b in zip(words, breaks))[:size]


def _corpus():
    """name -> (data, compressor options, the paths its frame must take)."""
    rng = np.random.default_rng(0)
    text = _text(600_000)
    weights = (rng.normal(size=250_000) * 0.05).astype(np.float32).tobytes()
    source = rng.integers(0, 90, 65_536, dtype=np.uint8).tobytes()  # no "Z"
    starts, lengths = rng.integers(0, 65_280, 6000), rng.integers(64, 256, 6000)
    cases = {
        "empty": (b"", {}, {"block:raw"}),
        "one_byte": (b"x", {}, {"block:raw", "frame:single_segment"}),
        "zeros_rle_blocks": (bytes(300_000), {}, {"block:rle", "sequences:predefined"}),
        "random_raw_blocks": (rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes(), {},
                              {"block:raw"}),
        "long_references_across_blocks": (
            rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes() * 3, {"level": 19},
            {"block:compressed", "literals:raw"}),
        # "ZZ" between copies of earlier stretches: the only literals
        "rle_literals": (source + b"".join(b"ZZ" + source[s:s + n]
                                           for s, n in zip(starts, lengths)),
                         {"level": 19}, {"literals:rle", "sequences:repeat"}),
        # 16 equally likely symbols: equal weights, which FSE cannot code
        "direct_huffman_weights": (rng.integers(0, 16, 60_000, dtype=np.uint8).tobytes(),
                                   {"level": 3}, {"weights:direct", "literals:huffman_4_streams"}),
        "one_huffman_stream": (rng.choice(np.frombuffer(b"ACGT", np.uint8), 200).tobytes(),
                               {"level": 3}, {"literals:huffman_1_stream", "weights:fse"}),
        "no_content_size": (text[:200_000], {"write_content_size": False},
                            {"frame:no_content_size", "frame:windowed"}),
        "checksum": (text[:200_000], {"write_checksum": True}, {"frame:checksum"}),
        "text_level-5": (text, {"level": -5}, {"literals:raw", "sequences:fse"}),
        "float32_level-5": (weights, {"level": -5}, {"block:raw"}),
        "float32_level1": (weights, {"level": 1}, {"literals:huffman_4_streams",
                                                   "sequences:none"}),
        "float32_level3": (weights, {"level": 3}, {"literals:treeless"}),
    }
    for level in (1, 3, 19, 22):
        cases[f"text_level{level}"] = (text, {"level": level}, {
            "literals:huffman_4_streams", "literals:treeless", "weights:fse", "sequences:fse"})
    for level in (19, 22):
        cases[f"float32_level{level}"] = (weights, {"level": level}, {
            "literals:huffman_4_streams", "sequences:rle", "sequences:repeat"})
    return cases


CORPUS = _corpus()


def test_zstd_corpus_declares_every_path():
    assert set().union(*(paths for _, _, paths in CORPUS.values())) == FORMAT_PATHS


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_zstd_equals_zstandard(case):
    data, options, paths = CORPUS[case]
    frame = zstandard.ZstdCompressor(**options).compress(data)
    assert paths <= _frame_paths(frame), f"{case} no longer takes {paths - _frame_paths(frame)}"
    assert zstd.decompress(frame) == zstandard.ZstdDecompressor().decompressobj().decompress(
        frame) == data


def test_zstd_concatenated_and_skippable_frames():
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    first, second = b"abc" * 100, CORPUS["rle_literals"][0]
    frames = (zstandard.ZstdCompressor(level=1).compress(first) + skippable
              + zstandard.ZstdCompressor(level=19).compress(second))
    assert {"frame:skippable", "literals:rle"} <= _frame_paths(frames)
    assert zstd.decompress(frames) == first + second


def test_zstd_refuses_a_corrupt_checksum_and_a_dictionary():
    data = CORPUS["checksum"][0]
    frame = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(data))
    frame[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    samples = [data[i:i + 500] for i in range(0, 150_000, 500)]
    dictionary = zstandard.train_dictionary(2048, samples)
    framed = zstandard.ZstdCompressor(dict_data=dictionary).compress(data[:1000])
    with pytest.raises(FormatNotRead, match="dictionary"):
        zstd.decompress(framed)


# ----------------------------------------------------------------- OCDBT ----

def _tensorstore_items(root):
    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    return {key: store.read(key).result().value for key in store.list().result()}


def _assert_same_store(root):
    expected = _tensorstore_items(root)
    store = ocdbt.OcdbtStore(str(root))
    assert store.list() == sorted(expected)
    assert {key: store.read(key) for key in store.list()} == expected
    return expected


def _small_train_state(model="HYPELCNNModel", params=None, data_shape=(3, 3, 13), seed=0):
    """A JAX ``TrainState`` at step 1 whose optimizer moments are not zero."""
    params = params or {"filter_count": 32}
    algorithm_params = {**jax_get_model(model).default_params(), **params}
    _, flax_params, batch_stats = init_jax(model, CLASSES, algorithm_params, data_shape, seed)
    tx, _ = jax_build_optimizer(algorithm_params)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, flax_params),
                                 jax.tree_util.tree_map(jnp.asarray, batch_stats), tx)
    rng = np.random.default_rng(seed)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), state.params)
    _, opt_state = tx.update(grads, state.opt_state, state.params)
    return state.replace(step=jnp.asarray(1, jnp.int32), opt_state=opt_state)


def test_ocdbt_reads_a_jax_checkpoint_as_tensorstore(tmp_path):
    jax_save_checkpoint(str(tmp_path), _small_train_state())
    item = tmp_path / "checkpoints" / "1" / "default"
    keys = _assert_same_store(item)
    assert b"params.Conv_0.kernel/.zarray" not in keys  # the names are the flax tree's
    assert any(k.endswith(b"/.zarray") for k in keys) and b"step/0" in keys
    (process,) = item.glob("ocdbt.process_*")
    assert _assert_same_store(process) == keys


def test_ocdbt_and_orbax_read_a_leaf_in_several_chunks(tmp_path):
    """orbax's own API writes a leaf in chunks of at most 4 KiB, as a run on
    several devices writes its shards."""
    rng = np.random.default_rng(1)
    tree = {"kernel": jnp.asarray(rng.normal(size=(37, 29, 5)).astype(np.float32)),
            "count": jnp.asarray(rng.integers(0, 9, (101,)).astype(np.int32))}
    save_args = jax.tree_util.tree_map(lambda _: ocp.SaveArgs(chunk_byte_size=4096), tree)
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(str(tmp_path / "snap"), tree, save_args=save_args)
    checkpointer.wait_until_finished()
    keys = _assert_same_store(tmp_path / "snap")
    assert len([k for k in keys if k.startswith(b"kernel/") and not k.endswith(b"zarray")]) > 4
    read = orbax.read_orbax(str(tmp_path / "snap"))
    for name, value in tree.items():
        assert read[name].dtype == value.dtype
        np.testing.assert_array_equal(read[name], np.asarray(value))


def test_ocdbt_reads_a_merged_two_process_database(tmp_path):
    """Two process databases with nodes of at most 400 bytes, copied into
    the top one as orbax merges them: interior nodes, and values reached
    through each process's base path."""
    config = {"max_inline_value_bytes": 64, "max_decoded_node_bytes": 400,
              "manifest_kind": "single"}
    context = ts.Context()

    def open_store(path):
        return ts.KvStore.open({"driver": "ocdbt", "base": {"driver": "file", "path": str(path)},
                                "config": config, "assume_config": True},
                               context=context).result()

    children = []
    for process in range(2):
        child = open_store(tmp_path / f"ocdbt.process_{process}")
        for batch in range(3):
            txn = ts.Transaction(atomic=True)
            for i in range(batch * 20, batch * 20 + 20):
                child.with_transaction(txn).write(
                    f"p{process}.leaf{i:03d}/0", f"value {process} {i} ".encode() * (1 + i % 20)
                ).result()
            txn.commit_sync()
        children.append(child)
    parent = open_store(tmp_path)
    txn = ts.Transaction(atomic=True)
    for child in children:
        child.experimental_copy_range_to(parent.with_transaction(txn)).result()
    txn.commit_sync()
    manifest = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path}/").result()).result()
    assert manifest["versions"][-1]["root_height"] > 1
    assert len(_assert_same_store(tmp_path)) == 120


def test_ocdbt_reads_the_newest_of_many_versions(tmp_path):
    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                             "config": {"manifest_kind": "single"}}).result()
    for i in range(40):
        store.write(f"k{i:02d}", b"v" * i).result()
    store.write("k05", b"rewritten").result()
    manifest = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path}/").result()).result()
    assert manifest["version_tree_nodes"]
    assert _assert_same_store(tmp_path)[b"k05"] == b"rewritten"


# ----------------------------------------------------------------- orbax ----

def _path_keys(path):
    keys = []
    for entry in path:
        for attr in ("key", "name", "idx"):
            if hasattr(entry, attr):
                keys.append(getattr(entry, attr))
                break
    return tuple(keys)


def _leaf(tree, keys):
    for key in keys:
        tree = tree[key]
    return tree


def _assert_tree_equals_jax(tree, jax_tree):
    leaves = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert leaves
    for path, value in leaves:
        ours, theirs = _leaf(tree, _path_keys(path)), np.asarray(value)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
        assert ours.tobytes() == theirs.tobytes(), path


FAMILY_STATES = {
    "HYPELCNNModel": ({"filter_count": 32}, (3, 3, 13)),
    "CONCNNModel": ({"filter_count": 8}, (5, 5, 13)),
    "DUALCNNModel": ({"filter_count": 32}, (5, 5, 13)),
    "CAPModel": ({"feature_count": 8, "primary_capsule_count": 2}, (3, 3, 13)),
}


@pytest.mark.parametrize("model", sorted(FAMILY_STATES))
def test_orbax_equals_jax_restore_of_each_train_state(model, tmp_path):
    """Bit for bit, and the weight bridge loads it into the port's module."""
    params, shape = FAMILY_STATES[model]
    state = _small_train_state(model, params, shape)
    jax_save_checkpoint(str(tmp_path), state)
    restored = jax_restore_checkpoint(str(tmp_path), state)
    tree = orbax.read_orbax(str(tmp_path / "checkpoints" / "1"))
    _assert_tree_equals_jax(tree, restored)
    payload = restore_checkpoint(str(tmp_path))
    assert payload["step"] == 1
    algorithm_params = {**get_model_from_name(model).default_params(), **params}
    module = get_model_from_name(model).create_module(CLASSES, algorithm_params, shape)
    module.load_state_dict(payload["state_dict"], strict=True)


class _Store:
    def __init__(self, items):
        self.items = items

    def read(self, key):
        return self.items.get(key)


def _zarray(**overrides):
    spec = {"chunks": [4], "compressor": None, "dimension_separator": ".", "dtype": "<f4",
            "fill_value": None, "filters": None, "order": "C", "shape": [6], "zarr_format": 2,
            **overrides}
    return {"a/.zarray": json.dumps(spec).encode()}


def test_zarr_arrays_assemble_chunks_and_fill_missing_ones():
    values = np.arange(8, dtype=np.float32)
    store = _Store({**_zarray(fill_value=-1.5), "a/0": values[:4].tobytes()})
    np.testing.assert_array_equal(orbax._read_array(store, "a", "x"),
                                  [0, 1, 2, 3, -1.5, -1.5])
    grid = np.arange(15, dtype="<i8").reshape(3, 5)
    chunks = {f"a/{i}.{j}": np.pad(grid[2 * i:2 * i + 2, 3 * j:3 * j + 3],
                                   ((0, 2 - len(grid[2 * i:2 * i + 2])),
                                    (0, 3 - grid[:, 3 * j:3 * j + 3].shape[1]))).tobytes()
              for i in range(2) for j in range(2)}
    store = _Store({**_zarray(shape=[3, 5], chunks=[2, 3], dtype="<i8"), **chunks})
    np.testing.assert_array_equal(orbax._read_array(store, "a", "x"), grid)
    store = _Store({**_zarray(fill_value="NaN"), "a/1": values[4:].tobytes()})
    assert np.isnan(orbax._read_array(store, "a", "x")[:4]).all()


@pytest.mark.parametrize("overrides, message", [
    ({"compressor": {"id": "blosc", "cname": "lz4"}}, "compressor 'blosc'"),
    ({"dtype": "bfloat16"}, "dtype 'bfloat16'"),
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
    ({"zarr_format": 3}, "zarr_format 3"),
    ({"order": "F"}, "order 'F'"),
])
def test_zarr_options_not_read_are_refused_by_name(overrides, message):
    with pytest.raises(FormatNotRead, match=message):
        orbax._read_array(_Store(_zarray(**overrides)), "a", "x")


def _as_zarr3(step_dir: pathlib.Path, **overrides):
    metadata = step_dir / "default" / "_METADATA"
    spec = json.loads(metadata.read_text())
    metadata.write_text(json.dumps({**spec, "use_zarr3": True, **overrides}))


@pytest.mark.parametrize("overrides, message", [
    ({}, "use_zarr3 is true"),
    ({"use_zarr3": False, "use_ocdbt": False}, "use_ocdbt is false"),
])
def test_orbax_items_not_read_are_refused_by_name(overrides, message, tmp_path):
    jax_save_checkpoint(str(tmp_path), _small_train_state())
    _as_zarr3(tmp_path / "checkpoints" / "1", **overrides)
    with pytest.raises(FormatNotRead, match=message):
        restore_checkpoint(str(tmp_path))


# ------------------------------------------------------ classifier states ----

def _jax_trainer(params, **kw):
    np.random.seed(0)
    data = jax_get_importer("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    return JaxClassificationTrainer(
        model=jax_get_model("HYPELCNNModel"), class_count=data.class_count,
        algorithm_params=params, scene=data.scene, sample_set=data.sample_set,
        sources=data.sources, data_shape=data.data_shape, mesh=create_mesh(), **kw)


def _port_trainer(params, **kw):
    np.random.seed(0)
    data = get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    return ClassificationTrainer(
        model=get_model_from_name("HYPELCNNModel"), class_count=data.class_count,
        algorithm_params=params, scene=data.scene, sample_set=data.sample_set,
        sources=data.sources, data_shape=data.data_shape, device="cpu", **kw)


def _fit(trainer, steps):
    losses = []
    result = trainer.fit(steps, BATCH, progress_callback=lambda s, l: losses.append((s, l)),
                         log_every=1)
    return result, losses


_JAX_RUNS = {}


def _jax_run(optimizer, tmp_path_factory):
    """JAX's log dir at step 3, and its uninterrupted run to step 6 (made once)."""
    if optimizer not in _JAX_RUNS:
        params = PARAMS if optimizer == "adam" else MOMENTUM
        log_dir = tmp_path_factory.mktemp(f"jax_{optimizer}") / "log"
        _fit(_jax_trainer(params, log_dir=str(log_dir), save_checkpoint_steps=SAVED), SAVED)
        trainer = _jax_trainer(params)
        _, losses = _fit(trainer, STEPS)
        final = variables_to_state_dict(numpy_tree(trainer.final_state.params),
                                        numpy_tree(trainer.final_state.batch_stats))
        _JAX_RUNS[optimizer] = params, log_dir, losses, final
    return _JAX_RUNS[optimizer]


def _copy_of_jax_log(optimizer, tmp_path_factory, tmp_path):
    params, jax_log, _, _ = _jax_run(optimizer, tmp_path_factory)
    log_dir = tmp_path / "log"
    shutil.copytree(jax_log, log_dir)
    return params, log_dir


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_a_jax_run_resumes_in_the_port(optimizer, tmp_path_factory, tmp_path):
    _, _, jax_losses, jax_final = _jax_run(optimizer, tmp_path_factory)
    params, log_dir = _copy_of_jax_log(optimizer, tmp_path_factory, tmp_path)
    assert checkpoint_steps(str(log_dir)) == [SAVED]
    result, losses = _fit(_port_trainer(params, log_dir=str(log_dir),
                                        save_checkpoint_steps=SAVED), STEPS)
    assert result.steps_run == STEPS - SAVED
    assert [s for s, _ in losses] == list(range(SAVED + 1, STEPS + 1))
    np.testing.assert_allclose([l for _, l in losses], [l for _, l in jax_losses[SAVED:]],
                               rtol=1e-4)
    final = result.final_state.module.state_dict()
    for key, theirs in jax_final.items():
        np.testing.assert_allclose(final[key].numpy(), theirs.numpy(), rtol=1e-3, atol=2e-3,
                                   err_msg=key)
    # the port's own orbax checkpoint beside JAX's, which it leaves as it was
    assert checkpoint_steps(str(log_dir)) == [SAVED, STEPS]
    assert holds_orbax_step(str(log_dir), SAVED) and holds_orbax_step(str(log_dir), STEPS)
    assert (log_dir / "checkpoints" / str(SAVED) / "default" / "ocdbt.process_0").is_dir()


def test_resuming_at_the_last_step_leaves_the_jax_checkpoint(tmp_path_factory, tmp_path):
    params, log_dir = _copy_of_jax_log("adam", tmp_path_factory, tmp_path)
    result, losses = _fit(_port_trainer(params, log_dir=str(log_dir),
                                        save_checkpoint_steps=SAVED), SAVED)
    assert result.steps_run == 0 and losses == []
    assert checkpoint_steps(str(log_dir)) == [SAVED] and holds_orbax_step(str(log_dir), SAVED)
    with pytest.raises(FileExistsError, match="written once"):
        save_checkpoint(str(log_dir), result.final_state.checkpoint_tree())


def test_an_unreadable_jax_checkpoint_is_refused_not_skipped(tmp_path_factory, tmp_path):
    params, log_dir = _copy_of_jax_log("adam", tmp_path_factory, tmp_path)
    _as_zarr3(log_dir / "checkpoints" / str(SAVED))
    with pytest.raises(FormatNotRead, match="zarr v3"):
        _port_trainer(params, log_dir=str(log_dir), save_checkpoint_steps=SAVED).fit(STEPS, BATCH)


def test_pruning_counts_jax_and_port_steps_together(tmp_path):
    state = _small_train_state()
    for step in (1, 2, 3):
        jax_save_checkpoint(str(tmp_path), state.replace(step=jnp.asarray(step, jnp.int32)))
    payload = restore_checkpoint(str(tmp_path))
    assert payload["step"] == 3
    port_state = _port_trainer(PARAMS).init_state()
    port_state.restore(payload)
    port_state.step = 4
    save_checkpoint(str(tmp_path), port_state.checkpoint_tree(), max_to_keep=3)
    assert checkpoint_steps(str(tmp_path)) == [2, 3, 4]
    assert [holds_orbax_step(str(tmp_path), s) for s in (2, 3, 4)] == [True, True, True]
    # JAX's steps hold its process database, the port's one store of its own
    assert [(tmp_path / "checkpoints" / str(s) / "default" / "ocdbt.process_0").is_dir()
            for s in (2, 3, 4)] == [True, True, False]
    assert restore_checkpoint(str(tmp_path))["step"] == 4


def _tiff(path):
    return imread(str(path))


def test_the_infer_cli_on_a_jax_log_dir_writes_jax_tiffs(tmp_path_factory, tmp_path):
    _, jax_log, _, _ = _jax_run("adam", tmp_path_factory)
    params_file = tmp_path / "params.json"
    params_file.write_text(json.dumps({"filter_count": 32, "drop_out_ratio": 0.0}))
    common = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--neighborhood=1",
              f"--algorithm_param_path={params_file}", f"--base_log_path={jax_log}"]
    for domain in ("all", "sample", "gt"):
        jax_infer_app.main(common + [f"--domain={domain}",
                                     f"--output_path={tmp_path / ('jax_' + domain)}"])
        infer_for_classification.main(common + [f"--domain={domain}", "--device=cpu",
                                                f"--output_path={tmp_path / domain}"])
        for name in ("result_raw.tif", "result_colorized.tif"):
            np.testing.assert_array_equal(_tiff(tmp_path / domain / name),
                                          _tiff(tmp_path / ("jax_" + domain) / name))


def test_the_activation_graph_reads_a_jax_log_dir(tmp_path_factory, tmp_path, capsys):
    from hypelcnn_tpu_torch.utils.nn_layer_activation_graph import main
    _, jax_log, _, _ = _jax_run("adam", tmp_path_factory)
    params_file = tmp_path / "params.json"
    params_file.write_text(json.dumps({"filter_count": 32}))
    got = main(["--model_name=HYPELCNNModel", "--neighborhood=1", f"--class_count={CLASSES}",
                "--bands=13", "--level_count=2", f"--algorithm_param_path={params_file}",
                f"--base_log_path={jax_log}", f"--output_path={tmp_path / 'act'}",
                "--device=cpu"])
    assert f"Restored checkpoint at step {SAVED}" in capsys.readouterr().out
    assert got and all(np.isfinite(v).all() for v in got.values())


# ------------------------------------------------------- committed fixtures ----

FIXTURE_SPEC = "synthetic://?h=349&w=1905&bands=144&classes=15"
FIXTURE_STEPS, FIXTURE_BATCH, FIXTURE_BANDS, TIE_GAP = 200, 48, 144, 1e-4
HYPELCNN_FIXTURE = FIXTURES / "jax_hypelcnn_480"
GAN_FIXTURE = FIXTURES / "jax_cycle_gan_144"


def _fixture_params():
    path = ROOT / "configs" / "modelconfigs" / "alg_param_hypelcnn.json"
    return {**jax_get_model("HYPELCNNModel").default_params(), **json.loads(path.read_text()),
            "batch_size": FIXTURE_BATCH}


def _bfloat16_grid(leaf):
    """A float32 leaf rounded (to nearest even) to the values bfloat16 holds;
    other leaves as they are."""
    array = np.asarray(leaf)
    if array.dtype != np.float32:
        return leaf
    bits = array.view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return jnp.asarray(rounded.view(np.float32))


def _jax_map_and_ties(module, variables, scene, rows=4):
    """JAX's class map of the scene and its ties: pixels whose two largest
    logits are within ``TIE_GAP``."""
    from hypelcnn_tpu.ops.window_gather import gather_patches_xla
    from hypelcnn_tpu.infer.scene_inference import predict_full_scene
    height, width = scene.get_scene_shape()
    k = 2 * scene.neighborhood + 1
    device_scene = scene.device_scene()

    @jax.jit
    def band(start):
        ys, xs = jnp.meshgrid(start + jnp.arange(rows), jnp.arange(width), indexing="ij")
        coords = jnp.stack([xs.reshape(-1), jnp.minimum(ys, height - 1).reshape(-1)], axis=1)
        logits = module.apply(variables, gather_patches_xla(device_scene, coords, k),
                              train=False).y_conv
        top = jax.lax.top_k(logits, 2)[0]
        return top[:, 0] - top[:, 1]

    gaps = np.concatenate([np.asarray(band(start)) for start in range(0, height, rows)])
    ties = gaps.reshape(-1, width)[:height] < TIE_GAP
    return predict_full_scene(module, variables, scene), ties


def write_jax_fixtures():
    """Write the committed fixtures (run once, JAX on the CPU):

    - ``jax_hypelcnn_480/checkpoints/200``: the JAX package's
      ``save_checkpoint`` of a HYPELCNN ``TrainState`` at the published
      width (``alg_param_hypelcnn.json``, 1,291,395 parameters, Adam) after
      200 steps at batch 48 on the GRSS2013-size synthetic scene
      (``train_ratio`` 0.10, ``test_ratio`` 0.05, seed 0). Every float32
      leaf is then rounded to bfloat16's values (float32 with the low 16
      bits zero), so that its three copies of the weights (parameters and
      Adam's two moments) fit the fixture's 10 MB; full-entropy float32 is
      the zstd corpus's;
    - ``jax_hypelcnn_480/class_map.npz``: JAX's map of that scene from the
      saved state (``predict_full_scene``) and the pixels whose two top
      logits are within ``TIE_GAP``, packed;
    - ``jax_cycle_gan_144/gan_params``: ``save_params_pytree`` of cycle_gan's
      networks at 144 bands (normal, std 0.05, seed 2), and
      ``translation.npz``: 256 pixels and JAX's translation of them each way.
    """
    from hypelcnn_tpu.train.state import variables_of
    params = _fixture_params()
    np.random.seed(0)
    data = jax_get_importer("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", FIXTURE_SPEC, train_ratio=0.10, test_ratio=0.05, neighborhood=1)
    trainer = JaxClassificationTrainer(
        model=jax_get_model("HYPELCNNModel"), class_count=data.class_count,
        algorithm_params=params, scene=data.scene, sample_set=data.sample_set,
        sources=data.sources, data_shape=data.data_shape, mesh=create_mesh())
    trainer.fit(FIXTURE_STEPS, FIXTURE_BATCH)
    state = jax.tree_util.tree_map(_bfloat16_grid, jax.device_get(trainer.final_state))
    shutil.rmtree(HYPELCNN_FIXTURE, ignore_errors=True)
    jax_save_checkpoint(str(HYPELCNN_FIXTURE), state)
    restored = jax_restore_checkpoint(str(HYPELCNN_FIXTURE), state)
    class_map, ties = _jax_map_and_ties(trainer.module, variables_of(restored), data.scene)
    np.savez_compressed(HYPELCNN_FIXTURE / "class_map.npz", class_map=class_map.astype(np.uint8),
                        ties=np.packbits(ties), shape=np.asarray(ties.shape))

    gan_trainer = jax_get_trainer_dict({}, FIXTURE_BANDS, max_steps=1)["cycle_gan"]
    rng = np.random.default_rng(2)
    gan_params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.05, np.shape(a)).astype(np.float32),
        jax.device_get(gan_trainer.init_state(jax.random.key(0)).params))
    shutil.rmtree(GAN_FIXTURE, ignore_errors=True)
    jax_save_params(str(GAN_FIXTURE / "gan_params"), gan_params)
    pixels = rng.uniform(0.05, 1.0, (256, 1, 1, FIXTURE_BANDS)).astype(np.float32)
    np.savez_compressed(GAN_FIXTURE / "translation.npz", pixels=pixels, **{
        name: np.asarray(gan_trainer.translate(gan_params, jnp.asarray(pixels), is_shadow))
        for name, is_shadow in (("shadow", True), ("deshadow", False))})


def _fixture_template():
    """A zero ``TrainState`` of the fixture's model and optimizer, the tree
    JAX's restore fills."""
    params = _fixture_params()
    module = jax_get_model("HYPELCNNModel").create_module(15, params)
    variables = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 3, 3, FIXTURE_BANDS + 1)), labels=jnp.zeros((2, 15)), train=True))
    tx, _ = jax_build_optimizer(params)
    return JaxTrainState.create(*(jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype), variables[c]) for c in ("params", "batch_stats")),
        tx)


def _write_full_entropy_checkpoint(log_dir) -> pathlib.Path:
    """The JAX package's ``save_checkpoint`` of the fixture's ``TrainState``
    with every float32 leaf drawn at full entropy (normal, seed 5; Adam's
    second moment squared), as a trained run writes it; its step dir."""
    rng = np.random.default_rng(5)

    def draw(path, leaf):
        if leaf.dtype != jnp.float32:
            return leaf
        value = rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)
        second_moment = any(getattr(key, "name", None) == "nu" for key in path)
        return jnp.asarray(value * value if second_moment else value)

    state = jax.tree_util.tree_map_with_path(draw, _fixture_template())
    jax_save_checkpoint(str(log_dir), state.replace(step=jnp.asarray(FIXTURE_STEPS, jnp.int32)))
    return pathlib.Path(log_dir) / "checkpoints" / str(FIXTURE_STEPS)


def test_a_full_entropy_full_width_checkpoint_reads_as_jax_restores(tmp_path):
    """The committed fixture's floats lie on bfloat16's grid; a checkpoint at
    the same width whose floats use all 32 bits (mostly Huffman literals in
    its frames) reads bit for bit as JAX restores it too."""
    step_dir = _write_full_entropy_checkpoint(tmp_path)
    restored = jax_restore_checkpoint(str(tmp_path), _fixture_template())
    _assert_tree_equals_jax(orbax.read_orbax(str(step_dir)), restored)


def time_decode():
    """Print one JSON line: ``read_orbax``'s seconds on this host (3 runs
    each, and their median) with the files' and arrays' bytes, for the
    committed HYPELCNN step and cycle_gan snapshot and for a full-entropy
    checkpoint of the same model (JAX on the CPU writes it to a temporary
    directory). The card's host times the two committed ones in
    ``chip_smoke.py``'s ``jax_log_dir``."""
    (step_dir,) = (HYPELCNN_FIXTURE / "checkpoints").iterdir()
    record = {"cpu_count": os.cpu_count()}
    with tempfile.TemporaryDirectory() as scratch:
        for name, path in (("train_state", step_dir),
                           ("gan_params", GAN_FIXTURE / "gan_params"),
                           ("full_entropy_train_state", _write_full_entropy_checkpoint(scratch))):
            seconds = []
            for _ in range(3):
                start = time.perf_counter()
                tree = orbax.read_orbax(str(path))
                seconds.append(time.perf_counter() - start)
            record[name] = {"seconds": seconds, "median_seconds": statistics.median(seconds),
                            "file_bytes": sum(p.stat().st_size for p in path.rglob("*")
                                              if p.is_file()),
                            "array_bytes": orbax.tree_bytes(tree)}
    print(json.dumps(record), flush=True)


def test_committed_fixtures_read_as_jax_restores():
    """The committed JAX checkpoints read bit for bit as JAX restores them,
    and the port's cycle_gan translates the fixture's pixels as JAX did."""
    (step_dir,) = (HYPELCNN_FIXTURE / "checkpoints").iterdir()
    restored = jax_restore_checkpoint(str(HYPELCNN_FIXTURE), _fixture_template())
    assert int(restored.step) == FIXTURE_STEPS == int(step_dir.name)
    _assert_tree_equals_jax(orbax.read_orbax(str(step_dir)), restored)
    maps = np.load(HYPELCNN_FIXTURE / "class_map.npz")
    assert maps["class_map"].shape == tuple(maps["shape"]) == (349, 1905)
    assert maps["class_map"].max() < 15

    gan_trainer = jax_get_trainer_dict({}, FIXTURE_BANDS, max_steps=1)["cycle_gan"]
    snapshot = GAN_FIXTURE / "gan_params"
    template = gan_trainer.init_state(jax.random.key(0)).params
    _assert_tree_equals_jax(orbax.read_orbax(str(snapshot)), jax_restore_params(str(snapshot),
                                                                                 template))
    trainer = get_trainer_dict({}, FIXTURE_BANDS, max_steps=1)["cycle_gan"]
    nets = trainer.restore_nets(str(snapshot), "cpu")
    translation = np.load(GAN_FIXTURE / "translation.npz")
    for name, is_shadow in (("shadow", True), ("deshadow", False)):
        with torch.no_grad():
            got = trainer.translate(nets, torch.from_numpy(translation["pixels"]), is_shadow)
        np.testing.assert_allclose(got.numpy(), translation[name], rtol=1e-5, atol=1e-5)
