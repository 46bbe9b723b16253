"""The port writes the JAX package's orbax checkpoints, on the CPU (the GAN
states and snapshots in ``test_torch_orbax_write_gan.py``, so that the two
files run on different test workers).

- ``compat/zstd.py``'s encoder: its frames decode with ``zstandard`` and
  with the port's decoder at 0, 1, 128 KiB - 1, 128 KiB, 128 KiB + 1 and
  3 MB.
- ``compat/ocdbt.py``'s writer: tensorstore's OCDBT kvstore lists the keys
  and values put in, inline and indirect ones; so it does for every step the
  port saves.
- For each family and each optimizer (Adam, Momentum), the state the port
  saves has the ``_METADATA`` tree the JAX package writes for the same state
  (paths, key types, value types, write shapes, in its order) and the same
  zarr specs, and the JAX package's ``restore_checkpoint``, with the
  template its trainer builds, returns it bit for bit.
- A port run saved at step 3 resumes in the JAX trainer (Adam and Momentum)
  and continues as the port's uninterrupted run does: losses to
  ``rtol=1e-4``, final weights to ``rtol=1e-3, atol=2e-3`` (the tolerances
  of the other direction, ``test_torch_orbax.py``). The JAX infer CLI on the
  port's log dir writes the port infer CLI's TIFFs (``all``, ``sample``,
  ``gt``).
- A write that dies before its rename leaves the steps as they were; a
  bfloat16 leaf is refused by name.
- A log dir the port wrote before it wrote orbax (``state.pt`` steps, made
  here with ``torch.save`` in that layout) still resumes and classifies.

``compare_file_bytes`` prints the file bytes of a HYPELCNN-480 step as JAX
writes it and as the port re-saves it, on the committed fixture and on a
full-entropy checkpoint (JAX on the CPU writes it to a temporary directory).
"""

import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hypelcnn_tpu.apps import infer_for_classification as jax_infer_app
from hypelcnn_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from hypelcnn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from hypelcnn_tpu_torch.apps import infer_for_classification
from hypelcnn_tpu_torch.compat import FormatNotRead, ocdbt, orbax, zstd
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.core.registry import get_model_from_name
from hypelcnn_tpu_torch.train.checkpoint import (
    checkpoint_steps,
    holds_orbax_step,
    restore_checkpoint,
    save_checkpoint,
)
from hypelcnn_tpu_torch.train.optimizer import build_optimizer
from hypelcnn_tpu_torch.train.state import TrainState
from test_torch_orbax import (
    CLASSES,
    HYPELCNN_FIXTURE,
    FAMILY_STATES,
    MOMENTUM,
    PARAMS,
    SAVED,
    SPEC,
    STEPS,
    _assert_same_store,
    _assert_tree_equals_jax,
    _fit,
    _jax_trainer,
    _port_trainer,
    _small_train_state,
    _tensorstore_items,
    _tiff,
    _write_full_entropy_checkpoint,
)
from torch_parity import numpy_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

zstandard = pytest.importorskip("zstandard")
pytest.importorskip("tensorstore")

OPTIMIZERS = {"adam": {}, "momentum": {"optimizer": ["MomentumOptimizer", 0.9]}}


# ------------------------------------------------------------------ zstd ----

@pytest.mark.parametrize("size", [0, 1, 128 * 1024 - 1, 128 * 1024, 128 * 1024 + 1, 3_000_000])
def test_zstd_frames_decode_with_zstandard_and_the_port(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    frame = zstd.encode(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstandard.decompress(frame) == data  # reads the content size from the header
    assert zstd.decompress(frame) == data
    assert len(frame) - size <= 18 + 3 * (size // (128 * 1024))  # raw blocks: headers only


# ----------------------------------------------------------------- OCDBT ----

def test_ocdbt_writer_is_read_by_tensorstore(tmp_path):
    rng = np.random.default_rng(3)
    items = {f"leaf{i:03d}/{j}".encode(): rng.integers(0, 256, int(rng.integers(0, 4000)),
                                                         dtype=np.uint8).tobytes()
             for i in range(60) for j in range(2)}
    items.update({b"": b"the empty key", b"inline/1024": bytes(1024),
                  b"indirect/1025": bytes(1025), b"\xff\x00binary": b"v"})
    with ocdbt.OcdbtWriter(str(tmp_path / "store")) as writer:
        for key in sorted(items, reverse=True):  # any order: the leaf sorts them
            writer.put(key, items[key])
    assert _assert_same_store(tmp_path / "store") == items
    with pytest.raises(FileExistsError):
        ocdbt.OcdbtWriter(str(tmp_path / "store"))


# ----------------------------------------------------- classifier states ----

def _port_state(model, params, shape):
    algorithm_params = {**get_model_from_name(model).default_params(), **params}
    module = get_model_from_name(model).create_module(CLASSES, algorithm_params, shape)
    optimizer, schedule = build_optimizer(algorithm_params, module.parameters())
    return TrainState(step=0, module=module, optimizer=optimizer, schedule=schedule)


def _metadata(step_dir):
    return json.loads((step_dir / "default" / "_METADATA").read_text())


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
@pytest.mark.parametrize("model", sorted(FAMILY_STATES))
def test_the_port_writes_the_jax_train_state(model, optimizer, tmp_path):
    """JAX's state restored into the port and saved by it: the files JAX
    writes for that state, and JAX's restore of them bit for bit."""
    params, shape = FAMILY_STATES[model]
    params = {**params, **OPTIMIZERS[optimizer]}
    jax_state = _small_train_state(model, params, shape)
    jax_save_checkpoint(str(tmp_path / "jax"), jax_state)
    state = _port_state(model, params, shape)
    state.restore(restore_checkpoint(str(tmp_path / "jax")))
    step_dir = save_checkpoint(str(tmp_path / "port"), state.checkpoint_tree())
    theirs, ours = (tmp_path / side / "checkpoints" / "1" for side in ("jax", "port"))
    assert step_dir == str(ours)
    assert json.loads((ours / "_CHECKPOINT_METADATA").read_text())["item_handlers"] == \
        json.loads((theirs / "_CHECKPOINT_METADATA").read_text())["item_handlers"]
    jax_meta, port_meta = _metadata(theirs), _metadata(ours)
    assert list(port_meta["tree_metadata"].items()) == list(jax_meta["tree_metadata"].items())
    assert port_meta == jax_meta
    assert json.loads((ours / "default" / "array_metadatas" / "process_0").read_text()) == \
        json.loads((theirs / "default" / "array_metadatas" / "process_0").read_text())
    # the same zarr arrays in the store, each the same bytes once decoded
    jax_items, port_items = _tensorstore_items(theirs / "default"), \
        _assert_same_store(ours / "default")
    assert sorted(port_items) == sorted(jax_items)
    for key, value in port_items.items():
        if key.endswith(b"/.zarray"):
            assert value == jax_items[key], key
        else:
            # JAX's frames leave out their content size, which a stream reads without
            assert zstd.decompress(value) == zstandard.ZstdDecompressor().decompressobj(
            ).decompress(jax_items[key]), key
    restored = jax_restore_checkpoint(str(tmp_path / "port"), jax_state)
    _assert_tree_equals_jax(orbax.read_orbax(str(theirs)), restored)
    _assert_tree_equals_jax(orbax.read_orbax(str(ours)), restored)


def test_a_write_that_dies_before_its_rename_leaves_the_steps(tmp_path, monkeypatch):
    state = _port_state("HYPELCNNModel", {"filter_count": 32}, (3, 3, 13))
    state.step = 2
    save_checkpoint(str(tmp_path), state.checkpoint_tree())
    state.step = 5

    def die(*args):
        raise OSError("the write died")

    with monkeypatch.context() as patch:
        patch.setattr(orbax.os, "rename", die)
        with pytest.raises(OSError, match="died"):
            save_checkpoint(str(tmp_path), state.checkpoint_tree())
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["2"]
    # a process killed mid-write leaves its temporary directory: not a step,
    # and the next write removes it, as it removes any other one left there
    for left in ("5.orbax-checkpoint-tmp-1", "7.orbax-checkpoint-tmp-3"):
        shutil.copytree(tmp_path / "checkpoints" / "2", tmp_path / "checkpoints" / left)
    assert checkpoint_steps(str(tmp_path)) == [2]
    assert restore_checkpoint(str(tmp_path))["step"] == 2
    save_checkpoint(str(tmp_path), state.checkpoint_tree())
    assert checkpoint_steps(str(tmp_path)) == [2, 5]
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["2", "5"]


def test_a_bfloat16_leaf_is_refused_by_name(tmp_path):
    tree = {"step": torch.tensor(1, dtype=torch.int32),
            "params": {"Dense_0": {"kernel": torch.zeros(2, 2, dtype=torch.bfloat16)}}}
    with pytest.raises(FormatNotRead, match="params.Dense_0.kernel: dtype bfloat16"):
        save_checkpoint(str(tmp_path), tree)
    assert checkpoint_steps(str(tmp_path)) == []
    assert not any((tmp_path / "checkpoints").iterdir())


# ------------------------------------------------------------ a port run ----

_PORT_RUNS = {}


def _port_run(optimizer, tmp_path_factory):
    """The port's log dir at step 3, and its uninterrupted run to step 6 (made once)."""
    if optimizer not in _PORT_RUNS:
        params = PARAMS if optimizer == "adam" else MOMENTUM
        log_dir = tmp_path_factory.mktemp(f"port_{optimizer}") / "log"
        _fit(_port_trainer(params, log_dir=str(log_dir), save_checkpoint_steps=SAVED), SAVED)
        result, losses = _fit(_port_trainer(params), STEPS)
        _PORT_RUNS[optimizer] = params, log_dir, losses, result.final_state.module.state_dict()
    return _PORT_RUNS[optimizer]


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_a_port_run_resumes_in_jax(optimizer, tmp_path_factory, tmp_path):
    params, port_log, port_losses, port_final = _port_run(optimizer, tmp_path_factory)
    log_dir = tmp_path / "log"
    shutil.copytree(port_log, log_dir)
    assert checkpoint_steps(str(log_dir)) == [SAVED] and not list(log_dir.rglob("*.pt"))
    trainer = _jax_trainer(params, log_dir=str(log_dir), save_checkpoint_steps=SAVED)
    _, losses = _fit(trainer, STEPS)
    assert int(trainer.final_state.step) == STEPS
    assert [s for s, _ in losses] == list(range(SAVED + 1, STEPS + 1))
    np.testing.assert_allclose([l for _, l in losses], [l for _, l in port_losses[SAVED:]],
                               rtol=1e-4)
    final = variables_to_state_dict(numpy_tree(trainer.final_state.params),
                                    numpy_tree(trainer.final_state.batch_stats))
    assert sorted(final) == sorted(port_final)
    for key, theirs in final.items():
        np.testing.assert_allclose(port_final[key].numpy(), theirs.numpy(), rtol=1e-3,
                                   atol=2e-3, err_msg=key)
    # JAX's own checkpoint beside the port's, which the port reads in turn
    assert checkpoint_steps(str(log_dir)) == [SAVED, STEPS]
    assert restore_checkpoint(str(log_dir))["step"] == STEPS


def _infer_common(tmp_path, log_dir):
    params_file = tmp_path / "params.json"
    params_file.write_text(json.dumps({"filter_count": 32, "drop_out_ratio": 0.0}))
    return ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--neighborhood=1",
            f"--algorithm_param_path={params_file}", f"--base_log_path={log_dir}"]


def test_the_jax_infer_cli_on_a_port_log_dir_writes_the_port_tiffs(tmp_path_factory, tmp_path):
    _, port_log, _, _ = _port_run("adam", tmp_path_factory)
    common = _infer_common(tmp_path, port_log)
    for domain in ("all", "sample", "gt"):
        jax_infer_app.main(common + [f"--domain={domain}",
                                     f"--output_path={tmp_path / ('jax_' + domain)}"])
        infer_for_classification.main(common + [f"--domain={domain}", "--device=cpu",
                                                f"--output_path={tmp_path / domain}"])
        for name in ("result_raw.tif", "result_colorized.tif"):
            np.testing.assert_array_equal(_tiff(tmp_path / ("jax_" + domain) / name),
                                          _tiff(tmp_path / domain / name))


# ------------------------------------------------------- older log dirs ----

def test_a_state_pt_log_dir_still_resumes_and_classifies(tmp_path_factory, tmp_path):
    """The layout the port wrote before orbax: ``checkpoints/<step>/state.pt``
    holding ``TrainState.checkpoint()``, written here with ``torch.save``."""
    params, port_log, port_losses, port_final = _port_run("adam", tmp_path_factory)
    result, _ = _fit(_port_trainer(params), SAVED)
    legacy = tmp_path / "legacy"
    (legacy / "checkpoints" / str(SAVED)).mkdir(parents=True)
    torch.save(result.final_state.checkpoint(), legacy / "checkpoints" / str(SAVED) / "state.pt")
    common = _infer_common(tmp_path, legacy)
    infer_for_classification.main(common + ["--domain=all", "--device=cpu",
                                            f"--output_path={tmp_path / 'legacy_map'}"])
    infer_for_classification.main(_infer_common(tmp_path, port_log) + [
        "--domain=all", "--device=cpu", f"--output_path={tmp_path / 'orbax_map'}"])
    np.testing.assert_array_equal(_tiff(tmp_path / "legacy_map" / "result_raw.tif"),
                                  _tiff(tmp_path / "orbax_map" / "result_raw.tif"))

    resumed, losses = _fit(_port_trainer(params, log_dir=str(legacy),
                                         save_checkpoint_steps=SAVED), STEPS)
    assert resumed.steps_run == STEPS - SAVED
    assert losses == port_losses[SAVED:]
    for key, value in port_final.items():
        assert torch.equal(resumed.final_state.module.state_dict()[key], value), key
    assert checkpoint_steps(str(legacy)) == [SAVED, STEPS]
    assert not holds_orbax_step(str(legacy), SAVED) and holds_orbax_step(str(legacy), STEPS)


# -------------------------------------------------------------- file bytes ----

def _as_held(tree, metadata, path=()):
    """``read_orbax``'s tree with each leaf as JAX held it when it saved."""
    if isinstance(tree, dict):
        return {k: _as_held(v, metadata, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_held(v, metadata, path + (str(i),)) for i, v in enumerate(tree)]
    held = metadata[str(path)]["value_metadata"]["value_type"] == "jax.Array"
    return torch.from_numpy(tree) if held else tree


def _file_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def compare_file_bytes():
    """Print one JSON line: for the committed HYPELCNN-480 step and a
    full-entropy one, the bytes of JAX's files and of the port's re-save of
    the same tree (with its metadata equal to JAX's), the arrays' bytes and
    the re-save's seconds on this host."""
    (fixture,) = (HYPELCNN_FIXTURE / "checkpoints").iterdir()
    record = {}
    with tempfile.TemporaryDirectory() as scratch:
        scratch = Path(scratch)
        for name, step_dir in (("fixture", fixture), ("full_entropy",
                                _write_full_entropy_checkpoint(scratch / "jax"))):
            tree = orbax.read_orbax(str(step_dir))
            metadata = _metadata(step_dir)
            start = time.perf_counter()
            ours = Path(save_checkpoint(str(scratch / name),
                                        _as_held(tree, metadata["tree_metadata"])))
            seconds = time.perf_counter() - start
            assert _metadata(ours) == metadata
            record[name] = {"jax_file_bytes": _file_bytes(step_dir),
                            "port_file_bytes": _file_bytes(ours),
                            "array_bytes": orbax.tree_bytes(tree), "port_save_seconds": seconds}
    print(json.dumps(record), flush=True)
