"""The PyTorch port's tensor parallelism (the mesh's model axis) on gloo ranks on the CPU.

Two worlds are started, each once for the module (``tests/torch_ranks.py``
spawns ``tests/torch_mp_worker.py``): two ranks as a (1, 2) mesh and four
as a (2, 2) mesh. This process runs the one-rank references with the same
worker functions, and the JAX package's own placement and its (1, 2) mesh
(two of the session's eight virtual CPU devices). Widths are at least 64,
so that kernels shard.

Tolerances, as measured:

- a mesh against one rank: as ``test_torch_multiprocess.py`` holds two
  ranks: the first step's loss ``rel=1e-6`` (measured: equal, or within
  1.6e-7 on (2, 2)), every later loss ``rel=1e-5`` (measured 4.1e-7); every
  final parameter and batch-norm statistic: its mean error within 5e-5
  (measured 1.2e-5) and its largest within Adam's reach, ``2 * lr`` a step
  (measured 8.6e-5, CAP's 1.9e-3); test and validation OA within 0.02
  (measured: equal, bfloat16's 6.5e-3). The sharded product differs from the whole one only in
  the order of its float sums. CAP's later losses ``rel=1e-3``: at this
  width (64 features, 128 primary channels) the reordered sums grow about
  five times a step through its routing and Adam's first steps, whatever
  the mesh (measured at step 4: 6.2e-5 on two data ranks, 7.4e-6 on four,
  1.5e-5 on (1, 2), 2.6e-4 on (2, 2), 1.9e-5 on (1, 4)). bfloat16 takes one step, held as
  the float32 cases are (measured: the loss equal, the states' mean error
  3.1e-5, the largest 2.0e-3, one flipped sign in Adam's first update,
  ``lr * sign(g)``): a sharded product's input gradient is the sum of the
  model ranks' partial gradients, each already rounded to bfloat16, so a
  gradient near zero may change sign, and the second step's loss differs
  by 2.5e-3 already;
- every rank reports the same losses, and the tensors a rank keeps whole
  (everything but the sharded kernels) are bit for bit the same on every
  rank;
- against JAX's (1, 2) mesh, one HYPELCNN step: the loss ``rel=1e-3`` (JAX's
  own ``tests/test_parallel.py`` TP test; measured 4.8e-7) and every
  parameter as ``test_torch_train_loop.py`` holds them (``rtol=1e-3,
  atol=2e-3``, mean error below 2e-4; measured: largest 5.4e-5, mean
  4.3e-6);
- a checkpoint resumed across meshes (TP to TP, TP to one rank, one rank to
  TP) against an uninterrupted one-rank run: the losses ``rtol=1e-5``, the
  states as above; the TP checkpoint's tensors and Adam moments are full
  width, the moments within 1e-6 of one rank's (measured 6.3e-8); the JAX
  package's orbax checkpoint resumed on (1, 2) as one rank resumes it, held
  the same way;
- sweep maps equal pixel for pixel; cycle_gan's losses ``rel=1e-4``, as
  ``test_torch_multiprocess_gan.py`` holds two ranks (measured: equal on
  both meshes).
"""

import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hypelcnn_tpu.core.registry import get_importer_from_name as jax_get_importer
from hypelcnn_tpu.models.hypelcnn import HYPELCNNModel as JaxHYPELCNNModel
from hypelcnn_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from hypelcnn_tpu.parallel.mesh import shard_params_for_tp as jax_shard_params_for_tp
from hypelcnn_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from hypelcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from hypelcnn_tpu.train.state import TrainState as JaxTrainState
from hypelcnn_tpu.train.trainer import ClassificationTrainer as JaxClassificationTrainer
from hypelcnn_tpu_torch.compat.flax_to_torch import ORBAX_TREE, variables_to_state_dict
from hypelcnn_tpu_torch.compat.orbax import read_orbax
from hypelcnn_tpu_torch.parallel.mesh import Mesh, create_mesh, shard_module_, tp_sharded_keys
from hypelcnn_tpu_torch.train.checkpoint import (
    checkpoint_steps,
    holds_orbax_step,
    restore_checkpoint,
)
from torch_mp_worker import run_gan, run_sweep, run_train
from torch_parity import init_jax, numpy_tree, torch_module
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
CLASSES, CHANNELS, BATCH, STEPS = 5, 13, 16, 4
LEARNING_RATE = 1e-3
HYPELCNN = {"filter_count": 128, "drop_out_ratio": 0.0}
CAP = {"feature_count": 64, "primary_capsule_count": 8}
CASES = {
    "concnn": ("CONCNNModel", {"filter_count": 64, "drop_out_ratio": 1.0}, False),
    "hypelcnn": ("HYPELCNNModel", HYPELCNN, False),
    "cap": ("CAPModel", CAP, False),
    "hypelcnn_dropout_augment": ("HYPELCNNModel", {**HYPELCNN, "drop_out_ratio": 0.5}, True),
    "hypelcnn_bf16": ("HYPELCNNModel", {**HYPELCNN, "compute_dtype": "bfloat16"}, True),
    "hypelcnn_remat": ("HYPELCNNModel", {**HYPELCNN, "drop_out_ratio": 0.5, "remat": True},
                       True),
}
LOSS_RTOL = {"cap": 1e-3}
CASE_STEPS = {"hypelcnn_bf16": 1}
# the four families at widths where kernels shard; HYPELCNN's 66-wide
# encoder shards at tp = 2 and not at tp = 4, as HYPELCNN-1200's 74 and 222 do
PLACEMENT = {
    "HYPELCNNModel": {"filter_count": 264},
    "CONCNNModel": {"filter_count": 64},
    "DUALCNNModel": {"filter_count": 128},
    "CAPModel": CAP,
}
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}  # name: (world, model_parallel)
GAN_CONFIG = {"patches": 3, "embedded_feat_size": 2}
GAN_BANDS, GAN_BATCH, GAN_STEPS = 12, 16, 3


def _train_task(name, model, params, augment, steps=STEPS, model_parallel=1, **extra):
    return {"kind": "train", "name": name, "model": model,
            "params": {**params, "learning_rate": LEARNING_RATE}, "spec": SPEC,
            "train_ratio": 0.5, "test_ratio": 0.1, "neighborhood": 1, "batch": BATCH,
            "steps": steps, "augment": augment, "model_parallel": model_parallel, **extra}


def _gan_task(name, batches, model_parallel):
    return {"kind": "gan", "name": name, "family": "cycle_gan", "bands": GAN_BANDS,
            "config": GAN_CONFIG, "max_steps": 2 * GAN_STEPS, "steps": GAN_STEPS,
            "batches": batches, "model_parallel": model_parallel}


def _sweep_task(name, weights, model_parallel):
    return {"kind": "sweep", "name": name, "model": "HYPELCNNModel", "params": HYPELCNN,
            "spec": SPEC, "neighborhood": 1, "classes": CLASSES, "state_dict": weights,
            "batch_rows": 16, "model_parallel": model_parallel}


def _jax_mesh(model_parallel: int, data: int = 1) -> JaxMesh:
    devices = np.array(jax.devices()[:data * model_parallel]).reshape(data, model_parallel)
    return JaxMesh(devices, (DATA_AXIS, MODEL_AXIS))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_ranks")


@pytest.fixture(scope="module")
def one_rank():
    """One-rank runs of the tasks, each made once."""
    cache = {}

    def run(task):
        key = task["name"]
        if key not in cache:
            runner = {"train": run_train, "sweep": run_sweep, "gan": run_gan}[task["kind"]]
            cache[key] = runner({**task, "model_parallel": 1}, create_mesh())
        return cache[key]
    return run


@pytest.fixture(scope="module")
def jax_tp_step(work):
    """One HYPELCNN step on JAX's (1, 2) mesh, from its init."""
    np.random.seed(0)
    data = jax_get_importer("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    params = {**JaxHYPELCNNModel().default_params(), **HYPELCNN, "learning_rate": LEARNING_RATE}
    trainer = JaxClassificationTrainer(
        model=JaxHYPELCNNModel(), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, mesh=_jax_mesh(2))
    init = trainer.init_state()
    path = work / "hypelcnn_jax_init.pt"
    torch.save(variables_to_state_dict(numpy_tree(init.params), numpy_tree(init.batch_stats)),
               path)
    result = trainer.fit(1, BATCH, log_every=1)
    final = variables_to_state_dict(numpy_tree(trainer.final_state.params),
                                    numpy_tree(trainer.final_state.batch_stats))
    return str(path), result.loss, final


@pytest.fixture(scope="module")
def jax_log(work):
    """A JAX run's log dir with its orbax checkpoint at STEPS (HYPELCNN on one
    device), copied for a (1, 2) resume and a one-rank resume."""
    np.random.seed(0)
    data = jax_get_importer("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    params = {**JaxHYPELCNNModel().default_params(), **HYPELCNN, "learning_rate": LEARNING_RATE}
    trainer = JaxClassificationTrainer(
        model=JaxHYPELCNNModel(), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, log_dir=str(work / "jax_log"), save_checkpoint_steps=STEPS)
    trainer.fit(STEPS, BATCH)
    for copy in ("jax_to_tp", "jax_to_one"):
        shutil.copytree(work / "jax_log", work / copy)
    return work


@pytest.fixture(scope="module")
def sweep_weights(work):
    """HYPELCNN's weights with random batch-norm state (``tests/torch_parity.py``)."""
    _, flax_params, batch_stats = init_jax("HYPELCNNModel", CLASSES, HYPELCNN,
                                           (3, 3, CHANNELS), seed=0)
    module = torch_module("HYPELCNNModel", flax_params, batch_stats, CLASSES, HYPELCNN,
                          (3, 3, CHANNELS))
    path = work / "sweep.pt"
    torch.save(module.state_dict(), path)
    return str(path)


@pytest.fixture(scope="module")
def gan_batches(work):
    rng = np.random.default_rng(1)
    batches = {}
    for step in range(GAN_STEPS):
        x = rng.uniform(0.2, 1.0, (GAN_BATCH, 1, 1, GAN_BANDS)).astype(np.float32)
        batches[f"x{step}"] = x
        batches[f"y{step}"] = (x * rng.uniform(0.3, 0.6, (1, 1, 1, GAN_BANDS))).astype(
            np.float32)
    np.savez(work / "gan_batches.npz", **batches)
    return str(work / "gan_batches.npz")


def _checkpoint_tasks(work, one_rank):
    """TP to TP: a (1, 2) run checkpoints at STEPS and a second (1, 2) run
    resumes it to 2 x STEPS; one rank to TP: a one-rank checkpoint at STEPS
    resumed by (1, 2). (TP to one rank is resumed in the test.)"""
    case = CASES["hypelcnn_dropout_augment"]
    one_rank(_train_task("one_checkpointed", *case, log_dir=str(work / "one_log"),
                         save_checkpoint_steps=STEPS))
    return [
        _train_task("tp_checkpointed", *case, model_parallel=2, log_dir=str(work / "tp_log"),
                    save_checkpoint_steps=STEPS),
        _train_task("tp_resumed", *case, steps=2 * STEPS, model_parallel=2,
                    log_dir=str(work / "tp_log"), save_checkpoint_steps=STEPS),
        _train_task("one_to_tp", *case, steps=2 * STEPS, model_parallel=2,
                    log_dir=str(work / "one_log"), save_checkpoint_steps=STEPS),
    ]


@pytest.fixture(scope="module")
def ranks(work, one_rank, jax_tp_step, sweep_weights, gan_batches, jax_log):
    """Every task of each world, in one launch of its ranks; the results by
    mesh name, rank 0 first."""
    out = {}
    for name, (world, mp) in MESHES.items():
        tasks = [_train_task(case, *spec, steps=CASE_STEPS.get(case, STEPS), model_parallel=mp)
                 for case, spec in CASES.items()]
        tasks.append(_sweep_task("sweep", sweep_weights, mp))
        tasks.append(_gan_task("gan", gan_batches, mp))
        if name == "1x2":
            tasks.append(_train_task("from_jax", *CASES["hypelcnn"], steps=1, model_parallel=2,
                                     state_dict=jax_tp_step[0]))
            tasks += _checkpoint_tasks(work, one_rank)
            tasks.append(_train_task("jax_to_tp", *CASES["hypelcnn"], steps=2 * STEPS,
                                     model_parallel=2, log_dir=str(jax_log / "jax_to_tp"),
                                     save_checkpoint_steps=STEPS))
        out[name] = run_ranks(tasks, work / f"out_{name}", world=world)
    return out


def _assert_states_close(ours, theirs, steps, what):
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        diff = (ours[key] - value).abs()
        assert float(diff.mean()) <= 5e-5, f"{what}: {key} differs by {float(diff.mean())}"
        assert float(diff.max()) <= 2 * LEARNING_RATE * steps, \
            f"{what}: {key} differs by {float(diff.max())}"


def _flax_paths(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flax_paths(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _nested(leaves):
    tree = {}
    for path, value in leaves:
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


@pytest.mark.parametrize("model_parallel", [2, 4])
@pytest.mark.parametrize("model_name", list(PLACEMENT))
def test_sharded_keys_are_jax_placement(model_name, model_parallel):
    """The port shards exactly the kernels that JAX's shard_params_for_tp
    puts on the model axis, mapped through the weight bridge."""
    params = PLACEMENT[model_name]
    _, flax_params, batch_stats = init_jax(model_name, CLASSES, params, (3, 3, CHANNELS))
    placed = jax_shard_params_for_tp(flax_params, _jax_mesh(model_parallel))
    on_model = [(path, np.asarray(leaf)) for path, leaf in _flax_paths(placed)
                if MODEL_AXIS in tuple(leaf.sharding.spec)]
    expected = sorted(variables_to_state_dict(_nested(on_model)))
    assert expected  # the width makes kernels shard
    module = torch_module(model_name, flax_params, batch_stats, CLASSES, params,
                          (3, 3, CHANNELS))
    full = {k: v.clone() for k, v in module.state_dict().items()}
    assert sorted(tp_sharded_keys(full, model_parallel)) == expected
    mesh = Mesh(model_parallel, model_parallel - 1, model_parallel=model_parallel)
    assert sorted(shard_module_(module, mesh)) == expected
    for key, value in module.state_dict().items():
        share = full[key].shape[0] // model_parallel
        assert torch.equal(value, full[key][-share:] if key in expected else full[key]), key


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tensor_parallel_trains_as_one_rank(ranks, one_rank, mesh, case):
    steps = CASE_STEPS.get(case, STEPS)
    one = one_rank(_train_task(case, *CASES[case], steps=steps))
    results = [r[case] for r in ranks[mesh]]
    first = results[0]
    assert first["sharded"]
    for other in results[1:]:
        assert other["losses"] == first["losses"]
        for key, value in first["own"].items():
            assert torch.equal(other["own"][key], value), key
    assert len(first["losses"]) == steps == first["step"]
    assert first["losses"][0] == pytest.approx(one["losses"][0], rel=1e-6)
    np.testing.assert_allclose(first["losses"], one["losses"], rtol=LOSS_RTOL.get(case, 1e-5))
    _assert_states_close(first["state"], one["state"], steps, case)
    assert first["test_oa"] == pytest.approx(one["test_oa"], abs=0.02)
    assert first["val_oa"] == pytest.approx(one["val_oa"], abs=0.02)


def test_hypelcnn_step_matches_jax_tensor_parallel_mesh(ranks, jax_tp_step):
    _, jax_loss, jax_final = jax_tp_step
    ours = ranks["1x2"][0]["from_jax"]
    assert ours["losses"][0] == pytest.approx(jax_loss, rel=1e-3)
    for key, theirs in jax_final.items():
        mine = ours["state"][key]
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-3, atol=2e-3,
                                   err_msg=key)
        assert float((mine - theirs).abs().mean()) < 2e-4, key


def _assert_resumed(resumed, straight, what):
    assert resumed["step"] == 2 * STEPS and len(resumed["losses"]) == STEPS
    np.testing.assert_allclose(resumed["losses"], straight["losses"][STEPS:], rtol=1e-5,
                               err_msg=what)
    _assert_states_close(resumed["state"], straight["state"], 2 * STEPS, what)


def test_checkpoint_moves_between_meshes(ranks, one_rank, work):
    """TP to TP, TP to one rank and one rank to TP, each against an
    uninterrupted one-rank run; a TP checkpoint holds full tensors and
    full Adam moments."""
    case = CASES["hypelcnn_dropout_augment"]
    straight = one_rank(_train_task("straight", *case, steps=2 * STEPS))
    chief = ranks["1x2"][0]
    assert chief["tp_resumed"]["step"] == 2 * STEPS
    _assert_resumed(chief["tp_resumed"], straight, "TP to TP")
    _assert_resumed(chief["one_to_tp"], straight, "one rank to TP")

    tp_dir, one_dir = work / "tp_log", work / "one_log"
    assert checkpoint_steps(str(tp_dir)) == [STEPS, 2 * STEPS]
    resumed_dir, one_copy = work / "tp_to_one", work / "one_at_steps"
    for source, copy in ((tp_dir, resumed_dir), (one_dir, one_copy)):
        shutil.copytree(source, copy)
        shutil.rmtree(copy / "checkpoints" / str(2 * STEPS))
    at_steps = restore_checkpoint(str(resumed_dir))
    one_at_steps = restore_checkpoint(str(one_copy))
    assert at_steps["step"] == STEPS and holds_orbax_step(str(tp_dir), STEPS)
    _assert_states_close(at_steps["state_dict"], one_at_steps["state_dict"], STEPS, "saved")
    sharded = set(chief["tp_checkpointed"]["sharded"])
    names = list(one_at_steps["state_dict"])
    params = [n for n in names if n.rpartition(".")[2] not in ("mean", "var")]
    for leaf in ("mu", "nu"):  # Adam's moments, saved as JAX's at full width
        moments, theirs = (variables_to_state_dict(saved[ORBAX_TREE]["opt_state"][0][leaf])
                           for saved in (at_steps, one_at_steps))
        assert sorted(moments) == sorted(params)
        for name in params:
            assert moments[name].shape == one_at_steps["state_dict"][name].shape
            torch.testing.assert_close(moments[name], theirs[name], rtol=0, atol=1e-6)
    assert any(name in sharded for name in params)

    resumed = one_rank(_train_task("tp_to_one", *case, steps=2 * STEPS,
                                   log_dir=str(resumed_dir), save_checkpoint_steps=STEPS))
    _assert_resumed(resumed, straight, "TP to one rank")
    assert restore_checkpoint(str(resumed_dir))["step"] == 2 * STEPS


def test_jax_restores_a_model_axis_checkpoint_at_full_width(ranks, work):
    """The (1, 2) chief's orbax step, written after the shards were
    gathered, is what a one-device JAX run writes: the JAX package's restore,
    with the template its trainer builds, reads every leaf at full width, bit
    for bit."""
    model, params, _ = CASES["hypelcnn_dropout_augment"]
    params = {**JaxHYPELCNNModel().default_params(), **params, "learning_rate": LEARNING_RATE}
    _, flax_params, batch_stats = init_jax(model, CLASSES, params, (3, 3, CHANNELS))
    tx, _ = jax_build_optimizer(params)
    template = JaxTrainState.create(*(jax.tree_util.tree_map(jax.numpy.asarray, tree)
                                      for tree in (flax_params, batch_stats)), tx)
    tp_dir = work / "tp_log"
    assert ranks["1x2"][0]["tp_resumed"]["step"] == 2 * STEPS
    restored = jax_restore_checkpoint(str(tp_dir), template)
    assert int(restored.step) == 2 * STEPS
    tree = read_orbax(str(tp_dir / "checkpoints" / str(2 * STEPS)))
    leaves = jax.tree_util.tree_leaves_with_path(restored)
    assert len(leaves) == len(jax.tree_util.tree_leaves(template))
    for path, value in leaves:
        ours = tree
        for entry in path:  # a dict key, a dataclass field or a tuple index
            attr = next(a for a in ("key", "name", "idx") if hasattr(entry, a))
            ours = ours[getattr(entry, attr)]
        theirs = np.asarray(value)
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype, path
        assert ours.tobytes() == theirs.tobytes(), path


def test_a_jax_checkpoint_resumes_on_a_model_axis(ranks, one_rank, jax_log):
    """The JAX package's orbax checkpoint (full-width arrays) resumed on a
    (1, 2) mesh as one rank resumes it: ``TrainState.restore`` converts it,
    then cuts each rank's slice."""
    one = one_rank(_train_task("jax_to_one", *CASES["hypelcnn"], steps=2 * STEPS,
                               log_dir=str(jax_log / "jax_to_one"), save_checkpoint_steps=STEPS))
    tp = ranks["1x2"][0]["jax_to_tp"]
    assert tp["step"] == one["step"] == 2 * STEPS and len(tp["losses"]) == STEPS
    np.testing.assert_allclose(tp["losses"], one["losses"], rtol=1e-5)
    _assert_states_close(tp["state"], one["state"], STEPS, "a JAX checkpoint on (1, 2)")
    assert checkpoint_steps(str(jax_log / "jax_to_tp")) == [STEPS, 2 * STEPS]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tensor_parallel_sweep_is_the_one_rank_map(ranks, one_rank, sweep_weights, mesh):
    one = one_rank(_sweep_task("sweep", sweep_weights, 1))["map"]
    assert len(np.unique(one.numpy())) > 1
    for rank in ranks[mesh]:
        assert torch.equal(rank["sweep"]["map"], one)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gan_on_a_model_axis_trains_as_one_rank(ranks, one_rank, gan_batches, mesh):
    """A GAN trainer keeps its networks replicated on a mesh with a model
    axis; the model ranks of one data index train the same rows."""
    one = one_rank(_gan_task("gan", gan_batches, 1))
    results = [r["gan"] for r in ranks[mesh]]
    for other in results[1:]:
        assert other["metrics"] == results[0]["metrics"]
        for key, value in results[0]["state"].items():
            assert torch.equal(other["state"][key], value), key
    for step, (mine, theirs) in enumerate(zip(results[0]["metrics"], one["metrics"])):
        for name, value in theirs.items():
            assert mine[name] == pytest.approx(value, rel=1e-4), (step, name)
    assert results[0]["translate_same"]
