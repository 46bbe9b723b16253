"""The PyTorch port's data parallelism on two gloo ranks on the CPU.

The ranks are separate processes (``tests/torch_mp_worker.py`` through
``tests/torch_ranks.py``), started once for the module; this process runs
the one-rank references with the same worker functions and the JAX
package's two-device mesh (two of the session's eight virtual CPU devices).

Tolerances:

- two ranks against one: the first step's loss ``rel=1e-6`` (measured:
  equal or within 5.5e-7), every later logged loss ``rel=1e-5`` (measured
  5.5e-7), CAP's ``rel=1e-4`` (measured 3.9e-5: its first-step gradients
  agree to 1.2e-5 relative, its batch norm's ``E[x^2] - E[x]^2`` and the
  routing sums magnify the order of the float sums, and Adam's first
  steps, about ``lr * sign(g)``, magnify it again where a gradient is near
  zero). Every final parameter and batch-norm statistic: its mean error
  within 5e-5 (measured 1.5e-5) and its largest within Adam's reach,
  ``2 * lr`` a step; test and validation OA within 0.02 (CAP's drains pad
  to a multiple of the ranks, as JAX's do, so its batch statistics see one
  more window);
- both ranks hold the same state bit for bit, and report the same losses;
- against JAX's mesh, CAP's one step: the loss ``rel=1e-5`` (measured
  2.5e-6) and every
  parameter as the single-device trajectory test holds them
  (``test_torch_train_loop.py``: ``rtol=1e-3, atol=2e-3``, mean error below
  2e-4);
- class maps equal, pixel for pixel.
"""

import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hypelcnn_tpu.core.registry import get_importer_from_name as jax_get_importer
from hypelcnn_tpu.data.loaders.synthetic import SyntheticDataLoader as JaxSyntheticDataLoader
from hypelcnn_tpu.infer.scene_inference import predict_full_scene as jax_predict_full_scene
from hypelcnn_tpu.models.cap import CAPModel as JaxCAPModel
from hypelcnn_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from hypelcnn_tpu.train.trainer import ClassificationTrainer as JaxClassificationTrainer
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.parallel.mesh import create_mesh
from torch_mp_worker import run_sweep, run_train
from torch_parity import init_jax, numpy_tree, torch_module
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
ODD_SPEC = "synthetic://?h=22&w=33&bands=12&classes=5&seed=3"  # bands of 165 pixels
CLASSES, CHANNELS, BATCH, STEPS = 5, 13, 16, 4
CAP = {"feature_count": 16, "primary_capsule_count": 4}
LEARNING_RATE = 1e-3
LOSS_RTOL = {"cap": 1e-4}
CASES = {
    "concnn": ("CONCNNModel", {"filter_count": 8, "drop_out_ratio": 1.0}, False),
    "hypelcnn": ("HYPELCNNModel", {"filter_count": 32, "drop_out_ratio": 0.0}, False),
    "cap": ("CAPModel", CAP, False),
    "hypelcnn_dropout_augment": ("HYPELCNNModel", {"filter_count": 32, "drop_out_ratio": 0.5},
                                 True),
}


def _train_task(name, model, params, augment, steps=STEPS, **extra):
    return {"kind": "train", "name": name, "model": model,
            "params": {**params, "learning_rate": LEARNING_RATE}, "spec": SPEC,
            "train_ratio": 0.5, "test_ratio": 0.1, "neighborhood": 1, "batch": BATCH,
            "steps": steps, "augment": augment, **extra}


def _jax_mesh():
    return JaxMesh(np.array(jax.devices()[:2]).reshape(2, 1), (DATA_AXIS, MODEL_AXIS))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


@pytest.fixture(scope="module")
def cap_jax_step(work):
    """One CAP step on JAX's two-device mesh, from its init."""
    np.random.seed(0)
    data = jax_get_importer("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    params = {**JaxCAPModel().default_params(), **CAP, "learning_rate": LEARNING_RATE}
    trainer = JaxClassificationTrainer(
        model=JaxCAPModel(), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, mesh=_jax_mesh())
    init = trainer.init_state()
    path = work / "cap_init.pt"
    torch.save(variables_to_state_dict(numpy_tree(init.params), numpy_tree(init.batch_stats)),
               path)
    result = trainer.fit(1, BATCH, log_every=1)
    final = variables_to_state_dict(numpy_tree(trainer.final_state.params),
                                    numpy_tree(trainer.final_state.batch_stats))
    return str(path), result.loss, final


@pytest.fixture(scope="module")
def cap_sweep_weights(work):
    """CAP's weights with random batch-norm state (``tests/torch_parity.py``)."""
    jax_module, flax_params, batch_stats = init_jax("CAPModel", CLASSES, CAP, (3, 3, CHANNELS),
                                                    seed=5)
    module = torch_module("CAPModel", flax_params, batch_stats, CLASSES, CAP, (3, 3, CHANNELS))
    path = work / "cap_sweep.pt"
    torch.save(module.state_dict(), path)
    return str(path), jax_module, {"params": flax_params, "batch_stats": batch_stats}


def _sweep_task(name, spec, weights, batch_rows):
    return {"kind": "sweep", "name": name, "model": "CAPModel", "params": CAP, "spec": spec,
            "neighborhood": 1, "classes": CLASSES, "state_dict": weights,
            "batch_rows": batch_rows}


@pytest.fixture(scope="module")
def ranks(work, cap_jax_step, cap_sweep_weights):
    """Every two-rank task, in one launch of the two ranks."""
    tasks = [_train_task(name, *case) for name, case in CASES.items()]
    tasks.append(_train_task("checkpointed", *CASES["hypelcnn_dropout_augment"],
                             log_dir=str(work / "log"), save_checkpoint_steps=STEPS))
    tasks.append(_train_task("late_follower", *CASES["hypelcnn"], log_dir=str(work / "late"),
                             save_checkpoint_steps=STEPS // 2, late_follower=True))
    tasks.append(_train_task("cap_from_jax", *CASES["cap"], steps=1,
                             state_dict=cap_jax_step[0]))
    tasks.append(_sweep_task("cap_sweep", SPEC, cap_sweep_weights[0], 16))
    tasks.append(_sweep_task("cap_sweep_odd", ODD_SPEC, cap_sweep_weights[0], 5))
    return run_ranks(tasks, work / "out")


def _one_rank(task):
    return (run_train if task["kind"] == "train" else run_sweep)(task, create_mesh())


def _assert_states_close(ours, theirs, steps, what):
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        diff = (ours[key] - value).abs()
        assert float(diff.mean()) <= 5e-5, f"{what}: {key} differs by {float(diff.mean())}"
        assert float(diff.max()) <= 2 * LEARNING_RATE * steps, \
            f"{what}: {key} differs by {float(diff.max())}"


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_train_as_one(ranks, case):
    one = _one_rank(_train_task(case, *CASES[case]))
    first, second = (r[case] for r in ranks)
    assert first["losses"] == second["losses"]
    for key, value in first["state"].items():
        assert torch.equal(second["state"][key], value), key
    assert len(first["losses"]) == STEPS == first["step"]
    assert first["losses"][0] == pytest.approx(one["losses"][0], rel=1e-6)
    np.testing.assert_allclose(first["losses"], one["losses"], rtol=LOSS_RTOL.get(case, 1e-5))
    _assert_states_close(first["state"], one["state"], STEPS, case)
    assert first["test_oa"] == pytest.approx(one["test_oa"], abs=0.02)
    assert first["val_oa"] == pytest.approx(one["val_oa"], abs=0.02)


def test_only_the_chief_writes(ranks, work):
    first, second = (r["checkpointed"] for r in ranks)
    assert first["losses"] == second["losses"]
    log = work / "log"
    events = sorted(p.name for p in log.iterdir() if p.name.startswith("events.out"))
    assert len(events) == 1 and events[0].endswith(f".{first['pid']}")
    assert sorted(p.name for p in log.iterdir()) == sorted(
        ["checkpoints", "summaries.jsonl", *events])
    assert sorted(p.name for p in (log / "checkpoints").iterdir()) == [str(STEPS)]
    logged = [line for line in (log / "summaries.jsonl").read_text().splitlines()
              if '"tag": "loss"' in line]
    assert len(logged) == STEPS  # one writer: each step's loss once


def test_a_rank_that_saves_after_the_chief_wrote_passes_every_barrier(ranks, work):
    """Whether a rank saves is decided without reading the log dir: a rank
    that comes to a save after the chief has written that step still meets
    the chief at its barrier, and the runs go on as one."""
    first, second = (r["late_follower"] for r in ranks)
    assert first["barriers"] == second["barriers"] == 2  # the saves at STEPS / 2 and STEPS
    assert first["losses"] == second["losses"]
    assert first["test_oa"] == second["test_oa"] and first["val_oa"] == second["val_oa"]
    assert sorted(p.name for p in (work / "late" / "checkpoints").iterdir()) == [
        str(STEPS // 2), str(STEPS)]


def test_two_rank_checkpoint_resumes_in_one_rank(ranks, work):
    """The checkpoint of the two-rank run resumes in one process to step 2 x
    STEPS and meets an uninterrupted one-rank run there."""
    log = work / "resumed"
    shutil.copytree(work / "log", log)
    case = CASES["hypelcnn_dropout_augment"]
    resumed = _one_rank(_train_task("resumed", *case, steps=2 * STEPS, log_dir=str(log),
                                    save_checkpoint_steps=STEPS))
    straight = _one_rank(_train_task("straight", *case, steps=2 * STEPS))
    assert resumed["step"] == 2 * STEPS and len(resumed["losses"]) == STEPS
    np.testing.assert_allclose(resumed["losses"], straight["losses"][STEPS:], rtol=1e-5)
    _assert_states_close(resumed["state"], straight["state"], 2 * STEPS, "resumed")


def test_cap_step_matches_jax_two_device_mesh(ranks, cap_jax_step):
    _, jax_loss, jax_final = cap_jax_step
    ours = ranks[0]["cap_from_jax"]
    assert ours["losses"][0] == pytest.approx(jax_loss, rel=1e-5)
    for key, theirs in jax_final.items():
        mine = ours["state"][key]
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-3, atol=2e-3,
                                   err_msg=key)
        assert float((mine - theirs).abs().mean()) < 2e-4, key


def test_cap_sharded_sweep_matches_jax_mesh(ranks, cap_sweep_weights):
    _, jax_module, variables = cap_sweep_weights
    expected = jax_predict_full_scene(jax_module, variables,
                                      JaxSyntheticDataLoader(SPEC).load_data(1, True),
                                      batch_rows=16, mesh=_jax_mesh())
    for rank in ranks:
        got = rank["cap_sweep"]["map"].numpy()
        assert len(np.unique(got)) > 1
        np.testing.assert_array_equal(got, expected)


def test_sweep_with_unequal_shares_and_overlapping_last_band(ranks, cap_sweep_weights):
    """165-pixel bands split 83 / 82, the last band overlapping the one
    before: CAP's batch statistics over the whole band all the same."""
    one = _one_rank(_sweep_task("one", ODD_SPEC, cap_sweep_weights[0], 5))["map"]
    assert len(np.unique(one.numpy())) > 1
    for rank in ranks:
        assert torch.equal(rank["cap_sweep_odd"]["map"], one)
