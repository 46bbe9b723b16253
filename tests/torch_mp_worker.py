"""One rank of the PyTorch port's multi-process tests (run through ``subprocess``).

    python tests/torch_mp_worker.py SPEC.json

The parent sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK`` as torchrun would; the rank joins the gloo group on the
CPU, runs every task of ``SPEC.json`` in order and writes
``<out>/rank<RANK>.pt``: one result a task, under its name. It imports
torch, numpy and the port only (``tests/test_torch_isolation.py``), so the
parent, which imports the JAX package, makes every JAX input and writes it
to files first.

Tasks (``kind``):

Every task runs on the mesh of every rank with ``model_parallel`` model
ranks (1 when the task does not say; each mesh is made once, in the order of
the tasks, so every rank makes the same subgroups).

- ``train``: a ``ClassificationTrainer`` on the mesh, its data read as the
  parent reads it; ``fit`` for ``steps`` steps with the loss logged every
  step. Result: the losses, test and validation OA, the final
  ``state_dict`` at full width (gathered over the model axis) and this
  rank's own replicated tensors, the sharded keys, the step, this
  process's id and how many barriers it passed. With ``late_follower``,
  every rank but the chief waits after each step it saves at until the
  chief's step directory is there, so it comes to the save after the
  chief has written.
- ``sweep``: ``predict_full_scene`` on the mesh, the module's wide kernels
  sharded over its model axis. Result: the class map.
- ``gan``: a GAN trainer of the registry on the mesh, ``train_step`` on the
  given global batches (with injected pool draws when given). Result: each
  step's metrics, the final networks, and whether ``translate`` gives the
  same pixels with and without the mesh.
- ``search``: a train CLI's ``main`` (``train`` or ``gan``) on ``argv`` in
  ``workdir``, its study seeded with ``seed``. Result: the study's trials,
  the searched params and log dir each episode was handed, and how many
  sqlite connections this rank opened.
"""

from __future__ import annotations

import functools
import json
import os
import random
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hypelcnn_tpu_torch.apps import gan_train_for_shadow, train_for_classification  # noqa: E402
from hypelcnn_tpu_torch.core.registry import get_importer_from_name, get_model_from_name  # noqa: E402
from hypelcnn_tpu_torch.data.augmentation import AugmentationInfo  # noqa: E402
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader  # noqa: E402
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict  # noqa: E402
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene  # noqa: E402
from hypelcnn_tpu_torch.parallel.distributed import (  # noqa: E402
    finalize_distributed,
    initialize_distributed,
    rank,
)
from hypelcnn_tpu_torch.parallel.mesh import create_mesh, shard_module_  # noqa: E402
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer  # noqa: E402
from hypelcnn_tpu_torch.tune import search  # noqa: E402

AUGMENTATION = AugmentationInfo(perform_rotation_augmentation=True,
                                perform_reflection_augmentation=True,
                                perform_spectral_augmentation=0.05)


def _load(path):
    return None if path is None else torch.load(path, weights_only=True)


def _counted(barrier, passed):
    barrier()
    passed.append(1)


def _late_step(train_step, task, state, tables, step):
    """``train_step``; at a step the trainer saves, then wait for the chief's checkpoint."""
    loss = train_step(state, tables, step)
    if (step + 1) % task["save_checkpoint_steps"] == 0:
        step_dir = os.path.join(task["log_dir"], "checkpoints", str(step + 1))
        deadline = time.monotonic() + 60
        while not os.path.isdir(step_dir):
            assert time.monotonic() < deadline, f"no checkpoint at {step_dir}"
            time.sleep(0.01)
    return loss


def run_train(task: dict, mesh) -> dict:
    np.random.seed(task.get("seed", 0))
    data = get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", task["spec"], train_ratio=task["train_ratio"],
        test_ratio=task["test_ratio"], neighborhood=task["neighborhood"])
    model = get_model_from_name(task["model"])
    trainer = ClassificationTrainer(
        model=model, class_count=data.class_count,
        algorithm_params={**model.default_params(), **task["params"]},
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, device="cpu", mesh=mesh,
        augmentation_info=AUGMENTATION if task.get("augment") else None,
        log_dir=task.get("log_dir"), save_checkpoint_steps=task.get("save_checkpoint_steps"),
        test_cadence=task.get("test_cadence", 100))
    if task.get("late_follower") and rank() != 0:
        trainer.train_step = functools.partial(_late_step, trainer.train_step, task)
    barriers = []
    mesh.barrier = functools.partial(_counted, type(mesh).barrier.__get__(mesh), barriers)
    losses = []
    try:
        result = trainer.fit(task["steps"], task["batch"], log_every=1,
                             progress_callback=lambda step, loss: losses.append(loss),
                             state_dict=_load(task.get("state_dict")))
    finally:
        del mesh.barrier
    state = result.final_state
    return {"losses": losses, "test_oa": result.test_accuracy,
            "val_oa": result.validation_accuracy, "step": state.step, "barriers": len(barriers),
            "state": state.checkpoint()["state_dict"],
            "own": {k: v.clone() for k, v in state.module.state_dict().items()
                    if k not in state.sharded},
            "sharded": sorted(state.sharded), "pid": os.getpid()}


def run_sweep(task: dict, mesh) -> dict:
    scene = SyntheticDataLoader(task["spec"]).load_data(task["neighborhood"], True)
    model = get_model_from_name(task["model"])
    module = model.create_module(task["classes"], {**model.default_params(), **task["params"]},
                                 scene.get_data_shape())
    module.load_state_dict(_load(task["state_dict"]), strict=True)
    shard_module_(module, mesh)
    return {"map": torch.from_numpy(predict_full_scene(
        module, scene, batch_rows=task["batch_rows"], device="cpu", mesh=mesh))}


def run_gan(task: dict, mesh) -> dict:
    def trainer_for(with_mesh):
        return get_trainer_dict(task["config"], task["bands"], task["max_steps"],
                                mesh=mesh if with_mesh else None)[task["family"]]

    trainer = trainer_for(True)
    initial = _load(task.get("state_dict"))
    state = trainer.init_state("cpu", torch.Generator().manual_seed(0), state_dict=initial)
    batches = np.load(task["batches"])
    draws = _load(task.get("draws"))
    metrics = []
    for step in range(task["steps"]):
        x = torch.from_numpy(batches[f"x{step}"])
        y = torch.from_numpy(batches[f"y{step}"])
        out = trainer.train_step(state, x, y, generator=torch.Generator().manual_seed(step),
                                 draws=draws[step] if draws else None)
        metrics.append({k: float(v) for k, v in out.items()})
    probe = torch.from_numpy(batches["x0"])
    translated = [torch.equal(trainer.translate(state.nets, probe, is_shadow),
                              trainer_for(False).translate(state.nets, probe, is_shadow))
                  for is_shadow in (True, False)]
    return {"metrics": metrics, "translate_same": all(translated),
            "state": {k: v.clone() for k, v in state.nets.state_dict().items()}}


def run_search(task: dict, mesh) -> dict:
    """The CLI's search with its study seeded, the episodes and sqlite
    connections of this rank recorded (the module attributes restored after)."""
    app = {"train": train_for_classification, "gan": gan_train_for_shadow}[task["app"]]
    episode_name = {"train": "perform_an_episode", "gan": "run_session"}[task["app"]]
    episode, create, connect = (getattr(app, episode_name), app.create_study,
                                search.sqlite3.connect)
    episodes, connects = [], []

    def recorded(*args, **kwargs):
        params = kwargs["params"] if "params" in kwargs else args[1]
        log = kwargs["base_log_path"] if "base_log_path" in kwargs else args[3]
        episodes.append({"params": {k: params[k] for k in task["searched"]}, "log": log})
        return episode(*args, **kwargs)

    def counted(*args, **kwargs):
        connects.append(args[0])
        return connect(*args, **kwargs)

    setattr(app, episode_name, recorded)
    app.create_study = functools.partial(create, seed=task["seed"])
    search.sqlite3.connect = counted
    before = os.getcwd()
    os.chdir(task["workdir"])
    random.seed(0)  # the run suffixes, which the chief alone draws
    try:
        study = app.main(task["argv"])
    finally:
        os.chdir(before)
        setattr(app, episode_name, episode)
        app.create_study = create
        search.sqlite3.connect = connect
    return {"trials": study.trials, "episodes": episodes, "connects": len(connects)}


RUNNERS = {"train": run_train, "sweep": run_sweep, "gan": run_gan, "search": run_search}


def main() -> None:
    with open(sys.argv[1], encoding="utf-8") as fid:
        spec = json.load(fid)
    torch.set_num_threads(1)
    assert initialize_distributed(device="cpu")
    meshes = {}
    results = {}
    for task in spec["tasks"]:
        model_parallel = task.get("model_parallel", 1)
        if model_parallel not in meshes:
            meshes[model_parallel] = create_mesh(model_parallel)
        results[task["name"]] = RUNNERS[task["kind"]](task, meshes[model_parallel])
    torch.save(results, os.path.join(spec["out"], f"rank{rank()}.pt"))
    create_mesh().barrier()
    finalize_distributed()


if __name__ == "__main__":
    main()
