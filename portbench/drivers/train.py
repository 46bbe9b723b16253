"""Closed loop of training steps: ``ClassificationTrainer.train_step``
back to back over its device tables, the step that the port's ``fit``
runs, with no hook and no checkpoint.

Set-up builds one trainer and one state from the benchmark's weights and
drives them through the checked steps and the warm-up steps; the window
goes on with that same state. The reference follows the checked steps:
each step's loss, the first gradient as the optimizer got it (Adam's first
moment after one step is ``(1 - b1)`` times it) and each parameter's change
over the checked steps, taken before the next step moves it.

Traffic parameters: ``batch``, ``train_targets`` (distinct pixels drawn
from the seed), ``augmentation`` (``rotation``, ``reflection``,
``spectral``), ``table_steps`` (rows of the index table, which the steps
walk round; more than a window runs today), ``checked_steps``,
``warmup_steps``, ``traced_steps``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from portbench import scene as scene_lib
from portbench.reference.common import (
    Adam,
    Norms,
    augment,
    epoch_rows,
    generator,
    padded_scene,
    precision,
    staircase_lr,
    windows,
)

ADAM_B1 = 0.9


def _norms(tensors: dict) -> dict:
    return {name: torch.linalg.vector_norm(t.double()).item() for name, t in tensors.items()}


def median_leaf_gap(program: dict, reference: dict, leaves) -> float:
    """The median over ``leaves`` of ``|program norm - reference norm|``, as a
    share of the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    median = float(np.median([reference[name] for name in leaves]))
    return float(np.median([abs(program[name] - reference[name]) / max(reference[name], median)
                            for name in leaves]))


class Driver:
    def __init__(self, env):
        self.env = env
        self.batch = env.traffic["batch"]
        self.trainer_seed = env.sub_seed("trainer", 31)

    def setup(self, mark) -> None:
        from hypelcnn_tpu_torch.core.registry import get_model_from_name
        from hypelcnn_tpu_torch.data.augmentation import AugmentationInfo
        from hypelcnn_tpu_torch.data.loaders.base import SampleSet
        from hypelcnn_tpu_torch.data.scene import Scene
        from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer

        env, traffic = self.env, self.env.traffic
        self.targets = scene_lib.training_targets(env.arrays.gt, traffic["train_targets"],
                                                  env.sub_seed("targets"))
        aug = traffic["augmentation"]
        none = np.zeros((0, 3), dtype=np.int32)
        trainer = ClassificationTrainer(
            model=get_model_from_name(env.config["model"]),
            class_count=env.config["scene"]["classes"], algorithm_params=env.config["params"],
            scene=Scene(env.arrays.casi, env.arrays.lidar, env.config["neighborhood"], True),
            sample_set=SampleSet(self.targets, none, none),
            augmentation_info=AugmentationInfo(
                perform_rotation_augmentation=aug["rotation"],
                perform_reflection_augmentation=aug["reflection"],
                perform_spectral_augmentation=aug["spectral"]),
            seed=self.trainer_seed, device=env.device)
        state = trainer.init_state(env.weights)
        tables = trainer.training_tables(traffic["table_steps"], self.batch)
        mark("program")
        names = [name for name, _ in state.module.named_parameters()]
        self.checked_losses = []
        for step in range(traffic["checked_steps"]):
            self.checked_losses.append(trainer.train_step(state, tables, step))
            if step == 0:  # a parameter the optimizer holds no moment of got no gradient
                moments = {name: state.optimizer.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) / (1 - ADAM_B1)
                    for name, p in state.module.named_parameters()}
                self.first_grad = _norms(moments)
        self.change = _norms({name: p.detach() - env.weights[name]
                              for name, p in state.module.named_parameters()})
        self.checked_losses = [float(loss) for loss in self.checked_losses]
        mark("checked steps")
        self.names = names
        self.trainer, self.state, self.tables = trainer, state, tables
        self.step = traffic["checked_steps"]
        for _ in range(traffic["warmup_steps"]):
            self._step()
        self._sync()
        mark("warm-up")

    def _sync(self) -> None:
        if self.env.device.type == "cuda":
            torch.cuda.synchronize(self.env.device)

    def _step(self) -> torch.Tensor:
        row = self.step % self.tables.indices.shape[0]  # a faster program wraps the table
        with record_function("portbench.train_step"):
            loss = self.trainer.train_step(self.state, self.tables, row)
        self.step += 1
        return loss

    def _mark(self):
        """A completion mark on the device (a host time off the card)."""
        if self.env.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def window(self, seconds: float):
        self._sync()
        start = time.perf_counter()
        marks = [self._mark()]
        losses = []
        while True:
            losses.append(self._step())
            marks.append(self._mark())
            if time.perf_counter() - start >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - start
        if self.env.device.type == "cuda":
            gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        steps = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return SimpleNamespace(
            metrics={"train_samples_per_s": steps * self.batch / elapsed,
                     "train_step_ms_p95": float(np.percentile(gaps, 95))},
            units=steps * self.batch, seconds=elapsed, iterations=steps,
            attempted=steps, failed=failed)

    def stretch(self):
        count = self.env.traffic["traced_steps"]
        for _ in range(count):
            self._step()
        return count * self.batch, count

    def release(self) -> None:
        del self.trainer, self.state, self.tables

    # ---- the judgement ----

    def reference_steps(self, tf32: bool = False, half_batch: bool = False) -> dict:
        """The reference's losses, first-gradient norms and changes over the
        checked steps, from the benchmark's weights and inputs; with
        ``half_batch`` each loss is the mean over the batch's first half
        (a planted fault)."""
        env = self.env
        n = env.config["neighborhood"]
        k = 2 * n + 1
        classes = env.config["scene"]["classes"]
        params = env.config["params"]
        scene = padded_scene(env.arrays.casi, env.arrays.lidar, n, env.device)
        steps = env.traffic["checked_steps"]
        rows = epoch_rows(self.trainer_seed, self.targets.shape[0], self.batch, steps)
        w = {name: t.clone() for name, t in env.weights.items()}
        leaves = [w[name].requires_grad_() for name in self.names]
        adam = Adam(leaves)
        losses, first = [], None
        targets = torch.from_numpy(self.targets.astype(np.int64)).to(env.device)
        with precision(tf32):
            for step in range(steps):
                picked = targets[torch.from_numpy(rows[step]).to(env.device)]
                x = windows(scene, picked[:, :2], k)
                x = augment(x, env.traffic["augmentation"],
                            generator(self.trainer_seed, "augment", step, env.device))
                onehot = torch.nn.functional.one_hot(picked[:, 2], classes).to(torch.float32)
                if half_batch:
                    x, onehot = x[: self.batch // 2], onehot[: self.batch // 2]
                logits, image = env.model.forward(
                    w, x, Norms("batch"), train=True,
                    dropout_gen=generator(self.trainer_seed, "dropout", step, env.device))
                loss = env.model.loss(logits, image, x, onehot)
                grads = torch.autograd.grad(loss, leaves)
                if first is None:
                    first = _norms(dict(zip(self.names, grads)))
                adam.step(grads, staircase_lr(params, step))
                losses.append(loss.item())
        change = _norms({name: w[name].detach() - env.weights[name] for name in self.names})
        return {"losses": losses, "first_grad": first, "change": change}

    def gaps(self, program: dict, reference: dict) -> dict:
        """The numbers compared.

        - ``loss_gap``: the largest relative gap of the losses of the first
          two checked steps. The third step's loss follows two Adam updates,
          which move the elements whose gradient is near Adam's epsilon by
          rounding: it swings by 16 times from seed to seed in sound runs.
        - ``grad_gap`` and ``change_gap``: the median leaf's gap of the
          norms of the first gradient, and of the change over the checked
          steps. The worst leaf is a small one (a batch-norm or conv bias,
          a reconstruction head's kernel: 15 to 6,075 elements) whose few
          elements near rounding swing it by 50 to 1,000 times from seed to
          seed. Leaves whose reference gradient is under a thousandth of the
          median leaf's move by rounding alone, and are left out of the
          change.
        """
        grad = reference["first_grad"]
        median = float(np.median(list(grad.values())))
        moving = [name for name in self.names if grad[name] >= 1e-3 * median]
        return {
            "loss_gap": max(abs(p - r) / abs(r) for p, r in
                            zip(program["losses"][:2], reference["losses"][:2])),
            "grad_gap": median_leaf_gap(program["first_grad"], grad, self.names),
            "change_gap": median_leaf_gap(program["change"], reference["change"], moving),
        }

    def program_readings(self) -> dict:
        return {"losses": self.checked_losses, "first_grad": self.first_grad,
                "change": self.change}

    def check(self) -> dict:
        self.reference = self.reference_steps()
        return self.gaps(self.program_readings(), self.reference)

    def control_readings(self) -> dict:
        """After :meth:`check`: the numbers compared where the TF32
        reference takes the program's place, and where the reference with
        half of each batch left out does (a state left unchanged reads 1
        on ``change_gap`` by its definition)."""
        return {"control_tf32": self.gaps(self.reference_steps(tf32=True), self.reference),
                "half_batch": self.gaps(self.reference_steps(half_batch=True), self.reference)}
