"""The classification training runtime (``hypelcnn_tpu/train/trainer.py``).

A training step runs on the device with no host read: the step's row of the
precomputed index stream selects the batch's coordinates and labels from
device tables, the window gather cuts the batch from the device-resident
scene (the CUDA kernel on a CUDA scene), augmentation and dropout draw from
generators seeded by (seed, purpose, step), then forward, backward and the
optimizer update. A ``MultiScene`` draws each window's member from such a
generator too, in every step and every eval-drain batch, as the JAX trainer
draws from its gather key. The loss stays on the device and is read only
where a log or hook cadence is crossed.

Hooks fire where the JAX trainer's fire for the same cadences: a test drain
every ``test_cadence`` steps (not at the last step), a validation drain on its
cadence, checkpoints on theirs, a final checkpoint, then final test and
validation drains. A NaN loss is logged once and does not stop training. An
existing checkpoint under ``log_dir`` is resumed from.

The JAX trainer groups steps into scanned chunks to save TPU dispatches; the
port steps one at a time.

Data parallelism (``mesh=``, by default every rank of the process group):
each rank builds the same global index stream and takes its own rows of
every step's global batch, so it launches the window gather on its share
only. Augmentation, dropout and a ``MultiScene``'s members are drawn over
the global batch from the same generators and each rank keeps its rows, so
that W ranks compute what one process computes on the same global batch,
up to the order of float sums. Batch norm's moments and CAP's routing are
global (``parallel/mesh.py``); each step averages the ranks' gradients and
losses in one all-reduce. An eval drain pads its batch to a multiple of the
data axis, each data index drains its share and the int64 confusion is
summed over the data axis. The
chief alone writes summaries, CSVs, history and checkpoints, and every rank
waits at a barrier after a save; a checkpoint holds the replicated state and
the global step, so it resumes into any world size.

Tensor parallelism (a ``mesh`` with a model axis, as JAX's trainer takes
``mesh=create_mesh(model_parallel=...)``): ``init_state`` keeps each rank's
slice of the wide kernels (``parallel/mesh.py`` ``shard_module_``, JAX's
``shard_params_for_tp``), and their Adam moments follow them. The data
axis deals the rows, draws, drains, gradient means and confusion sums as
above; the model ranks of one data index share their rows. A checkpoint
and the logged histograms hold full tensors, gathered over the model axis
first, and a restore cuts each rank's slice again
(``train/state.py``).

``algorithm_params["remat"]`` recomputes the forward pass in the backward
(``torch.utils.checkpoint``) instead of keeping its activations, as the
JAX trainer's ``jax.checkpoint`` does; the recomputation moves no batch-norm
statistic and draws the same dropout masks.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as recompute_in_backward

from hypelcnn_tpu_torch.core import trace
from hypelcnn_tpu_torch.core.rng import DEFAULT_SEED, RngPool
from hypelcnn_tpu_torch.data.augmentation import (
    AugmentationInfo,
    augment_batch,
    draw_augmentations,
    select_rows,
)
from hypelcnn_tpu_torch.data.importers import ScenePatchSource
from hypelcnn_tpu_torch.data.loaders.base import SampleSet
from hypelcnn_tpu_torch.models.base import NNModel
from hypelcnn_tpu_torch.models.layers import init_parameters, running_stats_frozen
from hypelcnn_tpu_torch.parallel.mesh import (
    Mesh,
    bind_mesh,
    create_mesh,
    pad_to_multiple,
    shard_module_,
)
from hypelcnn_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from hypelcnn_tpu_torch.train.metrics import MetricsResult, compute_metrics, confusion_update
from hypelcnn_tpu_torch.train.optimizer import build_optimizer
from hypelcnn_tpu_torch.train.state import TrainState
from hypelcnn_tpu_torch.train.summaries import SummaryWriter


@dataclass
class TrainingResult:
    validation_accuracy: float
    test_accuracy: float
    loss: float
    validation_metrics: Optional[MetricsResult] = None
    test_metrics: Optional[MetricsResult] = None
    history: list = field(default_factory=list)
    final_state: Optional[TrainState] = None
    steps_run: int = 0                      # steps this call ran (fewer when resumed)


class TrainingTables(NamedTuple):
    """Device tables of one training run."""
    indices: torch.Tensor     # [num_steps, batch] int32 rows of the training targets
    coords: torch.Tensor      # [N, 2] int32 (x, y)
    labels: torch.Tensor      # [N] int32 class ids
    class_ids: torch.Tensor   # [C] int32, for the one-hot labels


def make_epoch_index_stream(num_samples: int, batch_size: int, num_steps: int,
                            rng: np.random.Generator) -> np.ndarray:
    """Per-epoch shuffled sample indices for every training step, as a
    ``[num_steps, batch]`` int32 table."""
    needed = num_steps * batch_size
    epochs = math.ceil(needed / num_samples)
    perms = np.concatenate([rng.permutation(num_samples) for _ in range(epochs)])
    return perms[:needed].astype(np.int32).reshape(num_steps, batch_size)


def crossed(cadence: Optional[int], start: int, end: int) -> bool:
    """Whether a multiple of ``cadence`` lies in ``(start, end]``."""
    return bool(cadence) and (end // cadence) > (start // cadence)


class ClassificationTrainer:
    def __init__(self, model: NNModel, class_count: int, algorithm_params: Dict[str, Any],
                 scene, sample_set: SampleSet,
                 augmentation_info: Optional[AugmentationInfo] = None,
                 seed: int = DEFAULT_SEED,
                 log_dir: Optional[str] = None,
                 save_checkpoint_steps: Optional[int] = None,
                 test_cadence: int = 100,
                 validation_cadence: Optional[int] = None,
                 sources: Optional[Dict[str, Any]] = None,
                 data_shape: Optional[list] = None,
                 log_model_params: bool = False,
                 device="cuda",
                 mesh: Optional[Mesh] = None):
        self.model = model
        self.class_count = class_count
        self.algorithm_params = algorithm_params
        self.scene = scene
        if sources is None:
            src = ScenePatchSource(scene)
            sources = {"training": src, "test": src, "validation": src}
        self.sources = sources
        self.data_shape = list(data_shape if data_shape is not None else scene.get_data_shape())
        self.sample_set = sample_set
        self.augmentation_info = augmentation_info or AugmentationInfo()
        self.rng_pool = RngPool(seed)
        self.log_dir = log_dir
        self.save_checkpoint_steps = save_checkpoint_steps
        self.test_cadence = test_cadence
        self.validation_cadence = validation_cadence
        self.log_model_params = log_model_params
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else create_mesh()
        self.remat = bool(algorithm_params.get("remat", False))

        self._eval_tables: Dict = {}
        self.history: list = []

    # ---- setup ----

    def init_state(self, state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A fresh state on the device: weights from ``state_dict`` (full
        width) when given, else the JAX package's initializers drawn from the
        seed; on a mesh with a model axis, each wide kernel cut to this rank's
        slice."""
        module = self.model.create_module(self.class_count, self.algorithm_params,
                                          self.data_shape)
        if state_dict is None:
            init_parameters(module, self.rng_pool.generator("init", 0, "cpu"))
        else:
            module.load_state_dict(state_dict, strict=True)
        sharded = shard_module_(module, self.mesh)  # none without a model axis
        bind_mesh(module, self.mesh)
        module.to(self.device).train()
        optimizer, schedule = build_optimizer(self.algorithm_params, module.parameters())
        return TrainState(step=0, module=module, optimizer=optimizer, schedule=schedule,
                          mesh=self.mesh, sharded=frozenset(sharded))

    def training_tables(self, num_steps: int, batch_size: int) -> TrainingTables:
        """The index stream and target tables, sent to the device once."""
        train = self.sample_set.training_targets
        index_stream = make_epoch_index_stream(
            train.shape[0], batch_size, num_steps, self.rng_pool.numpy_rng("epoch-shuffle"))

        def to_device(array):
            return torch.from_numpy(np.ascontiguousarray(array, dtype=np.int32)).to(self.device)

        return TrainingTables(indices=to_device(index_stream), coords=to_device(train[:, :2]),
                              labels=to_device(train[:, 2]),
                              class_ids=to_device(np.arange(self.class_count)))

    # ---- the step ----

    def _member_generator(self, source, purpose: str, step: int) -> Optional[torch.Generator]:
        """The generator a multi-scene source draws each window's member
        from, seeded by (seed, purpose, step); ``None`` for other sources,
        which draw nothing."""
        if not source.draws_members:
            return None
        return self.rng_pool.generator(purpose, step, self.device)

    def _gather(self, source, arrays, idx, coords, purpose: str, step: int,
                rows: slice, total: int) -> torch.Tensor:
        """The windows of this rank's rows; a multi-scene source's members are
        drawn over the global batch."""
        generator = self._member_generator(source, purpose, step)
        member = None if generator is None else \
            source.draw_members(arrays, total, generator)[rows]
        return source.gather(arrays, idx, coords, member=member)

    def train_step(self, state: TrainState, tables: TrainingTables, step: int) -> torch.Tensor:
        """One optimizer step on the batch of row ``step``; returns the loss
        (the global batch's mean), on the device, without reading it."""
        with trace.span("train_step.input", step):
            idx = tables.indices[step]
            total = idx.shape[0]
            rows = self.mesh.rows(total)
            idx = idx[rows]
            coords = tables.coords.index_select(0, idx)
            label_ids = tables.labels.index_select(0, idx)
            source = self.sources["training"]
            patches = self._gather(source, source.device_arrays(self.device), idx, coords,
                                   "member", step, rows, total)
            draws = draw_augmentations(self.augmentation_info, (total, *patches.shape[1:]),
                                       self.rng_pool.generator("augment", step, self.device),
                                       patches.device, patches.dtype)
            patches = augment_batch(patches, self.augmentation_info,
                                    draws=select_rows(draws, rows))
            labels = (label_ids.unsqueeze(1) == tables.class_ids).to(torch.float32)

        with trace.span("train_step.forward", step):
            def forward():
                # the generator is seeded anew, so a recomputation draws the same masks
                return state.module(patches, labels=labels,
                                    dropout_generator=self.rng_pool.generator(
                                        "dropout", step, self.device))

            if self.remat:
                out = recompute_in_backward(forward, use_reentrant=False, context_fn=lambda: (
                    contextlib.nullcontext(), running_stats_frozen(state.module)))
            else:
                out = forward()
            loss = torch.mean(self.model.loss(out, labels))
        with trace.span("train_step.backward", step):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            params = [p for p in state.module.parameters() if p.grad is not None]
            *grads, loss = self.mesh.mean([p.grad for p in params] + [loss.detach()])
            for param, grad in zip(params, grads):
                param.grad = grad
        with trace.span("train_step.optimizer", step):
            state.apply_gradients()
            return loss.detach()

    # ---- evaluation drains ----

    def evaluate(self, state: TrainState, split: str = "test",
                 batch_size: int = 8192) -> MetricsResult:
        """Drain a target split through eval-mode batches into a confusion
        matrix on the device; OA/AA/kappa from it."""
        targets = {"training": self.sample_set.training_targets,
                   "test": self.sample_set.test_targets,
                   "validation": self.sample_set.validation_targets}[split]
        n = targets.shape[0]
        if n == 0:
            return compute_metrics(np.zeros((self.class_count, self.class_count)))
        # the padded device tables are built once per (split, batch) and
        # reused; the key carries a content hash, so a replaced sample set
        # cannot be served stale tables
        tbytes = np.ascontiguousarray(targets).tobytes()
        cache_key = (split, batch_size, targets.shape,
                     hashlib.blake2b(tbytes, digest_size=8).hexdigest())
        if cache_key not in self._eval_tables:
            for key in [k for k in self._eval_tables if k[:2] == (split, batch_size)]:
                del self._eval_tables[key]
            # the batch divides over the data axis; a small split shrinks to one batch
            eff_batch = pad_to_multiple(min(batch_size, n), self.mesh.data_size)
            num_batches = math.ceil(n / eff_batch)
            total = num_batches * eff_batch
            # pad by wrapping to real samples, not zeros: a model whose eval
            # normalization uses batch statistics must not see zero patches;
            # the mask keeps the wrapped rows out of the confusion
            wrap = np.arange(total) % n
            tables = (wrap.reshape(num_batches, eff_batch),
                      targets[:, :2][wrap].reshape(num_batches, eff_batch, 2),
                      targets[:, 2][wrap].reshape(num_batches, eff_batch),
                      (np.arange(total) < n).reshape(num_batches, eff_batch))
            self._eval_tables[cache_key] = tuple(
                torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32)).to(self.device)
                for t in tables)
        idx_d, coords_d, labels_d, mask_d = self._eval_tables[cache_key]
        total = idx_d.shape[1]
        rows = self.mesh.rows(total)
        idx_d, coords_d, labels_d, mask_d = (t[:, rows] for t in (idx_d, coords_d, labels_d,
                                                                   mask_d))
        source = self.sources[split]
        arrays = source.device_arrays(self.device)
        module = state.module
        was_training = module.training
        module.eval()
        try:
            with torch.inference_mode():
                confusion = torch.zeros((self.class_count, self.class_count), dtype=torch.int64,
                                        device=self.device)
                for batch in range(idx_d.shape[0]):
                    patches = self._gather(source, arrays, idx_d[batch], coords_d[batch],
                                           f"eval-member-{split}", batch, rows, total)
                    preds = torch.argmax(module(patches).y_conv, dim=1)
                    confusion_update(confusion, labels_d[batch], preds, mask_d[batch])
        finally:
            module.train(was_training)
        return compute_metrics(self.mesh.all_reduce_(confusion).cpu().numpy())

    # ---- the training loop ----

    def fit(self, num_steps: int, batch_size: int,
            progress_callback: Optional[Callable[[int, float], None]] = None,
            log_every: int = 100,
            state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TrainingResult:
        """Train to ``num_steps`` (resuming from ``log_dir``'s latest
        checkpoint when there is one); ``state_dict`` gives the initial weights."""
        state = self.init_state(state_dict)
        chief = self.mesh.rank == 0
        resume_step = 0
        saved_step = None  # the step on disk that this state is, the same on every rank
        if self.log_dir and self.save_checkpoint_steps:
            # every rank reads the chief's file
            restored = restore_checkpoint(self.log_dir)
            if restored is not None and int(restored["step"]) > 0:
                state.restore(restored)
                resume_step = min(state.step, num_steps)
                saved_step = state.step
                if chief:
                    print(f"Resuming from checkpoint at step {resume_step}")

        def save() -> None:
            nonlocal saved_step
            if state.step == saved_step:
                return  # this very state: saved at its cadence, or the one resumed from
            if chief or state.sharded:  # the shards are gathered by every rank
                tree = state.checkpoint_tree()
                if chief:
                    save_checkpoint(self.log_dir, tree)
            saved_step = state.step
            self.mesh.barrier()  # no rank reads a checkpoint before it exists

        tables = self.training_tables(num_steps, batch_size)
        writer = None
        if self.log_dir and chief:
            writer = SummaryWriter(self.log_dir)
            writer.text("algorithm_params", json.dumps(
                self.algorithm_params, indent=3, default=str))

        n_test = self.sample_set.test_targets.shape[0]
        n_validation = self.sample_set.validation_targets.shape[0]
        last_loss = float("nan")
        nan_seen = False
        for start in range(resume_step, num_steps):
            end = start + 1
            loss = self.train_step(state, tables, start)

            if crossed(log_every, start, end) or end == num_steps:
                last_loss = float(loss)
                if math.isnan(last_loss) and not nan_seen and chief:
                    nan_seen = True
                    print(f"[nan-guard] loss is NaN at step {end} (continuing)")
                if progress_callback:
                    progress_callback(end, last_loss)
                if writer:
                    writer.scalar("loss", last_loss, end)
                    writer.scalar("learning_rate", state.schedule(end), end)
                if self.log_model_params and (writer or state.sharded):
                    self._log_param_histograms(writer, state, end)

            if crossed(self.test_cadence, start, end) and end != num_steps and n_test > 0:
                test_metrics = self.evaluate(state, "test")
                self.history.append({"step": end, "loss": last_loss,
                                     "test_oa": test_metrics.overall_accuracy})
                if writer:
                    writer.scalar("test_overall_accuracy", test_metrics.overall_accuracy, end)

            if crossed(self.validation_cadence, start, end) and n_validation > 0:
                val_metrics = self.evaluate(state, "validation")
                self.history.append({"step": end, "val_oa": val_metrics.overall_accuracy,
                                     "val_aa": val_metrics.mean_per_class_accuracy,
                                     "val_kappa": val_metrics.kappa})
                if self.log_dir and chief:
                    np.savetxt(os.path.join(self.log_dir, f"validation_confusion_{end}.csv"),
                               val_metrics.confusion, fmt="%d", delimiter=",")
                if writer:
                    writer.scalar("validation_overall_accuracy",
                                  val_metrics.overall_accuracy, end)
                    writer.scalar("validation_kappa", val_metrics.kappa, end)

            if self.save_checkpoint_steps and self.log_dir \
                    and crossed(self.save_checkpoint_steps, start, end):
                save()

        if writer:
            writer.close()
        if self.save_checkpoint_steps and self.log_dir:
            save()
        if self.log_dir and chief and self.history:
            os.makedirs(self.log_dir, exist_ok=True)
            with open(os.path.join(self.log_dir, "history.jsonl"), "w", encoding="utf-8") as fid:
                for rec in self.history:
                    fid.write(json.dumps(rec) + "\n")

        test_metrics = self.evaluate(state, "test") if n_test else None
        val_metrics = self.evaluate(state, "validation") if n_validation else None

        return TrainingResult(
            validation_accuracy=val_metrics.overall_accuracy if val_metrics else 0.0,
            test_accuracy=test_metrics.overall_accuracy if test_metrics else 0.0,
            loss=last_loss,
            validation_metrics=val_metrics,
            test_metrics=test_metrics,
            history=self.history,
            final_state=state,
            steps_run=num_steps - resume_step)

    def _log_param_histograms(self, writer: Optional[SummaryWriter], state: TrainState,
                              step: int) -> None:
        """Histogram every parameter, at full width, and batch-norm statistic.
        Every rank calls this under tensor parallelism, where the shards are
        gathered; only the chief has a ``writer``."""
        params = state.parameters()
        if writer is None:
            return
        for name, tensor in params.items():
            writer.histogram("params/" + name.replace(".", "/"), tensor.cpu().numpy(), step)
        for name, tensor in state.module.named_buffers():
            writer.histogram("batch_stats/" + name.replace(".", "/"),
                             tensor.detach().cpu().numpy(), step)
