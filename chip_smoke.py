#!/usr/bin/env python3
"""Check the PyTorch port on one NVIDIA GPU: its main path, its other paths
and its kernel against their plain versions and the CPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; without them it exits 1 and prints no
result. Each phase prints one JSON line; any failed check raises. Times,
rates and idle shares of the port's paths live in ``portbench/`` (the
benchmark's cells) and PERF.md: this script times only the kernel table and
prints each phase's seconds. The scene is GRSS2013's size (349 x 1905, 144
bands plus LiDAR, 15 classes) from the synthetic loader; every model runs at
the full width of its published JSON (``configs/modelconfigs/``). A train
CLI run over a plain ``Scene`` must launch the CUDA gather exactly once a
step (at the step's batch) and once an eval batch; a sweep, once a band.

- ``device``, ``build``: the card's name and power limit; every kernel
  source built with ``nvcc``, with ptxas's registers, shared memory, spills.
- ``kernel_vs_plain``: the CUDA window gather bit for bit against its plain
  version over k, C and B (out-of-range and negative coordinates, every
  residue of B*k*k*C mod 4, B = 0, an 8.6 GB output past 2^31 floats).
- ``dist_world1``: the train CLI (HYPELCNN, batch 48, 50 steps) in a plain
  process and in one NCCL rank under torchrun, deterministic algorithms:
  losses and final weights equal bit for bit, exact launches, and the traced
  steps' kernels differing only by the collective's.
- ``infer_all``: the infer CLI ``--domain all`` on random HYPELCNN weights:
  one launch a band, both TIFFs, its map equal to the sweep's with the CUDA
  and with the plain gather, card logits within 1e-4 of the CPU's, some
  convolution on ``conv2d``'s GEMM route.
- ``train``: the train CLI (batch 48, dropout 0.7, rotation, reflection and
  spectral augmentation, 300 steps, checkpoints every 200): exact launches,
  a falling loss, test OA above 0.5, orbax checkpoints, the GEMM route and
  the pointwise route of the 1x1s' gradients (no sweep takes it); its
  final state saved again and read back bit for bit. ``train_vs_cpu``: 3
  steps from one init, card against CPU. ``resume``: the CLI to 400 resumes
  at 300, and its saved step is its final state. ``infer_trained``: the
  infer CLI ``all`` and ``sample`` (one launch per 4,096 targets) agree.
- ``family_concnn`` (k = 5, batch 10), ``family_dualcnn`` (k = 5, batch 48),
  ``family_cap`` (k = 3, batch 16): the train CLI's 300 steps (exact
  launches, a falling loss, test OA above 0.2); 3 steps card against CPU
  (step 1 within 1e-4); the infer CLI ``all`` (its map the plain gather's)
  and ``sample`` (equal to ``all`` but at pixels whose top two logits tie to
  1e-4; not for CAP, whose batch statistics and routing couple the batch);
  a sweep through the API equal to the plain gather's, CAP's on the folded
  route only, CONCNN's with 2 LRN calls a band over every feature;
  DUALCNN's state saved and read back bit for bit.
- ``loader_grss2013``, ``loader_grss2018``, ``loader_gulfport``,
  ``loader_avon``: each loader's own file layout written full size
  (``data.layouts``), read back bit for bit against the scene of the arrays
  written, then the train CLI: a loss below the CLI's first step's, an
  accuracy gate, exact launches (none for DFC2018's dual scene, whose dual
  gather equals the host windows); GRSS2013's infer map equals the in-memory
  scene's, DFC2018's ``gt`` map the GT written; GULFPORT's MIXED scene keeps
  2 scenes on the device and shadows 0.70 to 0.80 of its draws.
- ``gan_train``: cycle_gan through its CLI on the GRSS2013 layout (batch 32,
  250 steps, validation and checkpoints every 125): the pairs on the card,
  finite losses and divergences, the snapshots and states as orbax, the
  state restored and re-saved bit for bit, a rerun resuming at 250.
  ``gan_families``: the seven families' finite losses, 2 steps card against
  CPU (step 1 within 1e-4), dcl_cycle_gan equal to dcl_gan bit for bit.
  ``gan_infer``: finite divergences. ``gan_infer_image``: the translated
  TIFFs change only inside the mask; conv and Toeplitz generators on the
  card within 1e-5 of the CPU; the Toeplitz one's ``translate_scene`` of the
  whole scene within 1e-5 of its ``translate``. ``gan_augmented``: the train CLI with
  cycle_gan and simple shadow augmentation: exact launches, 0.25 to 0.35 of
  the windows shadowed, a falling loss, test OA at least 0.9.
- ``search``: both CLIs' hyperparameter search (trials stored and reloaded,
  finite, exact launches). ``records``: the ``.npz`` cache and the
  ``.tfrecord`` set read back bit for bit against ``InMemoryImporter``, and
  training from the cache with no gather. ``tf_checkpoint``: the committed
  TF generator at GRSS2013's declared path, card within 1e-5 of the CPU,
  augmented training. ``jax_log_dir``: the JAX package's committed orbax
  checkpoints read, re-saved by the port's writer equal to JAX's, the infer
  CLI's map JAX's but at its ties, the train CLI resuming JAX's step, JAX's
  cycle_gan translation to 1e-5.
- ``dist_two_ranks_one_card``: two gloo ranks on the card (train and infer
  CLIs, the trainer's first step, CAP's sweep, cycle_gan's steps) against one
  rank; one log dir by the chief; each rank's exact launches; the two-rank
  checkpoint resumed in one rank within 1e-4 of an uninterrupted run.
  ``tp_two_ranks_one_card`` and ``tp_data_model_four_ranks``: the (1, 2) and
  (2, 2) meshes, JAX's sharded kernels, losses against one rank, the (1, 2)
  checkpoint resumed in one rank (drain and sweep equal but at ties, 5 steps
  within 1e-3). ``search_two_ranks``: the search under two ranks, the
  chief's study alone. The ranks are this script again
  (``chip_smoke.py --rank-task SPEC.json``), started by torchrun.
- ``bf16``: the train CLI in bfloat16 (exact launches, a loss below its
  first step's), a bfloat16 sweep agreeing with float32 on 0.98 of the
  pixels, CONCNN and DUALCNN 3 steps card against CPU within 1e-3.
- ``utilities``: the five analysis tools on the card against the CPU.
  ``classic_ml``: the classic-ML CLI's exact launches by batch, windows and
  map equal to the plain gather's, its first trees grown again on the CPU
  node for node, the SVM grid's best cell equal on the card and the CPU.
- ``fused_levels``: fused and unfused multi-scale levels give the same
  logits (HYPELCNN and DUALCNN, 1e-4); DUALCNN's fused sweep equals the
  unfused but at top-two ties, and 5 training steps from one init keep step
  1's loss within 1e-4 and every loss finite.
- ``kernels``: the kernel table (PERF.md section 6). Each main-path shape
  of the gather (bands, steps, drains, a rank's shares, the families',
  loaders' and classic ML's shapes, one window) bit for bit against the
  plain version, then timed with CUDA events beside the plain version and
  one library call; its launches counted over the runs above (none at
  B = 1); its bound is the bytes it must move at the card's HBM bandwidth
  from ``portbench/counts.py`` (null for a card not there). A
  ``launch_floor`` line times an empty kernel.

Then a line of each phase's seconds and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import re
import shutil
import socket
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from hypelcnn_tpu_torch.apps import (
    classic_ml_trainer,
    gan_infer_for_shadow,
    gan_infer_image_for_shadow,
    gan_train_for_shadow,
    infer_for_classification,
    train_for_classification,
)
from hypelcnn_tpu_torch.classic.forest import RandomForestClassifier
from hypelcnn_tpu_torch.compat.flax_to_torch import ORBAX_TREE, orbax_payload
from hypelcnn_tpu_torch.compat.ocdbt import OcdbtStore
from hypelcnn_tpu_torch.compat.orbax import (
    ITEM_METADATA,
    is_orbax_checkpoint,
    read_orbax,
    tree_bytes,
)
from hypelcnn_tpu_torch.core.config import load_algorithm_params
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_importer_from_name, get_model_from_name
from hypelcnn_tpu_torch.core.rng import RngPool, set_run_seed
from hypelcnn_tpu_torch.data import layouts
from hypelcnn_tpu_torch.data.augmentation import AugmentationInfo, augment_batch
from hypelcnn_tpu_torch.data.importers import ScenePatchSource
from hypelcnn_tpu_torch.data.loaders import avon
from hypelcnn_tpu_torch.data.loaders.base import LoadingMode
from hypelcnn_tpu_torch.data.loaders.grss2013 import GRSS2013DataLoader
from hypelcnn_tpu_torch.data.loaders.grss2018 import GRSS2018DataLoader
from hypelcnn_tpu_torch.data.loaders.gulfport_alt import GULFPORTALTDataLoader
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.data.scene import DualResScene, Scene
from hypelcnn_tpu_torch.gan.shadow_ops import build_shadow_creators
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict
from hypelcnn_tpu_torch.infer.scene_inference import (
    create_target_image_via_samples,
    predict_full_scene,
)
from hypelcnn_tpu_torch.kernels import build
from hypelcnn_tpu_torch.kernels.window_gather import reset_launches, window_gather_cuda
from hypelcnn_tpu_torch.models.cap import CAPModule
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
from hypelcnn_tpu_torch.models.layers import (
    SlimBatchNorm,
    conv2d,
    fuse_variables,
    init_parameters,
    reset_conv_counts,
)
from hypelcnn_tpu_torch.ops.nn import local_response_normalization, reset_lrn_counts
from hypelcnn_tpu_torch.ops.window_gather import gather_patches_dual, gather_patches_torch
from hypelcnn_tpu_torch.parallel.distributed import finalize_distributed, join_rank
from hypelcnn_tpu_torch.parallel.distributed import rank as dist_rank
from hypelcnn_tpu_torch.parallel.distributed import world_size as dist_world_size
from hypelcnn_tpu_torch.parallel.mesh import create_mesh, pad_to_multiple, tp_sharded_keys
from hypelcnn_tpu_torch.train.checkpoint import (
    checkpoint_steps,
    holds_orbax_step,
    restore_checkpoint,
    save_checkpoint,
)
from hypelcnn_tpu_torch.train.optimizer import build_optimizer
from hypelcnn_tpu_torch.train.state import TrainState
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer, make_epoch_index_stream
from hypelcnn_tpu_torch.tune import search as tune_search
from hypelcnn_tpu_torch.utils import (
    lidar_matcher,
    measure_targets_shadow_ratio,
    nn_layer_activation_graph,
    record_writer,
    remove_test_targets_from_shadow,
    reveal_shadow_targets,
)
from hypelcnn_tpu_torch.utils.tf_checkpoint_import import (
    is_tf_checkpoint,
    load_tf_checkpoint_values,
)
from hypelcnn_tpu_torch.utils.tiff_io import imread, imwrite, read_tags
from portbench.counts import peak

ROOT = Path(__file__).resolve().parent
SOURCES = ["window_gather"]
SPEC = "synthetic://?h=349&w=1905&bands=144&classes=15"
HEIGHT, WIDTH, CLASSES, NEIGHBORHOOD = 349, 1905, 15, 1
BATCH_ROWS = 16
PARAMS_PATH = ROOT / "configs" / "modelconfigs" / "alg_param_hypelcnn.json"
SEED = 1234
TRAIN_BATCH, TRAIN_STEPS, RESUME_STEPS, CHECKPOINT_EVERY = 48, 300, 400, 200
TRAIN_RATIO, TEST_RATIO = 0.10, 0.05
TEST_CADENCE, EVAL_BATCH, SAMPLE_BATCH = 100, 8192, 4096
SPECTRAL = 0.05
QUEUE_SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's clocks: longer than queueing 21 calls
KERNEL_CALLS = 21  # calls a kernel row times (the band row 20); the tables hold as many steps
CONFIGS = ROOT / "configs" / "modelconfigs"


class Family(NamedTuple):
    """A classifier family at the full width of its published configuration."""
    phase: str
    model: str
    params_path: Path
    neighborhood: int
    batch: int          # the published batch, passed with --batch_size
    steps: int          # train CLI steps
    dropout_off: dict   # the override that turns dropout off


HYPELCNN = Family("train", "HYPELCNNModel", PARAMS_PATH, NEIGHBORHOOD, TRAIN_BATCH, TRAIN_STEPS,
                  {"drop_out_ratio": 0.0})
# CONCNN and DUALCNN drop with rate 1 - drop_out_ratio; CAP has no dropout
FAMILIES = [
    Family("family_concnn", "CONCNNModel", CONFIGS / "alg_param_concnn.json", 2, 10, 300,
           {"drop_out_ratio": 1.0}),
    Family("family_dualcnn", "DUALCNNModel", CONFIGS / "alg_param_dualcnn.json", 2, 48, 300,
           {"drop_out_ratio": 1.0}),
    Family("family_cap", "CAPModel", CONFIGS / "alg_param_capn.json", 1, 16, 300, {}),
]
FAMILY_OA = 0.2  # chance is 1/15
# the loader phases: the train CLI at HYPELCNN's full width on each layout
LOADER_BATCH, LOADER_STEPS, AVON_STEPS, MIXED_STEPS = 48, 100, 100, 50
LOADER_TRAIN_RATIO, LOADER_TEST_RATIO = 0.1, 0.05
MEMBER_DRAWS, DUAL_CHECKS = 10240, 4096
AVON_SIZE = {"height": 500, "width": 300}  # AVON's size is not published; this is ours
LOADER_OA = {"GRSS2013DataLoader": 0.5, "GRSS2018DataLoader": 0.5,
             "GULFPORTALTDataLoader": 0.5, "AVONDataLoader": 0.75}  # chance 1/15, 1/20, 1/11, 1/2
# the GAN phases, on the GRSS2013 layout (144 CASI bands)
GAN_BANDS, GAN_BATCH, GAN_STEPS, GAN_VALIDATION, GAN_RESUME_STEPS = 144, 32, 250, 125, 300
GAN_FAMILY_STEPS, TRANSLATE_CHECKS = 10, 4096
GAN_CARD_VS_CPU_STEPS = 2  # a family's steps on the card and on the CPU; step 1 is held
GAN_FAMILIES = ["cycle_gan", "gan_x2y", "gan_y2x", "cut_x2y", "cut_y2x", "dcl_gan",
                "dcl_cycle_gan"]
GAN_AUGMENTED_STEPS, SIMPLE_AUGMENTED_STEPS, SHADOW_THRESHOLD = 100, 50, 0.3
# the search, records and TF checkpoint phases, on the same layout
SEARCH_STEPS, GAN_SEARCH_STEPS, RECORD_STEPS, TF_AUGMENTED_STEPS = 50, 50, 50, 50
SEARCH_LEARNING_RATE = {"min": 1e-4, "max": 1e-3, "log": True}
GAN_SPACE = ROOT / "configs" / "gan" / "cycle_gan_flags_opt.json"
TF_FIXTURE = ROOT / "tests" / "torch_fixtures" / "tf_cycle_gan_144"
TF_TRANSLATE_CHECKS = 1024
# the JAX package's log dir: its committed orbax checkpoints (HYPELCNN at the
# published width after 200 JAX steps; a 144-band cycle_gan with JAX's
# translation of 256 pixels)
JAX_FIXTURE = ROOT / "tests" / "torch_fixtures" / "jax_hypelcnn_480"
JAX_GAN_FIXTURE = ROOT / "tests" / "torch_fixtures" / "jax_cycle_gan_144"
JAX_RESUMED_STEPS, JAX_AUGMENTED_STEPS = 50, 30
# the multi-device phases: one rank plainly and on NCCL; two ranks on the one card
DIST_WORLD1_STEPS, DIST_STEPS, DIST_CHECKPOINT_EVERY, DIST_RESUME_STEPS = 50, 50, 10, 20
DIST_GAN_STEPS, DIST_CAP_STEPS, DIST_TRACED_STEPS = 30, 20, 3
# tensor parallelism, two and four ranks on the one card: HYPELCNN-1200 on a
# (1, 2) mesh (13 kernels sharded, JAX's rule) with its checkpoint, test drain and
# a sweep of 3 bands of a 48-row scene of the same width; HYPELCNN-480 on (2, 2)
# (8 sharded); then the train CLI's search under two ranks. A rank's losses are
# read over the first steps, its model-axis collectives counted over the next
TP_PARAMS_PATH = CONFIGS / "alg_param_hypelcnn_1200.json"
TP_STEPS, TP_COUNTED_STEPS, TP_RESUME_STEPS, TP_SHARDED_KERNELS = 5, 5, 5, 13
TP_SWEEP_SPEC, TP_SWEEP_BANDS = "synthetic://?h=48&w=1905&bands=144&classes=15", 3
TP_DRAIN_DIFFER = 3  # of the 3,325 test windows: top-two ties, about 1e-3
TP4_STEPS, TP4_COUNTED_STEPS, TP4_SHARDED_KERNELS = 5, 5, 8
SEARCH_RANK_STEPS = 20
# the bfloat16 phase; the sweep's threshold is tests/test_torch_bf16.py's (0.9935
# measured on the CPU); the card-against-CPU loss limit is twice the largest gap
# read on the card (4.7e-4, CONCNN's third step)
BF16_STEPS, BF16_SWEEP_AGREEMENT, BF16_CARD_VS_CPU = 100, 0.98, 1e-3
# the fused_levels phase: DUALCNN's training steps fused and unfused from one init
FUSED_STEPS = 5
# the classic-ML phase: the GRSS2013-size scene with noise over the class
# signatures, so the forest's trees run to ~10k nodes and 28 levels (the
# default noise separates the classes on one band: 32 nodes a tree); the
# CLI's full-scene batch; the trees also grown on the CPU to hold the card's
# against; the grid search's small scene (3 classes, 320 training windows),
# noisy enough that its best cell scores below 1
CLASSIC_SPEC = SPEC + "&noise=3000"
CLASSIC_BATCH = 65536
CLASSIC_CPU_TREES = 3
CLASSIC_GRID_SPEC = "synthetic://?h=40&w=80&bands=144&classes=3&noise=6000"
CLASSIC_GRID_SCORE = 0.01  # a grid cell's score, card against CPU
HISTOGRAMS_CARD_VS_CPU = 1e-4  # of a tap's largest magnitude, at least 1
# the gather's launches by batch size in each main-path run (CLI runs), in order
MAIN_PATH_RUNS: list = []


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(message)


def _file_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def _same_tree(a, b) -> bool:
    """Two state trees (dicts and sequences of tensors or arrays) hold the
    same arrays, bit for bit."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and list(a) == list(b)
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    a, b = (np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t) for t in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _check_orbax(*paths: Path) -> None:
    """Each path is an orbax checkpoint, with no ``.pt`` file in it."""
    for path in paths:
        check(is_orbax_checkpoint(str(path)) and not any(path.rglob("*.pt")),
              f"{path} is not an orbax checkpoint, or holds a .pt file")


def _save_read_back(state, log_dir: Path) -> dict:
    """``save_checkpoint`` of ``state`` (a classifier's or a GAN's) into a
    fresh ``log_dir``: the step reads back bit for bit; the files' and the
    arrays' bytes."""
    tree = state.checkpoint_tree()
    step_dir = Path(save_checkpoint(str(log_dir), tree))
    read = read_orbax(str(step_dir))
    _check_orbax(step_dir)
    check(_same_tree(tree, read), f"{step_dir} does not read back bit for bit")
    return {"file_bytes": _file_bytes(step_dir), "array_bytes": tree_bytes(read)}


def _save_module(log_dir: Path, step: int, module, params: dict) -> None:
    """Save ``module`` as the state at ``step`` of a run with ``params``'
    optimizer, its moments not made yet (zero, as optax starts them)."""
    optimizer, schedule = build_optimizer(params, module.parameters())
    state = TrainState(step=step, module=module, optimizer=optimizer, schedule=schedule)
    save_checkpoint(str(log_dir), state.checkpoint_tree())


def _note_main_path() -> dict:
    """The gather's launches by batch size since the last reset, noted as
    one main-path run's."""
    by_batch = dict(window_gather_cuda.launches_by_batch)
    MAIN_PATH_RUNS.append(by_batch)
    return by_batch


def _conv_routes(model: str, what: str) -> dict:
    """The convolutions that took the GEMM, the pointwise route and cuDNN
    since the last ``reset_conv_counts``; HYPELCNN's and DUALCNN's 3x3 levels
    (and DUALCNN's LiDAR 5x5) cover their windows, so their runs must take the
    GEMM, and their training runs' 1x1s the pointwise route. A sweep records
    no autograd, so no run but training takes the pointwise route."""
    routes = {"gemm": conv2d.gemm, "pointwise": conv2d.pointwise, "cudnn": conv2d.cudnn}
    if model in ("HYPELCNNModel", "DUALCNNModel"):
        check(routes["gemm"] > 0, f"{model} {what}: no convolution took the GEMM: {routes}")
        if what == "training":
            check(routes["pointwise"] > 0,
                  f"{model} {what}: no 1x1 convolution took the pointwise route: {routes}")
    if what != "training":
        check(routes["pointwise"] == 0, f"{model} {what}: a 1x1 took the pointwise route: {routes}")
    return routes


def _augmentation() -> AugmentationInfo:
    """The train CLI's augmentation in the ``train`` and family phases."""
    return AugmentationInfo(perform_rotation_augmentation=True,
                            perform_reflection_augmentation=True,
                            perform_spectral_augmentation=SPECTRAL)


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count()})
    return name


def phase_build() -> None:
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = list(pool.map(build.build, SOURCES))
    for name in SOURCES:
        build.load(name)
    # each kernel's registers, shared memory and spills, as ptxas reported them
    emit({"phase": "build", "libraries": [str(p.relative_to(ROOT)) for p in paths],
          "ptxas": {name: build.ptxas_report(name) for name in SOURCES}})


def phase_kernel_vs_plain(device) -> None:
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = 0
    for channels in (12, 65, 145, 360):
        hp, wp = 40, 300
        scene = torch.randn((hp, wp, channels), generator=gen, device=device)
        for k in (1, 3, 5, 7, 9):
            for batch in (1, 129, 30480):
                xs = torch.randint(0, wp - k + 1, (batch,), generator=gen, device=device)
                ys = torch.randint(0, hp - k + 1, (batch,), generator=gen, device=device)
                wild = torch.rand((batch,), generator=gen, device=device) < 0.25
                xs = torch.where(wild, torch.randint(-2 * wp, 2 * wp, (batch,), generator=gen,
                                                     device=device), xs)
                ys = torch.where(wild, torch.randint(-2 * hp, 2 * hp, (batch,), generator=gen,
                                                     device=device), ys)
                coords = torch.stack([xs, ys], dim=1).to(torch.int32).contiguous()
                coords[0] = torch.tensor([-1, -k], dtype=torch.int32)
                got = window_gather_cuda(scene, coords, k)
                torch.cuda.synchronize()
                check(torch.equal(got, gather_patches_torch(scene, coords, k)),
                      f"window_gather differs from its plain version at k={k}, "
                      f"C={channels}, B={batch}")
                cases += 1
    # fewer channels than a 16-byte chunk, every residue of B*k*k*C mod 4 (the
    # scalar tail), and no windows at all
    residues = set()
    for channels in (1, 2, 3, 5):
        scene = torch.randn((9, 11, channels), generator=gen, device=device)
        for k in (1, 3, 5, 9):
            for batch in (0, 1, 2, 3, 4, 129):
                coords = _wild_coords(gen, batch, 9, 11, device)
                got = window_gather_cuda(scene, coords, k)
                torch.cuda.synchronize()
                check(got.shape == (batch, k, k, channels)
                      and torch.equal(got, gather_patches_torch(scene, coords, k)),
                      f"window_gather differs from its plain version at k={k}, "
                      f"C={channels}, B={batch}")
                residues.add(batch * k * k * channels % 4)
                cases += 1
    check(residues == {0, 1, 2, 3}, f"residues of B*k*k*C mod 4 covered: {residues}")
    # past 2^31 output floats (8.6 GB; the 64-bit index path), compared a
    # slice of windows at a time, then freed
    batch, k, channels = 73_700, 9, 360
    scene = torch.randn((40, 60, channels), generator=gen, device=device)
    coords = _wild_coords(gen, batch, 40, 60, device)
    got = window_gather_cuda(scene, coords, k)
    torch.cuda.synchronize()
    check(got.numel() > 2 ** 31, f"the wide case has {got.numel()} floats")
    for start in range(0, batch, 8192):
        check(torch.equal(got[start:start + 8192],
                          gather_patches_torch(scene, coords[start:start + 8192], k)),
              f"window_gather differs from its plain version past 2^31 at window {start}")
    wide_elements = got.numel()
    del got, scene, coords
    torch.cuda.empty_cache()
    cases += 1
    emit({"phase": "kernel_vs_plain", "cases": cases, "max_abs_err": 0.0, "exact": True,
          "tail_residues": sorted(residues), "wide_case_elements": wide_elements})


def _wild_coords(gen, batch: int, hp: int, wp: int, device) -> torch.Tensor:
    """int32 (x, y) from far below 0 to far past the scene's edge."""
    xs = torch.randint(-2 * wp, 2 * wp, (batch,), generator=gen, device=device)
    ys = torch.randint(-2 * hp, 2 * hp, (batch,), generator=gen, device=device)
    return torch.stack([xs, ys], dim=1).to(torch.int32).contiguous()


def _random_module(params, data_shape, patches: torch.Tensor, model: str = "HYPELCNNModel"):
    """A family (HYPELCNN unless named) at full width with random weights
    from one seeded generator.

    The batch-norm running statistics come from one train-mode pass over
    ``patches`` (dropout off, momentum 0, so they are those patches' batch
    statistics), and the batch-norm biases are then drawn at random. Zero
    means and unit variances would leave every pixel in one class.
    """
    module = get_model_from_name(model).create_module(CLASSES, params, data_shape)
    gen = torch.Generator().manual_seed(SEED)
    init_parameters(module, gen)
    norms = [layer for layer in module.modules() if isinstance(layer, SlimBatchNorm)]
    momenta = [bn.momentum for bn in norms]
    for bn in norms:
        bn.momentum = 0.0
    module.train()
    module.dropout.eval()
    with torch.no_grad():
        module(patches)
        for bn, momentum in zip(norms, momenta):
            bn.momentum = momentum
            bn.bias.copy_(0.1 * torch.randn(bn.bias.shape[0], generator=gen))
    return module.eval()


def phase_infer_all(device, work: Path):
    params = load_algorithm_params(HYPELCNNModel().default_params(), str(PARAMS_PATH))
    scene = SyntheticDataLoader(SPEC).load_data(NEIGHBORHOOD, True)
    data_shape = scene.get_data_shape()
    rng = np.random.default_rng(SEED)
    calibration = torch.from_numpy(np.stack([rng.integers(0, WIDTH, 2048),
                                             rng.integers(0, HEIGHT, 2048)], axis=1).astype(np.int32))
    module = _random_module(params, data_shape, gather_patches_torch(
        scene.device_scene("cpu"), calibration, data_shape[0]))
    log_dir, out_dir = work / "log", work / "out"
    _save_module(log_dir, 1, module, params)
    n_bands = (HEIGHT + BATCH_ROWS - 1) // BATCH_ROWS

    reset_launches()
    reset_conv_counts()
    infer_for_classification.main([
        "--loader_name=SyntheticDataLoader", f"--path={SPEC}", f"--neighborhood={NEIGHBORHOOD}",
        f"--algorithm_param_path={PARAMS_PATH}", f"--base_log_path={log_dir}",
        f"--output_path={out_dir}", "--domain=all", "--device=cuda"])
    launches = window_gather_cuda.launches
    conv_routes = _conv_routes("HYPELCNNModel", "sweep")
    _note_main_path()
    check(launches == n_bands,
          f"window_gather launched {launches} times over the sweep, expected {n_bands}")

    raw, colorized = out_dir / "result_raw.tif", out_dir / "result_colorized.tif"
    check(raw.is_file() and colorized.is_file(), "the CLI did not write both TIFFs")
    check(read_tags(str(raw))[279] == HEIGHT * WIDTH, "result_raw.tif strip size")
    check(read_tags(str(colorized))[279] == HEIGHT * WIDTH * 3, "result_colorized.tif strip size")
    cli_map = imread(str(raw))

    module = module.to(device)
    kernel_map = predict_full_scene(module, scene, device=device)
    plain_map = predict_full_scene(module, scene, device=device, gather=gather_patches_torch)
    check(np.array_equal(kernel_map, plain_map),
          "class maps differ between the CUDA gather and the plain gather")
    check(np.array_equal(kernel_map, cli_map), "the CLI's class map differs from the sweep's")
    classes_in_map = len(np.unique(kernel_map))
    check(int(kernel_map.max()) < CLASSES, "class ids out of range")
    check(classes_in_map > 1, "every pixel fell in one class")

    # float32 logits on the card against the CPU on a small batch
    coords = torch.from_numpy(np.stack([rng.integers(0, WIDTH, 256), rng.integers(0, HEIGHT, 256)],
                                       axis=1).astype(np.int32))
    scene_cpu = scene.device_scene("cpu")
    patches = gather_patches_torch(scene_cpu, coords, 2 * NEIGHBORHOOD + 1)
    with torch.inference_mode():
        gpu_logits = module(patches.to(device)).y_conv.cpu()
        cpu_logits = module.to("cpu")(patches).y_conv
    module.to(device)
    check(bool(torch.isfinite(gpu_logits).all()), "non-finite logits on the card")
    logit_err = float((gpu_logits - cpu_logits).abs().max() / cpu_logits.abs().max().clamp(min=1))
    check(logit_err < 1e-4, f"card and CPU logits differ by {logit_err} (relative)")
    emit({"phase": "infer_all", "scene": [HEIGHT, WIDTH, data_shape[2]], "patch": data_shape[0],
          "bands": n_bands, "windows": HEIGHT * WIDTH, "gather_launches": launches,
          "conv_routes": conv_routes, "classes_in_map": classes_in_map,
          "logit_rel_err_vs_cpu": logit_err,
          "parameters": sum(p.numel() for p in module.parameters())})
    return scene, launches


def _train_args(log_root: Path, steps: int, family: Family = HYPELCNN) -> list:
    return ["--device=cuda", "--loader_name=SyntheticDataLoader", f"--path={SPEC}",
            f"--model_name={family.model}", "--importer_name=GeneratorImporter",
            f"--neighborhood={family.neighborhood}",
            f"--algorithm_param_path={family.params_path}",
            f"--batch_size={family.batch}", f"--train_ratio={TRAIN_RATIO}",
            f"--test_ratio={TEST_RATIO}", f"--step={steps}",
            f"--save_checkpoint_steps={CHECKPOINT_EVERY}", "--augment_data_with_rotation",
            "--augment_data_with_reflection", f"--augment_data_with_spectral={SPECTRAL}",
            f"--base_log_path={log_root}"]


def _run_quiet(main, args: list):
    """Run a CLI's ``main``; its printout is kept, not shown (it holds every flag)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(args)
    return result, out.getvalue()


def _run_train_cli(args: list):
    return _run_quiet(train_for_classification.main, args)


def _eval_batches(n: int) -> int:
    return math.ceil(n / min(EVAL_BATCH, n)) if n else 0


def _expected_launches(start: int, stop: int, n_test: int, n_validation: int) -> dict:
    """Gather launches of a train CLI run from ``start`` to ``stop``: one a
    step, one an eval batch (test drains at the test cadence but not at the
    last step, then the final test and validation drains)."""
    drains = sum(1 for end in range(start + 1, stop) if end % TEST_CADENCE == 0)
    evals = (drains + 1) * _eval_batches(n_test) + _eval_batches(n_validation)
    return {"steps": stop - start, "eval_batches": evals, "total": stop - start + evals}


def _check_launches(what: str, by_batch: dict, launches: int, counts: dict, steps: int,
                    batch: int) -> dict:
    """A train CLI run over a plain ``Scene`` launched the CUDA gather once a
    step (at the step's batch) and once an eval batch (at every other size),
    exactly."""
    expected = _expected_launches(0, steps, counts["test"], counts["validation"])
    eval_sizes = {min(EVAL_BATCH, counts["test"]), min(EVAL_BATCH, counts["validation"])}
    check(batch not in eval_sizes, f"{what}: an eval batch has the step's size: {eval_sizes}")
    measured = {"steps": by_batch.get(batch, 0), "eval_batches": launches - by_batch.get(batch, 0),
                "total": launches}
    check(measured == expected, f"{what}: window_gather launches over training {measured} "
                                f"(by batch {by_batch}), expected {expected}")
    return {"gather_launches": measured, "expected_launches": expected}


def _logged_losses(log_dir: Path) -> list:
    with open(log_dir / "summaries.jsonl", encoding="utf-8") as fid:
        records = [json.loads(line) for line in fid]
    return [(r["step"], r["value"]) for r in records if r.get("tag") == "loss"]


@functools.lru_cache(maxsize=2)
def _training_data(neighborhood: int = NEIGHBORHOOD):
    """The CLI's data set, made the same way (seed, loader, split); made once
    per neighborhood in a process, and read only."""
    set_run_seed()
    return get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, TRAIN_RATIO, TEST_RATIO, neighborhood)


def _trainer(data, params, device, augmentation=None, model="HYPELCNNModel"
             ) -> ClassificationTrainer:
    return ClassificationTrainer(
        model=get_model_from_name(model), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, augmentation_info=augmentation, device=device)


def phase_train(device, work: Path, data) -> dict:
    params = {**load_algorithm_params(HYPELCNNModel().default_params(), str(PARAMS_PATH)),
              "batch_size": TRAIN_BATCH}
    counts = {split: data.targets(split).shape[0] for split in ("training", "test", "validation")}
    log_root = work / "train_log"

    reset_launches()
    reset_conv_counts()
    result, _ = _run_train_cli(_train_args(log_root, TRAIN_STEPS))
    launches = window_gather_cuda.launches
    conv_routes = _conv_routes("HYPELCNNModel", "training")
    by_batch = _note_main_path()
    (log_dir,) = [p for p in log_root.iterdir() if p.is_dir()]
    losses = _logged_losses(log_dir)
    gather = _check_launches("train", by_batch, launches, counts, TRAIN_STEPS, TRAIN_BATCH)
    check(len(losses) > 1 and all(math.isfinite(v) for _, v in losses),
          f"non-finite or missing logged losses: {losses}")
    check(losses[-1][1] < losses[0][1], f"the logged loss did not fall: {losses}")
    check(result.test_accuracy > 0.5, f"test OA {result.test_accuracy} is not above 0.5")
    saved = checkpoint_steps(str(log_dir))
    check(all(s in saved for s in range(CHECKPOINT_EVERY, TRAIN_STEPS + 1, CHECKPOINT_EVERY)),
          f"checkpoints at {saved}")
    _check_orbax(*(log_dir / "checkpoints" / str(s) for s in saved))

    # the trainer of the CLI's configuration, whose tables the kernel rows read
    trainer = _trainer(data, params, device, _augmentation())
    tables = trainer.training_tables(KERNEL_CALLS, TRAIN_BATCH)
    checkpoint = _save_read_back(result.final_state, work / "train_saved")
    emit({"phase": "train", "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "targets": counts, **gather,
          "conv_routes": conv_routes,
          "gather_launches_by_batch": {str(b): n for b, n in sorted(by_batch.items())},
          "logged_losses": losses, "test_oa": result.test_accuracy,
          "checkpoints": saved, "checkpoint": checkpoint,
          "parameters": sum(p.numel() for p in result.final_state.module.parameters())})
    return {"log_root": log_root, "log_dir": log_dir, "launches": gather["gather_launches"],
            "trainer": trainer, "tables": tables, "params": params}


def _card_vs_cpu(device, data, params, family: Family, steps: int,
                 rel_step1: float = 1e-4) -> dict:
    """``steps`` steps from the same weights on the same batches, with
    dropout and augmentation off, on the card and on the CPU; step 1's loss
    within ``rel_step1``."""
    plain = {**params, **family.dropout_off}
    weights = _trainer(data, plain, "cpu", model=family.model).init_state().module.state_dict()
    losses = {}
    for name, where in (("card", device), ("cpu", torch.device("cpu"))):
        trainer = _trainer(data, plain, where, model=family.model)
        state = trainer.init_state(weights)
        tables = trainer.training_tables(steps, family.batch)
        losses[name] = [float(trainer.train_step(state, tables, step)) for step in range(steps)]
    rel = [abs(g - c) / abs(c) for g, c in zip(losses["card"], losses["cpu"])]
    check(rel[0] < rel_step1, f"step 1 loss differs by {rel[0]} (relative) between card and CPU")
    return {"losses": losses, "rel_diff": rel}


def phase_train_vs_cpu(device, data, params) -> None:
    """3 steps from the same weights on the same batches, card against CPU."""
    result = _card_vs_cpu(device, data, params, HYPELCNN, 3)
    rel = result["rel_diff"]
    check(rel[-1] < 1e-3, f"step 3 loss differs by {rel[-1]} (relative) between card and CPU")
    emit({"phase": "train_vs_cpu", **result})


def phase_resume(device, train) -> None:
    sample = train["trainer"].sample_set
    expected = _expected_launches(TRAIN_STEPS, RESUME_STEPS, sample.test_targets.shape[0],
                                  sample.validation_targets.shape[0])
    reset_launches()
    result, out = _run_train_cli(_train_args(train["log_root"], RESUME_STEPS))
    launches = window_gather_cuda.launches
    _note_main_path()
    resumed = [line for line in out.splitlines() if line.startswith("Resuming")]
    check(resumed == [f"Resuming from checkpoint at step {TRAIN_STEPS}"],
          f"the second run did not resume at step {TRAIN_STEPS}: {resumed}")
    check(launches == expected["total"],
          f"window_gather launched {launches} times over the resumed run, expected {expected}")
    check(result.final_state.step == RESUME_STEPS and
          result.steps_run == RESUME_STEPS - TRAIN_STEPS,
          f"resumed run ran {result.steps_run} steps to {result.final_state.step}")
    steps = checkpoint_steps(str(train["log_dir"]))
    check(RESUME_STEPS in steps, "no checkpoint at the end")
    _check_orbax(*(train["log_dir"] / "checkpoints" / str(s) for s in steps))
    # the step the run saved reads back as the run's final state, bit for bit
    saved = restore_checkpoint(str(train["log_dir"]))
    check(saved["step"] == RESUME_STEPS
          and _same_tree(result.final_state.checkpoint_tree(), saved[ORBAX_TREE]),
          f"the saved step {saved['step']} is not the resumed run's final state")
    check(math.isfinite(result.loss), f"resumed loss {result.loss}")
    emit({"phase": "resume", "resumed_line": resumed[0], "gather_launches": launches,
          "expected_launches": expected, "final_step": result.final_state.step,
          "loss": result.loss, "test_oa": result.test_accuracy})


def phase_infer_trained(device, work: Path, train) -> None:
    maps, launches = {}, {}
    for domain in ("all", "sample"):
        out_dir = work / f"trained_{domain}"
        reset_launches()
        infer_for_classification.main([
            "--loader_name=SyntheticDataLoader", f"--path={SPEC}",
            f"--neighborhood={NEIGHBORHOOD}", f"--algorithm_param_path={PARAMS_PATH}",
            f"--base_log_path={train['log_dir']}", f"--output_path={out_dir}",
            f"--domain={domain}", "--device=cuda"])
        launches[domain] = window_gather_cuda.launches
        _note_main_path()
        raw, colorized = out_dir / "result_raw.tif", out_dir / "result_colorized.tif"
        check(raw.is_file() and colorized.is_file(), f"--domain={domain} did not write both TIFFs")
        check(read_tags(str(colorized))[279] == HEIGHT * WIDTH * 3, "colorized strip size")
        maps[domain] = imread(str(raw))
    n_bands = (HEIGHT + BATCH_ROWS - 1) // BATCH_ROWS
    check(launches == {"all": n_bands, "sample": math.ceil(HEIGHT * WIDTH / SAMPLE_BATCH)},
          f"window_gather launches in the infer CLI: {launches}")
    differ = int((maps["all"] != maps["sample"]).sum())
    check(differ <= 1e-4 * HEIGHT * WIDTH,
          f"{differ} pixels differ between --domain=all and --domain=sample")
    set_run_seed()
    loader = SyntheticDataLoader(SPEC)
    truth = create_target_image_via_samples(loader.load_samples(0.1, 0), (HEIGHT, WIDTH))
    emit({"phase": "infer_trained", "gather_launches": launches, "pixels_differ": differ,
          "agreement_with_truth": float((maps["all"] == truth).mean())})


def _top_two_gap(module, scene, device, pixels: np.ndarray) -> float:
    """The largest gap between the two top logits, relative to the largest
    logit magnitude (at least 1), over ``pixels`` ((y, x) rows), classified
    in one batch on the card; 0 for no pixels."""
    if not len(pixels):
        return 0.0
    coords = torch.from_numpy(pixels[:, ::-1].astype(np.int32).copy()).to(device)
    k = scene.get_data_shape()[0]
    with torch.inference_mode():
        logits = module.eval()(gather_patches_torch(scene.device_scene(device), coords, k)).y_conv
    top = logits.topk(2, dim=1).values
    scale = logits.abs().amax(dim=1).clamp(min=1)
    return float(((top[:, 0] - top[:, 1]) / scale).max())


def phase_family(device, work: Path, family: Family) -> dict:
    """One classifier family at its published width through the train CLI,
    the card-against-CPU steps, the infer CLI (``all``, then ``sample``) and
    a sweep through the API."""
    model = get_model_from_name(family.model)
    params = {**load_algorithm_params(model.default_params(), str(family.params_path)),
              "batch_size": family.batch}
    data = _training_data(family.neighborhood)
    scene, k = data.scene, 2 * family.neighborhood + 1
    counts = {split: data.targets(split).shape[0] for split in ("training", "test", "validation")}
    log_root = work / f"{family.phase}_log"

    # train CLI
    reset_launches()
    reset_conv_counts()
    result, _ = _run_train_cli(_train_args(log_root, family.steps, family))
    conv_routes = {"train": _conv_routes(family.model, "training")}
    by_batch = _note_main_path()
    launches = window_gather_cuda.launches
    (log_dir,) = [p for p in log_root.iterdir() if p.is_dir()]
    _check_orbax(*(log_dir / "checkpoints" / str(s) for s in checkpoint_steps(str(log_dir))))
    losses = _logged_losses(log_dir)
    gather = _check_launches(family.model, by_batch, launches, counts, family.steps, family.batch)
    check(len(losses) > 1 and all(math.isfinite(v) for _, v in losses),
          f"{family.model}: non-finite or missing logged losses: {losses}")
    check(losses[-1][1] < losses[0][1], f"{family.model}: the logged loss did not fall: {losses}")
    check(result.test_accuracy > FAMILY_OA,
          f"{family.model}: test OA {result.test_accuracy} is not above {FAMILY_OA}")
    module = result.final_state.module.eval()

    vs_cpu = _card_vs_cpu(device, data, params, family, 3)

    # infer CLI: --domain all, then sample, from the trained checkpoint
    maps, infer_launches = {}, {}
    sweep_launches = {}
    for domain in ("all", "sample"):
        out_dir = work / f"{family.phase}_{domain}"
        reset_launches()
        reset_conv_counts()
        infer_for_classification.main([
            "--loader_name=SyntheticDataLoader", f"--path={SPEC}",
            f"--neighborhood={family.neighborhood}", f"--model_name={family.model}",
            f"--algorithm_param_path={family.params_path}", f"--base_log_path={log_dir}",
            f"--output_path={out_dir}", f"--domain={domain}", "--device=cuda"])
        infer_launches[domain] = window_gather_cuda.launches
        conv_routes[domain] = _conv_routes(family.model, f"--domain={domain}")
        by_batch_infer = _note_main_path()
        if domain == "all":
            sweep_launches = by_batch_infer
        raw = out_dir / "result_raw.tif"
        check(raw.is_file() and (out_dir / "result_colorized.tif").is_file(),
              f"{family.model}: --domain={domain} did not write both TIFFs")
        maps[domain] = imread(str(raw))
    n_bands = (HEIGHT + BATCH_ROWS - 1) // BATCH_ROWS
    check(infer_launches == {"all": n_bands, "sample": math.ceil(HEIGHT * WIDTH / SAMPLE_BATCH)},
          f"{family.model}: window_gather launches in the infer CLI: {infer_launches}")
    plain_map = predict_full_scene(module, scene, device=device, gather=gather_patches_torch)
    check(np.array_equal(maps["all"], plain_map),
          f"{family.model}: the CLI's class map differs from the plain gather's sweep")
    check(int(maps["all"].max()) < CLASSES and len(np.unique(maps["all"])) > 1,
          f"{family.model}: class ids out of range, or every pixel in one class")
    # CAP normalizes and routes with the statistics of each batch, so its
    # sample map (batches of 4,096) legitimately differs from the sweep's.
    # The others run the same function on batches of another size, for
    # which cuDNN picks other algorithms: only a pixel whose two top logits
    # tie to rounding may change class
    differ = np.argwhere(maps["all"] != maps["sample"])
    sample_differ, tie_gap = len(differ), 0.0
    if family.model != "CAPModel":
        tie_gap = _top_two_gap(module, scene, device, differ)
        check(sample_differ <= 1e-4 * HEIGHT * WIDTH and tie_gap < 1e-4,
              f"{family.model}: {sample_differ} pixels differ between --domain all and "
              f"sample, their two top logits up to {tie_gap} (relative) apart")

    # the kernel rows read the trainer's tables; the largest state (DUALCNN's
    # 7,783,240 parameters) is saved once and read back
    tables = _trainer(data, params, device, model=family.model).training_tables(
        KERNEL_CALLS, family.batch)
    checkpoint = _save_read_back(result.final_state, work / f"{family.phase}_saved") \
        if family.model == "DUALCNNModel" else None
    # the sweep through the API, its map the plain gather's
    CAPModule.reset_routes()
    reset_lrn_counts()
    swept = predict_full_scene(module, scene, device=device)
    sweep_cap_routes = dict(CAPModule.routes)
    lrn = {"calls": local_response_normalization.calls,
           "elements": local_response_normalization.elements}
    check(np.array_equal(swept, plain_map),
          f"{family.model}: the kernel sweep's class map differs from the plain gather's")
    record = {"phase": family.phase, "model": family.model,
              "config": str(family.params_path.relative_to(ROOT)), "patch": k,
              "batch": family.batch, "steps": family.steps, "targets": counts, **gather,
              "conv_routes": conv_routes,
              "gather_launches_by_batch": {str(b): n for b, n in sorted(by_batch.items())},
              "logged_losses": losses, "test_oa": result.test_accuracy,
              "card_vs_cpu": vs_cpu, "infer_launches": infer_launches,
              "sample_pixels_differ": sample_differ, "sample_differ_top_two_gap": tie_gap,
              "classes_in_map": len(np.unique(maps["all"])),
              "parameters": sum(p.numel() for p in module.parameters()),
              **({"checkpoint": checkpoint} if checkpoint else {})}
    if family.model == "CONCNNModel":
        # two LRNs a forward, one forward a band, each over all 3f channels of every window
        width = 3 * params["filter_count"]
        check(lrn == {"calls": 2 * n_bands, "elements": 2 * n_bands * BATCH_ROWS * WIDTH * k * k
                      * width}, f"CONCNN's sweep: LRN counts {lrn} for {n_bands} bands")
        record["lrn_counts"] = lrn
    if family.model == "CAPModel":
        # the sweep takes the folded route, which forms no u_hat (the counter
        # holds the u_hat bytes of the sweep's last forward, a band)
        u_hat_bytes = CAPModule.u_hat_bytes
        print(f"{family.phase}: the sweep's CAP routes {sweep_cap_routes}", flush=True)
        check(sweep_cap_routes == {"u_hat": 0, "folded": n_bands} and u_hat_bytes == 0,
              f"CAP's sweep took the u_hat route: {sweep_cap_routes}, {u_hat_bytes} B of u_hat")
        record.update({"cap_routes": sweep_cap_routes, "u_hat_bytes_per_band": u_hat_bytes})
    emit(record)
    return {"family": family, "data": data, "params": params, "scene": scene, "tables": tables,
            "train_launches": by_batch, "sweep_launches": sweep_launches}


def phase_fused_levels(device, scene3, dual) -> None:
    """Fused and unfused multi-scale levels give the same logits at full
    width, on 256 windows of the scene (HYPELCNN at k = 3, DUALCNN at k = 5);
    then DUALCNN's sweep and training steps both ways; ``dual`` is the
    ``family_dualcnn`` phase's result."""
    results = {}
    rng = np.random.default_rng(SEED)
    coords = torch.from_numpy(np.stack([rng.integers(0, WIDTH, 256),
                                        rng.integers(0, HEIGHT, 256)], axis=1).astype(np.int32))
    for model_name, path, scene in (("HYPELCNNModel", PARAMS_PATH, scene3),
                                    ("DUALCNNModel", dual["family"].params_path, dual["scene"])):
        model = get_model_from_name(model_name)
        params = load_algorithm_params(model.default_params(), str(path))
        data_shape = scene.get_data_shape()
        patches = window_gather_cuda(scene.device_scene(device), coords.to(device), data_shape[0])
        unfused = _random_module(params, data_shape, patches.cpu(), model_name)
        fused = model.create_module(CLASSES, {**params, "fuse_level_convs": True}, data_shape)
        fused.load_state_dict(fuse_variables(unfused.state_dict()), strict=True)
        with torch.inference_mode():
            expected = unfused.to(device).eval()(patches).y_conv
            got = fused.to(device).eval()(patches).y_conv
        err = float((got - expected).abs().max() / expected.abs().max().clamp(min=1))
        check(bool(torch.isfinite(got).all()), f"{model_name}: non-finite fused logits")
        check(err < 1e-4, f"{model_name}: fused and unfused logits differ by {err} (relative)")
        results[model_name] = {"patch": data_shape[0], "logit_rel_err": err,
                               "argmax_equal": bool(torch.equal(got.argmax(1),
                                                                expected.argmax(1)))}
    # the loop's last modules are DUALCNN's
    results["DUALCNNModel"].update(_fused_paths(device, dual, unfused, fused))
    emit({"phase": "fused_levels", "windows": 256, "models": results})


def _fused_paths(device, dual, unfused, fused) -> dict:
    """DUALCNN fused against unfused through the sweep and the trainer: the
    scene's maps equal but at top-two ties, then FUSED_STEPS augmented steps
    from one init on the same tables, step 1's loss within 1e-4 (relative)
    and every loss finite."""
    family, scene, data = dual["family"], dual["scene"], dual["data"]
    maps = {name: predict_full_scene(module, scene, device=device)
            for name, module in (("unfused", unfused), ("fused", fused))}
    sweep = _same_but_ties(maps["fused"], maps["unfused"], unfused, scene, device,
                           "DUALCNN's fused sweep")
    losses, init, tables = {}, None, None
    for name, fuse in (("unfused", False), ("fused", True)):
        trainer = _trainer(data, {**dual["params"], "fuse_level_convs": fuse}, device,
                           _augmentation(), model=family.model)
        state = trainer.init_state(init)
        if init is None:
            init = fuse_variables({k: v.detach().cpu().clone()
                                   for k, v in state.module.state_dict().items()})
            tables = trainer.training_tables(FUSED_STEPS, family.batch)
        losses[name] = [float(trainer.train_step(state, tables, step))
                        for step in range(FUSED_STEPS)]
    rel = abs(losses["fused"][0] - losses["unfused"][0]) / abs(losses["unfused"][0])
    check(rel < 1e-4, f"DUALCNN's fused step 1 loss differs from the unfused by {rel} (relative)")
    check(all(math.isfinite(v) for run in losses.values() for v in run),
          f"DUALCNN's fused or unfused training losses: {losses}")
    return {"sweep": sweep, "step_losses": losses, "step1_rel_diff": rel}


# ---- the loader phases ----


def _same_scene(got, expected, what: str) -> None:
    """The loader's padded, normalized host arrays and statistics equal, bit
    for bit, those of the scene built from the arrays that were written."""
    for name in ("casi", "lidar", "casi_min", "casi_max", "lidar_min", "lidar_max"):
        a, b = getattr(got, name), getattr(expected, name)
        same = (a is None and b is None) or (
            a is not None and b is not None and np.asarray(a).dtype == np.asarray(b).dtype
            and np.array_equal(a, b))
        check(same, f"{what}: the loader's {name} differs from the written arrays' scene")


def _write(writer, root: Path, **sizes):
    arrays = writer(str(root), **sizes)
    files = {str(f.relative_to(root)): f.stat().st_size for f in sorted(root.rglob("*"))
             if f.is_file()}
    return arrays, {"files": files, "bytes": sum(files.values())}


def _read(loader: str, root: Path, train_ratio: float, test_ratio: float, device, reads: list):
    """The train CLI's data set, read the way it reads it (seed, importer),
    then put on the device; with the bytes of ``reads``, the files the loader
    opens for it."""
    read_bytes = sum((root / name).stat().st_size for name in reads)
    set_run_seed()
    data = get_importer_from_name("GeneratorImporter").read_data_set(
        loader, str(root), train_ratio, test_ratio, NEIGHBORHOOD)
    arrays = data.sources["training"].device_arrays(device)
    tensors = arrays if isinstance(arrays, tuple) else (arrays,)
    counts = {split: data.targets(split).shape[0] for split in ("training", "test", "validation")}
    return data, {"read_bytes": read_bytes,
                  "device_scene_bytes": sum(t.numel() * t.element_size() for t in tensors),
                  "targets": counts}


def _loader_params() -> dict:
    return {**load_algorithm_params(HYPELCNNModel().default_params(), str(PARAMS_PATH)),
            "batch_size": LOADER_BATCH}


def _loader_train_cli(device, loader: str, root: Path, log_root: Path, steps: int,
                      train_ratio: float, test_ratio: float) -> dict:
    """The train CLI on a dataset directory, HYPELCNN at full width, no
    augmentation; its gather launches by batch size and logged losses."""
    args = [f"--device={device.type}", f"--loader_name={loader}", f"--path={root}",
            "--model_name=HYPELCNNModel", "--importer_name=GeneratorImporter",
            f"--neighborhood={NEIGHBORHOOD}", f"--algorithm_param_path={PARAMS_PATH}",
            f"--batch_size={LOADER_BATCH}", f"--train_ratio={train_ratio}",
            f"--test_ratio={test_ratio}", f"--step={steps}", f"--save_checkpoint_steps={steps}",
            f"--base_log_path={log_root}"]
    reset_launches()
    result, _ = _run_train_cli(args)
    by_batch = _note_main_path()
    (log_dir,) = [p for p in log_root.iterdir() if p.is_dir()]
    losses = _logged_losses(log_dir)
    check(len(losses) >= 1 and all(math.isfinite(v) for _, v in losses),
          f"{loader}: non-finite or missing logged losses: {losses}")
    return {"result": result, "log_dir": log_dir, "by_batch": by_batch,
            "launches": window_gather_cuda.launches, "losses": losses}


def _loader_steps(device, data, loader: str, run: dict) -> dict:
    """The CLI's first step again (same seed, weights, batch and dropout
    draws, so its loss is the CLI's first) and the check that the CLI's last
    logged loss is below it; with the trainer's tables."""
    trainer = _trainer(data, _loader_params(), device)
    state = trainer.init_state()
    tables = trainer.training_tables(KERNEL_CALLS, LOADER_BATCH)
    first_loss = float(trainer.train_step(state, tables, 0))
    check(math.isfinite(first_loss) and run["losses"][-1][1] < first_loss,
          f"{loader}: the loss did not fall from {first_loss}: {run['losses']}")
    return {"first_loss": first_loss, "tables": tables}


def _loader_record(phase: str, written: dict, read: dict, run: dict, steps: dict) -> dict:
    return {"phase": phase, "write": written, **read,
            "gather_launches_by_batch": {str(b): n for b, n in sorted(run["by_batch"].items())},
            "logged_losses": run["losses"], "first_loss": steps["first_loss"],
            "test_oa": run["result"].test_accuracy,
            "validation_oa": run["result"].validation_accuracy}


def phase_loader_grss2013(device, work: Path) -> dict:
    """GRSS2013's layout at its published 349 x 1905 (144-page uint16 CASI,
    float32 LiDAR, uint8 TR/VA, shadow map) through ``GRSS2013DataLoader``:
    the train CLI for 100 steps, then the infer CLI's ``all`` map against the
    sweep of the same weights over the written arrays' ``Scene``."""
    loader, root = "GRSS2013DataLoader", work / "grss2013"
    arrays, written = _write(layouts.write_grss2013, root)
    names = GRSS2013DataLoader
    data, read = _read(loader, root, LOADER_TRAIN_RATIO, LOADER_TEST_RATIO, device, [
        "2013_DFTC/" + name for name in (names.CASI_FILE, names.LIDAR_FILE,
                                         names.TRAINING_FILE, names.VALIDATION_FILE)])
    memory_scene = Scene(arrays["casi"], arrays["lidar"][:, :, None], NEIGHBORHOOD, True)
    _same_scene(data.scene, memory_scene, loader)
    run = _loader_train_cli(device, loader, root, work / "grss2013_log", LOADER_STEPS,
                            LOADER_TRAIN_RATIO, LOADER_TEST_RATIO)
    launches = _check_launches(loader, run["by_batch"], run["launches"], read["targets"],
                               LOADER_STEPS, LOADER_BATCH)
    check(run["result"].test_accuracy > LOADER_OA[loader],
          f"{loader}: test OA {run['result'].test_accuracy}")
    steps = _loader_steps(device, data, loader, run)

    out_dir = work / "grss2013_all"
    reset_launches()
    infer_for_classification.main([
        f"--loader_name={loader}", f"--path={root}", f"--neighborhood={NEIGHBORHOOD}",
        f"--algorithm_param_path={PARAMS_PATH}", f"--base_log_path={run['log_dir']}",
        f"--output_path={out_dir}", "--domain=all", f"--device={device.type}"])
    infer_launches = window_gather_cuda.launches
    _note_main_path()
    height = arrays["casi"].shape[0]
    n_bands = (height + BATCH_ROWS - 1) // BATCH_ROWS
    check(infer_launches == n_bands, f"{loader}: {infer_launches} launches in the sweep")
    cli_map = imread(str(out_dir / "result_raw.tif"))
    memory_map = predict_full_scene(run["result"].final_state.module, memory_scene, device=device)
    check(np.array_equal(cli_map, memory_map),
          f"{loader}: the infer CLI's map differs from the in-memory scene's")
    emit({**_loader_record("loader_grss2013", written, read, run, steps), **launches,
          "infer_launches": infer_launches, "classes_in_map": len(np.unique(cli_map))})
    return {"run": run, "root": root, "targets": read["targets"],
            "first_loss": steps["first_loss"]}


def phase_loader_grss2018(device, work: Path) -> None:
    """DFC2018's published layout (CASI 1202 x 4172 x 50 uint16, LiDAR
    2404 x 8344 float32 with values above 300, GT 1202 x 4768 uint8 with
    10% of its pixels labelled) through ``GRSS2018DataLoader``: the dual
    gather on the card against the host windows, the train CLI for 200
    steps, and the infer CLI's ``gt`` map."""
    loader, root = "GRSS2018DataLoader", work / "grss2018"
    arrays, written = _write(layouts.write_grss2018, root)
    names = GRSS2018DataLoader
    data, read = _read(loader, root, LOADER_TRAIN_RATIO, LOADER_TEST_RATIO, device, [
        "2018_DFTC/" + name for name in (names.CASI_FILE, names.LIDAR_FILE, names.GT_FILE)])
    lidar = arrays["lidar"][:, :, None].copy()
    outliers = int((lidar > 300).sum())
    check(outliers > 0, "the LiDAR holds no value above 300")
    lidar[lidar > 300] = 0
    _same_scene(data.scene, DualResScene(arrays["casi"][:, :, :-2], lidar, NEIGHBORHOOD, True),
                loader)
    del lidar

    # the dual gather on the card, against the host's windows
    every = np.vstack([data.targets(split) for split in ("training", "test", "validation")])
    rows = every[np.random.default_rng(SEED).choice(len(every), DUAL_CHECKS, replace=False), :2]
    casi, lidar = data.sources["training"].device_arrays(device)
    windows = gather_patches_dual(casi, lidar, torch.from_numpy(rows.astype(np.int32)).to(device),
                                  NEIGHBORHOOD).cpu().numpy()
    host = np.stack([data.scene.get_data_point(int(x), int(y)) for x, y in rows])
    check(windows.dtype == host.dtype and np.array_equal(windows, host),
          f"{loader}: gather_patches_dual on the card differs from the host windows")

    run = _loader_train_cli(device, loader, root, work / "grss2018_log", LOADER_STEPS,
                            LOADER_TRAIN_RATIO, LOADER_TEST_RATIO)
    # a DualResScene goes through gather_patches_dual: the CUDA window gather
    # is not on this path
    check(run["launches"] == 0, f"{loader}: {run['launches']} window_gather launches")
    check(run["result"].test_accuracy > LOADER_OA[loader],
          f"{loader}: test OA {run['result'].test_accuracy}")
    steps = _loader_steps(device, data, loader, run)

    out_dir = work / "grss2018_gt"
    infer_for_classification.main([
        f"--loader_name={loader}", f"--path={root}", f"--output_path={out_dir}",
        "--domain=gt", f"--device={device.type}"])
    gt_map = imread(str(out_dir / "result_raw.tif"))
    expected = np.full(data.scene.get_scene_shape(), 255, dtype=np.uint8)
    ys, xs = np.nonzero(arrays["gt"])
    expected[ys + GRSS2018DataLoader.Y_DELTA, xs + GRSS2018DataLoader.X_DELTA] = \
        arrays["gt"][ys, xs] - 1
    check(np.array_equal(gt_map, expected), f"{loader}: the gt map differs from the GT written")
    emit({**_loader_record("loader_grss2018", written, read, run, steps),
          "lidar_values_above_300": outliers, "dual_gather_windows_checked": DUAL_CHECKS,
          "window_gather_launches": run["launches"], "gt_map_shape": list(gt_map.shape)})


def phase_loader_gulfport(device, work: Path) -> dict:
    """MUUFL Gulfport's layout at 325 x 220 x 64 float32 (LiDAR, GT,
    shadowed and deshadowed variants, shadow-corrected GT, shadow map):
    the train CLI through ``GULFPORTALTDataLoader`` (ORIGINAL mode) for 200
    steps, the CUDA gather at C = 65; then a trainer on the MIXED
    ``MultiScene`` for 50 steps and 10,240 member draws."""
    loader, root = "GULFPORTALTDataLoader", work / "gulfport"
    arrays, written = _write(layouts.write_gulfport, root)
    data, read = _read(loader, root, LOADER_TRAIN_RATIO, 0.0, device, [
        f"GULFPORT/muulf_{name}.tif" for name in ("hsi", "lidar", "gt_shadow_corrected",
                                                  "shadow_map")])
    _same_scene(data.scene, Scene(arrays["hsi"], arrays["lidar"][:, :, None], NEIGHBORHOOD, True),
                loader)
    check(read["targets"]["test"] == 0, f"{loader}: a test split by construction empty is not")
    run = _loader_train_cli(device, loader, root, work / "gulfport_log", LOADER_STEPS,
                            LOADER_TRAIN_RATIO, 0.0)
    launches = _check_launches(loader, run["by_batch"], run["launches"], read["targets"],
                               LOADER_STEPS, LOADER_BATCH)
    check(run["result"].validation_accuracy > LOADER_OA[loader],
          f"{loader}: validation OA {run['result'].validation_accuracy}")
    steps = _loader_steps(device, data, loader, run)

    # MIXED: the original and the shadowed variant three times
    mixed_loader = GULFPORTALTDataLoader(str(root))
    mixed_loader.load_mode = LoadingMode.MIXED
    mixed = mixed_loader.load_data(NEIGHBORHOOD, True)
    set_run_seed()
    samples = mixed_loader.load_samples(LOADER_TRAIN_RATIO, 0.0)
    source = ScenePatchSource(mixed)
    trainer = ClassificationTrainer(
        model=HYPELCNNModel(), class_count=11, algorithm_params=_loader_params(), scene=mixed,
        sample_set=samples, sources={"training": source, "test": source, "validation": source},
        data_shape=mixed.get_data_shape(), device=device)
    losses = []
    reset_launches()
    mixed_result = trainer.fit(MIXED_STEPS, LOADER_BATCH, log_every=10,
                               progress_callback=lambda s, l: losses.append((s, l)))
    _note_main_path()
    check(window_gather_cuda.launches == 0,
          f"MIXED: {window_gather_cuda.launches} window_gather launches")
    check(all(math.isfinite(v) for _, v in losses) and losses[-1][1] < losses[0][1],
          f"MIXED: the loss did not fall: {losses}")
    stacked, lookup = source.device_arrays(device)
    check(stacked.shape[0] == 2 and lookup.tolist() == [0, 1, 1, 1],
          f"MIXED: {stacked.shape[0]} scenes on the device, lookup {lookup.tolist()}")
    coords = np.resize(samples.training_targets[:, :2], (MEMBER_DRAWS, 2)).astype(np.int32)
    windows = source.gather((stacked, lookup), None, torch.from_numpy(coords).to(device),
                            torch.Generator(device=device).manual_seed(SEED)).cpu().numpy()
    original, shadowed = mixed.scenes[0], mixed.scenes[1]
    shadowed_draws = 0
    for (x, y), window in zip(coords.tolist(), windows):
        from_original = np.array_equal(window, original.get_data_point(x, y))
        from_shadowed = np.array_equal(window, shadowed.get_data_point(x, y))
        check(from_original != from_shadowed,
              f"MIXED: the window at ({x}, {y}) is not exactly one member's host window")
        shadowed_draws += from_shadowed
    share = shadowed_draws / MEMBER_DRAWS
    check(0.70 <= share <= 0.80, f"MIXED: {share} of the draws are shadowed")
    emit({**_loader_record("loader_gulfport", written, read, run, steps), **launches,
          "mixed": {"steps": MIXED_STEPS, "losses": losses,
                    "validation_oa": mixed_result.validation_accuracy,
                    "scenes_on_device": int(stacked.shape[0]), "lookup": lookup.tolist(),
                    "device_bytes": stacked.numel() * stacked.element_size(),
                    "draws": MEMBER_DRAWS, "shadowed_share": share,
                    "window_gather_launches": 0}})
    return {"scene": data.scene, "tables": steps["tables"], "run": run}


def phase_loader_avon(device, work: Path) -> dict:
    """AVON's layout at 500 x 300 x 360 (no published size): the uint16 cube
    stored (360, 300, 610) and four 1-bit BMP masks, through
    ``AVONDataLoader``; the train CLI for 100 steps, the CUDA gather at C = 360."""
    loader, root = "AVONDataLoader", work / "avon"
    arrays, written = _write(layouts.write_avon, root, **AVON_SIZE)
    data, read = _read(loader, root, LOADER_TRAIN_RATIO, LOADER_TEST_RATIO, device, [
        "AVON/" + name for name in [avon.SCENE_FILE] + [
            avon.TARGET_FILE.format(mask) for mask in ("1_nsh", "1_sh", "2_nsh", "2_sh")]])
    casi = arrays["casi"].copy()
    np.clip(casi, None, np.percentile(casi, 95, axis=[0, 1]).astype(casi.dtype), out=casi)
    _same_scene(data.scene, Scene(casi, None, NEIGHBORHOOD, True, casi_min=0), loader)
    del casi
    run = _loader_train_cli(device, loader, root, work / "avon_log", AVON_STEPS,
                            LOADER_TRAIN_RATIO, LOADER_TEST_RATIO)
    launches = _check_launches(loader, run["by_batch"], run["launches"], read["targets"],
                               AVON_STEPS, LOADER_BATCH)
    check(run["result"].test_accuracy > LOADER_OA[loader],
          f"{loader}: test OA {run['result'].test_accuracy}")
    steps = _loader_steps(device, data, loader, run)
    emit({**_loader_record("loader_avon", written, read, run, steps), **launches,
          "scene": list(data.scene.get_scene_shape()) + [data.scene.get_casi_band_count()],
          "stored_cube": list(arrays["cube"].shape)})
    return {"scene": data.scene, "tables": steps["tables"], "run": run}


# ---- the GAN phases ----


def _gan_args(root: Path, base: Path, steps: int, *extra) -> list:
    return ["--device=cuda", "--loader_name=GRSS2013DataLoader", f"--path={root}",
            "--gan_type=cycle_gan", "--pairing_method=random", f"--batch_size={GAN_BATCH}",
            f"--step={steps}", f"--validation_steps={GAN_VALIDATION}",
            f"--base_log_path={base}", *extra]


def _gan_family_step_fn(family: str, pairs: dict, device, steps: int, seed: int = SEED):
    """A ``family`` trainer at the CLI's defaults over the device pairs, its
    state from ``seed`` and the CLI's step function over a fresh index stream."""
    trainer = get_trainer_dict({}, GAN_BANDS, steps)[family]
    state = trainer.init_state(device, torch.Generator().manual_seed(seed))
    rng = RngPool(seed)
    stream = make_epoch_index_stream(pairs["normal"].shape[0], GAN_BATCH, steps,
                                     rng.numpy_rng("gan-shuffle"))
    step_fn = gan_train_for_shadow.build_step_fn(
        trainer, pairs["normal"], pairs["shadow"], torch.from_numpy(stream).to(device),
        pairs["ratio"], 0.0, rng)
    return trainer, state, step_fn


def phase_gan_train(device, work: Path, root: Path) -> dict:
    """``gan_train_for_shadow`` (cycle_gan, random pairing, batch 32) on the
    GRSS2013 layout that ``loader_grss2013`` wrote: ``GAN_STEPS`` steps,
    validation and checkpoints every ``GAN_VALIDATION``; then a rerun to
    ``GAN_RESUME_STEPS`` that resumes from a state that restores bit for bit."""
    captured = {}
    build = gan_train_for_shadow.build_step_fn

    def capture(trainer, normal, shadow, index_stream, ratio, rate, rng):
        captured.update(normal=normal, shadow=shadow, ratio=ratio)
        return build(trainer, normal, shadow, index_stream, ratio, rate, rng)

    base = work / "gan" / "run"
    gan_train_for_shadow.build_step_fn = capture
    try:
        divergences, out = _run_quiet(gan_train_for_shadow.main, _gan_args(root, base, GAN_STEPS))
    finally:
        gan_train_for_shadow.build_step_fn = build
    (log_dir,) = [p for p in base.parent.iterdir() if p.is_dir()]

    # the pairs: every shadowed pixel repeated lit // shadowed times, as many lit
    loader = GRSS2013DataLoader(str(root))
    shadow_map, _ = loader.load_shadow_map(0, None)
    n_shadow = int((shadow_map == 1).sum())
    n_pairs = n_shadow * ((shadow_map.size - n_shadow) // n_shadow)
    for name in ("normal", "shadow"):
        tensor = captured[name]
        check(tensor.is_cuda and tuple(tensor.shape) == (n_pairs, 1, 1, GAN_BANDS),
              f"GAN {name} pairs: {tuple(tensor.shape)} on {tensor.device}, expected "
              f"({n_pairs}, 1, 1, {GAN_BANDS}) on the card")
    losses = [(int(m.group(1)), float(m.group(2))) for m in
              re.finditer(r"^step (\d+): generator_loss=(\S+) ", out, re.M)]
    check([s for s, _ in losses] == [GAN_VALIDATION, GAN_STEPS]
          and all(math.isfinite(v) for _, v in losses), f"GAN cadence losses: {losses}")
    check(all(math.isfinite(d) for d in divergences), f"GAN divergences: {divergences}")
    for name in ("shadowed", "deshadowed"):
        points = json.loads((log_dir / f"best_ratio_{name}.json").read_text())
        check(sorted(p[0] for p in points) == [GAN_VALIDATION, GAN_STEPS],
              f"best_ratio_{name}.json: {points}")
    check(checkpoint_steps(str(log_dir)) == [GAN_VALIDATION, GAN_STEPS],
          f"GAN full states at {checkpoint_steps(str(log_dir))}")
    _check_orbax(*(log_dir / name for name in (f"ckpt_params_{GAN_VALIDATION}",
                                               f"ckpt_params_{GAN_STEPS}", "gan_params")),
                 *(log_dir / "checkpoints" / str(s) for s in (GAN_VALIDATION, GAN_STEPS)))

    # the state the rerun resumes from restores bit for bit: networks, both
    # optimizers' counts and moments, both pools
    saved = restore_checkpoint(str(log_dir))
    trainer = get_trainer_dict({}, GAN_BANDS, GAN_RESUME_STEPS)["cycle_gan"]
    state = trainer.init_state(device)
    state.restore(saved)
    check(saved["step"] == state.step == GAN_STEPS
          and _same_tree(state.checkpoint_tree(), saved[ORBAX_TREE]),
          "the restored GAN state differs from the saved one")
    checkpoint = _save_read_back(state, work / "gan_saved")
    _, out = _run_quiet(gan_train_for_shadow.main, _gan_args(root, base, GAN_RESUME_STEPS))
    resumed = [line for line in out.splitlines() if line.startswith("Resuming")]
    check(resumed == [f"Resuming GAN training from checkpoint at step {GAN_STEPS}"],
          f"the GAN rerun did not resume at {GAN_STEPS}: {resumed}")
    check(checkpoint_steps(str(log_dir)) == [GAN_STEPS, GAN_RESUME_STEPS],
          f"GAN full states after the rerun at {checkpoint_steps(str(log_dir))}")

    pairs = {"normal": captured["normal"], "shadow": captured["shadow"],
             "ratio": captured["ratio"]}
    emit({"phase": "gan_train", "pairs": n_pairs, "pair_bytes": 2 * n_pairs * GAN_BANDS * 4,
          "batch": GAN_BATCH, "steps": GAN_STEPS, "cadence_losses": losses,
          "divergences": divergences, "resumed_line": resumed[0], "checkpoint": checkpoint})
    return {"log_dir": log_dir, "pairs": pairs}


def phase_gan_families(device, pairs: dict) -> dict:
    """Each of the seven GAN families on the device pairs at batch 32:
    ``GAN_FAMILY_STEPS`` steps with finite losses, and 2 steps on the card
    against the CPU from one init, on the same batches and pool draws; then
    dcl_cycle_gan against dcl_gan, bit for bit under cuDNN's deterministic
    algorithms."""
    records = {}
    for family in GAN_FAMILIES:
        _, state, step_fn = _gan_family_step_fn(family, pairs, device, GAN_FAMILY_STEPS)
        losses = torch.stack([step_fn(state, step) for step in range(GAN_FAMILY_STEPS)])
        check(bool(torch.isfinite(losses).all()), f"{family}: non-finite losses")
        records[family] = {"losses_at": {str(s): float(losses[s - 1]) for s in
                                          (1, GAN_FAMILY_STEPS // 2, GAN_FAMILY_STEPS)},
                           "card_vs_cpu": _gan_card_vs_cpu(family, pairs, device)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        finals = {}
        for family in ("dcl_gan", "dcl_cycle_gan"):
            _, state, step_fn = _gan_family_step_fn(family, pairs, device, 10)
            losses = [step_fn(state, step) for step in range(10)]
            finals[family] = (torch.stack(losses), state.nets.state_dict())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (la, pa), (lb, pb) = finals["dcl_gan"], finals["dcl_cycle_gan"]
    check(torch.equal(la, lb) and all(torch.equal(pb[k], v) for k, v in pa.items()),
          "dcl_cycle_gan differs from dcl_gan")
    emit({"phase": "gan_families", "batch": GAN_BATCH, "steps": GAN_FAMILY_STEPS,
          "families": records, "dcl_cycle_gan_equals_dcl_gan": True})
    return records


def _gan_card_vs_cpu(family: str, pairs: dict, device) -> dict:
    """``GAN_CARD_VS_CPU_STEPS`` steps from one init on the same batches and
    injected pool draws, on the card and on the CPU; step 1 within 1e-4
    (relative)."""
    trainer = get_trainer_dict({}, GAN_BANDS, 3)[family]
    weights = trainer.init_state("cpu", torch.Generator().manual_seed(SEED)).nets.state_dict()
    gen = torch.Generator().manual_seed(SEED)
    rows = [torch.randint(0, pairs["normal"].shape[0], (GAN_BATCH,), generator=gen)
            for _ in range(GAN_CARD_VS_CPU_STEPS)]
    batches = [(pairs["normal"][r.to(device)].cpu(), pairs["shadow"][r.to(device)].cpu())
               for r in rows]
    draws = [{name: (torch.randperm(50, generator=gen)[:GAN_BATCH],
                     torch.rand(GAN_BATCH, generator=gen) < 0.5) for name in trainer.pool_names}
             for _ in range(GAN_CARD_VS_CPU_STEPS)]
    losses = {}
    for name, where in (("card", device), ("cpu", torch.device("cpu"))):
        state = trainer.init_state(where, state_dict=weights)
        losses[name] = [float(trainer.train_step(state, x.to(where), y.to(where),
                                                 draws=d)["generator_loss"])
                        for (x, y), d in zip(batches, draws)]
    rel = [abs(g - c) / max(abs(c), 1e-12) for g, c in zip(losses["card"], losses["cpu"])]
    check(rel[0] < 1e-4, f"{family}: step 1 loss differs by {rel[0]} between card and CPU")
    return {"losses": losses, "rel_diff": rel}


def phase_gan_infer(device, work: Path, root: Path, log_dir: Path) -> None:
    """``gan_infer_for_shadow`` on ``gan_params`` at its default 6,000 samples."""
    validator, _ = _run_quiet(gan_infer_for_shadow.main, [
        "--device=cuda", "--loader_name=GRSS2013DataLoader", f"--path={root}",
        f"--base_log_path={log_dir / 'gan_params'}", f"--output_path={work}"])
    divergences = {"mean": validator.get_best_mean_div(), "upper": validator.get_best_upper_div()}
    check(all(len(v) == 2 and all(math.isfinite(d) for d in v) for v in divergences.values()),
          f"gan_infer divergences: {divergences}")
    emit({"phase": "gan_infer", "samples": 6000, "divergences": divergences})


def phase_gan_infer_image(device, work: Path, root: Path, log_dir: Path) -> None:
    """``gan_infer_image_for_shadow``: shadow, deshadow, shadow with
    ``--convert_all``, and the untranslated scene; then the conv and the
    Toeplitz generators on the card against the CPU, and the Toeplitz one's
    ``translate_scene`` over the whole scene."""
    params = log_dir / "gan_params"
    out_dir = work / "gan_image"
    out_dir.mkdir()
    loader = GRSS2013DataLoader(str(root))
    scene = loader.load_data(0, True)
    shadow_map, _ = loader.load_shadow_map(0, None)
    images = {}
    for mode, convert_all in (("", False), ("shadow", False), ("deshadow", False),
                              ("shadow", True)):
        path, _ = _run_quiet(gan_infer_image_for_shadow.main, [
            "--device=cuda", "--loader_name=GRSS2013DataLoader", f"--path={root}",
            f"--base_log_path={params}", f"--output_path={out_dir}",
            f"--make_them_shadow={mode}", f"--convert_all={convert_all}"])
        key = (mode or "none") + ("_all" if convert_all else "")
        images[key] = imread(path)
        check(images[key].shape == (HEIGHT, WIDTH, GAN_BANDS)
              and images[key].dtype == scene.get_unnormalized_casi_dtype(),
              f"{path}: {images[key].shape} {images[key].dtype}")
    for key, side in (("shadow", 0), ("deshadow", 1)):
        outside = shadow_map != side
        check(np.array_equal(images[key][outside], images["none"][outside]),
              f"{key}: pixels outside the mask differ from the untranslated output")
        check(not np.array_equal(images[key][~outside], images["none"][~outside]),
              f"{key}: nothing was translated")

    # the card against the CPU port on 4,096 pixels, before un-normalizing
    trainer = get_trainer_dict({}, GAN_BANDS, 1)["cycle_gan"]
    rng = np.random.default_rng(SEED)
    flat = scene.casi[:, :, :GAN_BANDS].reshape(-1, GAN_BANDS)
    sample = torch.from_numpy(np.ascontiguousarray(
        flat[rng.choice(flat.shape[0], TRANSLATE_CHECKS, replace=False)], dtype=np.float32)
    ).view(-1, 1, 1, GAN_BANDS)
    nets = {"cpu": trainer.restore_nets(str(params), "cpu"),
            "conv": trainer.restore_nets(str(params), device)}
    toeplitz = get_trainer_dict({"fused_generator": True}, GAN_BANDS, 1)["cycle_gan"]
    nets["toeplitz"] = toeplitz.restore_nets(str(params), device)
    errors = {}
    for is_shadow in (True, False):
        expected = trainer.translate(nets["cpu"], sample, is_shadow)
        for impl, owner in (("conv", trainer), ("toeplitz", toeplitz)):
            got = owner.translate(nets[impl], sample.to(device), is_shadow).cpu()
            err = float((got - expected).abs().max())
            check(err <= 1e-5, f"{impl} translation differs from the CPU's by {err}")
            errors[f"{impl}_{'shadow' if is_shadow else 'deshadow'}"] = err
    # the Toeplitz generator over the whole scene through translate_scene
    # (blocks of 65,536 pixels, the last one zero-padded) against its own
    # translate of the same blocks unpadded
    pixels = np.ascontiguousarray(scene.casi[:, :, :GAN_BANDS], dtype=np.float32)
    swept = toeplitz.translate_scene(nets["toeplitz"], pixels, True)
    blocks = torch.from_numpy(pixels.reshape(-1, 1, 1, GAN_BANDS)).to(device).split(65536)
    expected = torch.cat([toeplitz.translate(nets["toeplitz"], b, True) for b in blocks])
    scene_err = float(np.abs(swept - expected.cpu().numpy().reshape(pixels.shape)).max())
    check(np.isfinite(swept).all() and scene_err <= 1e-5,
          f"translate_scene differs from translate's blocks by {scene_err}")
    emit({"phase": "gan_infer_image", "scene": [HEIGHT, WIDTH, GAN_BANDS],
          "translate_abs_err_vs_cpu": errors, "checked": TRANSLATE_CHECKS,
          "translate_scene_abs_err": scene_err})


def _augmented_cli(work: Path, root: Path, method: str, steps: int, targets: dict) -> dict:
    """The train CLI on the GRSS2013 layout at HYPELCNN's full width, batch
    48, with ``--augment_data_with_shadow method`` at threshold 0.3: its
    result, logged losses and the gather's exact launches."""
    log_root = work / f"augmented_{method}_{steps}"
    args = ["--device=cuda", "--loader_name=GRSS2013DataLoader", f"--path={root}",
            "--model_name=HYPELCNNModel", "--importer_name=GeneratorImporter",
            f"--neighborhood={NEIGHBORHOOD}", f"--algorithm_param_path={PARAMS_PATH}",
            f"--batch_size={LOADER_BATCH}", f"--train_ratio={LOADER_TRAIN_RATIO}",
            f"--test_ratio={LOADER_TEST_RATIO}", f"--step={steps}",
            f"--save_checkpoint_steps={steps}", f"--augment_data_with_shadow={method}",
            f"--augmentation_random_threshold={SHADOW_THRESHOLD}", f"--base_log_path={log_root}"]
    reset_launches()
    result, _ = _run_train_cli(args)
    by_batch = _note_main_path()
    launches = window_gather_cuda.launches
    (run_dir,) = [p for p in log_root.iterdir() if p.is_dir()]
    losses = _logged_losses(run_dir)
    check(len(losses) >= 1 and all(math.isfinite(v) for _, v in losses),
          f"{method} augmentation: losses {losses}")
    return {"result": result, "by_batch": by_batch, "losses": losses, "steps": steps,
            **_check_launches(f"{method} augmentation", by_batch, launches, targets, steps,
                              LOADER_BATCH)}


def _augmented_record(run: dict) -> dict:
    return {"steps": run["steps"], "logged_losses": run["losses"],
            "test_oa": run["result"].test_accuracy,
            "gather_launches_by_batch": {str(b): n for b, n in sorted(run["by_batch"].items())},
            "gather_launches": run["gather_launches"]}


def _shadow_checks(data, info, device, run: dict) -> dict:
    """The CLI's first step again with the shadow op (its loss must be above
    the run's last logged one) and the share of windows the op changed over
    the run's steps, which must lie within 0.25 and 0.35."""
    trainer = _trainer(data, _loader_params(), device, info)
    state = trainer.init_state()
    tables = trainer.training_tables(run["steps"], LOADER_BATCH)
    first_loss = float(trainer.train_step(state, tables, 0))
    check(run["losses"][-1][1] < first_loss,
          f"shadow augmentation: the loss did not fall from {first_loss}: {run['losses']}")
    source = data.sources["training"]
    arrays = source.device_arrays(device)
    shadowed = 0
    with torch.no_grad():
        for step in range(run["steps"]):
            idx = tables.indices[step]
            patches = source.gather(arrays, idx, tables.coords.index_select(0, idx))
            augmented = augment_batch(patches, info, trainer.rng_pool.generator("augment", step,
                                                                                device))
            shadowed += int((augmented != patches).flatten(1).any(1).sum())
    share = shadowed / (run["steps"] * LOADER_BATCH)
    check(0.25 <= share <= 0.35, f"{share} of the windows were shadowed")
    return {"first_loss": first_loss, "shadowed_share": share,
            "windows": run["steps"] * LOADER_BATCH}


def phase_gan_augmented(device, work: Path, root: Path, log_dir: Path) -> dict:
    """The GAN's ``gan_params`` installed at GRSS2013's declared cycle_gan
    path; the train CLI at HYPELCNN's full width, batch 48, with cycle_gan
    shadow augmentation at threshold 0.3 for 100 steps, then 50 with
    ``simple``; the share of windows shadowed, the gather's launches, a
    falling loss and test OA."""
    loader = GRSS2013DataLoader(str(root))
    target = Path(loader.get_model_base_dir()) / loader.get_shadow_checkpoints()["cycle_gan"]
    shutil.copytree(log_dir / "gan_params", target)
    data, read = _read("GRSS2013DataLoader", root, LOADER_TRAIN_RATIO, LOADER_TEST_RATIO, device,
                       [])
    runs = {method: _augmented_cli(work, root, method, steps, read["targets"])
            for method, steps in (("cycle_gan", GAN_AUGMENTED_STEPS),
                                  ("simple", SIMPLE_AUGMENTED_STEPS))}
    gan = runs["cycle_gan"]
    check(gan["result"].test_accuracy >= 0.9,
          f"GAN-augmented test OA {gan['result'].test_accuracy}")

    # the trainer the CLI built, with its shadow op
    creators = build_shadow_creators(data.loader, data.scene, NEIGHBORHOOD, device)
    check(sorted(creators) == ["cycle_gan", "simple"], f"shadow creators: {sorted(creators)}")
    info = AugmentationInfo(shadow_struct=creators["cycle_gan"], perform_shadow_augmentation=True,
                            augmentation_random_threshold=SHADOW_THRESHOLD)
    shadow = _shadow_checks(data, info, device, gan)
    emit({"phase": "gan_augmented", "threshold": SHADOW_THRESHOLD, **shadow,
          "installed_at": str(target.relative_to(root)),
          **{method: _augmented_record(r) for method, r in runs.items()}})
    return sum(r["by_batch"].get(LOADER_BATCH, 0) for r in runs.values())


# ---- the search, records and TF checkpoint phases ----


def _study_rows(db: Path) -> list:
    with sqlite3.connect(db) as conn:
        return conn.execute("SELECT study, number, value, params FROM trials "
                            "ORDER BY number").fetchall()


def _trial_dirs(base: Path) -> list:
    return sorted(p for p in base.parent.iterdir() if p.name.startswith(base.name + "_"))


def phase_search(device, work: Path, root: Path, grss: dict) -> dict:
    """Hyperparameter search on the GRSS2013 layout, in its own working
    directory: the classifier train CLI with ``--flag_config_file_opt`` (the
    published HYPELCNN JSON pinned at full width but a log-uniform learning
    rate), 2 trials of 50 steps at batch 48, then a rerun with 1 trial that
    loads both; then the GAN CLI with ``configs/gan/cycle_gan_flags_opt.json``,
    2 trials of 100 steps."""
    search_dir = work / "search"
    search_dir.mkdir()
    space = {**json.loads(PARAMS_PATH.read_text()), "batch_size": LOADER_BATCH,
             "learning_rate": SEARCH_LEARNING_RATE}
    space_path = search_dir / "space.json"
    space_path.write_text(json.dumps(space))
    base = search_dir / "classifier"
    args = ["--device=cuda", "--loader_name=GRSS2013DataLoader", f"--path={root}",
            "--model_name=HYPELCNNModel", "--importer_name=GeneratorImporter",
            f"--neighborhood={NEIGHBORHOOD}", f"--train_ratio={LOADER_TRAIN_RATIO}",
            f"--test_ratio={LOADER_TEST_RATIO}", f"--step={SEARCH_STEPS}",
            f"--flag_config_file_opt={space_path}", "--opt_run_count=1",
            f"--base_log_path={base}"]
    cwd = os.getcwd()
    os.chdir(search_dir)
    try:
        runs = []
        for trials in (2, 1):
            reset_launches()
            study, out = _run_quiet(train_for_classification.main,
                                    args + [f"--opt_trial_count={trials}"])
            runs.append((_note_main_path(), window_gather_cuda.launches, out))
        gan_base = search_dir / "gan"
        gan_study, gan_out = _run_quiet(gan_train_for_shadow.main, [
            "--device=cuda", "--loader_name=GRSS2013DataLoader", f"--path={root}",
            "--gan_type=cycle_gan", "--pairing_method=random", f"--step={GAN_SEARCH_STEPS}",
            f"--flag_config_file_opt={GAN_SPACE}", "--opt_trial_count=2", "--opt_run_count=1",
            f"--base_log_path={gan_base}"])
    finally:
        os.chdir(cwd)

    check("Loaded 2 prior trials for study classification_opt" in runs[1][2],
          "the classifier search's rerun did not load its 2 earlier trials")
    rows = _study_rows(search_dir / "classification_opt.db")
    check([r[:2] for r in rows] == [("classification_opt", n) for n in range(3)]
          and [t["number"] for t in study.trials] == [0, 1, 2],
          f"classification_opt trials: {[r[:3] for r in rows]}")
    check(all(0.0 <= r[2] <= 1.0 for r in rows), f"1 - validation OA: {[r[2] for r in rows]}")
    # every trial through the CUDA gather, counted by batch size as in ``train``
    launches = {"steps": 0, "eval_batches": 0}
    for (by_batch, total, _), trials in zip(runs, (2, 1)):
        expected = _expected_launches(0, SEARCH_STEPS, grss["targets"]["test"],
                                      grss["targets"]["validation"])
        measured = {"steps": by_batch.get(LOADER_BATCH, 0),
                    "eval_batches": total - by_batch.get(LOADER_BATCH, 0)}
        check(measured == {"steps": trials * expected["steps"],
                           "eval_batches": trials * expected["eval_batches"]},
              f"search: gather launches {measured} (by batch {by_batch}) over {trials} "
              f"trials, expected {expected} each")
        for key in launches:
            launches[key] += measured[key]
    trial_losses = []
    for log_dir in _trial_dirs(base):
        losses = _logged_losses(log_dir)
        check(len(losses) == 1 and math.isfinite(losses[0][1])
              and losses[0][1] < grss["first_loss"],
              f"search trial {log_dir.name}: loss {losses} against the first step's "
              f"{grss['first_loss']}")
        trial_losses.append(losses[0][1])
    check(len(trial_losses) == 3, f"{len(trial_losses)} classifier trial log dirs")

    gan_rows = _study_rows(search_dir / "gan_shadow_opt.db")
    check([r[:2] for r in gan_rows] == [("gan_shadow_opt", 0), ("gan_shadow_opt", 1)]
          and all(math.isfinite(r[2]) for r in gan_rows) and len(gan_study.trials) == 2,
          f"gan_shadow_opt trials: {[r[:3] for r in gan_rows]}")
    gan_losses = [float(m.group(1)) for m in
                  re.finditer(rf"^step {GAN_SEARCH_STEPS}: generator_loss=(\S+) ", gan_out, re.M)]
    check(len(gan_losses) == 2 and all(math.isfinite(v) for v in gan_losses),
          f"GAN search generator losses: {gan_losses}")
    emit({"phase": "search", "steps": SEARCH_STEPS, "batch": LOADER_BATCH,
          "classifier_trials": [{"number": r[1], "value": r[2], "params": json.loads(r[3])}
                                for r in rows],
          "trial_losses": trial_losses, "first_loss": grss["first_loss"],
          "gather_launches": launches, "gan_steps": GAN_SEARCH_STEPS,
          "gan_trials": [{"number": r[1], "value": r[2], "params": json.loads(r[3])}
                         for r in gan_rows],
          "gan_generator_losses": gan_losses})
    return launches


def phase_records(device, work: Path, root: Path) -> None:
    """``record_writer`` writes the GRSS2013 layout's splits at k = 3 as the
    ``.npz`` cache and as the reference's ``.tfrecord`` set; ``RecordImporter``
    reads both back, equal bit for bit to ``InMemoryImporter``'s patches (and,
    for the records, which hold no coordinates, its labels); then the train
    CLI trains from the cache with no gather launch."""
    common = ["--loader_name=GRSS2013DataLoader", f"--path={root}",
              f"--neighborhood={NEIGHBORHOOD}", f"--train_ratio={LOADER_TRAIN_RATIO}",
              f"--test_ratio={LOADER_TEST_RATIO}"]
    written, imported = {}, {}
    for fmt in ("npz", "tfrecord"):
        out = work / f"records_{fmt}"
        set_run_seed()  # the loader's split draws, as the train CLI seeds them
        _run_quiet(record_writer.main, common + [f"--output_path={out}", f"--format={fmt}"])
        written[fmt] = {"bytes": sum(f.stat().st_size for f in out.iterdir()),
                        "files": sorted(f.name for f in out.iterdir())}
        imported[fmt] = get_importer_from_name("RecordImporter").read_data_set(
            "GRSS2013DataLoader", str(out), None, None, None)
    set_run_seed()
    memory = get_importer_from_name("InMemoryImporter").read_data_set(
        "GRSS2013DataLoader", str(root), LOADER_TRAIN_RATIO, LOADER_TEST_RATIO, NEIGHBORHOOD)
    counts = {}
    for split in ("training", "test", "validation"):
        expected = memory.sources[split].patches
        counts[split] = int(expected.shape[0])
        for fmt, data in imported.items():
            check(data.scene is None and data.sources[split].patches.shape == expected.shape
                  and np.array_equal(data.sources[split].patches, expected),
                  f"{fmt} records: {split} patches differ from InMemoryImporter's")
        check(np.array_equal(imported["npz"].targets(split), memory.targets(split)),
              f"npz cache: {split} targets differ")
        check(np.array_equal(imported["tfrecord"].targets(split)[:, 2],
                             memory.targets(split)[:, 2])
              and not imported["tfrecord"].targets(split)[:, :2].any(),
              f"tfrecord: {split} labels differ, or its (x, y) are not zero")
    check(imported["tfrecord"].class_count == imported["npz"].class_count == 15,
          "records: class counts")

    log_root = work / "records_log"
    args = ["--device=cuda", "--loader_name=GRSS2013DataLoader",
            f"--path={work / 'records_npz'}", "--model_name=HYPELCNNModel",
            "--importer_name=RecordImporter", f"--neighborhood={NEIGHBORHOOD}",
            f"--algorithm_param_path={PARAMS_PATH}", f"--batch_size={LOADER_BATCH}",
            f"--step={RECORD_STEPS}", f"--save_checkpoint_steps={RECORD_STEPS}",
            f"--base_log_path={log_root}"]
    reset_launches()
    result, _ = _run_train_cli(args)
    _note_main_path()
    check(window_gather_cuda.launches == 0,
          f"RecordImporter launched the gather {window_gather_cuda.launches} times")
    (log_dir,) = [p for p in log_root.iterdir() if p.is_dir()]
    run = {"losses": _logged_losses(log_dir)}
    check(len(run["losses"]) == 1 and math.isfinite(run["losses"][0][1]),
          f"records: logged losses {run['losses']}")
    steps = _loader_steps(device, imported["npz"], "RecordImporter", run)
    emit({"phase": "records", "targets": counts, "written": written,
          "steps": RECORD_STEPS, "batch": LOADER_BATCH, "logged_losses": run["losses"],
          "first_loss": steps["first_loss"], "test_oa": result.test_accuracy,
          "gather_launches": 0})


def phase_tf_checkpoint(device, work: Path, root: Path) -> dict:
    """The committed TF fixture (``tests/torch_fixtures/tf_cycle_gan_144``)
    at GRSS2013's declared ``shadow_gen_model/cycle_gan/model.ckpt-5000``,
    where ``gan_augmented`` had installed a params snapshot:
    ``build_shadow_creators`` imports it; 1,024 pixels shadow and de-shadow on
    the card as on the CPU, to 1e-5; the train CLI with
    ``--augment_data_with_shadow=cycle_gan`` for 100 steps: a shadowed share
    of 0.25 to 0.35, a falling loss and the gather's launches."""
    loader = GRSS2013DataLoader(str(root))
    target = Path(loader.get_model_base_dir()) / loader.get_shadow_checkpoints()["cycle_gan"]
    shutil.rmtree(target)
    for path in TF_FIXTURE.iterdir():
        shutil.copy2(path, target.parent / path.name)
    check(is_tf_checkpoint(str(target)), f"{target} is not a TF checkpoint")
    values = load_tf_checkpoint_values(str(target))
    data, read = _read("GRSS2013DataLoader", root, LOADER_TRAIN_RATIO, LOADER_TEST_RATIO, device,
                       [])
    creators = build_shadow_creators(data.loader, data.scene, NEIGHBORHOOD, device)
    on_cpu = build_shadow_creators(data.loader, data.scene, NEIGHBORHOOD, "cpu")
    check(sorted(creators) == sorted(on_cpu) == ["cycle_gan", "simple"],
          f"shadow creators: {sorted(creators)}, on the CPU {sorted(on_cpu)}")
    rng = np.random.default_rng(SEED)
    flat = data.scene.casi.reshape(-1, data.scene.casi.shape[-1])
    pixels = torch.from_numpy(np.ascontiguousarray(
        flat[rng.choice(flat.shape[0], TF_TRANSLATE_CHECKS, replace=False)], dtype=np.float32)
    ).view(-1, 1, 1, flat.shape[-1])
    errors = {}
    for name in ("shadow_fn", "deshadow_fn"):
        expected = getattr(on_cpu["cycle_gan"], name)(pixels)
        got = getattr(creators["cycle_gan"], name)(pixels.to(device)).cpu()
        errors[name] = float((got - expected).abs().max())
        check(errors[name] <= 1e-5, f"{name}: the card differs from the CPU by {errors[name]}")
        check(not torch.equal(expected[..., :GAN_BANDS], pixels[..., :GAN_BANDS]),
              f"{name}: nothing was translated")

    run = _augmented_cli(work, root, "cycle_gan", TF_AUGMENTED_STEPS, read["targets"])
    info = AugmentationInfo(shadow_struct=creators["cycle_gan"], perform_shadow_augmentation=True,
                            augmentation_random_threshold=SHADOW_THRESHOLD)
    shadow = _shadow_checks(data, info, device, run)
    emit({"phase": "tf_checkpoint", "fixture": str(TF_FIXTURE.relative_to(ROOT)),
          "installed_at": str(target.relative_to(root)), "variables": len(values),
          "fixture_bytes": sum(p.stat().st_size for p in TF_FIXTURE.iterdir()),
          "translate_abs_err_vs_cpu": errors, "checked": TF_TRANSLATE_CHECKS,
          "threshold": SHADOW_THRESHOLD, **shadow, "run": _augmented_record(run)})
    return {"steps": run["gather_launches"]["steps"],
            "eval_batches": run["gather_launches"]["eval_batches"]}


def _as_jax_held(tree, value_types: dict, path=()):
    """``tree`` (``read_orbax``'s numpy leaves) with each leaf as JAX held it
    when it saved: a tensor where ``value_types`` (by the key path's
    ``str(tuple)``) says ``jax.Array``, else the numpy array."""
    if isinstance(tree, dict):
        return {k: _as_jax_held(v, value_types, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_jax_held(v, value_types, path + (str(i),)) for i, v in enumerate(tree)]
    held = value_types[str(path)] == "jax.Array"
    return torch.from_numpy(tree) if held else tree


def _resave_jax_step(step_dir: Path, tree: dict, log_dir: Path) -> dict:
    """The committed JAX step re-saved by the port's writer into ``log_dir``:
    its ``_METADATA`` tree equals the one JAX wrote, key for key and in
    order (path, key types, value type, write shape), its store holds the
    same keys and ``.zarray`` specs, and every array reads back bit for bit."""
    metadata = json.loads((step_dir / "default" / ITEM_METADATA).read_text())["tree_metadata"]
    value_types = {name: entry["value_metadata"]["value_type"]
                   for name, entry in metadata.items()}
    resaved = Path(save_checkpoint(str(log_dir), _as_jax_held(tree, value_types)))
    check(resaved.name == step_dir.name, f"re-saved as step {resaved.name}")
    ours = json.loads((resaved / "default" / ITEM_METADATA).read_text())["tree_metadata"]
    check(list(ours.items()) == list(metadata.items()),
          "the re-saved _METADATA differs from JAX's: "
          f"{[k for k in metadata if ours.get(k) != metadata[k]][:5]}")
    theirs_store, ours_store = (OcdbtStore(str(d / "default")) for d in (step_dir, resaved))
    keys = theirs_store.list()
    check(ours_store.list() == keys, "the re-saved store's keys differ from JAX's")
    specs = [k for k in keys if k.endswith(b"/.zarray")]
    differ = [k for k in specs if ours_store.read(k) != theirs_store.read(k)]
    check(not differ, f"re-saved .zarray specs differ from JAX's: {differ[:5]}")
    check(_same_tree(tree, read_orbax(str(resaved))), "the re-saved arrays differ from JAX's")
    return {"leaves": len(metadata), "zarray_specs": len(specs),
            "file_bytes": _file_bytes(resaved), "fixture_file_bytes": _file_bytes(step_dir),
            "array_bytes": tree_bytes(tree)}


def phase_jax_log_dir(device, work: Path, root: Path, data) -> dict:
    """The JAX package's orbax checkpoints (committed under
    ``tests/torch_fixtures``, as the JAX package wrote them) read by the
    port: the decode's bytes; the step re-saved by the port's
    writer, with JAX's metadata, specs and arrays; the infer CLI on a log dir holding
    the JAX step, whose map must be JAX's but at the pixels whose two top
    logits JAX found within 1e-4; the train CLI resuming the JAX step for
    ``JAX_RESUMED_STEPS`` (its exact launches), the first resumed step on the
    card within 1e-4 of the CPU's; JAX's cycle_gan ``gan_params`` at
    GRSS2013's declared path: the creator, JAX's translation to 1e-5, and
    ``JAX_AUGMENTED_STEPS`` shadow-augmented train CLI steps."""
    (step_dir,) = (JAX_FIXTURE / "checkpoints").iterdir()
    saved = int(step_dir.name)
    decode, trees = {}, {}
    for name, path in (("train_state", step_dir), ("gan_params", JAX_GAN_FIXTURE / "gan_params")):
        trees[name] = read_orbax(str(path))
        decode[name] = {"file_bytes": _file_bytes(path), "array_bytes": tree_bytes(trees[name])}

    resaved = _resave_jax_step(step_dir, trees["train_state"], work / "jax_resaved")

    # a log dir holding the JAX step, where the train CLI's flags name it
    log_root = work / "jax_log"
    flags = SimpleNamespace(loader_name="SyntheticDataLoader", model_name=HYPELCNN.model,
                            train_ratio=TRAIN_RATIO, algorithm_param_path=str(PARAMS_PATH),
                            neighborhood=NEIGHBORHOOD, augment_data_with_shadow=None,
                            augmentation_random_threshold=0.5,
                            augment_data_with_spectral=SPECTRAL)
    log_dir = log_root / train_for_classification.get_log_suffix(flags)
    shutil.copytree(JAX_FIXTURE / "checkpoints", log_dir / "checkpoints")
    out_dir = work / "jax_all"
    reset_launches()
    infer_for_classification.main([
        "--loader_name=SyntheticDataLoader", f"--path={SPEC}", f"--neighborhood={NEIGHBORHOOD}",
        f"--algorithm_param_path={PARAMS_PATH}", f"--base_log_path={log_dir}",
        f"--output_path={out_dir}", "--domain=all", "--device=cuda"])
    bands = window_gather_cuda.launches
    _note_main_path()
    check(bands == math.ceil(HEIGHT / BATCH_ROWS), f"infer CLI on the JAX step: {bands} launches")
    got = imread(str(out_dir / "result_raw.tif"))
    jax_maps = np.load(JAX_FIXTURE / "class_map.npz")
    ties = np.unpackbits(jax_maps["ties"])[:HEIGHT * WIDTH].reshape(HEIGHT, WIDTH).astype(bool)
    differ = got != jax_maps["class_map"]
    check(not (differ & ~ties).any(), f"{int((differ & ~ties).sum())} pixels differ from "
                                      f"JAX's map away from its {int(ties.sum())} ties")

    n_test, n_validation = (data.targets(split).shape[0] for split in ("test", "validation"))
    expected = _expected_launches(saved, saved + JAX_RESUMED_STEPS, n_test, n_validation)
    reset_launches()
    result, out = _run_train_cli(_train_args(log_root, saved + JAX_RESUMED_STEPS))
    launches = window_gather_cuda.launches
    by_batch = _note_main_path()
    resumed = [line for line in out.splitlines() if line.startswith("Resuming")]
    check(resumed == [f"Resuming from checkpoint at step {saved}"],
          f"the train CLI did not resume the JAX step {saved}: {resumed}")
    check(launches == expected["total"] and by_batch.get(TRAIN_BATCH, 0) == expected["steps"],
          f"window_gather launched {launches} times ({by_batch}), expected {expected}")
    check(result.steps_run == JAX_RESUMED_STEPS and math.isfinite(result.loss),
          f"the resumed run ran {result.steps_run} steps, loss {result.loss}")
    steps = checkpoint_steps(str(log_dir))
    check(steps == [saved, saved + JAX_RESUMED_STEPS] and holds_orbax_step(str(log_dir), saved),
          f"checkpoints {steps}")
    params = {**load_algorithm_params(HYPELCNNModel().default_params(), str(PARAMS_PATH)),
              "batch_size": TRAIN_BATCH, **HYPELCNN.dropout_off}
    restored = orbax_payload(trees["train_state"])  # what restore_checkpoint gives for it
    first = {}
    for name, where in (("card", device), ("cpu", torch.device("cpu"))):
        trainer = _trainer(data, params, where)
        state = trainer.init_state()
        state.restore(restored)
        tables = trainer.training_tables(saved + 1, TRAIN_BATCH)
        first[name] = float(trainer.train_step(state, tables, saved))
    rel = abs(first["card"] - first["cpu"]) / abs(first["cpu"])
    check(rel < 1e-4, f"the first resumed step's loss differs by {rel} between card and CPU")

    # the JAX cycle_gan where GRSS2013 declares its generator
    loader = GRSS2013DataLoader(str(root))
    target = Path(loader.get_model_base_dir()) / loader.get_shadow_checkpoints()["cycle_gan"]
    shutil.rmtree(target.parent, ignore_errors=True)  # gan_augmented's and the TF fixture
    shutil.copytree(JAX_GAN_FIXTURE / "gan_params", target)
    check(is_orbax_checkpoint(str(target)), f"{target} is not an orbax checkpoint")
    grss, read = _read("GRSS2013DataLoader", root, LOADER_TRAIN_RATIO, LOADER_TEST_RATIO,
                       device, [])
    creators = build_shadow_creators(grss.loader, grss.scene, NEIGHBORHOOD, device)
    check(sorted(creators) == ["cycle_gan", "simple"], f"shadow creators: {sorted(creators)}")
    translation = np.load(JAX_GAN_FIXTURE / "translation.npz")
    pixels = torch.from_numpy(translation["pixels"])
    windows = torch.cat([pixels, torch.ones(pixels.shape[:-1] + (1,))], dim=-1).to(device)
    errors = {}
    for name, key in (("shadow_fn", "shadow"), ("deshadow_fn", "deshadow")):
        got_translation = getattr(creators["cycle_gan"], name)(windows).cpu()[..., :GAN_BANDS]
        errors[name] = float((got_translation - torch.from_numpy(translation[key])).abs().max())
        check(errors[name] <= 1e-5, f"{name}: {errors[name]} from JAX's translation")
    run = _augmented_cli(work, root, "cycle_gan", JAX_AUGMENTED_STEPS, read["targets"])
    emit({"phase": "jax_log_dir", "fixture": str(JAX_FIXTURE.relative_to(ROOT)),
          "gan_fixture": str(JAX_GAN_FIXTURE.relative_to(ROOT)), "saved_step": saved,
          "decode": decode, "resaved": resaved, "infer_launches": bands,
          "pixels_differ": int(differ.sum()), "jax_ties": int(ties.sum()),
          "resumed_line": resumed[0],
          "gather_launches": launches, "expected_launches": expected,
          "resumed_loss": result.loss, "test_oa": result.test_accuracy,
          "first_step_loss": first, "first_step_rel_diff": rel,
          "installed_at": str(target.relative_to(root)), "translate_abs_err_vs_jax": errors,
          "augmented": _augmented_record(run)})
    return {"bands": bands, "steps": expected["steps"] + run["gather_launches"]["steps"],
            "eval_batches": expected["eval_batches"] + run["gather_launches"]["eval_batches"]}


# ---- the multi-device and bfloat16 phases ----
#
# A rank of a multi-process phase is this script again, started by torchrun
# (or alone, for the plain run it is held against) as
# ``chip_smoke.py --rank-task SPEC.json``: it joins the group torchrun
# describes, if any, runs the spec's tasks and writes ``rank<R>.json`` beside
# the spec.


def _card_and_cpu(device, main, args: list, out: Path, record: dict, name: str) -> dict:
    """A tool's ``main`` on the card (``device``), then on the CPU, each into
    its own output directory under ``out`` and after the same ``np.random``
    seed; results under ``card`` and ``cpu``. ``record`` collects the card
    run's lines naming a figure it did not write (the card's machine has no
    matplotlib)."""
    results = {}
    for side, where in (("card", device.type), ("cpu", "cpu")):
        target = out / f"{name}_{side}"
        target.mkdir(parents=True)
        np.random.seed(SEED)
        results[side], printed = _run_quiet(main, [*args, f"--output_path={target}",
                                                   f"--device={where}"])
        results[f"{side}_dir"] = target
        if side == "card":
            record["unwritten"] += [line for line in printed.splitlines()
                                    if line.endswith("not written")]
    return results


def _edge_safe_gulfport(source: Path, root: Path) -> Path:
    """A copy of a GULFPORT layout whose GT has no building-shadow pixel in
    the last row or column: there the reveal tool's neighbour votes index past
    the image and raise, in the JAX package as in the port."""
    shutil.copytree(source / "GULFPORT", root / "GULFPORT")
    gt_path = root / "GULFPORT" / "muulf_gt.tif"
    gt = imread(str(gt_path))
    shadow = reveal_shadow_targets.BUILDING_SHADOW_CLASS + 1
    for edge in (gt[-1, :], gt[:, -1]):
        edge[edge == shadow] = 0
    imwrite(str(gt_path), gt)
    return root


def phase_utilities(device, work: Path, roots: dict, train_log_dir: Path) -> None:
    """The five analysis tools on the card and on the CPU, on the layouts the
    loader phases wrote: each result on the card against the same tool's on
    the CPU."""
    out = work / "utilities"
    record: dict = {"unwritten": []}
    # GRSS2013 <-> GRSS2018 registration: both datasets under one path
    both = work / "registration"
    both.mkdir()
    for name, folder in (("grss2013", "2013_DFTC"), ("grss2018", "2018_DFTC")):
        os.symlink(roots[name] / folder, both / folder)
    matched = _card_and_cpu(device, lidar_matcher.main, [f"--path={both}"], out, record,
                            "lidar_matcher")
    check(matched["card"] == matched["cpu"],
          f"lidar_matcher: card corners {matched['card']} against CPU {matched['cpu']}")
    grss2013 = [f"--loader_name=GRSS2013DataLoader", f"--path={roots['grss2013']}"]
    ratio = _card_and_cpu(device, measure_targets_shadow_ratio.main,
                          [*grss2013, "--pairing_method=random"], out, record, "shadow_ratio")
    for got, want, what in zip(ratio["card"], ratio["cpu"], ("mean", "std")):
        check(bool(np.isfinite(got).all()) and np.allclose(got, want, rtol=1e-6, atol=0),
              f"measure_targets_shadow_ratio: the {what} on the card differs from the CPU's")
    removed = _card_and_cpu(device, remove_test_targets_from_shadow.main, grss2013, out, record,
                            "remove_test_targets")
    check(np.array_equal(removed["card"], removed["cpu"])
          and np.array_equal(imread(str(removed["card_dir"] / "shadow_map.tif")), removed["cpu"]),
          "remove_test_targets_from_shadow: the shadow maps differ")
    histograms = _card_and_cpu(device, nn_layer_activation_graph.main, [
        "--model_name=HYPELCNNModel", f"--neighborhood={NEIGHBORHOOD}", "--class_count=15",
        "--bands=145", f"--algorithm_param_path={PARAMS_PATH}",
        f"--base_log_path={train_log_dir}"], out, record, "activation_graph")
    gaps = {name: float(np.abs(t - histograms["cpu"][name]).max())
            / max(1.0, float(np.abs(histograms["cpu"][name]).max()))
            for name, t in histograms["card"].items()}
    check(len(gaps) == 4 and max(gaps.values()) <= HISTOGRAMS_CARD_VS_CPU,
          f"nn_layer_activation_graph: card against CPU {gaps}")
    muufl = _edge_safe_gulfport(roots["gulfport"], work / "muufl")
    revealed = _card_and_cpu(device, reveal_shadow_targets.main, [
        "--loader_name=GULFPORTDataLoader", f"--path={muufl}"], out, record, "reveal_shadow")
    tiffs = {}
    for name in revealed["card"]:
        got, want = (imread(str(revealed[f"{side}_dir"] / name)) for side in ("card", "cpu"))
        check(got.dtype == want.dtype and got.shape == want.shape, f"reveal_shadow_targets: {name}")
        tiffs[name] = float(np.abs(got.astype(np.float64) - want).max())
    check(tiffs["muulf_shadow_map.tif"] == 0 and tiffs["muulf_gt_shadow_corrected.tif"] == 0
          and tiffs["muulf_hsi_shadow_corrected.tif"] <= 1e-6,
          f"reveal_shadow_targets: card against CPU {tiffs}")
    emit({"phase": "utilities", **record, "lidar_match": list(matched["card"]),
          "shadow_ratio_mean": float(np.mean(ratio["card"][0])),
          "non_shadow_map_pixels": int((removed["card"] == 0).sum()),
          "histogram_card_vs_cpu": gaps, "reveal_card_vs_cpu": tiffs,
          "shadow_pixels": int(revealed["card"]["muulf_shadow_map.tif"].sum())})


def _same_forest(a: RandomForestClassifier, b: RandomForestClassifier) -> bool:
    return len(a.trees) == len(b.trees) and all(
        torch.equal(getattr(s, name).cpu(), getattr(t, name).cpu())
        for s, t in zip(a.trees, b.trees)
        for name in ("feature", "threshold", "left", "right", "value"))


def phase_classic_ml(device, work: Path) -> dict:
    """The classic-ML CLI on the GRSS2013-size synthetic scene with class
    overlap (k = 1, C = 145) with the full scene in batches of 65,536, then
    its SVM grid on a small scene, each checked on the card against the plain
    gather and the CPU."""
    loader = SyntheticDataLoader(CLASSIC_SPEC)
    np.random.seed(SEED)
    samples = loader.load_samples(0.1, 0)
    targets = {"training": samples.training_targets, "validation": samples.validation_targets}
    pixels = HEIGHT * WIDTH
    expected = {targets["training"].shape[0]: 1, targets["validation"].shape[0]: 1}
    expected[CLASSIC_BATCH] = expected.get(CLASSIC_BATCH, 0) + pixels // CLASSIC_BATCH
    if pixels % CLASSIC_BATCH:
        expected[pixels % CLASSIC_BATCH] = expected.get(pixels % CLASSIC_BATCH, 0) + 1
    out = work / "classic"
    args = ["--loader_name=SyntheticDataLoader", f"--path={CLASSIC_SPEC}", "--neighborhood=0",
            "--fullscene", f"--batch_size={CLASSIC_BATCH}", f"--base_log_path={out}",
            f"--output_path={out}"]
    np.random.seed(SEED)
    reset_launches()
    (run,), _ = _run_quiet(classic_ml_trainer.main, [*args, f"--device={device.type}"])
    by_batch = _note_main_path()
    check(dict(by_batch) == expected,
          f"classic_ml: gather launches by batch {dict(by_batch)}, expected {expected}")
    check(sorted(os.listdir(out)) == [
        "confusion_matrix_SyntheticDataLoader_run0.csv", "metrics_SyntheticDataLoader_run0.txt",
        "params_SyntheticDataLoader_run0.json", "result_colorized.tif", "result_raw.tif"],
        f"classic_ml: wrote {sorted(os.listdir(out))}")
    # the windows of each batch, bit for bit the plain gather's
    scene_dev = loader.load_data(0, False).device_scene(device)
    coords = {split: torch.from_numpy(t[:, :2].astype(np.int32)).to(device)
              for split, t in targets.items()}
    for split, x in (("training", run["train_x"]), ("validation", run["val_x"])):
        plain = gather_patches_torch(scene_dev, coords[split], 1).reshape(x.shape[0], -1)
        check(torch.equal(x, plain),
              f"classic_ml: the {split} windows differ from the plain gather")
    index = torch.arange(pixels, device=device, dtype=torch.int32)
    scene_coords = torch.stack([index % WIDTH, index // WIDTH], dim=1)
    batches = list(torch.split(scene_coords, CLASSIC_BATCH))
    before = (window_gather_cuda.launches, window_gather_cuda.launches_by_batch.copy())
    for batch in batches:
        check(torch.equal(window_gather_cuda(scene_dev, batch.contiguous(), 1),
                          gather_patches_torch(scene_dev, batch, 1)),
              "classic_ml: a full-scene batch differs from the plain gather")
    window_gather_cuda.launches, window_gather_cuda.launches_by_batch = before
    scene_map = imread(str(out / "result_raw.tif"))
    plain_map = np.concatenate([run["estimator"].predict(
        gather_patches_torch(scene_dev, b, 1).reshape(b.shape[0], -1)) for b in batches])
    check(np.array_equal(scene_map.reshape(-1), plain_map.astype(np.uint8)),
          "classic_ml: the full-scene map differs from the plain gather's")
    oa = run["overall_accuracy"]
    check(oa > 1.0 / 15, f"classic_ml: validation OA {oa} is not above chance")
    # the same draws on the CPU grow the same trees, node for node: the
    # forest's first trees (a forest's seeds are the first of a longer draw's),
    # which predict alike on the card and on the CPU
    forest = run["estimator"]
    np.random.seed(SEED)
    loader.load_samples(0.1, 0)
    cpu_forest = RandomForestClassifier(n_estimators=CLASSIC_CPU_TREES, max_features=24).fit(
        run["train_x"].cpu(), run["train_y"])
    card_head = RandomForestClassifier(n_estimators=CLASSIC_CPU_TREES, max_features=24)
    card_head.classes_, card_head.trees = forest.classes_, forest.trees[:CLASSIC_CPU_TREES]
    check(_same_forest(card_head, cpu_forest),
          f"classic_ml: the card's first {CLASSIC_CPU_TREES} trees differ from the CPU's")
    head = run["val_x"][:CLASSIC_BATCH]
    check(np.array_equal(cpu_forest.predict(head.cpu()), card_head.predict(head)),
          "classic_ml: validation predictions differ, card against CPU")
    nodes = [t.feature.shape[0] for t in forest.trees]
    # the SVM grid on a small scene, card against CPU
    grids = {}
    for side, where in (("card", device.type), ("cpu", "cpu")):
        np.random.seed(SEED)
        reset_launches()
        (grid_run,), _ = _run_quiet(classic_ml_trainer.main, [
            "--loader_name=SyntheticDataLoader", f"--path={CLASSIC_GRID_SPEC}",
            "--neighborhood=0", "--hyperparamopt", f"--base_log_path={work / ('grid_' + side)}",
            f"--device={where}"])
        grids[side] = grid_run["grid"]
        if side == "card":
            _note_main_path()
    gaps = np.abs(grids["card"]["mean_test_score"] - grids["cpu"]["mean_test_score"])
    check(grids["card"]["best_params"] == grids["cpu"]["best_params"]
          and float(gaps.max()) <= CLASSIC_GRID_SCORE,
          f"classic_ml: grid on the card {grids['card']['best_params']} against the CPU's "
          f"{grids['cpu']['best_params']}, largest score gap {gaps.max()}")
    emit({"phase": "classic_ml", "targets": {k: int(v.shape[0]) for k, v in targets.items()},
          "gather_launches_by_batch": {str(b): n for b, n in sorted(by_batch.items())},
          "validation_oa": oa, "cpu_trees": CLASSIC_CPU_TREES, "forest_nodes": sum(nodes),
          "forest_nodes_per_tree": [min(nodes), max(nodes)],
          "forest_depth": max(t.depth for t in forest.trees),
          "grid_best": {k: float(v) for k, v in grids["card"]["best_params"].items()},
          "grid_best_score": grids["card"]["best_score"],
          "grid_score_gap": float(gaps.max())})
    return {"scene": scene_dev, "coords": coords, "scene_coords": batches,
            "by_batch": dict(by_batch)}


def _rank_train_cli(task: dict, device) -> dict:
    reset_launches()
    result, _ = _run_train_cli(task["args"])
    return {"launches": window_gather_cuda.launches,
            "by_batch": {str(b): n for b, n in window_gather_cuda.launches_by_batch.items()},
            "loss": result.loss, "test_oa": result.test_accuracy, "pid": os.getpid(),
            "backend": torch.distributed.get_backend() if torch.distributed.is_initialized()
            else None}


def _rank_infer_cli(task: dict, device) -> dict:
    (log_dir,) = [p for p in Path(task["log_root"]).iterdir() if p.is_dir()]
    reset_launches()
    _run_quiet(infer_for_classification.main, [*task["args"], f"--base_log_path={log_dir}"])
    return {"launches": window_gather_cuda.launches,
            "by_batch": {str(b): n for b, n in window_gather_cuda.launches_by_batch.items()}}


def _device_kernels(prof) -> dict:
    """Calls of each device kernel in a profiled window; the ranges that
    ``record_function`` annotates on the device timeline are not kernels and
    are left out."""
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


def _collective_rows(prof) -> dict:
    """All-reduces a profiled window holds: the host op (gloo or NCCL) and
    NCCL's device kernels, with their counts."""
    host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU
            and "all_reduce" in e.key.lower()]
    busiest = max(host, key=lambda e: e.count, default=None)
    return {"host_op": busiest.key if busiest else None,
            "host_calls": busiest.count if busiest else 0,
            "nccl_kernel_calls": sum(n for name, n in _device_kernels(prof).items()
                                     if "nccl" in name.lower())}


def _rank_first_step(task: dict, device, steps: int) -> tuple:
    """The HYPELCNN trainer at full width on the rank's mesh, its state after
    the first step, its tables of ``steps`` steps and the first step's loss."""
    data = _training_data()
    params = {**load_algorithm_params(HYPELCNNModel().default_params(), str(PARAMS_PATH)),
              "batch_size": TRAIN_BATCH, **task.get("params", {})}
    trainer = ClassificationTrainer(
        model=HYPELCNNModel(), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, device=device, mesh=create_mesh(),
        augmentation_info=_augmentation() if task["augment"] else None)
    state = trainer.init_state()
    tables = trainer.training_tables(steps, TRAIN_BATCH)
    return trainer, state, tables, float(trainer.train_step(state, tables, 0))


def _rank_loss0(task: dict, device) -> dict:
    """The HYPELCNN step's first loss through the trainer on the rank's mesh."""
    return {"loss0": _rank_first_step(task, device, 1)[3]}


def _rank_steps(task: dict, device) -> dict:
    """The HYPELCNN step at full width through the trainer on the rank's
    mesh: the first step's loss, then the kernels and collectives of traced
    steps after 5 warm-up steps."""
    traced = DIST_TRACED_STEPS
    trainer, state, tables, loss0 = _rank_first_step(task, device, 6 + traced)
    for step in range(1, 6):
        trainer.train_step(state, tables, step)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for step in range(6, 6 + traced):
            trainer.train_step(state, tables, step)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    return {"loss0": loss0, "launches_per_step": sum(kernels.values()) / traced,
            "kernels": {name: count / traced for name, count in kernels.items()},
            "collectives": _collective_rows(prof), "traced_steps": traced}


def _cap_module(device, state_dict=None):
    """CAP at the full width of its published JSON, over the ``infer_all`` scene."""
    model = get_model_from_name("CAPModel")
    params = load_algorithm_params(model.default_params(), str(CONFIGS / "alg_param_capn.json"))
    module = model.create_module(CLASSES, params, (3, 3, 145))
    if state_dict is None:
        init_parameters(module, torch.Generator().manual_seed(SEED))
    else:
        module.load_state_dict(state_dict)
    return module.to(device), params


def _rank_cap_sweep(task: dict, device) -> dict:
    module, _ = _cap_module(device, torch.load(task["state_dict"], weights_only=True))
    scene = SyntheticDataLoader(SPEC).load_data(NEIGHBORHOOD, True)
    swept = predict_full_scene(module, scene, device=device, mesh=create_mesh())
    if dist_rank() == 0:
        np.save(task["out"], swept)
    return {}


def _rank_gan(task: dict, device) -> dict:
    """cycle_gan at the CLI's defaults on the given global batches; on
    several ranks, data-parallel."""
    batches = np.load(task["batches"])
    mesh = create_mesh() if dist_world_size() > 1 else None
    trainer = get_trainer_dict({}, GAN_BANDS, task["steps"], mesh=mesh)["cycle_gan"]
    state = trainer.init_state(device, torch.Generator().manual_seed(SEED))
    losses = []
    for step in range(task["steps"]):
        x = torch.from_numpy(batches[f"x{step}"]).to(device)
        y = torch.from_numpy(batches[f"y{step}"]).to(device)
        out = trainer.train_step(state, x, y,
                                 generator=torch.Generator(device=device).manual_seed(step))
        losses.append(out["generator_loss"])
    return {"losses": [float(v) for v in losses]}


def _tp_trainer(params_path: Path, device, mesh, log_dir=None) -> ClassificationTrainer:
    """HYPELCNN at the width of ``params_path``, batch 48, the ``train``
    phase's augmentation, on ``mesh``."""
    data = _training_data()
    params = {**load_algorithm_params(HYPELCNNModel().default_params(), str(params_path)),
              "batch_size": TRAIN_BATCH}
    return ClassificationTrainer(
        model=HYPELCNNModel(), class_count=data.class_count, algorithm_params=params,
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, augmentation_info=_augmentation(), device=device,
        mesh=mesh, log_dir=log_dir)


def _launches() -> dict:
    return {str(b): n for b, n in window_gather_cuda.launches_by_batch.items()}


def _rank_tp(task: dict, device) -> dict:
    """HYPELCNN through the trainer on a (data, model) mesh of every rank,
    from the seed's init: ``steps`` steps whose losses are read, ``counted``
    more, over which the model-axis collectives are counted; then, when asked,
    the full-width checkpoint (the chief writes it), a test drain and a
    sweep of ``sweep_spec``'s bands, whose map the chief saves."""
    mesh = create_mesh(task["model_parallel"])
    trainer = _tp_trainer(Path(task["params_path"]), device, mesh)
    reset_launches()
    state = trainer.init_state()
    steps, counted = task["steps"], task["counted_steps"]
    tables = trainer.training_tables(steps + counted, TRAIN_BATCH)
    losses = [float(trainer.train_step(state, tables, step)) for step in range(steps)]
    gathers, sums = mesh.channel_gathers, mesh.gradient_sums
    for step in range(steps, steps + counted):
        trainer.train_step(state, tables, step)
    out = {"losses": losses, "sharded": sorted(state.sharded),
           "channel_gathers_per_step": (mesh.channel_gathers - gathers) / counted,
           "gradient_sums_per_step": (mesh.gradient_sums - sums) / counted,
           "data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
           "backend": torch.distributed.get_backend()}
    if task.get("log_dir"):
        tree = state.checkpoint_tree()  # every rank: the shards are gathered
        if dist_rank() == 0:
            save_checkpoint(task["log_dir"], tree)
        mesh.barrier()
        out["test"] = trainer.evaluate(state, "test").confusion.tolist()
        scene = SyntheticDataLoader(task["sweep_spec"]).load_data(NEIGHBORHOOD, True)
        gathers = mesh.channel_gathers
        swept = predict_full_scene(state.module, scene, device=device, mesh=mesh)
        out["sweep_channel_gathers"] = mesh.channel_gathers - gathers
        if dist_rank() == 0:
            np.save(task["map"], swept)
    out["launches"] = _launches()
    return out


def _rank_search(task: dict, device) -> dict:
    """The train CLI's search under torchrun, in ``workdir``: each episode's
    searched params and log dir, and this rank's sqlite connections, recorded."""
    episode, connect = train_for_classification.perform_an_episode, tune_search.sqlite3.connect
    episodes, connects = [], []

    def recorded(flags, params, *rest):
        episodes.append({"learning_rate": params["learning_rate"], "log": rest[1]})
        return episode(flags, params, *rest)

    def counted(*args, **kwargs):
        connects.append(args[0])
        return connect(*args, **kwargs)

    train_for_classification.perform_an_episode = recorded
    tune_search.sqlite3.connect = counted
    cwd = os.getcwd()
    os.chdir(task["workdir"])
    reset_launches()
    try:
        study, _ = _run_train_cli(task["args"])
    finally:
        os.chdir(cwd)
        train_for_classification.perform_an_episode = episode
        tune_search.sqlite3.connect = connect
    return {"episodes": episodes,
            "connects": len(connects), "trials": study.trials, "launches": _launches(),
            "total_launches": window_gather_cuda.launches}


RANK_TASKS = {"train_cli": _rank_train_cli, "infer_cli": _rank_infer_cli, "steps": _rank_steps,
              "loss0": _rank_loss0, "cap_sweep": _rank_cap_sweep, "gan": _rank_gan,
              "tp": _rank_tp, "search": _rank_search}


def rank_main(spec_path: str) -> int:
    """One rank of a multi-process phase (``--rank-task SPEC.json``), or the
    one plain process it is held against: it joins torchrun's group when
    torchrun started it and runs the spec's tasks."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    spec = json.loads(Path(spec_path).read_text())
    device = join_rank(resolve_device("cuda"))
    results = {}
    with _deterministic() if spec.get("deterministic") else contextlib.nullcontext():
        for task in spec["tasks"]:
            results[task["name"]] = RANK_TASKS[task["kind"]](task, device)
    Path(spec_path).with_name(f"rank{dist_rank()}.json").write_text(json.dumps(results))
    finalize_distributed()
    return 0


@contextlib.contextmanager
def _deterministic():
    """cuDNN's and PyTorch's deterministic algorithms inside (a rank sets
    ``CUBLAS_WORKSPACE_CONFIG`` before its first cuBLAS call too), so that
    two runs of the same training can be compared step for step."""
    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[:2]
        torch.use_deterministic_algorithms(before[2], warn_only=before[3])


def _launch_ranks(root: Path, tasks: list, nproc=None, deterministic: bool = False,
                  timeout: int = 600) -> list:
    """Run ``tasks`` in ``nproc`` ranks under torchrun (one plain process for
    None); each rank's results, rank 0 first."""
    root.mkdir(parents=True, exist_ok=True)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    spec = root / "spec.json"
    spec.write_text(json.dumps({"tasks": tasks, "deterministic": deterministic}))
    command = [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-task", str(spec)]
    if nproc is not None:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        command[1:1] = ["-m", "torch.distributed.run", f"--nproc_per_node={nproc}",
                        "--master_addr=127.0.0.1", f"--master_port={port}"]
    env = dict(os.environ)
    if deterministic:
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # cuBLAS repeats itself only so
    proc = subprocess.run(command, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    check(proc.returncode == 0, f"ranks {command} exited {proc.returncode}:\n"
                                f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    # operations that have no deterministic implementation warn and run anyway
    nondeterministic = sorted(set(re.findall(r"UserWarning: (\S+ does not have a deterministic "
                                             r"implementation[^\n]*)", proc.stderr)))
    return [{**json.loads((root / f"rank{r}.json").read_text()),
             "nondeterministic_ops": nondeterministic} for r in range(nproc or 1)]


def _dist_train_args(log_root: Path, steps: int, augment: bool, checkpoint_every: int,
                     params_path: Path = PARAMS_PATH) -> list:
    """The train CLI at HYPELCNN's full width, batch 48."""
    args = ["--device=cuda", "--loader_name=SyntheticDataLoader", f"--path={SPEC}",
            "--model_name=HYPELCNNModel", "--importer_name=GeneratorImporter",
            f"--neighborhood={NEIGHBORHOOD}", f"--algorithm_param_path={params_path}",
            f"--batch_size={TRAIN_BATCH}", f"--train_ratio={TRAIN_RATIO}",
            f"--test_ratio={TEST_RATIO}", f"--step={steps}",
            f"--save_checkpoint_steps={checkpoint_every}", f"--base_log_path={log_root}"]
    if augment:
        args += ["--augment_data_with_rotation", "--augment_data_with_reflection",
                 f"--augment_data_with_spectral={SPECTRAL}"]
    return args


def _expected_rank_launches(steps: int, counts: dict, world: int) -> dict:
    """One rank's gather launches in a train CLI run of ``steps`` steps from
    0: one a step, one an eval batch (each padded to a multiple of the ranks)."""
    def batches(n):
        return math.ceil(n / pad_to_multiple(min(EVAL_BATCH, n), world)) if n else 0
    drains = sum(1 for end in range(1, steps) if end % TEST_CADENCE == 0)
    evals = (drains + 1) * batches(counts["test"]) + batches(counts["validation"])
    return {"steps": steps, "eval_batches": evals, "total": steps + evals}


def _rank_launches(run: dict, batch: int) -> dict:
    steps = run["by_batch"].get(str(batch), 0)
    return {"steps": steps, "eval_batches": run["launches"] - steps, "total": run["launches"]}


def _band_gaps(module, scene, device, pixels: np.ndarray, batch_rows: int = BATCH_ROWS) -> float:
    """The largest gap between the two top logits, relative to the largest
    logit magnitude (at least 1), over ``pixels`` ((y, x) rows), each
    classified in its sweep band, as the sweep classifies it (CAP's logits
    depend on the band); 0 for no pixels."""
    height, width = scene.get_scene_shape()
    n_bands = (height + batch_rows - 1) // batch_rows
    k = scene.get_data_shape()[0]
    worst = 0.0
    starts = [min(min(y // batch_rows, n_bands - 1) * batch_rows, height - batch_rows)
              for y in pixels[:, 0]]
    for start in sorted(set(starts)):
        ys = np.repeat(np.arange(start, start + batch_rows), width)
        xs = np.tile(np.arange(width), batch_rows)
        coords = torch.from_numpy(np.stack([xs, ys], 1).astype(np.int32)).to(device)
        with torch.inference_mode():
            logits = module.eval()(gather_patches_torch(scene.device_scene(device), coords, k)
                                   ).y_conv
        top = logits.topk(2, dim=1).values
        gap = (top[:, 0] - top[:, 1]) / logits.abs().amax(dim=1).clamp(min=1)
        mine = [(y - start) * width + x for (y, x), s in zip(pixels, starts) if s == start]
        worst = max(worst, float(gap[mine].max()))
    return worst


def _same_but_ties(got: np.ndarray, expected: np.ndarray, module, scene, device,
                   what: str) -> dict:
    differ = np.argwhere(got != expected)
    gap = _band_gaps(module, scene, device, differ)
    check(gap < 1e-4, f"{what}: {len(differ)} pixels differ, top-two gap up to {gap}")
    return {"pixels_differ": int(len(differ)), "top_two_gap": gap}


def _state_equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def phase_dist_world1(device, work: Path, data) -> dict:
    """The train CLI at full HYPELCNN width (batch 48, 50 steps, no
    augmentation) in one plain process and in one NCCL rank that torchrun
    starts, both under cuDNN's and PyTorch's deterministic algorithms: the
    logged losses and the final checkpoints equal bit for bit (a mesh of one
    rank runs no collective), the gather's exact launches, and the traced
    step of each, whose kernels may differ only by collectives."""
    counts = {split: data.targets(split).shape[0] for split in ("training", "test", "validation")}
    root = work / "world1"
    runs = {}
    for name, nproc in (("plain", None), ("nccl", 1)):
        (rank0,) = _launch_ranks(root / f"{name}_ranks", [
            {"kind": "train_cli", "name": "cli",
             "args": _dist_train_args(root / name, DIST_WORLD1_STEPS, False, DIST_WORLD1_STEPS)},
            {"kind": "steps", "name": "steps", "augment": False}], nproc, deterministic=True)
        runs[name] = {"cli": rank0["cli"], "steps": rank0["steps"],
                      "nondeterministic_ops": rank0["nondeterministic_ops"]}
    dirs = {}
    for name in runs:
        (dirs[name],) = [p for p in (root / name).iterdir() if p.is_dir()]
    plain, nccl = runs["plain"], runs["nccl"]
    check(plain["cli"]["backend"] is None and nccl["cli"]["backend"] == "nccl",
          f"backends {plain['cli']['backend']}, {nccl['cli']['backend']}")
    losses = {name: _logged_losses(d) for name, d in dirs.items()}
    check(losses["plain"] == losses["nccl"]
          and len(losses["plain"]) == math.ceil(DIST_WORLD1_STEPS / 100),
          f"world-1 NCCL losses {losses['nccl']} against plain {losses['plain']}; operations "
          f"without a deterministic implementation: {plain['nondeterministic_ops']}")
    check(_state_equal(*(restore_checkpoint(str(d))["state_dict"] for d in dirs.values())),
          "the world-1 NCCL run's final weights differ from the plain run's")
    expected = _expected_launches(0, DIST_WORLD1_STEPS, counts["test"], counts["validation"])
    for name, run in runs.items():
        got = _rank_launches(run["cli"], TRAIN_BATCH)
        check(got == expected, f"world-1 {name}: gather launches {got}, expected {expected}")
        MAIN_PATH_RUNS.append({int(b): n for b, n in run["cli"]["by_batch"].items()})
    # the NCCL step's kernels: the plain step's, plus the collective and the
    # gradients' flattening
    added = {k: v - plain["steps"]["kernels"].get(k, 0) for k, v in nccl["steps"]["kernels"].items()
             if v > plain["steps"]["kernels"].get(k, 0)}
    collective = {k: v for k, v in added.items() if re.search(r"nccl|cat", k, re.I)}
    extra = nccl["steps"]["launches_per_step"] - plain["steps"]["launches_per_step"]
    check(extra <= sum(collective.values()) + 1,
          f"the world-1 NCCL step launches {extra} more kernels than the plain step, of which "
          f"{collective} are the collective's; added {added}")
    record = {"phase": "dist_world1", "steps": DIST_WORLD1_STEPS, "batch": TRAIN_BATCH,
              "logged_losses": losses["plain"], "losses_equal": True, "weights_equal": True,
              "gather_launches": expected, "backend": nccl["cli"]["backend"],
              "launches_per_step": {n: r["steps"]["launches_per_step"] for n, r in runs.items()},
              "kernels_added_per_step": added,
              "collectives": nccl["steps"]["collectives"],
              "nondeterministic_ops": plain["nondeterministic_ops"]}
    emit(record)
    return {"steps": 2 * DIST_WORLD1_STEPS, "eval_batches": 2 * expected["eval_batches"]}


def _cap_trained(device, root: Path, data) -> tuple:
    """CAP at full width trained a few steps (batch 16, one rank), saved for the ranks."""
    params = {**_cap_module("cpu")[1], "batch_size": 16}
    trainer = _trainer(data, params, device, model="CAPModel")
    state = trainer.init_state()
    tables = trainer.training_tables(DIST_CAP_STEPS, 16)
    for step in range(DIST_CAP_STEPS):
        trainer.train_step(state, tables, step)
    path = root / "cap_state.pt"
    torch.save({k: v.cpu() for k, v in state.module.state_dict().items()}, path)
    return state.module, path


def phase_dist_two_ranks(device, work: Path, data, pairs: dict) -> dict:
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    card), at full width: the HYPELCNN train CLI (global batch 48, 50 steps,
    augmentation, checkpoints every 10) and the infer CLI ``--domain all``
    from its checkpoint, CAP's sweep and cycle_gan's steps on the GRSS2013
    layout's pairs, each against one rank; then the two-rank checkpoint
    resumed in one rank against an uninterrupted one-rank run."""
    root = work / "two_ranks"
    root.mkdir(parents=True)
    counts = {split: data.targets(split).shape[0] for split in ("training", "test", "validation")}
    cap_module, cap_path = _cap_trained(device, root, data)
    n_pairs = pairs["normal"].shape[0]
    stream = make_epoch_index_stream(n_pairs, GAN_BATCH, DIST_GAN_STEPS,
                                     RngPool(SEED).numpy_rng("dist-gan"))
    batches = {}
    for step, idx in enumerate(torch.from_numpy(stream).to(device)):
        batches[f"x{step}"] = pairs["normal"].index_select(0, idx).cpu().numpy()
        batches[f"y{step}"] = pairs["shadow"].index_select(0, idx).cpu().numpy()
    np.savez(root / "gan_batches.npz", **batches)
    log_root, out_dir = root / "log", root / "infer"
    gan_task = {"kind": "gan", "name": "gan", "batches": str(root / "gan_batches.npz"),
                "steps": DIST_GAN_STEPS}
    steps_task = {"kind": "loss0", "name": "steps", "augment": True}
    ranks = _launch_ranks(root, [
        {"kind": "train_cli", "name": "cli",
         "args": _dist_train_args(log_root, DIST_STEPS, True, DIST_CHECKPOINT_EVERY)},
        {"kind": "infer_cli", "name": "infer", "log_root": str(log_root),
         "args": ["--device=cuda", "--loader_name=SyntheticDataLoader", f"--path={SPEC}",
                  f"--neighborhood={NEIGHBORHOOD}", f"--algorithm_param_path={PARAMS_PATH}",
                  f"--output_path={out_dir}", "--domain=all"]},
        steps_task,
        {"kind": "cap_sweep", "name": "cap", "state_dict": str(cap_path),
         "out": str(root / "cap_map.npy")},
        gan_task], nproc=2, deterministic=True)
    chief, other = ranks
    check(chief["cli"]["backend"] == other["cli"]["backend"] == "gloo",
          f"two ranks on one card ran {chief['cli']['backend']}")
    check(chief["cli"]["loss"] == other["cli"]["loss"]
          and chief["cli"]["test_oa"] == other["cli"]["test_oa"],
          f"the ranks disagree: {chief['cli']} / {other['cli']}")

    # one log dir, written by the chief alone
    (log_dir,) = [p for p in log_root.iterdir() if p.is_dir()]
    names = sorted(p.name for p in log_dir.iterdir())
    events = [n for n in names if n.startswith("events.out")]
    check(len(events) == 1 and events[0].endswith(f".{chief['cli']['pid']}")
          and sorted(set(names) - set(events)) == ["checkpoints", "summaries.jsonl"],
          f"the two-rank log dir holds {names}")
    saved = checkpoint_steps(str(log_dir))
    check(saved == list(range(DIST_CHECKPOINT_EVERY, DIST_STEPS + 1, DIST_CHECKPOINT_EVERY)),
          f"two-rank checkpoints at {saved}")
    expected = _expected_rank_launches(DIST_STEPS, counts, 2)
    share = TRAIN_BATCH // 2
    for rank, run in enumerate(ranks):
        got = _rank_launches(run["cli"], share)
        check(got == expected, f"rank {rank}: gather launches {got}, expected {expected}")
        check(run["infer"]["by_batch"] == {str(WIDTH * BATCH_ROWS // 2): 22},
              f"rank {rank}: infer launches {run['infer']['by_batch']}")
        MAIN_PATH_RUNS.append({int(b): n for b, n in run["cli"]["by_batch"].items()})
        MAIN_PATH_RUNS.append({int(b): n for b, n in run["infer"]["by_batch"].items()})
    logged = _logged_losses(log_dir)

    # one rank: the first step, the infer map, CAP's sweep, cycle_gan's steps
    with _deterministic():
        one = _rank_loss0(steps_task, device)
    rel0 = [abs(r["steps"]["loss0"] - one["loss0"]) / one["loss0"] for r in ranks]
    check(max(rel0) < 1e-4, f"step 1 loss: two ranks {[r['steps']['loss0'] for r in ranks]} "
                            f"against one {one['loss0']}")
    check(len(logged) == 1 and math.isfinite(logged[0][1]) and logged[0][1] < one["loss0"],
          f"two-rank logged losses {logged} against step 1's {one['loss0']}")
    scene = SyntheticDataLoader(SPEC).load_data(NEIGHBORHOOD, True)
    params = {**load_algorithm_params(HYPELCNNModel().default_params(), str(PARAMS_PATH)),
              "batch_size": TRAIN_BATCH}
    module = HYPELCNNModel().create_module(CLASSES, params, scene.get_data_shape())
    module.load_state_dict(restore_checkpoint(str(log_dir))["state_dict"])
    module.to(device)
    infer = _same_but_ties(imread(str(out_dir / "result_raw.tif")),
                           predict_full_scene(module, scene, device=device), module, scene,
                           device, "two-rank infer CLI")
    cap = _same_but_ties(np.load(root / "cap_map.npy"),
                         predict_full_scene(cap_module, scene, device=device), cap_module, scene,
                         device, "two-rank CAP sweep")
    gan_one = _rank_gan(gan_task, device)
    check(chief["gan"]["losses"] == other["gan"]["losses"], "the ranks' GAN losses differ")
    gan_rel = [abs(a - b) / abs(b) for a, b in zip(chief["gan"]["losses"], gan_one["losses"])]
    check(max(gan_rel) < 1e-4, f"cycle_gan losses differ from one rank's by {max(gan_rel)}")

    # the two-rank checkpoint at step 10, resumed in one rank to 20
    resume_root = root / "resume"
    shutil.copytree(log_dir, resume_root)
    for step in checkpoint_steps(str(resume_root)):
        if step != DIST_CHECKPOINT_EVERY:
            shutil.rmtree(resume_root / "checkpoints" / str(step))
    runs = {}
    for name, one_log in (("resumed", resume_root), ("straight", root / "straight")):
        trainer = ClassificationTrainer(
            model=HYPELCNNModel(), class_count=data.class_count, algorithm_params=params,
            scene=data.scene, sample_set=data.sample_set, sources=data.sources,
            data_shape=data.data_shape, augmentation_info=_augmentation(), device=device,
            log_dir=str(one_log), save_checkpoint_steps=DIST_CHECKPOINT_EVERY)
        reset_launches()
        with _deterministic(), contextlib.redirect_stdout(io.StringIO()):
            runs[name] = trainer.fit(DIST_RESUME_STEPS, TRAIN_BATCH)
        runs[name + "_launches"] = _rank_launches({
            "launches": window_gather_cuda.launches,
            "by_batch": {str(b): n for b, n in window_gather_cuda.launches_by_batch.items()}},
            TRAIN_BATCH)
        _note_main_path()
    resumed, straight = runs["resumed"], runs["straight"]
    check(resumed.steps_run == DIST_RESUME_STEPS - DIST_CHECKPOINT_EVERY
          and straight.steps_run == DIST_RESUME_STEPS,
          f"steps run: resumed {resumed.steps_run}, uninterrupted {straight.steps_run}")
    resume_launches, straight_launches = runs["resumed_launches"], runs["straight_launches"]
    resume_rel = abs(resumed.loss - straight.loss) / abs(straight.loss)
    check(resume_rel < 1e-4, f"resumed loss {resumed.loss} against uninterrupted "
                             f"{straight.loss}")
    record = {"phase": "dist_two_ranks_one_card", "ranks": 2, "backend": "gloo",
              "global_batch": TRAIN_BATCH, "steps": DIST_STEPS, "logged_losses": logged,
              "step1_loss": {"ranks": [r["steps"]["loss0"] for r in ranks], "one": one["loss0"],
                             "rel": rel0},
              "gather_launches_per_rank": expected, "test_oa": chief["cli"]["test_oa"],
              "checkpoints": saved, "log_dir_files": names,
              "infer": infer, "cap_sweep": cap,
              "gan": {"losses": chief["gan"]["losses"], "one_rank": gan_one["losses"],
                      "max_rel": max(gan_rel)},
              "resume": {"resumed_loss": resumed.loss, "uninterrupted_loss": straight.loss,
                         "rel": resume_rel}}
    emit(record)
    share_steps = sum(r["cli"]["by_batch"].get(str(share), 0) for r in ranks)
    return {"share_steps": share_steps,
            "share_evals": sum(r["cli"]["launches"] for r in ranks) - share_steps,
            "half_bands": sum(r["infer"]["launches"] for r in ranks),
            "steps": resume_launches["steps"] + straight_launches["steps"],
            "eval_batches": resume_launches["eval_batches"] + straight_launches["eval_batches"]}


def phase_tp_two_ranks(device, work: Path, data) -> dict:
    """Tensor parallelism: a (1, 2) mesh, two ranks on the one card over
    gloo, HYPELCNN at the 1200 width the model axis was written for, batch
    48, augmentation on. Its losses against one rank on the card from the
    same init (step 1 within 1e-4); its full-width checkpoint resumed in one
    rank (a test drain and a sweep of 3 bands on those weights equal the
    ranks' but for top-two ties, and 5 more steps within 1e-3 of an
    uninterrupted one-rank run); the 13 sharded kernels; each rank's
    model-axis collectives a step."""
    root = work / "tp_two_ranks"
    root.mkdir(parents=True)
    log_dir, map_path = root / "log", root / "tp_map.npy"
    saved = TP_STEPS + TP_COUNTED_STEPS
    ranks = _launch_ranks(root, [{
        "kind": "tp", "name": "tp", "model_parallel": 2, "params_path": str(TP_PARAMS_PATH),
        "steps": TP_STEPS, "counted_steps": TP_COUNTED_STEPS, "log_dir": str(log_dir),
        "sweep_spec": TP_SWEEP_SPEC, "map": str(map_path)}], nproc=2, deterministic=True)
    chief, other = (r["tp"] for r in ranks)
    check(chief["backend"] == other["backend"] == "gloo", f"TP ranks ran {chief['backend']}")
    check([(r["data_rank"], r["model_rank"]) for r in (chief, other)] == [(0, 0), (0, 1)],
          "the (1, 2) mesh's ranks are not laid out as JAX lays out its devices")
    check(chief["losses"] == other["losses"] and chief["test"] == other["test"],
          f"the model ranks disagree: {chief['losses']} / {other['losses']}")
    n_test = data.targets("test").shape[0]
    expected = {str(TRAIN_BATCH): saved, str(n_test): 1, str(WIDTH * BATCH_ROWS): TP_SWEEP_BANDS}
    for rank, run in enumerate((chief, other)):
        check(run["launches"] == expected,
              f"TP rank {rank}: gather launches {run['launches']}, expected {expected}")
        MAIN_PATH_RUNS.append({int(b): n for b, n in run["launches"].items()})

    with _deterministic():
        trainer = _tp_trainer(TP_PARAMS_PATH, device, create_mesh())
        state = trainer.init_state()
        full = state.module.state_dict()
        sharded = sorted(tp_sharded_keys(full, 2))
        check(chief["sharded"] == sharded and len(sharded) == TP_SHARDED_KERNELS,
              f"TP sharded {len(chief['sharded'])} kernels, JAX's rule {len(sharded)}, "
              f"expected {TP_SHARDED_KERNELS}")
        tables = trainer.training_tables(saved + TP_RESUME_STEPS, TRAIN_BATCH)
        one = [float(trainer.train_step(state, tables, step)) for step in range(TP_STEPS)]
        rel = [abs(a - b) / abs(b) for a, b in zip(chief["losses"], one)]
        check(rel[0] < 1e-4, f"TP step 1 loss {chief['losses'][0]} against one rank's {one[0]}")
        for step in range(TP_STEPS, saved):
            trainer.train_step(state, tables, step)

        # the ranks' checkpoint at full width, resumed in one rank
        restored = restore_checkpoint(str(log_dir))
        check(restored["step"] == saved and all(
            restored["state_dict"][k].shape == v.shape for k, v in full.items()),
            "the TP checkpoint is not the one-rank layout")
        resumed = trainer.init_state()
        resumed.restore(restored)
        confusion = trainer.evaluate(resumed, "test").confusion
        drain_differ = int(np.abs(np.asarray(chief["test"]) - confusion).sum()) // 2
        check(drain_differ <= TP_DRAIN_DIFFER,
              f"TP test drain: {drain_differ} of {n_test} windows differ from one rank's")
        scene = SyntheticDataLoader(TP_SWEEP_SPEC).load_data(NEIGHBORHOOD, True)
        sweep = _same_but_ties(np.load(map_path),
                               predict_full_scene(resumed.module, scene, device=device),
                               resumed.module, scene, device, "TP sweep")
        resumed.module.train()
        after = [float(trainer.train_step(resumed, tables, step))
                 for step in range(saved, saved + TP_RESUME_STEPS)]
        straight = [float(trainer.train_step(state, tables, step))
                    for step in range(saved, saved + TP_RESUME_STEPS)]
    resume_rel = max(abs(a - b) / abs(b) for a, b in zip(after, straight))
    check(resume_rel < 1e-3, f"one rank resumed from the TP checkpoint: {after} against "
                             f"uninterrupted {straight}")
    emit({"phase": "tp_two_ranks_one_card", "mesh": {"data": 1, "model": 2},
          "backend": "gloo", "config": str(TP_PARAMS_PATH.relative_to(ROOT)),
          "global_batch": TRAIN_BATCH, "sharded_kernels": len(sharded), "sharded": sharded,
          "losses": {"ranks": chief["losses"], "one_rank": one, "rel": rel},
          "channel_gathers_per_step": [r["channel_gathers_per_step"] for r in (chief, other)],
          "gradient_sums_per_step": [r["gradient_sums_per_step"] for r in (chief, other)],
          "checkpoint_step": saved, "drain_windows_differ": drain_differ,
          "sweep": {**sweep, "bands": TP_SWEEP_BANDS,
                    "channel_gathers": chief["sweep_channel_gathers"]},
          "resume": {"resumed": after, "uninterrupted": straight, "max_rel": resume_rel},
          "gather_launches_per_rank": expected})
    return {"steps": 2 * saved, "drains": 2, "bands": 2 * TP_SWEEP_BANDS}


def phase_tp_four_ranks(device, work: Path) -> dict:
    """A (2, 2) mesh, four ranks on the one card over gloo, HYPELCNN at its
    published 480 width, global batch 48: each data index's 24 windows,
    the 8 sharded kernels, the losses against one rank on the card (step 1
    within 1e-4), each rank's collectives."""
    root = work / "tp_four_ranks"
    steps = TP4_STEPS + TP4_COUNTED_STEPS
    ranks = [r["tp"] for r in _launch_ranks(root, [{
        "kind": "tp", "name": "tp", "model_parallel": 2, "params_path": str(PARAMS_PATH),
        "steps": TP4_STEPS, "counted_steps": TP4_COUNTED_STEPS}], nproc=4, deterministic=True)]
    check([(r["data_rank"], r["model_rank"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)],
          "the (2, 2) mesh's ranks are not laid out as JAX lays out its devices")
    check(all(r["losses"] == ranks[0]["losses"] for r in ranks), "the four ranks disagree")
    expected = {str(TRAIN_BATCH // 2): steps}
    for rank, run in enumerate(ranks):
        check(run["launches"] == expected,
              f"(2, 2) rank {rank}: gather launches {run['launches']}, expected {expected}")
        MAIN_PATH_RUNS.append({int(b): n for b, n in run["launches"].items()})
    with _deterministic():
        trainer = _tp_trainer(PARAMS_PATH, device, create_mesh())
        state = trainer.init_state()
        sharded = sorted(tp_sharded_keys(state.module.state_dict(), 2))
        tables = trainer.training_tables(TP4_STEPS, TRAIN_BATCH)
        one = [float(trainer.train_step(state, tables, step)) for step in range(TP4_STEPS)]
    check(ranks[0]["sharded"] == sharded and len(sharded) == TP4_SHARDED_KERNELS,
          f"(2, 2) sharded {len(ranks[0]['sharded'])} kernels, JAX's rule {len(sharded)}")
    rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], one)]
    check(rel[0] < 1e-4,
          f"(2, 2) step 1 loss {ranks[0]['losses'][0]} against one rank's {one[0]}")
    emit({"phase": "tp_data_model_four_ranks", "mesh": {"data": 2, "model": 2},
          "backend": ranks[0]["backend"], "global_batch": TRAIN_BATCH,
          "sharded_kernels": len(sharded),
          "losses": {"ranks": ranks[0]["losses"], "one_rank": one, "rel": rel},
          "channel_gathers_per_step": [r["channel_gathers_per_step"] for r in ranks],
          "gradient_sums_per_step": [r["gradient_sums_per_step"] for r in ranks],
          "gather_launches_per_rank": expected})
    return {"steps": 4 * steps}


def phase_search_two_ranks(device, work: Path, data) -> dict:
    """The train CLI's search under torchrun, two ranks on the one card over
    gloo: HYPELCNN's published JSON pinned but a log-uniform learning rate,
    global batch 48, 2 trials of 20 steps. Both ranks run the trials the
    chief drew, in the same log dirs; only the chief opens the study, whose
    file alone is in the working directory."""
    root = work / "search_ranks"
    workdir = root / "run"
    workdir.mkdir(parents=True)
    space_path = root / "space.json"
    space_path.write_text(json.dumps({**json.loads(PARAMS_PATH.read_text()),
                                      "batch_size": TRAIN_BATCH,
                                      "learning_rate": SEARCH_LEARNING_RATE}))
    base = workdir / "classifier"
    args = ["--device=cuda", "--loader_name=SyntheticDataLoader", f"--path={SPEC}",
            "--model_name=HYPELCNNModel", "--importer_name=GeneratorImporter",
            f"--neighborhood={NEIGHBORHOOD}", f"--train_ratio={TRAIN_RATIO}",
            f"--test_ratio={TEST_RATIO}", f"--step={SEARCH_RANK_STEPS}",
            f"--flag_config_file_opt={space_path}", "--opt_trial_count=2", "--opt_run_count=1",
            f"--base_log_path={base}"]
    chief, other = (r["search"] for r in _launch_ranks(root, [
        {"kind": "search", "name": "search", "workdir": str(workdir), "args": args}], nproc=2))
    check(chief["connects"] > 0 and other["connects"] == 0,
          f"sqlite connections by rank: {chief['connects']}, {other['connects']}")
    check(sorted(p.name for p in workdir.iterdir() if p.is_file()) == ["classification_opt.db"],
          f"the search's working directory holds {sorted(p.name for p in workdir.iterdir())}")
    rows = _study_rows(workdir / "classification_opt.db")
    check([r[:2] for r in rows] == [("classification_opt", 0), ("classification_opt", 1)]
          and all(0.0 <= r[2] <= 1.0 for r in rows), f"the two-rank study: {rows}")
    check(chief["episodes"] == other["episodes"] and len(chief["episodes"]) == 2
          and chief["trials"] == other["trials"]
          and [t["params"] for t in chief["trials"]] == [json.loads(r[3]) for r in rows],
          f"the ranks ran different trials: {chief['episodes']} / {other['episodes']}")
    dirs = _trial_dirs(base)
    check(sorted(str(d) for d in dirs) == sorted(e["log"] for e in chief["episodes"]),
          f"trial log dirs {dirs} against the episodes' {chief['episodes']}")
    counts = {split: data.targets(split).shape[0] for split in ("training", "test", "validation")}
    expected = _expected_rank_launches(SEARCH_RANK_STEPS, counts, 2)
    share = TRAIN_BATCH // 2
    for rank, run in enumerate((chief, other)):
        got = _rank_launches({"launches": run["total_launches"], "by_batch": run["launches"]},
                             share)
        want = {key: 2 * value for key, value in expected.items()}
        check(got == want, f"search rank {rank}: gather launches {got}, expected {want}")
        MAIN_PATH_RUNS.append({int(b): n for b, n in run["launches"].items()})
    emit({"phase": "search_two_ranks", "ranks": 2, "steps": SEARCH_RANK_STEPS,
          "global_batch": TRAIN_BATCH,
          "trials": [{"number": r[1], "value": r[2], "params": json.loads(r[3])} for r in rows],
          "episodes": chief["episodes"], "sqlite_connections": [chief["connects"], 0],
          "gather_launches_per_rank": {key: 2 * value for key, value in expected.items()}})
    share_steps = 2 * 2 * expected["steps"]
    return {"share_steps": share_steps, "share_evals": 2 * 2 * expected["eval_batches"]}


def phase_bf16(device, work: Path, data, train, families: dict) -> dict:
    """``compute_dtype: "bfloat16"``: HYPELCNN's published JSON so changed
    through the train CLI (100 steps, the ``train`` phase's augmentation),
    the ``train`` phase's checkpoint swept in bfloat16 against float32, and
    CONCNN and DUALCNN 3 steps card against CPU."""
    published = json.loads(PARAMS_PATH.read_text())
    params_path = work / "alg_param_hypelcnn_bf16.json"
    params_path.write_text(json.dumps({**published, "compute_dtype": "bfloat16"}))
    counts = {split: data.targets(split).shape[0] for split in ("training", "test", "validation")}
    log_root = work / "bf16_log"
    reset_launches()
    result, _ = _run_train_cli(_dist_train_args(log_root, BF16_STEPS, True, BF16_STEPS,
                                                params_path))
    launches = window_gather_cuda.launches
    by_batch = _note_main_path()
    gather = _check_launches("bf16", by_batch, launches, counts, BF16_STEPS, TRAIN_BATCH)
    (log_dir,) = [p for p in log_root.iterdir() if p.is_dir()]
    logged = _logged_losses(log_dir)

    # the CLI's first step again, in bfloat16
    params = {**load_algorithm_params(HYPELCNNModel().default_params(), str(PARAMS_PATH)),
              "batch_size": TRAIN_BATCH}
    trainer = _trainer(data, {**params, "compute_dtype": "bfloat16"}, device, _augmentation())
    loss0 = float(trainer.train_step(trainer.init_state(), trainer.training_tables(1, TRAIN_BATCH),
                                     0))
    check(len(logged) == 1 and math.isfinite(logged[0][1]) and logged[0][1] < loss0,
          f"bfloat16 logged losses {logged} against step 1's {loss0}")

    # the trained float32 weights swept in both types
    scene = SyntheticDataLoader(SPEC).load_data(NEIGHBORHOOD, True)
    trained = restore_checkpoint(str(train["log_dir"]))["state_dict"]
    maps = {}
    for dtype in ("float32", "bfloat16"):
        module = HYPELCNNModel().create_module(CLASSES, {**params, "compute_dtype": dtype},
                                               scene.get_data_shape())
        module.load_state_dict(trained)
        module.to(device)
        maps[dtype] = predict_full_scene(module, scene, device=device)
    agreement = float((maps["float32"] == maps["bfloat16"]).mean())
    check(agreement >= BF16_SWEEP_AGREEMENT,
          f"bfloat16 sweep agrees with float32 on {agreement} of the pixels")

    # CONCNN and DUALCNN, 3 steps card against CPU in bfloat16
    card_vs_cpu = {}
    for family in FAMILIES[:2]:
        fam = families[family.phase]
        out = _card_vs_cpu(device, fam["data"], {**fam["params"], "compute_dtype": "bfloat16"},
                           family, 3, rel_step1=BF16_CARD_VS_CPU)
        check(max(out["rel_diff"]) < BF16_CARD_VS_CPU,
              f"{family.model} in bfloat16: card against CPU {out['rel_diff']}")
        card_vs_cpu[family.model] = out
    record = {"phase": "bf16", "steps": BF16_STEPS, "logged_losses": logged,
              "step1_loss": loss0, **gather, "test_oa": result.test_accuracy,
              "sweep_agreement": agreement, "sweep_agreement_threshold": BF16_SWEEP_AGREEMENT,
              "card_vs_cpu": card_vs_cpu}
    emit(record)
    return {"steps": gather["gather_launches"]["steps"],
            "eval_batches": gather["gather_launches"]["eval_batches"]}


def _event_times(fn, inputs) -> list:
    """Per-call device time in ms, from CUDA events around each call. A
    sleep kernel first holds the stream until every call is queued behind
    it, so the events time the device's work, not the host's launch overhead
    (which is longer than a small batch's kernel)."""
    fn(inputs[0])
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    times = []
    for item in inputs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(item)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in times]


def _window_rows(coords: torch.Tensor, k: int) -> tuple:
    """The scene rows and columns of every window's pixels, ``[B, k, 1]`` and
    ``[B, 1, k]``: in range for a batch that lies inside the padded scene."""
    offs = torch.arange(k, device=coords.device)
    return (coords[:, 1, None] + offs)[:, :, None], (coords[:, 0, None] + offs)[:, None, :]


def _gather_bytes(coords: torch.Tensor, k: int, channels: int, width: int) -> tuple:
    """Bytes that the gather of one batch must move: each output float
    written once; each distinct pixel of a scene ``width`` pixels wide that
    the windows cover, and the coordinates, read once. (written, read)"""
    ys, xs = _window_rows(coords, k)
    distinct_pixels = int(torch.unique((ys * width + xs).reshape(-1)).numel())
    batch = coords.shape[0]
    return batch * k * k * channels * 4, distinct_pixels * channels * 4 + batch * 2 * 4


def _bound_ms(moved_bytes: int, device_name: str):
    """The least time in ms to move ``moved_bytes`` at the card's HBM
    bandwidth (``portbench/counts.py``); None for a card not in its table."""
    bandwidth = peak(device_name, "hbm_bytes_per_s")
    return None if bandwidth is None else moved_bytes / bandwidth * 1e3


def _gather_row(scene_dev, batches, launches: int, shape_note: str = "",
                k: int = 2 * NEIGHBORHOOD + 1) -> dict:
    """One kernel row: the CUDA gather on each coordinate batch, bit-exact
    against the plain version, then timed beside it and the library call."""
    _, wp, channels = scene_dev.shape
    index_pairs = [_window_rows(c, k) for c in batches]
    before = (window_gather_cuda.launches, window_gather_cuda.launches_by_batch.copy())
    err = 0.0
    for coords in batches:
        got = window_gather_cuda(scene_dev, coords, k)
        err = max(err, float((got - gather_patches_torch(scene_dev, coords, k)).abs().max()))
    check(err == 0.0, f"window_gather differs from its plain version at "
                      f"{tuple(batches[0].shape)}: {err}")
    ms = statistics.median(_event_times(lambda c: window_gather_cuda(scene_dev, c, k), batches))
    plain_ms = statistics.median(_event_times(lambda c: gather_patches_torch(scene_dev, c, k),
                                              batches))
    library_ms = statistics.median(_event_times(lambda yx: scene_dev[yx[0], yx[1]], index_pairs))
    window_gather_cuda.launches, window_gather_cuda.launches_by_batch = before
    batch = batches[0].shape[0]
    out_bytes, read_bytes = _gather_bytes(batches[0], k, channels, wp)
    return {"name": "window_gather", "route": "cuda",
            "source": "hypelcnn_tpu_torch/csrc/window_gather.cu",
            "replaces": "hypelcnn_tpu/ops/window_gather.py:183",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": _bound_ms(out_bytes + read_bytes,
                                  torch.cuda.get_device_name(scene_dev.device)),
            "bound_by": "bytes", "library_ms": library_ms,
            "shape": f"{batch}x{k}x{k}x{channels} f32{shape_note}",
            "bytes_written": out_bytes, "bytes_read": read_bytes}


def _training_batches(tables, start: int, count: int) -> list:
    return [tables.coords.index_select(0, tables.indices[step])
            for step in range(start, start + count)]


def _bands(device, count: int = 20) -> list:
    """The coordinates of ``count`` consecutive sweep bands, so each call
    reads scene rows the last one did not."""
    rows = torch.arange(BATCH_ROWS, device=device, dtype=torch.int32)
    cols = torch.arange(WIDTH, device=device, dtype=torch.int32)
    band = torch.stack([cols.repeat(BATCH_ROWS), rows.repeat_interleave(WIDTH)], dim=1)
    return [band.add(torch.tensor([0, 1], dtype=torch.int32, device=device),
                     alpha=min(i * BATCH_ROWS, HEIGHT - BATCH_ROWS)) for i in range(count)]


def phase_kernels(device, scene, launches: int, train, families: dict, loaders: dict,
                  augmented_launches: int, later: dict, dist: dict, classic: dict,
                  tp: dict) -> None:
    """Kernel rows; ``launches`` are the sweeps' (``infer_all``'s and the
    infer CLI's on the JAX step), ``train["launches"]`` the
    train CLI run's, split by batch size; ``families`` the family phases'
    results, with their launches by batch size; ``loaders`` the GULFPORT and
    AVON phases', whose train CLI runs launch at C = 65 and C = 360;
    ``augmented_launches`` the GAN-augmented train CLI runs' steps';
    ``later`` the search, TF checkpoint, JAX log dir, world-1, resume and
    bfloat16 train CLI runs' launches (``steps`` at the step's batch, ``eval_batches`` at
    the drains'); ``dist`` the two-rank runs' launches at a rank's shares
    (the search under two ranks included); ``classic`` the classic-ML CLI's
    scene, coordinates and launches (k = 1); ``tp`` the tensor-parallel
    ranks' launches."""
    scene_dev = scene.device_scene(device)
    rows = [_gather_row(scene_dev, _bands(device), launches)]
    # the training path's shapes: the step's batch and the eval drain's
    tables, train_launches = train["tables"], train["launches"]
    rows.append(_gather_row(scene_dev, _training_batches(tables, 0, KERNEL_CALLS),
                            train_launches["steps"] + augmented_launches + later["steps"],
                            " (training step; with the GAN-augmented, search, TF-checkpoint,"
                            " JAX-resumed, world-1, one-rank resume and bfloat16 steps)"))
    train_coords = tables.coords
    gen = torch.Generator(device=device).manual_seed(SEED)
    eval_batches = [train_coords.index_select(0, torch.randperm(
        train_coords.shape[0], generator=gen, device=device)[:EVAL_BATCH])
        for _ in range(KERNEL_CALLS)]
    rows.append(_gather_row(scene_dev, eval_batches,
                            train_launches["eval_batches"] + later["eval_batches"],
                            " (eval drain; its launches include the test drains' smaller batches"
                            " and the later one-rank train CLI runs' drains)"))
    # a rank's shares in the two-rank runs
    rows.append(_gather_row(scene_dev, [c[:TRAIN_BATCH // 2]
                                        for c in _training_batches(tables, 0, KERNEL_CALLS)],
                            dist["share_steps"],
                            " (a rank's half of the training step: two ranks, global batch 48)"))
    rows.append(_gather_row(scene_dev, [c[:EVAL_BATCH // 2] for c in eval_batches],
                            dist["share_evals"],
                            " (a rank's half of an eval-drain batch; its launches include the"
                            " test drain's 1,663-window halves)"))
    rows.append(_gather_row(scene_dev, [c[:WIDTH * BATCH_ROWS // 2] for c in _bands(device)],
                            dist["half_bands"], " (a rank's half of a sweep band)"))
    # the tensor-parallel ranks: each model rank gathers its data index's whole rows
    rows.append(_gather_row(scene_dev, _training_batches(tables, 0, KERNEL_CALLS), tp["steps"],
                            " (a (1, 2) mesh's rank: the whole training step, HYPELCNN-1200)"))
    rows.append(_gather_row(scene_dev, [c[:TRAIN_BATCH // 2]
                                        for c in _training_batches(tables, 0, KERNEL_CALLS)],
                            tp["four_ranks_steps"],
                            " (a (2, 2) mesh's rank: its data index's half of the step)"))
    n_test = train["trainer"].sample_set.test_targets.shape[0]
    rows.append(_gather_row(scene_dev, [c[:n_test] for c in eval_batches], tp["drains"],
                            " (a (1, 2) mesh's rank: the whole test drain)"))
    rows.append(_gather_row(scene_dev, _bands(device), tp["bands"],
                            " (a (1, 2) mesh's rank: a whole sweep band)"))
    # a single window: the smallest launch (one block; a thread's chunk is a
    # dependent coordinate load, then its scene loads); its launches are
    # those of every main-path run at B = 1, and there should be none
    single = sum(run.get(1, 0) for run in MAIN_PATH_RUNS)
    check(single == 0, f"the main path launched the gather {single} times at B = 1")
    rows.append(_gather_row(scene_dev,
                            [c[:1] for c in _training_batches(tables, 0, KERNEL_CALLS)], single,
                            " (one window: the smallest launch; not a main-path shape)"))
    # the shapes the other families add: the k = 5 band of CONCNN's and
    # DUALCNN's sweeps, and each family's training step
    band = WIDTH * BATCH_ROWS
    k5 = [families[name] for name in ("family_concnn", "family_dualcnn")]
    rows.append(_gather_row(k5[0]["scene"].device_scene(device), _bands(device),
                            sum(f["sweep_launches"][band] for f in k5),
                            " (k = 5 sweep band: CONCNN and DUALCNN)", k=5))
    for name in ("family_concnn", "family_dualcnn", "family_cap"):
        fam = families[name]
        family = fam["family"]
        rows.append(_gather_row(
            fam["scene"].device_scene(device), _training_batches(fam["tables"], 0, KERNEL_CALLS),
            fam["train_launches"][family.batch],
            f" ({family.model} training step)", k=2 * family.neighborhood + 1))
    for name, note in (("loader_gulfport", "GULFPORT-ALT"), ("loader_avon", "AVON")):
        phase = loaders[name]
        rows.append(_gather_row(
            phase["scene"].device_scene(device),
            _training_batches(phase["tables"], 0, KERNEL_CALLS),
            phase["run"]["by_batch"][LOADER_BATCH], f" ({note} training step)"))
    # the classic-ML CLI's shapes, k = 1 on the unnormalized scene: each
    # split once, and the full scene in batches
    for split in ("training", "validation"):
        coords = classic["coords"][split]
        rows.append(_gather_row(classic["scene"], [coords] * KERNEL_CALLS,
                                classic["by_batch"][coords.shape[0]],
                                f" (classic ML: the {split} split, the same coordinates each call)",
                                k=1))
    full = [b for b in classic["scene_coords"] if b.shape[0] == CLASSIC_BATCH]
    rows.append(_gather_row(classic["scene"], [b.contiguous() for b in full],
                            classic["by_batch"][CLASSIC_BATCH],
                            " (classic ML: a full-scene batch; the scene's last, shorter batch"
                            " launches once more)", k=1))
    # the empty-launch floor: a kernel that does nothing, timed as the rows
    # are; an instrument beside the rows, which the port never calls
    floor = _event_times(lambda _: torch.cuda._sleep(0), [None] * KERNEL_CALLS)
    floor_ms = statistics.median(floor)
    emit({"phase": "launch_floor", "kernel": "torch.cuda._sleep(0)", "ms": floor_ms,
          "min_ms": min(floor), "max_ms": max(floor)})
    for row in rows:
        row["floor_ms"] = floor_ms
    emit({"kernels": rows})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    seconds = {}

    def timed(phase, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - start
        emit({"phase_done": phase, "seconds": seconds[phase],
              "device_allocated_bytes": torch.cuda.memory_allocated(),
              "device_reserved_bytes": torch.cuda.memory_reserved()})
        return out

    name = timed("device", phase_device)
    timed("build", phase_build)
    timed("kernel_vs_plain", phase_kernel_vs_plain, device)
    families = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        data = _training_data()
        world1 = timed("dist_world1", phase_dist_world1, device, Path(work), data)
        scene, launches = timed("infer_all", phase_infer_all, device, Path(work))
        train = timed("train", phase_train, device, Path(work), data)
        timed("train_vs_cpu", phase_train_vs_cpu, device, data, train["params"])
        timed("resume", phase_resume, device, train)
        timed("infer_trained", phase_infer_trained, device, Path(work), train)
        for family in FAMILIES:
            families[family.phase] = timed(family.phase, phase_family, device, Path(work), family)
        grss2013 = timed("loader_grss2013", phase_loader_grss2013, device, Path(work))
        timed("loader_grss2018", phase_loader_grss2018, device, Path(work))
        loaders = {"loader_gulfport": timed("loader_gulfport", phase_loader_gulfport, device,
                                            Path(work)),
                   "loader_avon": timed("loader_avon", phase_loader_avon, device, Path(work))}
        root = grss2013["root"]
        gan = timed("gan_train", phase_gan_train, device, Path(work), root)
        timed("gan_families", phase_gan_families, device, gan["pairs"])
        timed("gan_infer", phase_gan_infer, device, Path(work), root, gan["log_dir"])
        timed("gan_infer_image", phase_gan_infer_image, device, Path(work), root, gan["log_dir"])
        augmented = timed("gan_augmented", phase_gan_augmented, device, Path(work), root,
                          gan["log_dir"])
        searched = timed("search", phase_search, device, Path(work), root, grss2013)
        timed("records", phase_records, device, Path(work), root)
        imported = timed("tf_checkpoint", phase_tf_checkpoint, device, Path(work), root)
        jax_logs = timed("jax_log_dir", phase_jax_log_dir, device, Path(work), root, data)
        dist = timed("dist_two_ranks_one_card", phase_dist_two_ranks, device, Path(work), data,
                     gan["pairs"])
        del gan["pairs"]
        tp = timed("tp_two_ranks_one_card", phase_tp_two_ranks, device, Path(work), data)
        tp["four_ranks_steps"] = timed("tp_data_model_four_ranks", phase_tp_four_ranks, device,
                                       Path(work))["steps"]
        searched_ranks = timed("search_two_ranks", phase_search_two_ranks, device, Path(work),
                               data)
        for key in ("share_steps", "share_evals"):
            dist[key] += searched_ranks[key]
        bf16 = timed("bf16", phase_bf16, device, Path(work), data, train, families)
        timed("utilities", phase_utilities, device, Path(work),
              {"grss2013": root, "grss2018": Path(work) / "grss2018",
               "gulfport": Path(work) / "gulfport"}, train["log_dir"])
        classic = timed("classic_ml", phase_classic_ml, device, Path(work))
    timed("fused_levels", phase_fused_levels, device, scene, families["family_dualcnn"])
    later = {key: sum(run[key] for run in (searched, imported, jax_logs, world1, dist, bf16))
             for key in ("steps", "eval_batches")}
    timed("kernels", phase_kernels, device, scene, launches + jax_logs["bands"], train, families,
          loaders, augmented, later, dist, classic, tp)
    torch.cuda.synchronize()
    emit({"phase_seconds": seconds, "total_seconds": sum(seconds.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-task":
        sys.exit(rank_main(sys.argv[2]))
    sys.exit(main())
