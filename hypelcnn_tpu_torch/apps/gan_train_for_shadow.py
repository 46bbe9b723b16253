"""GAN shadow-translation training CLI (``hypelcnn_tpu/apps/gan_train_for_shadow.py``).

The same flags and defaults, the same log-dir codec and output files, plus
``--device`` (``cuda`` unless asked for ``cpu``)::

    python -m hypelcnn_tpu_torch.apps.gan_train_for_shadow \\
        --loader_name=GRSS2013DataLoader --path=DATA --gan_type=cycle_gan \\
        --pairing_method=random --batch_size=32 --step=2000 --validation_steps=1000 \\
        --base_log_path=LOG_ROOT/run

The scene is read at neighborhood 0 and paired into unpaired (lit,
shadowed) pixels on the host; both pair arrays then live on the device, and
each step selects its rows by the step's row of an epoch-shuffled index
stream (bit-equal to the JAX package's), with no host read. At every
validation cadence the CLI prints the generator loss, validates both
directions (``best_ratio_*.json``), and writes a params snapshot
(``ckpt_params_N``) and the full state (``checkpoints/N``, the last
``step // validation_steps`` kept), each an orbax checkpoint the JAX
package reads; at the end ``gan_params``, which
``gan_infer_for_shadow``, ``gan_infer_image_for_shadow`` and the classifier's
``--augment_data_with_shadow`` read. A log dir that holds a full state is
resumed from, the JAX package's as well.

Under ``torchrun`` with more than one rank the trainer runs data-parallel
(``use_mesh``): every rank draws the same global batch (and its
regularization-support swap) and trains on its rows; ``--batch_size`` must
divide over the ranks. The chief alone validates, prints and writes
``best_ratio_*.json``, ``ckpt_params_*``, the full states and ``gan_params``.

``--flag_config_file_opt=SPACE.json`` (``configs/gan/*_flags_opt.json``)
runs a hyperparameter search instead: ``--opt_trial_count`` trials of
``--opt_run_count`` runs each, every run a session on ``--device`` with the
space's suggestions laid over the flags, under ``<base_log_path>_<random
suffix>``. A trial's score is the largest of its runs' mean divergences; the
study ``gan_shadow_opt`` is kept in ``gan_shadow_opt.db`` in the working
directory, and a rerun continues it. Under torchrun the chief alone opens
the study, draws each trial's flags and run suffixes and records the value;
every rank receives the draws and runs the same sessions
(``tune/search.py``).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
from types import SimpleNamespace
from typing import Callable, List

import numpy as np
import torch

from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_json_loader,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
    add_parse_cmds_for_opt,
    add_parse_cmds_for_trainers,
    merge_flag_config_json,
    type_ensure_strtobool,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_loader_from_name
from hypelcnn_tpu_torch.core.rng import DEFAULT_SEED, RngPool
from hypelcnn_tpu_torch.gan.sampling import read_hsi_data
from hypelcnn_tpu_torch.gan.validation import PeerValidator
from hypelcnn_tpu_torch.gan.wrapper_registry import get_sampling_map, get_trainer_dict
from hypelcnn_tpu_torch.gan.wrappers.base import GANState, GANTrainerBase
from hypelcnn_tpu_torch.parallel.distributed import (
    finalize_distributed,
    is_chief,
    join_rank,
    world_size,
)
from hypelcnn_tpu_torch.parallel.mesh import create_mesh
from hypelcnn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint, save_params
from hypelcnn_tpu_torch.train.trainer import make_epoch_index_stream
from hypelcnn_tpu_torch.tune.search import Study, create_study, objective
from hypelcnn_tpu_torch.utils.text import replace_abbrs


def add_parse_cmds_for_app(parser) -> None:
    parser.add_argument("--gan_type", nargs="?", type=str, default="cycle_gan",
                        help="Gan type to train, possible values; cycle_gan, gan_x2y, gan_y2x, "
                             "cut_x2y, cut_y2x, dcl_gan, dcl_cycle_gan")
    parser.add_argument("--use_identity_loss", nargs="?", type=type_ensure_strtobool,
                        default=True, help="Whether to use identity loss during training.")
    parser.add_argument("--identity_loss_weight", nargs="?", type=float, default=0.5,
                        help="The weight of identity loss.")
    parser.add_argument("--regularization_support_rate", nargs="?", type=float, default=0.0,
                        help="The regularization support rate, ranges from 0 to 1.")
    parser.add_argument("--cycle_consistency_loss_weight", nargs="?", type=float, default=10.0,
                        help="The weight of cycle consistency loss.")
    parser.add_argument("--nce_loss_weight", nargs="?", type=float, default=10.0,
                        help="The weight of NCE loss.")
    parser.add_argument("--tau", nargs="?", type=float, default=0.07,
                        help="Tau value for the NCE loss.")
    parser.add_argument("--patches", nargs="?", type=int, default=6,
                        help="Patch count for feature discriminator (CUT/DCL GANs)")
    parser.add_argument("--embedded_feat_size", nargs="?", type=int, default=2,
                        help="Embedded feature size for feature discriminator (CUT/DCL GANs)")
    parser.add_argument("--validation_steps", nargs="?", type=int, default=1000,
                        help="Validation frequency")
    parser.add_argument("--validation_sample_count", nargs="?", type=int, default=300,
                        help="Validation sample count")
    parser.add_argument("--generator_lr", nargs="?", type=float, default=0.0002,
                        help="The generator learning rate.")
    parser.add_argument("--discriminator_lr", nargs="?", type=float, default=0.0001,
                        help="The discriminator learning rate.")
    parser.add_argument("--gen_discriminator_lr", nargs="?", type=float, default=0.0001,
                        help="The generator discriminator learning rate.")
    parser.add_argument("--discriminator_reg_scale", nargs="?", type=float, default=0.00001,
                        help="The discriminator regularization scale.")
    parser.add_argument("--gen_disc_reg_scale", nargs="?", type=float, default=0.0001,
                        help="The generator discriminator regularization scale.")
    parser.add_argument("--pairing_method", nargs="?", type=str, default="random",
                        help="Pairing method: random, target, dummy, neighbour")
    # the reference's parameter-server flags, accepted and ignored
    parser.add_argument("--master", nargs="?", type=str, default="")
    parser.add_argument("--ps_tasks", nargs="?", type=int, default=0)
    parser.add_argument("--task", nargs="?", type=int, default=0)


def get_log_suffix(flags) -> str:
    """Log-dir naming codec."""
    abbreviations = {"dataloader": "ldr"}
    patch_size = flags.neighborhood * 2 + 1
    suffix = (f"{flags.loader_name.lower():s}_{flags.gan_type.lower():s}_"
              f"{patch_size:d}x{patch_size:d}_"
              f"regsup{flags.regularization_support_rate:.2f}_"
              f"batch{flags.batch_size:d}").replace(".", "")
    if flags.use_identity_loss is True:
        suffix = suffix + f"_idnty{flags.use_identity_loss:.2f}".replace(".", "")
    return replace_abbrs(suffix, abbreviations)


def build_step_fn(trainer: GANTrainerBase, normal: torch.Tensor, shadow: torch.Tensor,
                  index_stream: torch.Tensor, shadow_ratio: torch.Tensor, reg_rate: float,
                  rng: RngPool) -> Callable[[GANState, int], torch.Tensor]:
    """``step_fn(state, step)``: one training step on row ``step`` of the
    index stream; returns the generator loss on the device, unread.

    With a regularization-support rate, each x is replaced by ``y * ratio``
    with that probability, and then each y by ``x / ratio`` (the x already
    replaced), each draw uniform in ``[0.01, 0.99)``.
    """
    device = normal.device

    def step_fn(state: GANState, step: int) -> torch.Tensor:
        idx = index_stream[step]
        x, y = normal.index_select(0, idx), shadow.index_select(0, idx)
        if reg_rate > 0:
            gen = rng.generator("gan-regsup", step, device)
            shape = (idx.shape[0], 1, 1, 1)
            u1 = torch.rand(shape, generator=gen, device=device) * 0.98 + 0.01
            x = torch.where(u1 < reg_rate, y * shadow_ratio, x)
            u2 = torch.rand(shape, generator=gen, device=device) * 0.98 + 0.01
            y = torch.where(u2 < reg_rate, x / shadow_ratio, y)
        pool_generator = rng.generator("gan-pool", step, device)
        return trainer.train_step(state, x, y, generator=pool_generator)["generator_loss"]

    return step_fn


def run_session(params, base_log_path, device) -> List[float]:
    flags = SimpleNamespace(**params)
    chief = is_chief()
    say = print if chief else (lambda *args, **kwargs: None)
    say("Args:", json.dumps(vars(flags), indent=3, default=str))
    log_dir = f"{base_log_path}_{get_log_suffix(flags)}"
    if chief:
        os.makedirs(log_dir, exist_ok=True)

    neighborhood = 0
    rng = RngPool(DEFAULT_SEED)

    loader = get_loader_from_name(flags.loader_name, flags.path)
    data_set = loader.load_data(neighborhood, True)
    shadow_map, shadow_ratio = loader.load_shadow_map(neighborhood, data_set)

    normal, shadow = read_hsi_data(loader, data_set, shadow_map,
                                   flags.pairing_method, get_sampling_map())
    say(f"Pairs: normal={normal.shape} shadow={shadow.shape}")

    mesh = None
    if world_size() > 1:
        if flags.batch_size % world_size():
            raise ValueError(f"--batch_size={flags.batch_size} does not divide over "
                             f"{world_size()} ranks")
        mesh = create_mesh()
        say(f"GAN training data-parallel over {world_size()} ranks")
    band_count = data_set.get_casi_band_count()
    trainer = get_trainer_dict(vars(flags), band_count, flags.step, mesh=mesh)[flags.gan_type]
    state = trainer.init_state(device, rng.generator("gan-init", 0, "cpu"))

    # one full state per validated iteration is kept
    keep = max(flags.step // max(flags.validation_steps, 1), 1)
    resume_step = 0
    restored = restore_checkpoint(log_dir)
    if restored is not None and int(restored["step"]) > 0:
        state.restore(restored)
        resume_step = min(state.step, flags.step)
        say(f"Resuming GAN training from checkpoint at step {resume_step}")

    validator = PeerValidator(loader, data_set, shadow_map, shadow_ratio,
                              neighborhood, flags.validation_sample_count, log_dir) \
        if chief else None

    def to_device(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    total_steps, batch = flags.step, flags.batch_size
    index_stream = make_epoch_index_stream(normal.shape[0], batch, total_steps,
                                           rng.numpy_rng("gan-shuffle"))
    step_fn = build_step_fn(trainer, to_device(normal), to_device(shadow),
                            to_device(index_stream), to_device(shadow_ratio),
                            flags.regularization_support_rate, rng)
    del normal, shadow

    cadence = min(flags.validation_steps, total_steps)
    t0 = time.time()
    # the index stream is a function of the seed alone, so a run resumed at
    # step N continues from row N the stream an uninterrupted run consumes
    start = resume_step
    while start < total_steps:
        n = min(cadence, total_steps - start)
        losses = [step_fn(state, step) for step in range(start, start + n)]
        start += n
        say(f"step {start}: generator_loss={float(losses[-1]):.4f} "
            f"({start / (time.time() - t0):.1f} steps/s avg)")

        if chief:
            validator.run(trainer.host_translator(state.nets, True),
                          trainer.host_translator(state.nets, False), start, plot=True)
            save_params(os.path.join(log_dir, f"ckpt_params_{start}"), state.nets.state_dict())
            save_checkpoint(log_dir, state.checkpoint_tree(), max_to_keep=keep)
        if mesh is not None:
            mesh.barrier()  # no rank reads a checkpoint before it exists

    if chief:
        save_params(os.path.join(log_dir, "gan_params"), state.nets.state_dict())
    else:
        return [float("nan"), float("nan")]

    best_upper = validator.get_best_upper_div()
    best_mean = validator.get_best_mean_div()
    return [max(best_upper) if best_upper else float("nan"),
            max(best_mean) if best_mean else float("nan")]


def main(argv=None):
    """Run one session and return its divergences; in search mode, run the
    study and return it."""
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_trainers(parser)
    add_parse_cmds_for_json_loader(parser)
    add_parse_cmds_for_device(parser)
    add_parse_cmds_for_app(parser)
    add_parse_cmds_for_opt(parser)
    flags, _ = parser.parse_known_args(argv)
    device = join_rank(resolve_device(flags.device))

    if flags.flag_config_file:
        flags = merge_flag_config_json(flags, flags.flag_config_file)
    if flags.flag_config_file_opt:
        with open(flags.flag_config_file_opt, "r", encoding="utf-8") as fid:
            params_from_json_opt = json.load(fid)
        if is_chief():
            print("Running on hyper parameter optimization mode")
        objective_func = functools.partial(
            objective, params=dict(vars(flags)), params_from_json_opt=params_from_json_opt,
            opt_run_count=flags.opt_run_count,
            func_to_run=functools.partial(run_session, device=device),
            base_log_path=flags.base_log_path, device=device)
        study = create_study("gan_shadow_opt", direction="minimize",
                             storage="sqlite:///gan_shadow_opt.db") if is_chief() \
            else Study("gan_shadow_opt", direction="minimize")
        study.optimize(objective_func, n_trials=flags.opt_trial_count)
        return study
    if is_chief():
        print("Running on training mode")
    divergences = run_session(params=dict(vars(flags)), base_log_path=flags.base_log_path,
                              device=device)
    if is_chief():
        print("Output divergence values:", divergences)
    return divergences


if __name__ == "__main__":
    main()
    finalize_distributed()
