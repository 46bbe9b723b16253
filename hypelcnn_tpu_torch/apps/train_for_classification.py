"""Classification training CLI (``hypelcnn_tpu/apps/train_for_classification.py``).

The same flags and defaults and the same log-dir suffix codec, plus
``--device`` (``cuda`` unless asked for ``cpu``; asking for CUDA where there
is none raises before anything is read or written)::

    python -m hypelcnn_tpu_torch.apps.train_for_classification \\
        --loader_name=SyntheticDataLoader --path="synthetic://?h=349&w=1905&bands=144&classes=15" \\
        --model_name=HYPELCNNModel --importer_name=GeneratorImporter --neighborhood=1 \\
        --algorithm_param_path=configs/modelconfigs/alg_param_hypelcnn.json --batch_size=48 \\
        --step=600 --save_checkpoint_steps=200 --base_log_path=LOG_ROOT

The run writes ``<base_log_path>/<suffix>/checkpoints/<step>/``, an orbax
checkpoint of the JAX package's ``TrainState``, which
``infer_for_classification --base_log_path=<base_log_path>/<suffix>`` reads,
and the JAX package's CLIs as well. A
log dir that already holds a checkpoint is resumed from: at or past
``--step`` nothing trains, the printed loss is ``nan`` and the accuracies are
those of the restored model.

``--augment_data_with_shadow simple|<gan type>`` shadows a share
(``--augmentation_random_threshold``) of each batch's windows: by the
loader's band ratio, or through the frozen generator that
``gan_train_for_shadow`` trained, installed at the path the loader declares
(``get_shadow_checkpoints``): a params snapshot directory or a TF
``model.ckpt-N``.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node=N``)
each rank trains on its card (``cuda:LOCAL_RANK``) its share of every global
batch of ``--batch_size``, which N must divide; the chief alone prints and
writes the log dir, and a checkpoint resumes into any number of ranks::

    python -m torch.distributed.run --nproc_per_node=2 \
        -m hypelcnn_tpu_torch.apps.train_for_classification ...

``--flag_config_file_opt=SPACE.json`` runs a hyperparameter search instead:
``--opt_trial_count`` trials of ``--opt_run_count`` runs each, every run an
episode on ``--device`` under ``<base_log_path>_<random suffix>``. A trial's
algorithm params are the flags as a dict with the space's suggestions laid
over them (not the modelconfig JSON: a model key the space does not pin
takes the model's default). Its score is the worst run's ``1 -
validation_accuracy``; the study ``classification_opt`` is kept in
``classification_opt.db`` in the working directory, and a rerun continues it.
Under torchrun the chief alone opens the study, draws each trial's params
and run suffixes and records the value; every rank receives the draws and
runs the same episodes on the mesh (``tune/search.py``).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_importers,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
    add_parse_cmds_for_models,
    add_parse_cmds_for_opt,
    add_parse_cmds_for_trainers,
    load_algorithm_params,
    type_ensure_strtobool,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_importer_from_name, get_model_from_name
from hypelcnn_tpu_torch.core.rng import set_run_seed
from hypelcnn_tpu_torch.data.augmentation import AugmentationInfo
from hypelcnn_tpu_torch.gan.shadow_ops import build_shadow_creators
from hypelcnn_tpu_torch.parallel.distributed import finalize_distributed, is_chief, join_rank
from hypelcnn_tpu_torch.parallel.mesh import create_mesh
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer, TrainingResult
from hypelcnn_tpu_torch.tune.search import Study, create_study, objective
from hypelcnn_tpu_torch.utils.text import path_leaf, replace_abbrs


def add_parse_cmds_for_app(parser) -> None:
    parser.add_argument("--perform_validation", nargs="?", const=True, type=type_ensure_strtobool,
                        default=False,
                        help="If true, performs validation after training phase.")
    parser.add_argument("--augment_data_with_rotation", nargs="?", const=True,
                        type=type_ensure_strtobool, default=False,
                        help="If true, input data is augmented with synthetic rotational(90 degrees) input.")
    parser.add_argument("--augment_data_with_spectral", nargs="?", const=True, type=float,
                        default=None,
                        help="If given, input data is augmented with spectral ratio.")
    parser.add_argument("--augment_data_with_shadow", nargs="?", const=True, type=str,
                        default=None,
                        help="Given a method name, input data is augmented with shadow data(cycle_gan or simple")
    parser.add_argument("--augment_data_with_reflection", nargs="?", const=True,
                        type=type_ensure_strtobool, default=False,
                        help="If true, input data is augmented with synthetic reflection input.")
    parser.add_argument("--augmentation_random_threshold", nargs="?", type=float, default=0.5,
                        help="Augmentation randomization threshold.")
    parser.add_argument("--save_checkpoint_steps", nargs="?", type=int, default=2000,
                        help="Save frequency of the checkpoint")
    parser.add_argument("--validation_steps", nargs="?", type=int, default=40000,
                        help="Validation frequency")
    parser.add_argument("--all_data_shuffle_ratio", nargs="?", type=float, default=None,
                        help="If given as a valid ratio, validation and training data is "
                             "shuffled and redistributed")
    parser.add_argument("--log_model_params", nargs="?", const=True, type=type_ensure_strtobool,
                        default=False,
                        help="If added, logs model histograms.")


def get_log_suffix(flags) -> str:
    """Log-dir naming codec."""
    abbreviations = {"model": "mdl", "dataloader": "ldr", "alg_param_": "p"}
    if flags.train_ratio > 1.0:
        trn_ratio_str = f"{int(flags.train_ratio):d}"
    else:
        trn_ratio_str = f"{flags.train_ratio:.2f}".replace(".", "")
    patch_size = flags.neighborhood * 2 + 1
    suffix = (f"{flags.loader_name.lower():s}_{flags.model_name.lower():s}_trn{trn_ratio_str:s}_"
              f"{os.path.splitext(path_leaf(flags.algorithm_param_path))[0].lower()}_"
              f"{patch_size:d}x{patch_size:d}")
    if flags.augment_data_with_shadow is not None:
        suffix += (f"_{flags.augment_data_with_shadow}"
                   + f"_aug{flags.augmentation_random_threshold:.2f}".replace(".", ""))
    if flags.augment_data_with_spectral is not None:
        suffix += f"_spectral{flags.augment_data_with_spectral:.3f}".replace(".", "")
    return replace_abbrs(suffix, abbreviations)


def perform_an_episode(flags, algorithm_params, model, base_log_path, device) -> TrainingResult:
    """One training episode on ``device``; on several ranks, this rank's share of it."""
    chief = is_chief()
    say = print if chief else (lambda *args, **kwargs: None)
    say("Args:", json.dumps(vars(flags), indent=3))
    set_run_seed()

    data_importer = get_importer_from_name(flags.importer_name)
    data = data_importer.read_data_set(flags.loader_name, flags.path,
                                       flags.train_ratio, flags.test_ratio,
                                       flags.neighborhood)

    shadow_struct = None
    if flags.augment_data_with_shadow is not None:
        if data.scene is None:
            raise ValueError("--augment_data_with_shadow needs a scene-backed importer "
                             "(records carry no scene to shadow)")
        shadow_dict = build_shadow_creators(data.loader, data.scene, flags.neighborhood, device)
        if flags.augment_data_with_shadow not in shadow_dict:
            raise KeyError(f"unknown shadow method {flags.augment_data_with_shadow!r}; "
                           f"available: {sorted(shadow_dict)}")
        shadow_struct = shadow_dict[flags.augment_data_with_shadow]

    augmentation_info = AugmentationInfo(
        shadow_struct=shadow_struct,
        perform_shadow_augmentation=flags.augment_data_with_shadow is not None,
        perform_rotation_augmentation=flags.augment_data_with_rotation,
        perform_reflection_augmentation=flags.augment_data_with_reflection,
        perform_spectral_augmentation=flags.augment_data_with_spectral or 0.0,
        augmentation_random_threshold=flags.augmentation_random_threshold)

    batch_size = algorithm_params["batch_size"]
    n_train = data.sample_set.training_targets.shape[0]
    required_steps = flags.step if flags.epoch is None else (n_train * flags.epoch) // batch_size
    say(f"Steps: {required_steps:d}, Algorithm Params: {algorithm_params}")

    trainer = ClassificationTrainer(
        model=model, class_count=data.class_count, algorithm_params=algorithm_params,
        scene=data.scene, sample_set=data.sample_set,
        augmentation_info=augmentation_info,
        log_dir=base_log_path,
        save_checkpoint_steps=flags.save_checkpoint_steps,
        validation_cadence=flags.validation_steps if flags.perform_validation else None,
        sources=data.sources, data_shape=data.data_shape,
        log_model_params=bool(flags.log_model_params), device=device,
        mesh=create_mesh())

    start = time.time()
    result = trainer.fit(required_steps, batch_size,
                         progress_callback=lambda s, l: say(f"step {s}: loss={l:.4f}"))
    say(f"Done training for {time.time() - start:.3f} sec")

    if flags.perform_validation:
        say(f"Validation accuracy={result.validation_accuracy:g}, "
              f"Testing accuracy={result.test_accuracy:g}, loss={result.loss:.2f}")
    else:
        say(f"Testing accuracy={result.test_accuracy:g}, loss={result.loss:.2f}")
    return result


def main(argv=None):
    """Train one episode and return its ``TrainingResult``; in search mode,
    run the study and return it."""
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_trainers(parser)
    add_parse_cmds_for_models(parser)
    add_parse_cmds_for_importers(parser)
    add_parse_cmds_for_device(parser)
    add_parse_cmds_for_app(parser)
    add_parse_cmds_for_opt(parser)
    flags, _ = parser.parse_known_args(argv)
    device = join_rank(resolve_device(flags.device))

    nn_model = get_model_from_name(flags.model_name)
    if flags.flag_config_file_opt:
        with open(flags.flag_config_file_opt, "r", encoding="utf-8") as fid:
            params_from_json_opt = json.load(fid)
        if is_chief():
            print("Running in hyper parameter optimization mode")

        def run_session(params, base_log_path):
            return [1 - perform_an_episode(flags, params, nn_model, base_log_path,
                                           device).validation_accuracy]

        objective_func = functools.partial(
            objective, params=dict(vars(flags)), params_from_json_opt=params_from_json_opt,
            opt_run_count=flags.opt_run_count, func_to_run=run_session,
            base_log_path=flags.base_log_path, device=device)
        study = create_study("classification_opt", direction="minimize",
                             storage="sqlite:///classification_opt.db") if is_chief() \
            else Study("classification_opt", direction="minimize")
        study.optimize(objective_func, n_trials=flags.opt_trial_count)
        return study
    if is_chief():
        print("Running on training mode")
    algorithm_params = load_algorithm_params(nn_model.default_params(),
                                             flags.algorithm_param_path)
    if not algorithm_params:
        raise IOError("Algorithm parameter file is not given")
    algorithm_params["batch_size"] = flags.batch_size
    return perform_an_episode(flags, algorithm_params, nn_model,
                              os.path.join(flags.base_log_path, get_log_suffix(flags)), device)


if __name__ == "__main__":
    main()
    finalize_distributed()
