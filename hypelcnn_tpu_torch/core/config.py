"""CLI flag groups, with the names and defaults of ``hypelcnn_tpu/core/config.py``.

The groups of the train, infer and GAN CLIs, plus ``--device``.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Any


def type_ensure_strtobool(val: Any) -> bool:
    """Bool-ish CLI string -> bool (distutils.strtobool semantics)."""
    truthy = {"y", "yes", "t", "true", "on", "1"}
    falsy = {"n", "no", "f", "false", "off", "0"}
    sval = str(val).strip().lower()
    if sval in truthy:
        return True
    if sval in falsy:
        return False
    raise ValueError(f"invalid truth value {val!r}")


def add_parse_cmds_for_json_loader(parser) -> None:
    parser.add_argument("--flag_config_file", nargs="?", type=str, default=None,
                        help="Flags as json")


def merge_flag_config_json(flags: SimpleNamespace, config_path: str | None) -> SimpleNamespace:
    """The flags with a JSON file's keys and values laid over them."""
    if not config_path:
        return flags
    with open(config_path, "r", encoding="utf-8") as fid:
        overrides = json.load(fid)
    merged = vars(flags).copy()
    merged.update(overrides)
    return SimpleNamespace(**merged)


def add_parse_cmds_for_trainers(parser) -> None:
    parser.add_argument("--batch_size", nargs="?", type=int, default=20,
                        help="Batch size")
    parser.add_argument("--step", nargs="?", const=True, type=int, default=50000,
                        help="Step number to perform for training, either this parameter "
                             "or epoch should be used")
    parser.add_argument("--epoch", nargs="?", const=True, type=int, default=None,
                        help="Epoch number to traverse data, either this parameter or "
                             "step should be used")


def add_parse_cmds_for_loggers(parser) -> None:
    parser.add_argument("--base_log_path", nargs="?", const=True, type=str,
                        default=os.getcwd(),
                        help="Base path for saving logs, default: working directory")
    parser.add_argument("--output_path", nargs="?", const=True, type=str,
                        default=os.getcwd(),
                        help="Path for saving output logs and images, default: working directory")


def add_parse_cmds_for_loaders(parser) -> None:
    parser.add_argument("--path", nargs="?", const=True, type=str,
                        default="/data/2013_DFTC/2013_DFTC",
                        help="Input data path")
    parser.add_argument("--loader_name", nargs="?", const=True, type=str,
                        default="GRSS2013DataLoader",
                        help="Data set loader name, values: GRSS2013DataLoader, "
                             "GRSS2018DataLoader, GULFPORTDataLoader, GULFPORTALTDataLoader, "
                             "AVONDataLoader, SyntheticDataLoader")
    parser.add_argument("--neighborhood", nargs="?", type=int, default=0,
                        help="Neighborhood for data extraction, e.g. 1 means 3x3 patches")
    parser.add_argument("--test_ratio", nargs="?", type=float, default=0.05,
                        help="Ratio of training data to use in testing")
    parser.add_argument("--train_ratio", nargs="?", type=float, default=0.10,
                        help="Ratio of training data to use in validation, not accepted "
                             "by all data set impls.")


def add_parse_cmds_for_models(parser) -> None:
    parser.add_argument("--algorithm_param_path", nargs="?", const=True, type=str,
                        default=None,
                        help="Algorithm parameter (json) data file path")
    parser.add_argument("--model_name", nargs="?", const=True, type=str,
                        default="HYPELCNNModel",
                        help="Model to use in training, values: CAPModel, CONCNNModel, "
                             "DUALCNNModel, HYPELCNNModel")


def add_parse_cmds_for_importers(parser) -> None:
    parser.add_argument("--importer_name", nargs="?", const=True, type=str,
                        default="InMemoryImporter",
                        help="Importer name, Values : GeneratorImporter, InMemoryImporter, "
                             "RecordImporter")


def add_parse_cmds_for_opt(parser) -> None:
    parser.add_argument("--flag_config_file_opt", nargs="?", type=str, default=None,
                        help="Flag config file for hyper parameter optimization")
    parser.add_argument("--opt_trial_count", nargs="?", type=int, default=10,
                        help="Trial count for the optimization part.")
    parser.add_argument("--opt_run_count", nargs="?", type=int, default=3,
                        help="Retry count for each trial during the optimization.")


def add_parse_cmds_for_device(parser) -> None:
    parser.add_argument("--device", nargs="?", type=str, default="cuda",
                        help="Device to run on: cuda (default) or cpu; asking for cuda "
                             "where there is none is an error")


def load_algorithm_params(default_params: dict, algorithm_param_path: str | None) -> dict:
    """Model hyperparameters: defaults overlaid with a modelconfig JSON file."""
    params = dict(default_params)
    if algorithm_param_path:
        with open(algorithm_param_path, "r", encoding="utf-8") as fid:
            params.update(json.load(fid))
    return params
