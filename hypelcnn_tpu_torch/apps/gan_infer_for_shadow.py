"""GAN validation CLI (``hypelcnn_tpu/apps/gan_infer_for_shadow.py``).

Restores a trained generator and runs the band-ratio validation once, both
directions (statistics printout, JS divergences, percentile plots into
``--output_path`` where matplotlib is installed). ``--base_log_path`` is a
params snapshot directory that ``gan_train_for_shadow`` wrote
(``.../gan_params`` or ``.../ckpt_params_N``). Runs on ``--device`` (``cuda``
unless asked for ``cpu``).
"""

from __future__ import annotations

import argparse

import numpy as np

from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_loader_from_name
from hypelcnn_tpu_torch.gan.validation import PeerValidator
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict


def add_parse_cmds_for_app(parser) -> None:
    parser.add_argument("--number_of_samples", nargs="?", type=int, default=6000,
                        help="Number of samples.")
    parser.add_argument("--gan_type", nargs="?", type=str, default="cycle_gan",
                        help="Gan type, possible values; cycle_gan, gan_x2y, gan_y2x, "
                             "cut_x2y, cut_y2x, dcl_gan, dcl_cycle_gan")


def main(argv=None) -> PeerValidator:
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_device(parser)
    add_parse_cmds_for_app(parser)
    flags, _ = parser.parse_known_args(argv)
    device = resolve_device(flags.device)

    np.set_printoptions(precision=5, suppress=True)
    loader = get_loader_from_name(flags.loader_name, flags.path)
    data_set = loader.load_data(flags.neighborhood, True)
    shadow_map, shadow_ratio = loader.load_shadow_map(flags.neighborhood, data_set)

    trainer = get_trainer_dict({}, data_set.get_casi_band_count(), max_steps=1)[flags.gan_type]
    nets = trainer.restore_nets(flags.base_log_path, device)

    validator = PeerValidator(loader, data_set, shadow_map, shadow_ratio,
                              flags.neighborhood, flags.number_of_samples,
                              flags.output_path)

    validator.run(trainer.host_translator(nets, True), trainer.host_translator(nets, False),
                  iteration=0, plot=True)
    return validator


if __name__ == "__main__":
    main()
