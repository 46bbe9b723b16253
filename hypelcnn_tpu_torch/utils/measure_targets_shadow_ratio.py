"""Plot the shadow/lit band-ratio statistics of a pairing method
(``hypelcnn_tpu/utils/measure_targets_shadow_ratio.py``).

The same flags (loader, logger, ``--pairing_method``), plus ``--device``
(``cuda`` unless asked for ``cpu``). The pairs come from the port's samplers
(``gan/sampling.py``, host); the ratio ``shadow / lit`` and its per-band mean
and standard deviation over the finite rows run on the device. Writes
``<loader>_<method>_0.pdf`` to ``--output_path`` where matplotlib is
installed::

    python -m hypelcnn_tpu_torch.utils.measure_targets_shadow_ratio \\
        --loader_name=GRSS2013DataLoader --path=DATA --pairing_method=random --device=cpu
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_loader_from_name
from hypelcnn_tpu_torch.gan.sampling import read_hsi_data
from hypelcnn_tpu_torch.gan.validation import plot_overall_info
from hypelcnn_tpu_torch.gan.wrapper_registry import get_sampling_map


def ratio_statistics(normal: np.ndarray, shadow: np.ndarray, device) -> Tuple[np.ndarray,
                                                                               np.ndarray]:
    """Per-band mean and (population) standard deviation of ``shadow /
    normal`` over the rows that are finite in every band, on ``device``; the
    ratio in float32 as numpy forms it, the moments summed in float64."""
    normal_t = torch.from_numpy(np.ascontiguousarray(normal)).to(device)
    shadow_t = torch.from_numpy(np.ascontiguousarray(shadow)).to(device)
    ratio = shadow_t / normal_t
    ratio = ratio[torch.isfinite(ratio).all(dim=1)].to(torch.float64)
    mean = ratio.mean(dim=0)
    std = (ratio - mean).square().mean(dim=0).sqrt()
    return (mean.to(torch.float32).cpu().numpy(), std.to(torch.float32).cpu().numpy())


def main(argv=None) -> Tuple[np.ndarray, np.ndarray]:
    """Runs the CLI; returns the ratio's mean and standard deviation."""
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_loaders(parser)
    parser.add_argument("--pairing_method", nargs="?", type=str, default="random",
                        help="Pairing method: random, target, dummy, neighbour")
    add_parse_cmds_for_device(parser)
    flags, _ = parser.parse_known_args(argv)
    device = resolve_device(flags.device)

    neighborhood = 0
    loader = get_loader_from_name(flags.loader_name, flags.path)
    data_set = loader.load_data(neighborhood, True)
    shadow_map, _ = loader.load_shadow_map(neighborhood, data_set)

    normal, shadow = read_hsi_data(loader, data_set, shadow_map,
                                   flags.pairing_method, get_sampling_map())
    normal = np.squeeze(normal)
    shadow = np.squeeze(shadow)
    mean_res, std_res = ratio_statistics(normal, shadow, device)
    plot_overall_info(loader.get_band_measurements(), mean_res,
                      mean_res - std_res, mean_res + std_res, 0,
                      f"{flags.loader_name.lower()}_{flags.pairing_method.lower()}",
                      flags.output_path)
    return mean_res, std_res


if __name__ == "__main__":
    main()
