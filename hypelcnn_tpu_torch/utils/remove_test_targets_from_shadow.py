"""Zero the validation targets' pixels out of a shadow map
(``hypelcnn_tpu/utils/remove_test_targets_from_shadow.py``).

The same flags, plus ``--device`` (``cuda`` unless asked for ``cpu``; the
work is a walk over the targets on the host, as in the JAX package). Writes
``shadow_map_before.png``, ``shadow_map_after.png`` (where matplotlib is
installed) and ``shadow_map.tif`` to ``--output_path`` and prints how many
validation targets lay outside the shadow::

    python -m hypelcnn_tpu_torch.utils.remove_test_targets_from_shadow \\
        --loader_name=GULFPORTDataLoader --path=DATA --output_path=OUT --device=cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_loader_from_name
from hypelcnn_tpu_torch.utils.plotting import pyplot
from hypelcnn_tpu_torch.utils.tiff_io import imwrite


def _save_map(shadow_map: np.ndarray, path: str) -> None:
    plt = pyplot(path)
    if plt is None:
        return
    plt.imshow(shadow_map * 255)
    plt.xticks([]), plt.yticks([])
    plt.savefig(path)
    plt.clf()


def remove_targets(shadow_map: np.ndarray, targets: np.ndarray) -> int:
    """Zero, in place, the shadow pixels at the ``(x, y)`` targets; returns
    how many targets were not in the shadow."""
    non_shadow = 0
    for point in targets:
        if shadow_map[point[1], point[0]] == 1:
            shadow_map[point[1], point[0]] = 0
        else:
            non_shadow += 1
    return non_shadow


def main(argv=None) -> np.ndarray:
    """Runs the CLI; returns the shadow map it wrote."""
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_device(parser)
    flags, _ = parser.parse_known_args(argv)
    resolve_device(flags.device)

    loader = get_loader_from_name(flags.loader_name, flags.path)
    sample_set = loader.load_samples(0.1, 0.1)
    data_set = loader.load_data(0, True)
    shadow_map, _ = loader.load_shadow_map(0, data_set)
    shadow_map = np.array(shadow_map)

    _save_map(shadow_map, os.path.join(flags.output_path, "shadow_map_before.png"))
    non_shadow_test_sample = remove_targets(shadow_map, sample_set.validation_targets)
    print(f"Non-shadow validation samples: {non_shadow_test_sample}")
    _save_map(shadow_map, os.path.join(flags.output_path, "shadow_map_after.png"))

    imwrite(os.path.join(flags.output_path, "shadow_map.tif"), shadow_map)
    return shadow_map


if __name__ == "__main__":
    main()
