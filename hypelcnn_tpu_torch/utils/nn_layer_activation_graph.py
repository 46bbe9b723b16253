"""Plot per-layer activation histograms for constant inputs
(``hypelcnn_tpu/utils/nn_layer_activation_graph.py``).

Constant patches, one level a row, evenly spaced in [0, 1], run through the
model in evaluation mode on ``--device`` (``cuda`` unless asked for
``cpu``), and each activation tap the model returns
(``ModelOutput.histograms``: HYPELCNN's, in NHWC) is plotted per level as
``activation_<tap>.png`` in ``--output_path`` where matplotlib is installed.
The weights are the latest checkpoint the port's or the JAX package's
train CLI wrote under ``--base_log_path`` when it has a ``checkpoints/``
directory (which must then hold one), else a fresh initialization from a
seeded generator::

    python -m hypelcnn_tpu_torch.utils.nn_layer_activation_graph \\
        --model_name=HYPELCNNModel --neighborhood=1 --class_count=15 --bands=145 \\
        --algorithm_param_path=configs/modelconfigs/alg_param_hypelcnn.json \\
        --base_log_path=LOG_DIR --output_path=OUT --device=cpu
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
    add_parse_cmds_for_models,
    load_algorithm_params,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_model_from_name
from hypelcnn_tpu_torch.models.layers import init_parameters
from hypelcnn_tpu_torch.train.checkpoint import restore_checkpoint
from hypelcnn_tpu_torch.utils.plotting import pyplot

INIT_SEED = 0


def controlled_patches(data_shape, level_count: int) -> np.ndarray:
    """Constant patches at ``level_count`` evenly spaced levels in [0, 1]."""
    levels = np.linspace(0.0, 1.0, level_count, dtype=np.float32)
    return np.stack([np.full(data_shape, lv, dtype=np.float32) for lv in levels])


def plot_activation_histograms(model_name: str, class_count: int, data_shape,
                               level_count: int, output_path: str, device,
                               algorithm_params=None,
                               state_dict: Optional[Dict[str, torch.Tensor]] = None
                               ) -> Dict[str, np.ndarray]:
    """The model's taps on the constant patches, as numpy arrays by name,
    each plotted as one histogram a level. ``state_dict`` gives the weights;
    without it they are initialized from a generator seeded with 0."""
    nn_model = get_model_from_name(model_name)
    params = {**nn_model.default_params(), **(algorithm_params or {})}
    module = nn_model.create_module(class_count, params, list(data_shape))
    if state_dict is None:
        init_parameters(module, torch.Generator().manual_seed(INIT_SEED))
    else:
        module.load_state_dict(state_dict, strict=True)
    module.to(device).eval()
    x = torch.from_numpy(controlled_patches(data_shape, level_count)).to(device)
    with torch.inference_mode():
        out = module(x)
    histograms = {name: t.float().cpu().numpy() for name, t in out.histograms.items()}

    os.makedirs(output_path, exist_ok=True)
    for name, tensor in histograms.items():
        path = os.path.join(output_path, f"activation_{name}.png")
        plt = pyplot(path)
        if plt is None:
            continue
        fig, axes = plt.subplots(1, level_count, figsize=(4 * level_count, 3), squeeze=False)
        for li in range(level_count):
            axes[0][li].hist(tensor[li].reshape(-1), bins=50)
            axes[0][li].set_title(f"{name} @lvl{li}")
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
    return histograms


def main(argv=None) -> Dict[str, np.ndarray]:
    """Runs the CLI; returns the histograms' arrays by tap."""
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_models(parser)
    parser.add_argument("--level_count", nargs="?", type=int, default=4,
                        help="Number of constant input levels to probe")
    parser.add_argument("--class_count", nargs="?", type=int, default=15)
    parser.add_argument("--bands", nargs="?", type=int, default=145)
    add_parse_cmds_for_device(parser)
    flags, _ = parser.parse_known_args(argv)
    device = resolve_device(flags.device)

    k = flags.neighborhood * 2 + 1
    nn_model = get_model_from_name(flags.model_name)
    algorithm_params = load_algorithm_params(nn_model.default_params(),
                                             flags.algorithm_param_path)

    state_dict = None
    base = flags.base_log_path
    if base and os.path.isdir(os.path.join(base, "checkpoints")):
        restored = restore_checkpoint(base)
        if restored is None:
            raise FileNotFoundError(
                f"--base_log_path={base} has a checkpoints/ dir but no restorable checkpoint")
        state_dict = restored["state_dict"]
        print(f"Restored checkpoint at step {int(restored['step'])} from {base}")
    elif base:
        print(f"No checkpoints under {base}; histograms use random init")

    histograms = plot_activation_histograms(
        flags.model_name, flags.class_count, (k, k, flags.bands), flags.level_count,
        flags.output_path, device, algorithm_params=algorithm_params, state_dict=state_dict)
    print(f"Plotted {len(histograms)} activation histograms to {flags.output_path}")
    return histograms


if __name__ == "__main__":
    main()
