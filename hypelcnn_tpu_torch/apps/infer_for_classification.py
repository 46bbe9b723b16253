"""Classification inference CLI (``hypelcnn_tpu/apps/infer_for_classification.py``).

The same flags, plus ``--device`` (``cuda`` unless asked for ``cpu``). The
model comes from the registry and its weights from the latest port
checkpoint under ``--base_log_path``; ``--domain all`` classifies every pixel
of the scene and writes ``result_raw.tif`` and ``result_colorized.tif`` to
``--output_path``::

    python -m hypelcnn_tpu_torch.apps.infer_for_classification \\
        --loader_name=SyntheticDataLoader --path="synthetic://?h=349&w=1905&bands=144&classes=15" \\
        --neighborhood=1 --base_log_path=LOG_DIR --output_path=OUT_DIR --domain=all

``--domain sample`` and ``--domain gt`` need the stratified splitters, which
are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import time

from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_importers,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
    add_parse_cmds_for_models,
    add_parse_cmds_for_trainers,
    load_algorithm_params,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_loader_from_name, get_model_from_name
from hypelcnn_tpu_torch.infer.scene_inference import create_colored_image, predict_full_scene
from hypelcnn_tpu_torch.train.checkpoint import restore_checkpoint
from hypelcnn_tpu_torch.utils.tiff_io import imwrite


def add_parse_cmds_for_app(parser) -> None:
    parser.add_argument("--domain", nargs="?", type=str, default="all",
                        help="Conversion domain for inferencing. It can be all(all scene "
                             "inference), sample(sample based inference) or gt(ground truth)")


def prediction_process(flags, device):
    loader = get_loader_from_name(flags.loader_name, flags.path)
    scene = loader.load_data(flags.neighborhood, True)
    class_count = loader.get_class_count().stop
    color_list = loader.get_samples_color_list()

    nn_model = get_model_from_name(flags.model_name)
    algorithm_params = load_algorithm_params(nn_model.default_params(),
                                             flags.algorithm_param_path)
    algorithm_params["batch_size"] = flags.batch_size
    module = nn_model.create_module(class_count, algorithm_params, scene.get_data_shape())
    checkpoint = restore_checkpoint(flags.base_log_path)
    if checkpoint is None:
        raise IOError(f"No checkpoint found under {flags.base_log_path}/checkpoints")
    module.load_state_dict(checkpoint["state_dict"], strict=True)
    module.to(device)
    return predict_full_scene(module, scene, device=device), color_list


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_trainers(parser)
    add_parse_cmds_for_models(parser)
    add_parse_cmds_for_importers(parser)
    add_parse_cmds_for_device(parser)
    add_parse_cmds_for_app(parser)
    flags, _ = parser.parse_known_args(argv)
    device = resolve_device(flags.device)

    start_time = time.time()
    if flags.domain in ("sample", "gt"):
        raise NotImplementedError(
            f"--domain {flags.domain} needs the stratified splitters, which are not ported "
            "yet (ROADMAP.md, queue A: splitters without scikit-learn)")
    if flags.domain != "all":
        raise ValueError(f"Domain flags does not support value:{flags.domain}")
    scene_as_image, color_list = prediction_process(flags, device)

    os.makedirs(flags.output_path, exist_ok=True)
    imwrite(os.path.join(flags.output_path, "result_raw.tif"), scene_as_image)
    imwrite(os.path.join(flags.output_path, "result_colorized.tif"),
            create_colored_image(scene_as_image, color_list))
    print(f"Done evaluation({time.time() - start_time:.3f} sec)")


if __name__ == "__main__":
    main()
