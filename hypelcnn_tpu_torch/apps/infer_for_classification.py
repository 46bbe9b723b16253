"""Classification inference CLI (``hypelcnn_tpu/apps/infer_for_classification.py``).

The same flags, plus ``--device`` (``cuda`` unless asked for ``cpu``). The
model comes from the registry and its weights from the latest checkpoint
under ``--base_log_path`` (the train CLI's suffixed log dir, the port's or
the JAX package's, whose orbax checkpoints it reads as well). It
writes ``result_raw.tif`` and ``result_colorized.tif`` to ``--output_path``:

- ``--domain all`` classifies every pixel of the scene;
- ``--domain sample`` classifies the labelled pixels (every split of the
  sample set) and leaves the others at 255;
- ``--domain gt`` rasterizes the ground truth, with no model::

    python -m hypelcnn_tpu_torch.apps.infer_for_classification \\
        --loader_name=SyntheticDataLoader --path="synthetic://?h=349&w=1905&bands=144&classes=15" \\
        --neighborhood=1 --base_log_path=LOG_DIR --output_path=OUT_DIR --domain=all

Under ``torchrun`` each rank runs on its card and ``--domain all`` splits
every band's pixels over the ranks; the chief alone prints and writes the
TIFFs.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

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
from hypelcnn_tpu_torch.infer.scene_inference import (
    INVALID_TARGET_VALUE,
    create_colored_image,
    create_target_image_via_samples,
    predict_full_scene,
    predict_targets,
)
from hypelcnn_tpu_torch.parallel.distributed import finalize_distributed, is_chief, join_rank
from hypelcnn_tpu_torch.parallel.mesh import create_mesh
from hypelcnn_tpu_torch.train.checkpoint import restore_checkpoint
from hypelcnn_tpu_torch.utils.tiff_io import imwrite


def add_parse_cmds_for_app(parser) -> None:
    parser.add_argument("--domain", nargs="?", type=str, default="all",
                        help="Conversion domain for inferencing. It can be all(all scene "
                             "inference), sample(sample based inference) or gt(ground truth)")


def gt_process(flags):
    """Rasterize the ground-truth sample set."""
    loader = get_loader_from_name(flags.loader_name, flags.path)
    sample_set = loader.load_samples(0.1, 0)
    data_set = loader.load_data(0, False)
    scene_as_image = create_target_image_via_samples(sample_set, data_set.get_scene_shape())
    return scene_as_image, loader.get_samples_color_list()


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
    if flags.domain == "all":
        return predict_full_scene(module, scene, device=device,
                                  mesh=create_mesh()), color_list
    sample_set = loader.load_samples(0.1, 0)
    targets = np.vstack([sample_set.test_targets.astype(np.int32),
                         sample_set.training_targets.astype(np.int32),
                         sample_set.validation_targets.astype(np.int32)])
    scene_as_image = np.full(scene.get_scene_shape(), INVALID_TARGET_VALUE, dtype=np.uint8)
    scene_as_image[targets[:, 1], targets[:, 0]] = predict_targets(module, scene, targets, device)
    return scene_as_image, color_list


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
    device = join_rank(resolve_device(flags.device))

    start_time = time.time()
    if flags.domain in ("all", "sample"):
        scene_as_image, color_list = prediction_process(flags, device)
    elif flags.domain == "gt":
        scene_as_image, color_list = gt_process(flags)
    else:
        raise ValueError(f"Domain flags does not support value:{flags.domain}")

    if not is_chief():
        return
    os.makedirs(flags.output_path, exist_ok=True)
    imwrite(os.path.join(flags.output_path, "result_raw.tif"), scene_as_image)
    imwrite(os.path.join(flags.output_path, "result_colorized.tif"),
            create_colored_image(scene_as_image, color_list))
    print(f"Done evaluation({time.time() - start_time:.3f} sec)")


if __name__ == "__main__":
    main()
    finalize_distributed()
