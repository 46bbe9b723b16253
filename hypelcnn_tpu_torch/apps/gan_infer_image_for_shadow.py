"""Whole-scene shadow / de-shadow translation CLI
(``hypelcnn_tpu/apps/gan_infer_image_for_shadow.py``).

``--make_them_shadow shadow`` translates the lit pixels through the
shadowing generator, ``deshadow`` the shadowed ones through the other;
``--convert_all true`` translates every pixel; anything else writes the
scene as it is. The result is un-normalized to the loader's CASI dtype and
written as ``shadow_image_<mode>_<checkpoint>[_all].tif`` beside an sRGB
render, ``shadow_image_rgb_<mode>_<checkpoint>_[_all].tif``, in
``--output_path``. ``--base_log_path`` is a params snapshot directory of
``gan_train_for_shadow``. The scene is translated on ``--device`` (``cuda``
unless asked for ``cpu``) in blocks of 65,536 pixels.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
    type_ensure_strtobool,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_loader_from_name
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict
from hypelcnn_tpu_torch.utils.hsi_rgb import get_rgb_from_hsi
from hypelcnn_tpu_torch.utils.tiff_io import imwrite


def add_parse_cmds_for_app(parser) -> None:
    parser.add_argument("--gan_type", nargs="?", type=str, default="cycle_gan",
                        help="Gan type, e.g. cycle_gan, gan_x2y, gan_y2x, cut_x2y, dcl_gan")
    parser.add_argument("--make_them_shadow", nargs="?", type=str, default="",
                        help="makes the scene shadowed(shadow), non shadowed(deshadow), "
                             "or empty(none)")
    parser.add_argument("--convert_all", nargs="?", type=type_ensure_strtobool, default=False,
                        help="Whether to convert filtered pixels(shadowed or not) or all.")


def main(argv=None) -> str:
    """Returns the path of the HSI TIFF written."""
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_device(parser)
    add_parse_cmds_for_app(parser)
    flags, _ = parser.parse_known_args(argv)
    device = resolve_device(flags.device)

    make_them_shadow = flags.make_them_shadow
    loader = get_loader_from_name(flags.loader_name, flags.path)
    data_set = loader.load_data(0, True)
    target_dtype = data_set.get_unnormalized_casi_dtype()
    shadow_map, _ = loader.load_shadow_map(0, data_set)

    scene_shape = data_set.get_scene_shape()
    band_size = data_set.get_casi_band_count()

    if make_them_shadow == "shadow":
        is_shadow, filter_sign = True, 0
    elif make_them_shadow == "deshadow":
        is_shadow, filter_sign = False, 1
    else:
        is_shadow, filter_sign = True, -1
        make_them_shadow = "none"

    h, w = scene_shape
    n = data_set.neighborhood
    pixels = np.asarray(data_set.casi[n:n + h, n:n + w, :band_size], dtype=np.float32)

    if make_them_shadow == "none":
        converted = pixels
    else:
        trainer = get_trainer_dict({}, band_size, max_steps=1)[flags.gan_type]
        nets = trainer.restore_nets(flags.base_log_path, device)
        converted = trainer.translate_scene(nets, pixels, is_shadow)
        if not flags.convert_all:
            mask = (np.asarray(shadow_map)[:h, :w] == filter_sign)[:, :, None]
            converted = np.where(mask, converted, pixels)

    hsi_image = ((converted * data_set.casi_max) + data_set.casi_min).astype(target_dtype)

    convert_region_sfx = "" if not flags.convert_all else "_all"
    chkpnt_num_str = flags.base_log_path.rsplit("-", 1)[-1].rsplit("/", 1)[-1]
    hsi_path = os.path.join(flags.output_path,
                            f"shadow_image_{make_them_shadow}_{chkpnt_num_str}"
                            f"{convert_region_sfx}.tif")
    print(f"Saving output to {hsi_path}")
    imwrite(hsi_path, hsi_image)

    hsi_float = (hsi_image.astype(float) - data_set.casi_min) / data_set.casi_max
    rgb = (get_rgb_from_hsi(loader.get_band_measurements(), hsi_float) * 255).astype(np.uint8)
    rgb_path = os.path.join(flags.output_path,
                            f"shadow_image_rgb_{make_them_shadow}_{chkpnt_num_str}_"
                            f"{convert_region_sfx}.tif")
    print(f"Saving output RGB to {rgb_path}")
    imwrite(rgb_path, rgb)
    return hsi_path


if __name__ == "__main__":
    main()
