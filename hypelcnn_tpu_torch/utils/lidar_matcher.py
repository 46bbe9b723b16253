"""GRSS2013 <-> GRSS2018 registration by template matching
(``hypelcnn_tpu/utils/lidar_matcher.py``).

One CASI band of each scene (GRSS2013's band 8, enlarged 5 times;
GRSS2018's band 2, cropped by 350 rows and 75 columns, enlarged 2 times) is
brought to a common ground resolution with OpenCV's area interpolation, and
the GRSS2018 band is located in the GRSS2013 band by normalized
cross-correlation on ``--device`` (``cuda`` unless asked for ``cpu``), with
the port's copies of the OpenCV calls (:mod:`hypelcnn_tpu_torch.utils.cv_ops`).
Prints the matched rectangle in raw and scaled coordinates and writes
``lidar_match.png`` to ``--output_path`` where matplotlib is installed.
``--path`` holds both datasets' layouts::

    python -m hypelcnn_tpu_torch.utils.lidar_matcher --path=DATA --output_path=OUT --device=cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hypelcnn_tpu_torch.core.config import (
    add_parse_cmds_for_device,
    add_parse_cmds_for_loaders,
    add_parse_cmds_for_loggers,
)
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.core.registry import get_loader_from_name
from hypelcnn_tpu_torch.utils.cv_ops import (
    draw_rectangle,
    match_template_ccorr_normed,
    max_location,
    resize_area,
)
from hypelcnn_tpu_torch.utils.plotting import pyplot


def match_data(grss_2013_band, grss_2018_band, grss_2013_data_set, grss_2018_data_set,
               grss2013_scale, grss2018_scale, device, output_path="."):
    """``(top_left, bottom_right)`` of the GRSS2018 band's match in the
    enlarged GRSS2013 band, ``(x, y)`` each."""
    band_2013 = grss_2013_data_set.casi[:, :, grss_2013_band]
    band_2013 = resize_area(band_2013, (band_2013.shape[1] * grss2013_scale,
                                        band_2013.shape[0] * grss2013_scale))

    band_2018 = np.squeeze(grss_2018_data_set.casi[:, :, grss_2018_band]).astype(np.float32)
    band_2018 = band_2018[0:-350, 0:-75]
    band_2018 = resize_area(band_2018, (int(band_2018.shape[1] * grss2018_scale),
                                        int(band_2018.shape[0] * grss2018_scale)))

    res = match_template_ccorr_normed(torch.from_numpy(band_2013.astype(np.float32)).to(device),
                                      torch.from_numpy(band_2018).to(device))
    max_loc = max_location(res)
    w, h = band_2018.shape[::-1]
    top_left = max_loc
    bottom_right = (top_left[0] + w, top_left[1] + h)
    im_2013 = (band_2013 / np.max(band_2013) * 255).astype("uint8")
    draw_rectangle(im_2013, top_left, bottom_right, 255, 4 * grss2013_scale)
    path = os.path.join(output_path, "lidar_match.png")
    plt = pyplot(path)
    if plt is not None:
        plt.imshow(im_2013)
        plt.title("Detected Point"), plt.xticks([]), plt.yticks([])
        plt.savefig(path)
        plt.clf()
    print("Top Left", top_left)
    print("Top Left(scaled) (%f, %f)" % (top_left[0] / grss2013_scale,
                                         top_left[1] / grss2013_scale))
    print("Bottom Right", bottom_right)
    print("Bottom Right(scaled) (%f, %f)" % (bottom_right[0] / grss2013_scale,
                                             bottom_right[1] / grss2013_scale))
    return top_left, bottom_right


def main(argv=None):
    """Runs the CLI; returns ``(top_left, bottom_right)``."""
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loggers(parser)
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_device(parser)
    flags, _ = parser.parse_known_args(argv)
    device = resolve_device(flags.device)

    lidar_grss2013_scale = 5
    lidar_grss2018_scale = lidar_grss2013_scale / 2.5

    grss_2013 = get_loader_from_name("GRSS2013DataLoader", flags.path).load_data(0, True)
    grss_2018 = get_loader_from_name("GRSS2018DataLoader", flags.path).load_data(0, True)
    return match_data(8, 2, grss_2013, grss_2018, lidar_grss2013_scale, lidar_grss2018_scale,
                      device, flags.output_path)


if __name__ == "__main__":
    main()
