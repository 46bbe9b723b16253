"""Full-scene classification inference (``hypelcnn_tpu/infer/scene_inference.py``).

The padded scene stays on the device; the sweep walks it in row bands, makes
each band's pixel coordinates on the device, gathers the band's windows with
one :func:`~hypelcnn_tpu_torch.ops.window_gather.gather_patches` call, runs
the eval-mode forward and keeps the argmax class ids on the device. Only the
finished ``uint8`` class map comes back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from hypelcnn_tpu_torch.ops.window_gather import gather_patches

INVALID_TARGET_VALUE = 255


def predict_targets(module, scene, targets_xy: np.ndarray, device,
                    batch_size: int = 4096) -> np.ndarray:
    """Predict class ids for an explicit ``[N, >=2]`` (x, y) target list."""
    k = 2 * scene.neighborhood + 1
    scene_dev = scene.device_scene(device)
    coords_all = torch.from_numpy(np.ascontiguousarray(targets_xy[:, :2], dtype=np.int32)).to(device)
    preds = []
    module.eval()
    with torch.inference_mode():
        for start in range(0, coords_all.shape[0], batch_size):
            patches = gather_patches(scene_dev, coords_all[start:start + batch_size], k)
            preds.append(torch.argmax(module(patches).y_conv, dim=1).to(torch.int32))
    if not preds:
        return np.empty((0,), dtype=np.int32)
    return torch.cat(preds).cpu().numpy()


def predict_full_scene(module, scene, batch_rows: int = 16, device="cuda",
                       gather=gather_patches) -> np.ndarray:
    """Classify every pixel; returns an ``[H, W]`` uint8 class map.

    ``module`` must already be on ``device``. Bands hold ``batch_rows`` full
    scene rows; the last band is moved up to end at the last row (its rows
    overlap the band before, which they overwrite with the same ids). A scene
    shorter than a band is swept from row 0, the rows past its end reading
    the clamped edge. ``gather`` is the window gather; the default launches
    the CUDA kernel on a CUDA scene, and ``gather_patches_torch`` gives the
    plain reference on the same device.
    """
    device = torch.device(device)
    height, width = scene.get_scene_shape()
    k = 2 * scene.neighborhood + 1
    scene_dev = scene.device_scene(device)

    rows = torch.arange(batch_rows, device=device, dtype=torch.int32)
    cols = torch.arange(width, device=device, dtype=torch.int32)
    band = torch.stack([cols.repeat(batch_rows), rows.repeat_interleave(width)], dim=1)
    y_step = torch.tensor([0, 1], dtype=torch.int32, device=device)
    result = torch.empty((max(height, batch_rows), width), dtype=torch.uint8, device=device)
    n_bands = (height + batch_rows - 1) // batch_rows

    module.eval()
    with torch.inference_mode():
        for index in range(n_bands):
            rs = min(index * batch_rows, height - batch_rows) if height >= batch_rows else 0
            coords = band.add(y_step, alpha=rs)
            logits = module(gather(scene_dev, coords, k)).y_conv
            result[rs:rs + batch_rows] = torch.argmax(logits, dim=1).to(torch.uint8).view(
                batch_rows, width)
    return result[:height].cpu().numpy()


def create_colored_image(target_image: np.ndarray, color_list: np.ndarray) -> np.ndarray:
    """Class map -> RGB through a lookup table."""
    lut = np.zeros((256, 3), dtype=np.uint8)
    lut[: len(color_list)] = color_list
    return lut[target_image]


def create_target_image_via_samples(sample_set, scene_shape) -> np.ndarray:
    """Rasterize the sample set into a class map."""
    image = np.full((scene_shape[0], scene_shape[1]), INVALID_TARGET_VALUE, dtype=np.uint8)
    targets = np.vstack([sample_set.training_targets, sample_set.test_targets,
                         sample_set.validation_targets])
    for point in targets.astype(int):
        image[point[1], point[0]] = point[2]
    return image
