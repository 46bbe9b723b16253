"""Full-scene classification inference (``hypelcnn_tpu/infer/scene_inference.py``).

The padded scene stays on the device; the sweep walks it in row bands, makes
each band's pixel coordinates on the device, gathers the band's windows with
one :func:`~hypelcnn_tpu_torch.ops.window_gather.gather_patches` call, runs
the eval-mode forward and keeps the argmax class ids on the device. Only the
finished ``uint8`` class map comes back to the host.

A ``MultiScene`` is swept through its member 0, as in the JAX package. A
``DualResScene`` has no fused device scene, so both functions raise on one
(``DualResScene.device_scene``): the JAX package cannot sweep one either.

With a :class:`~hypelcnn_tpu_torch.parallel.mesh.Mesh` of several data
ranks each band's pixels are split by data index, each rank gathers and
classifies its slice, and the class map is the sum over the data axis of a
zero-filled int map in which each data index wrote its own pixels (exact:
each pixel has one writer). The model's batch-coupled layers (CAP) reduce
over the whole band, so the map is the one-rank map. On a mesh with a model
axis the module holds this rank's kernel slices (``shard_module_``): the
model ranks of one data index compute the same pixels together.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Optional

import numpy as np
import torch

from hypelcnn_tpu_torch.core import trace
from hypelcnn_tpu_torch.ops.window_gather import gather_patches
from hypelcnn_tpu_torch.parallel.mesh import Mesh, bound_mesh

INVALID_TARGET_VALUE = 255
_SWEEPS = itertools.count()  # the sweep's call number, the id of its spans


def predict_targets(module, scene, targets_xy: np.ndarray, device,
                    batch_size: int = 4096) -> np.ndarray:
    """Predict class ids for an explicit ``[N, >=2]`` (x, y) target list.

    Every batch holds ``batch_size`` windows: the last one is padded with
    coordinate (0, 0), whose predictions are dropped, as the JAX package
    pads it. A model that normalizes with batch statistics in evaluation
    (CAP) gives the JAX package's ids only so.
    """
    k = 2 * scene.neighborhood + 1
    n = targets_xy.shape[0]
    padded = np.zeros((-(-n // batch_size) * batch_size, 2), dtype=np.int32)
    padded[:n] = targets_xy[:, :2]
    scene_dev = scene.device_scene(device)
    coords_all = torch.from_numpy(padded).to(device)
    preds = []
    module.eval()
    with torch.inference_mode():
        for start in range(0, padded.shape[0], batch_size):
            patches = gather_patches(scene_dev, coords_all[start:start + batch_size], k)
            preds.append(torch.argmax(module(patches).y_conv, dim=1).to(torch.int32))
    if not preds:
        return np.empty((0,), dtype=np.int32)
    return torch.cat(preds)[:n].cpu().numpy()


def predict_full_scene(module, scene, batch_rows: int = 16, device="cuda",
                       gather=gather_patches, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Classify every pixel; returns an ``[H, W]`` uint8 class map.

    ``module`` must already be on ``device``. Bands hold ``batch_rows`` full
    scene rows; the last band is moved up to end at the last row (its rows
    overlap the band before, which they overwrite with the same ids). A scene
    shorter than a band is swept from row 0, the rows past its end reading
    the clamped edge. ``gather`` is the window gather; the default launches
    the CUDA kernel on a CUDA scene, and ``gather_patches_torch`` gives the
    plain reference on the same device. ``mesh`` splits each band's pixels
    over its data axis; every rank returns the whole map.
    """
    call = next(_SWEEPS)
    with trace.span("sweep.setup", call):
        device = torch.device(device)
        height, width = scene.get_scene_shape()
        k = 2 * scene.neighborhood + 1
        scene_dev = scene.device_scene(device)
        ranks = mesh if mesh is not None else Mesh()

        rows = torch.arange(batch_rows, device=device, dtype=torch.int32)
        cols = torch.arange(width, device=device, dtype=torch.int32)
        band = torch.stack([cols.repeat(batch_rows), rows.repeat_interleave(width)], dim=1)
        share = ranks.split(band.shape[0])
        band = band[share]
        y_step = torch.tensor([0, 1], dtype=torch.int32, device=device)
        # a rank writes its pixels of a zero-filled map, summed over the ranks at the end
        result = torch.zeros((max(height, batch_rows), width), dtype=torch.int32, device=device)
        n_bands = (height + batch_rows - 1) // batch_rows
        module.eval()

    with torch.inference_mode(), bound_mesh(module, mesh) if mesh is not None \
            else contextlib.nullcontext():
        for index in range(n_bands):
            with trace.span("sweep.band", call, index):
                rs = min(index * batch_rows, height - batch_rows) if height >= batch_rows else 0
                coords = band.add(y_step, alpha=rs)
                preds = torch.argmax(module(gather(scene_dev, coords, k)).y_conv, dim=1)
                block = result[rs:rs + batch_rows]
                block.zero_()  # the last band's pixels may have had another owner before
                block.view(-1)[share] = preds.to(torch.int32)
    with trace.span("sweep.map", call):
        return ranks.all_reduce_(result)[:height].to(torch.uint8).cpu().numpy()


def predict_full_scene_scan(module, scene, batch_rows: int = 16, device="cuda",
                            gather=gather_patches, mesh: Optional[Mesh] = None) -> np.ndarray:
    """:func:`predict_full_scene` under the JAX package's name for its
    one-dispatch sweep (``lax.scan`` over the bands, which saves TPU
    dispatches). The port runs the same band loop: on the card a band's
    launches already keep the device busy."""
    return predict_full_scene(module, scene, batch_rows, device, gather, mesh)


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
