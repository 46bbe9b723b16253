"""Input-pipeline strategies ("importers"), as in ``hypelcnn_tpu/data/importers.py``.

Each importer yields a :class:`PatchSource` per split, which the training
step and the eval drains call on the device:

- ``GeneratorImporter`` -> :class:`ScenePatchSource`: the padded scene lives
  on the device and every batch of windows is cut from it there. A
  ``Scene`` goes through
  :func:`~hypelcnn_tpu_torch.ops.window_gather.gather_patches`, the CUDA
  window gather on a CUDA scene; a ``DualResScene`` through
  ``gather_patches_dual`` and a ``MultiScene`` through ``gather_from_multi``,
  which draws each window's member from the generator it is given.
- ``InMemoryImporter`` -> :class:`ArrayPatchSource`: every split's windows are
  cut on the host once (``get_data_point``; a ``MultiScene`` draws its
  members from the global ``np.random`` state), moved to the device once,
  and a step selects rows of it.
- ``RecordImporter`` -> :class:`ArrayPatchSource` too, fed from the files
  ``utils/record_writer.py`` writes: a ``patch_cache.npz``, or the
  reference's four ``.tfrecord`` files (read with numpy,
  ``utils/tfrecord_compat.py``). It carries no scene, so it never reaches
  the window gather.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from hypelcnn_tpu_torch.core.registry import get_loader_from_name, register_importer
from hypelcnn_tpu_torch.data.loaders.base import SampleSet
from hypelcnn_tpu_torch.data.scene import DualResScene, MultiScene
from hypelcnn_tpu_torch.ops.window_gather import (
    gather_from_multi,
    gather_patches,
    gather_patches_dual,
)
from hypelcnn_tpu_torch.utils.tfrecord_compat import read_reference_tfrecords


class PatchSource:
    """Patch access for one split: ``gather(device_arrays(device), idx, coords)``
    returns the ``[B, k, k, C]`` windows of the rows ``idx`` at ``coords``.
    A source whose ``draws_members`` is true takes each window's member from
    ``member`` (:meth:`draw_members`), else draws it from the ``generator``
    passed to ``gather``; the others take neither."""

    draws_members = False

    def device_arrays(self, device):
        raise NotImplementedError

    def draw_members(self, arrays, count: int, generator: torch.Generator) -> torch.Tensor:
        """The ``[count]`` member ids that ``gather`` would draw from ``generator``."""
        raise NotImplementedError

    def gather(self, arrays, idx: torch.Tensor, coords: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               member: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError


class ScenePatchSource(PatchSource):
    def __init__(self, scene):
        self.scene = scene
        self.draws_members = isinstance(scene, MultiScene)

    def device_arrays(self, device):
        if isinstance(self.scene, MultiScene):
            return self.scene.device_scenes(device)
        if isinstance(self.scene, DualResScene):
            return self.scene.device_modalities(device)
        return self.scene.device_scene(device)

    def draw_members(self, arrays, count, generator):
        return torch.randint(0, arrays[1].shape[0], (count,), generator=generator,
                             device=arrays[1].device)

    def gather(self, arrays, idx, coords, generator=None, member=None):
        """``coords``: contiguous int32 ``[B, 2]`` (x, y) on the scene's device."""
        n = self.scene.neighborhood
        if isinstance(self.scene, MultiScene):
            return gather_from_multi(arrays, coords, n, member=member, generator=generator)
        if isinstance(self.scene, DualResScene):
            casi, lidar = arrays
            return gather_patches_dual(casi, lidar, coords, n, DualResScene.CASI_SCALE)
        return gather_patches(arrays, coords, 2 * n + 1)


class ArrayPatchSource(PatchSource):
    def __init__(self, patches: np.ndarray):
        self.patches = patches
        self._device_patches: Dict[torch.device, torch.Tensor] = {}

    def device_arrays(self, device) -> torch.Tensor:
        device = torch.device(device)
        patches = self._device_patches.get(device)
        if patches is None:
            patches = torch.from_numpy(np.ascontiguousarray(self.patches, dtype=np.float32)
                                       ).to(device)
            self._device_patches[device] = patches
        return patches

    def gather(self, arrays, idx, coords, generator=None, member=None):
        return arrays.index_select(0, idx)


@dataclass
class ImportedDataSet:
    loader: Any
    scene: Any
    sample_set: SampleSet
    class_count: int
    data_shape: list
    color_list: np.ndarray
    sources: Dict[str, PatchSource]           # keys: training / test / validation

    def targets(self, split: str) -> np.ndarray:
        return {"training": self.sample_set.training_targets,
                "test": self.sample_set.test_targets,
                "validation": self.sample_set.validation_targets}[split]


def _load_common(loader_name: str, path: str, neighborhood: int,
                 train_ratio: float, test_ratio: float, normalize: bool = True):
    loader = get_loader_from_name(loader_name, path)
    scene = loader.load_data(neighborhood, normalize=normalize)
    sample_set = loader.load_samples(train_ratio, test_ratio)
    return loader, scene, sample_set


def _gather_all_host(scene, targets: np.ndarray) -> np.ndarray:
    """Every target's window, cut on the host."""
    n = targets.shape[0]
    out = np.empty((n, *scene.get_data_shape()), dtype=np.float32)
    for i in range(n):
        out[i] = scene.get_data_point(int(targets[i, 0]), int(targets[i, 1]))
    return out


class BaseImporter:
    def read_data_set(self, loader_name: str, path: str, train_ratio: float,
                      test_ratio: float, neighborhood: int,
                      normalize: bool = True) -> ImportedDataSet:
        raise NotImplementedError


@register_importer("GeneratorImporter")
class GeneratorImporter(BaseImporter):
    """Windows cut on the device from the device-resident scene."""

    def read_data_set(self, loader_name, path, train_ratio, test_ratio, neighborhood,
                      normalize=True):
        loader, scene, sample_set = _load_common(loader_name, path, neighborhood,
                                                 train_ratio, test_ratio, normalize)
        src = ScenePatchSource(scene)
        return ImportedDataSet(
            loader=loader, scene=scene, sample_set=sample_set,
            class_count=loader.get_class_count().stop,
            data_shape=scene.get_data_shape(),
            color_list=loader.get_samples_color_list(),
            sources={"training": src, "test": src, "validation": src})


@register_importer("InMemoryImporter")
class InMemoryImporter(BaseImporter):
    """Windows cut on the host once per split and kept on the device. Validation
    uses the loader's validation targets (not the test split's, as in the JAX
    package)."""

    def read_data_set(self, loader_name, path, train_ratio, test_ratio, neighborhood,
                      normalize=True):
        loader, scene, sample_set = _load_common(loader_name, path, neighborhood,
                                                 train_ratio, test_ratio, normalize)
        sources = {}
        for split, targets in (("training", sample_set.training_targets),
                               ("test", sample_set.test_targets),
                               ("validation", sample_set.validation_targets)):
            sources[split] = ArrayPatchSource(_gather_all_host(scene, targets))
        return ImportedDataSet(
            loader=loader, scene=scene, sample_set=sample_set,
            class_count=loader.get_class_count().stop,
            data_shape=scene.get_data_shape(),
            color_list=loader.get_samples_color_list(),
            sources=sources)


@register_importer("RecordImporter")
class RecordImporter(BaseImporter):
    """Reads ``utils/record_writer.py``'s output: ``path`` is the
    ``patch_cache.npz``, its directory, or a directory of the reference's
    ``.tfrecord`` files (``metadata.tfrecord`` beside the splits), which
    ``TFRecordImporter`` names too. The ratios and neighborhood are the
    files'."""

    def read_data_set(self, loader_name, path, train_ratio, test_ratio, neighborhood,
                      normalize=True):
        del train_ratio, test_ratio, neighborhood, normalize
        record_dir = path if os.path.isdir(path) else os.path.dirname(path) or "."
        if not path.endswith(".npz") and \
                os.path.exists(os.path.join(record_dir, "metadata.tfrecord")):
            return self._read_reference_tfrecords(loader_name, record_dir)
        cache_path = path if path.endswith(".npz") else os.path.join(path, "patch_cache.npz")
        with np.load(cache_path, allow_pickle=False) as blob:
            sources = {split: ArrayPatchSource(blob[f"{split}_patches"])
                       for split in ("training", "test", "validation")}
            sample_set = SampleSet(training_targets=blob["training_targets"],
                                   test_targets=blob["test_targets"],
                                   validation_targets=blob["validation_targets"])
            class_count = int(blob["class_count"])
            color_list = blob["color_list"] if "color_list" in blob else \
                np.zeros((class_count, 3), dtype=np.uint8)
            data_shape = list(blob["data_shape"])
        return ImportedDataSet(
            loader=None, scene=None, sample_set=sample_set, class_count=class_count,
            data_shape=data_shape, color_list=color_list, sources=sources)

    @staticmethod
    def _read_reference_tfrecords(loader_name, record_dir):
        """The reference's records hold only ``{label, image}``: the targets'
        ``(x, y)`` are zero, so whatever needs coordinates (a scene sweep,
        target maps) needs a scene-backed importer. The class count and
        colours are the named loader's, else from the labels."""
        splits = read_reference_tfrecords(record_dir)
        sources = {}
        sample_targets = {}
        data_shape = None
        for split, (patches, labels) in splits.items():
            targets = np.zeros((labels.shape[0], 3), dtype=np.int32)
            targets[:, 2] = labels
            sample_targets[split] = targets
            sources[split] = ArrayPatchSource(patches)
            if patches.shape[0]:
                data_shape = list(patches.shape[1:])
        sample_set = SampleSet(training_targets=sample_targets["training"],
                               test_targets=sample_targets["test"],
                               validation_targets=sample_targets["validation"])
        class_count = int(max(int(t[:, 2].max(initial=0)) for t in sample_targets.values())) + 1
        color_list = np.zeros((class_count, 3), dtype=np.uint8)
        loader = None
        if loader_name:
            try:
                loader = get_loader_from_name(loader_name, record_dir)
                class_count = loader.get_class_count().stop
                color_list = loader.get_samples_color_list()
            except (KeyError, ValueError) as exc:
                # an unknown loader, or one the record directory is no path
                # for: reported, and the labels' class count kept
                print(f"RecordImporter: loader {loader_name!r} unavailable ({exc}); "
                      f"{class_count} classes from the labels")
                loader = None
        return ImportedDataSet(
            loader=loader, scene=None, sample_set=sample_set,
            class_count=class_count, data_shape=data_shape,
            color_list=color_list, sources=sources)
