"""Patch-cache writer (``hypelcnn_tpu/utils/record_writer.py``), host only.

Cuts every split's windows on the host, as ``InMemoryImporter`` does, and
writes them for ``RecordImporter``:

- ``--format npz`` (the default): one ``patch_cache.npz`` holding each
  split's patches and targets, the class count, the data shape and the
  colour list (``np.savez_compressed`` unless ``--compressed=false``);
- ``--format tfrecord``: the reference's own four ``.tfrecord`` files
  (``utils/tfrecord_write.py``; the splits gzipped under ``--compressed``),
  which TF's ``TFRecordImporter`` reads too. They carry labels only, no
  coordinates.

CLI: ``python -m hypelcnn_tpu_torch.utils.record_writer --loader_name=...
--path=... --neighborhood=N --output_path=DIR [--format npz|tfrecord]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from hypelcnn_tpu_torch.core.config import add_parse_cmds_for_loaders, add_parse_cmds_for_loggers
from hypelcnn_tpu_torch.data.importers import _gather_all_host, _load_common
from hypelcnn_tpu_torch.utils.tfrecord_write import write_reference_dataset


def write_records(loader_name: str, path: str, train_ratio: float, test_ratio: float,
                  neighborhood: int, output_path: str, compressed: bool = True,
                  fmt: str = "npz") -> str:
    loader, scene, sample_set = _load_common(loader_name, path, neighborhood,
                                             train_ratio, test_ratio)
    blobs = {}
    for split, targets in (("training", sample_set.training_targets),
                           ("test", sample_set.test_targets),
                           ("validation", sample_set.validation_targets)):
        blobs[f"{split}_patches"] = _gather_all_host(scene, targets)
        blobs[f"{split}_targets"] = np.asarray(targets, dtype=np.int32)
    blobs["class_count"] = np.asarray(loader.get_class_count().stop)
    blobs["data_shape"] = np.asarray(scene.get_data_shape())
    blobs["color_list"] = loader.get_samples_color_list()

    os.makedirs(output_path, exist_ok=True)
    if fmt == "tfrecord":
        write_reference_dataset(
            output_path,
            {split: (blobs[f"{split}_patches"],
                     blobs[f"{split}_targets"][:, 2]
                     if blobs[f"{split}_targets"].shape[0] else
                     np.zeros((0,), np.int32))
             for split in ("training", "test", "validation")},
            compressed=compressed)
        print(f"Wrote reference .tfrecord set to {output_path}: " + ", ".join(
            f"{s}={blobs[f'{s}_patches'].shape[0]}"
            for s in ("training", "test", "validation")))
        return output_path
    out_file = os.path.join(output_path, "patch_cache.npz")
    save = np.savez_compressed if compressed else np.savez
    save(out_file, **blobs)
    print(f"Wrote {out_file}: " + ", ".join(
        f"{s}={blobs[f'{s}_patches'].shape[0]}" for s in ("training", "test", "validation")))
    return out_file


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    add_parse_cmds_for_loaders(parser)
    add_parse_cmds_for_loggers(parser)
    parser.add_argument("--compressed", type=lambda v: v.lower() != "false", default=True,
                        help="gzip the splits (the reference's GZIP option)")
    parser.add_argument("--format", choices=("npz", "tfrecord"), default="npz",
                        help="npz: the patch cache; tfrecord: the reference's own "
                             "four-file .tfrecord set")
    flags, _ = parser.parse_known_args(argv)
    return write_records(flags.loader_name, flags.path, flags.train_ratio, flags.test_ratio,
                         flags.neighborhood, flags.output_path, flags.compressed,
                         fmt=flags.format)


if __name__ == "__main__":
    main()
