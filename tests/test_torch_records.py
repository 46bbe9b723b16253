"""Record interop in the port against the JAX package and TensorFlow on the CPU.

The record writer's ``.npz`` cache and ``.tfrecord`` set (plain and gzipped)
are byte-equal to the JAX writer's on one synthetic scene (the clock fixed,
as zip and gzip headers hold it); the numpy TFRecord and ``tf.train.Example``
reader equals TF's parse of the same files, including records TF wrote and
hand-encoded unpacked values; ``RecordImporter`` feeds the JAX importer's
patches and targets, and ``InMemoryImporter``'s patches bit for bit; the
train CLI trains from both formats; and the port's summary event files are
read by TF's own reader. Everything is exact.
"""

import glob
import gzip
import os
import struct
import time

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from hypelcnn_tpu.core.registry import get_importer_from_name as jax_get_importer  # noqa: E402
from hypelcnn_tpu.utils import record_writer as jax_record_writer  # noqa: E402
from hypelcnn_tpu.utils import tfrecord_compat as jax_compat  # noqa: E402
from hypelcnn_tpu_torch.apps import train_for_classification  # noqa: E402
from hypelcnn_tpu_torch.core.registry import get_importer_from_name  # noqa: E402
from hypelcnn_tpu_torch.data.importers import ArrayPatchSource  # noqa: E402
from hypelcnn_tpu_torch.train.summaries import SummaryWriter  # noqa: E402
from hypelcnn_tpu_torch.utils import record_writer, tfrecord_compat  # noqa: E402
from hypelcnn_tpu_torch.utils.tb_events import DataLoss  # noqa: E402
from hypelcnn_tpu_torch.utils.tfrecord_write import (  # noqa: E402
    _len_delimited,
    _tag,
    _varint,
    write_tfrecord,
)
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread)

SPEC = "synthetic://?h=24&w=32&bands=6&classes=4&seed=5"
SPLITS = ("training", "test", "validation")


def _write(writer, out, fmt, compressed, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    np.random.seed(7)  # the loader's split draws
    return writer.write_records("SyntheticDataLoader", SPEC, 0.3, 0.2, 1, str(out),
                                compressed=compressed, fmt=fmt)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The port's npz cache and gzipped records, and the JAX writer's records."""
    root = tmp_path_factory.mktemp("records")
    with pytest.MonkeyPatch.context() as monkeypatch:
        _write(record_writer, root / "npz", "npz", True, monkeypatch)
        _write(record_writer, root / "tf", "tfrecord", True, monkeypatch)
    return root


@pytest.mark.parametrize("fmt, compressed", [("npz", True), ("npz", False),
                                             ("tfrecord", False), ("tfrecord", True)])
def test_writer_output_is_byte_equal_to_jax(tmp_path, monkeypatch, fmt, compressed):
    _write(record_writer, tmp_path / "port", fmt, compressed, monkeypatch)
    _write(jax_record_writer, tmp_path / "jax", fmt, compressed, monkeypatch)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == (["patch_cache.npz"] if fmt == "npz" else
                     ["metadata.tfrecord", "test.tfrecord", "training.tfrecord",
                      "validation.tfrecord"])
    for name in names:
        ours = (tmp_path / "port" / name).read_bytes()
        assert ours == (tmp_path / "jax" / name).read_bytes(), name
        if fmt == "tfrecord" and compressed and name != "metadata.tfrecord":
            assert ours[:2] == b"\x1f\x8b"


@pytest.mark.parametrize("compressed", [False, True])
def test_numpy_reader_equals_tf_on_the_written_records(tmp_path, monkeypatch, compressed):
    _write(record_writer, tmp_path, "tfrecord", compressed, monkeypatch)
    ours = tfrecord_compat.read_reference_tfrecords(str(tmp_path))
    theirs = jax_compat.read_reference_tfrecords(str(tmp_path))  # tf.data and tf.train.Example
    assert tfrecord_compat.read_metadata(str(tmp_path)).keys() == set(SPLITS)
    for split in SPLITS:
        for a, b in zip(ours[split], theirs[split]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert ours["training"][0].shape[1:] == (3, 3, 7)


def _tf_example():
    feature = tf.train.Feature
    return tf.train.Example(features=tf.train.Features(feature={
        "raw": feature(bytes_list=tf.train.BytesList(value=[b"ab", b"", b"\x00\xff"])),
        "f": feature(float_list=tf.train.FloatList(value=[1.5, -0.0, 3e-38, np.inf])),
        "i": feature(int64_list=tf.train.Int64List(value=[0, -1, 2 ** 62, -(2 ** 63)])),
        "empty": feature(),
    }))


def _unpacked_example() -> bytes:
    """Floats and int64s as one field each, not packed (a valid proto2-era
    encoding that TF's parser accepts)."""
    floats = b"".join(_tag(1, 5) + struct.pack("<f", v) for v in (0.25, -2.0))
    ints = b"".join(_tag(1, 0) + _varint(v) for v in (5, -3))
    entries = (_len_delimited(1, _len_delimited(1, b"f") + _len_delimited(2, _len_delimited(
        2, floats))) + _len_delimited(1, _len_delimited(1, b"i") + _len_delimited(
            2, _len_delimited(3, ints))))
    return _len_delimited(1, entries)


def _tf_values(feature):
    kind = feature.WhichOneof("kind")
    if kind is None:
        return "empty", []
    return kind, list(getattr(feature, kind).value)


@pytest.mark.parametrize("compression", ["", "GZIP"])
def test_example_decoder_equals_tf_on_records_tf_wrote(tmp_path, compression):
    path = str(tmp_path / "x.tfrecord")
    records = [_tf_example().SerializeToString(), _unpacked_example()]
    with tf.io.TFRecordWriter(path, options=compression or None) as writer:
        for record in records:
            writer.write(record)
    ours = tfrecord_compat.read_records(path)
    assert ours == [bytes(r.numpy()) for r in tf.data.TFRecordDataset(
        path, compression_type=compression)] == records
    for record in records:
        expected = tf.train.Example()
        expected.ParseFromString(record)
        got = tfrecord_compat.parse_example(record)
        assert sorted(got) == sorted(expected.features.feature)
        for name, feature in expected.features.feature.items():
            kind, values = _tf_values(feature)
            assert got[name][0] == kind, name
            if kind == "float_list":
                np.testing.assert_array_equal(got[name][1], np.asarray(values, np.float32))
                assert got[name][1].dtype == np.float32
            else:
                assert list(got[name][1]) == values, name


def test_a_corrupt_record_raises(tmp_path):
    path = tmp_path / "x.tfrecord"
    write_tfrecord(str(path), [b"abc" * 10, b"defg"])
    data = bytearray(path.read_bytes())
    data[15] ^= 0x01  # a payload byte of the first record
    path.write_bytes(bytes(data))
    with pytest.raises(IOError, match="could not read tfrecord"):
        tfrecord_compat.read_records(str(path))
    with pytest.raises(DataLoss, match="data crc"):
        tfrecord_compat.split_frames(bytes(data))
    gz = tmp_path / "y.tfrecord"
    gz.write_bytes(gzip.compress(bytes(data)))
    with pytest.raises(DataLoss):
        tfrecord_compat.read_records(str(gz))


@pytest.mark.parametrize("fmt", ["npz", "tf"])
def test_record_importer_feeds_the_jax_patches_and_targets(written, fmt):
    path = str(written / fmt)
    ours = get_importer_from_name("TFRecordImporter").read_data_set(
        "SyntheticDataLoader", path, None, None, None)
    theirs = jax_get_importer("TFRecordImporter").read_data_set(
        "SyntheticDataLoader", path, None, None, None)
    assert ours.scene is None and ours.class_count == theirs.class_count
    assert list(ours.data_shape) == list(theirs.data_shape)
    np.testing.assert_array_equal(ours.color_list, theirs.color_list)
    for split in SPLITS:
        np.testing.assert_array_equal(ours.targets(split), theirs.targets(split))
        assert isinstance(ours.sources[split], ArrayPatchSource)
        np.testing.assert_array_equal(ours.sources[split].device_arrays("cpu").numpy(),
                                      np.asarray(theirs.sources[split].device_arrays()))


def test_record_importer_patches_are_in_memory_importers(written):
    np.random.seed(7)
    in_memory = get_importer_from_name("InMemoryImporter").read_data_set(
        "SyntheticDataLoader", SPEC, 0.3, 0.2, 1)
    cache = get_importer_from_name("RecordImporter").read_data_set(
        None, str(written / "npz" / "patch_cache.npz"), None, None, None)
    records = get_importer_from_name("RecordImporter").read_data_set(
        None, str(written / "tf"), None, None, None)
    for split in SPLITS:
        expected = in_memory.sources[split].device_arrays("cpu")
        assert torch.equal(cache.sources[split].device_arrays("cpu"), expected)
        assert torch.equal(records.sources[split].device_arrays("cpu"), expected)
        np.testing.assert_array_equal(cache.targets(split), in_memory.targets(split))
        # the records hold labels only: their targets' (x, y) are zero
        np.testing.assert_array_equal(records.targets(split)[:, 2], in_memory.targets(split)[:, 2])
        assert not records.targets(split)[:, :2].any()
    assert cache.class_count == records.class_count == in_memory.class_count == 4


@pytest.mark.parametrize("fmt", ["npz", "tf"])
def test_train_cli_trains_from_records(written, tmp_path, monkeypatch, fmt):
    """Rows of the split arrays, never the window gather."""
    import hypelcnn_tpu_torch.data.importers as importers

    def no_gather(*args, **kwargs):
        raise AssertionError("RecordImporter reached the window gather")

    monkeypatch.setattr(importers, "gather_patches", no_gather)
    params = tmp_path / "params.json"
    params.write_text('{"filter_count": 32}')
    result = train_for_classification.main([
        "--loader_name=SyntheticDataLoader", f"--path={written / fmt}",
        "--importer_name=RecordImporter", "--neighborhood=1", f"--algorithm_param_path={params}",
        "--device=cpu", "--step=30", "--batch_size=16", "--save_checkpoint_steps=30",
        f"--base_log_path={tmp_path / 'log'}"])
    assert np.isfinite(result.loss) and result.steps_run == 30
    assert result.test_metrics.confusion.sum() == len(
        get_importer_from_name("RecordImporter").read_data_set(
            None, str(written / fmt), None, None, None).targets("test"))


def test_port_event_files_are_read_by_tf(tmp_path):
    writer = SummaryWriter(str(tmp_path))
    writer.text("algorithm_params", '{"a": 1}')
    writer.scalar("loss", 0.75, 10)
    writer.histogram("params/w", np.arange(12.0), 10)
    writer.close()
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    events = list(tf.compat.v1.train.summary_iterator(path))
    assert events[0].file_version == "brain.Event:2"
    values = {v.tag: (e.step, v) for e in events[1:] for v in e.summary.value}
    assert values["loss"][0] == 10 and values["loss"][1].simple_value == 0.75
    text = values["algorithm_params"][1]
    assert text.metadata.plugin_data.plugin_name == "text"
    assert tf.make_ndarray(text.tensor).tolist() == [b'{"a": 1}']
    histo = values["params/w"][1].histo
    assert (histo.min, histo.max, histo.num, histo.sum) == (0.0, 11.0, 12.0, 66.0)
    assert sum(histo.bucket) == 12
