"""The port's event-file utilities against the JAX package's copies on the CPU.

``tb_events`` (confusion text tensors and scalars out of event files, a
corrupt tail skipped), ``stat_extractor``, ``summary_reader`` on a log dir
that the port's train CLI wrote, and ``latex_table``: the same results, the
same files and the same printed report. Everything is exact.
"""

import os

import numpy as np
import pytest

from hypelcnn_tpu.utils import latex_table as jax_latex_table
from hypelcnn_tpu.utils import stat_extractor as jax_stat_extractor
from hypelcnn_tpu.utils import summary_reader as jax_summary_reader
from hypelcnn_tpu.utils import tb_events as jax_tb_events
from hypelcnn_tpu_torch.apps import train_for_classification
from hypelcnn_tpu_torch.train.summaries import SummaryWriter
from hypelcnn_tpu_torch.utils import latex_table, stat_extractor, summary_reader, tb_events
from hypelcnn_tpu_torch.utils.tfrecord_write import _len_delimited, _tag, _varint, frame_records
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
CONFUSIONS = [np.array([[41, 2, 0], [3, 57, 1], [0, 4, 66]]),
              np.array([[39, 4, 0], [1, 60, 0], [2, 2, 66]]),
              np.array([[40, 3, 0], [2, 58, 1], [1, 3, 67]])]


def _confusion_event(step: int, matrix: np.ndarray) -> bytes:
    """An Event holding ``tf.summary.text('validation_confusion',
    tf.as_string(matrix))``, as the reference writes it."""
    dims = b"".join(_len_delimited(2, _tag(1, 0) + _varint(n)) for n in matrix.shape)
    tensor = (_tag(1, 0) + _varint(7) + _len_delimited(2, dims)
              + b"".join(_len_delimited(8, str(int(v)).encode()) for v in matrix.reshape(-1)))
    value = _len_delimited(1, b"validation_confusion") + _len_delimited(8, tensor)
    return _tag(2, 0) + _varint(step) + _len_delimited(5, _len_delimited(1, value))


@pytest.fixture(scope="module")
def event_dir(tmp_path_factory):
    """runs/exp1/: the port's summary writer's event file, plus a file of
    reference-style confusion events."""
    base = tmp_path_factory.mktemp("runs") / "exp1"
    writer = SummaryWriter(str(base))
    for step, value in ((100, 0.91), (101, 0.93)):
        writer.scalar("validation_overall_accuracy", value, step)
    writer.close()
    (base / "events.out.tfevents.1.ref").write_bytes(frame_records(
        [_confusion_event(100 + i, m) for i, m in enumerate(CONFUSIONS)]))
    return base


def _same_results(ours, theirs):
    assert [(s, os.path.basename(p)) for s, p, _ in ours] == \
        [(s, os.path.basename(p)) for s, p, _ in theirs]
    for (_, _, a), (_, _, b) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_extract_confusions_and_scalars_match_jax(event_dir, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = tb_events.extract_confusions(str(event_dir), output_dir=str(tmp_path / "port"))
    theirs = jax_tb_events.extract_confusions(str(event_dir), output_dir=str(tmp_path / "jax"))
    _same_results(ours, theirs)
    assert [s for s, _, _ in ours] == [100, 101, 102]
    for (_, path, matrix), expected in zip(ours, CONFUSIONS):
        np.testing.assert_array_equal(matrix, expected)
        name = os.path.basename(path)
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    filtered = tb_events.extract_confusions(str(event_dir), [101], output_dir=str(tmp_path))
    assert [s for s, _, _ in filtered] == [101]
    scalars = tb_events.read_scalars(str(event_dir))
    assert scalars == jax_tb_events.read_scalars(str(event_dir))
    assert dict(scalars["validation_overall_accuracy"]) == pytest.approx({100: 0.91, 101: 0.93})


def test_a_corrupt_tail_is_skipped_as_jax_skips_it(event_dir, tmp_path, capsys):
    data = bytearray((event_dir / "events.out.tfevents.1.ref").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "events.out.tfevents.1.ref").write_bytes(bytes(data))
    ours = tb_events.extract_confusions(str(tmp_path / "bad"), output_dir=str(tmp_path))
    theirs = jax_tb_events.extract_confusions(str(tmp_path / "bad"), output_dir=str(tmp_path))
    _same_results(ours, theirs)
    assert len(ours) < 3 and "Error reading summary file" in capsys.readouterr().out
    assert tb_events.masked_crc32c(b"abc") == jax_tb_events.masked_crc32c(b"abc")
    rows = np.frombuffer(b"".join(bytes([i]) * 9 for i in range(5)), np.uint8).reshape(5, 9)
    assert tb_events.masked_crc32c_rows(rows).tolist() == \
        [jax_tb_events.masked_crc32c(bytes(r)) for r in rows]


def _write_confusion_dir(directory, matrices):
    directory.mkdir()
    for i, m in enumerate(matrices):
        np.savetxt(directory / f"run_{i}.csv", m, fmt="%d", delimiter=",")
    return str(directory)


def test_stat_extractor_matches_jax(tmp_path, capsys):
    directory = _write_confusion_dir(tmp_path / "runs", CONFUSIONS)
    ours = stat_extractor.extract_statistics_info(
        stat_extractor.get_conf_list_from_directory(directory))
    theirs = jax_stat_extractor.extract_statistics_info(
        jax_stat_extractor.get_conf_list_from_directory(directory))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    for module in (stat_extractor, jax_stat_extractor):
        module.print_statistics_info(module.extract_statistics_info(
            module.get_conf_list_from_directory(directory)))
    report = capsys.readouterr().out
    half = len(report) // 2
    assert report[:half] == report[half:] and "Kappa:" in report
    kappas = [0.9, 0.8, 0.95]
    assert stat_extractor.calc_mean_quadratic_weighted_kappa(kappas) == \
        jax_stat_extractor.calc_mean_quadratic_weighted_kappa(kappas)


def test_summary_reader_on_a_port_log_dir_matches_jax(tmp_path):
    params = tmp_path / "params.json"
    params.write_text('{"filter_count": 32}')
    train_for_classification.main([
        "--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu",
        "--importer_name=GeneratorImporter", "--neighborhood=1",
        f"--algorithm_param_path={params}", "--batch_size=16", "--step=20",
        "--perform_validation=true", "--validation_steps=10",
        f"--base_log_path={tmp_path / 'log'}"])
    (log_dir,) = (tmp_path / "log").iterdir()
    assert sorted(p.name for p in log_dir.glob("validation_confusion_*.csv")) == \
        ["validation_confusion_10.csv", "validation_confusion_20.csv"]
    assert list(log_dir.glob("events.out.tfevents.*"))
    summary_reader.process_log_dir(str(log_dir), str(tmp_path / "port"))
    jax_summary_reader.process_log_dir(str(log_dir), str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert "metrics_history.csv" in names and "validation_confusion_20.csv" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    scalars = tb_events.read_scalars(str(log_dir))
    assert scalars == jax_tb_events.read_scalars(str(log_dir))
    assert [s for s, _ in scalars["loss"]] == [20] and "validation_kappa" in scalars


def test_latex_table_matches_jax(tmp_path):
    dirs = {"A": _write_confusion_dir(tmp_path / "a", CONFUSIONS[:2]),
            "B": _write_confusion_dir(tmp_path / "b", CONFUSIONS[1:])}
    ours = latex_table.build_table(dirs, class_names=["x", "y", "z"])
    assert ours == jax_latex_table.build_table(dirs, class_names=["x", "y", "z"])
    assert ours.count("\\textbf") >= 6 and ours.startswith("\\begin{table}")
    with pytest.raises(ValueError, match="No confusion CSVs"):
        latex_table.build_table({"empty": str(tmp_path)})
