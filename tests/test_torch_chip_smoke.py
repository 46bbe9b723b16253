"""``chip_smoke.py`` on the CPU: it imports, refuses to run without a card,
keeps no peak of the card of its own, and bounds its kernel rows with the
benchmark's peaks (``portbench/counts.py``)."""

import re

import pytest
import torch

import chip_smoke
from portbench import counts
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

H100 = "NVIDIA H100 80GB HBM3"


def test_exports_what_the_repeat_script_imports():
    # scripts/torch_train_repeat.py drives the train CLI through these
    for name in ("_train_args", "_run_train_cli", "_logged_losses", "emit", "phase_device"):
        assert callable(getattr(chip_smoke, name))
    assert [f.phase for f in chip_smoke.FAMILIES] == ["family_concnn", "family_dualcnn",
                                                      "family_cap"]


@pytest.mark.parametrize("entry", [chip_smoke.main,
                                   lambda: chip_smoke.rank_main("no_such_spec.json")],
                         ids=["main", "rank_main"])
def test_refuses_without_cuda(entry, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert entry() == 1
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def test_keeps_no_peak_of_its_own():
    assert [name for name in vars(chip_smoke) if re.search(r"_PER_S$", name)] == []


@pytest.mark.parametrize("k, channels", [(1, 145), (3, 145), (5, 145), (3, 65), (3, 360)])
def test_band_bytes_are_the_benchmarks(k, channels):
    """A sweep band's coordinates (the band at rows 32 to 47) over the scene
    padded by k - 1: the bytes the kernel row reckons are
    ``counts.gather_band_bytes``'s."""
    band = chip_smoke._bands("cpu", 3)[2]
    assert band.shape == (chip_smoke.BATCH_ROWS * chip_smoke.WIDTH, 2)
    written, read = chip_smoke._gather_bytes(band, k, channels, chip_smoke.WIDTH + k - 1)
    assert written + read == counts.gather_band_bytes(chip_smoke.BATCH_ROWS, chip_smoke.WIDTH,
                                                      k, channels)


def test_bound_reads_the_benchmarks_bandwidth():
    moved = counts.gather_band_bytes(chip_smoke.BATCH_ROWS, chip_smoke.WIDTH, 3, 145)
    assert chip_smoke._bound_ms(moved, H100) == moved / counts.peak(H100, "hbm_bytes_per_s") * 1e3
    assert chip_smoke._bound_ms(moved, "a card the table lacks") is None
