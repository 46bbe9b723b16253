"""The port's five analysis utilities (``hypelcnn_tpu_torch/utils/``) against
the JAX package's on the same inputs, with ``np.random`` seeded alike: the
shadow map of ``remove_test_targets_from_shadow`` bit for bit, the band
ratio of ``measure_targets_shadow_ratio`` within 1e-6, the corners of
``lidar_matcher`` equal, the three MUUFL TIFFs of ``reveal_shadow_targets``
equal (the corrected HSI within 1e-6), and the activation histograms of
``nn_layer_activation_graph`` within 1e-5, fresh and from a checkpoint the
port's trainer wrote."""

import json
import os

import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.data import layouts
from hypelcnn_tpu_torch.utils.tiff_io import imread, imwrite
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SYN = "synthetic://?h=32&w=32&bands=8&classes=3"
SHADOW, BUILDING = 6, 7  # the building-shadow and building classes, 0-indexed


def test_remove_test_targets_writes_the_jax_shadow_map(tmp_path, capsys):
    from hypelcnn_tpu.utils.remove_test_targets_from_shadow import main as jax_main
    from hypelcnn_tpu_torch.utils.remove_test_targets_from_shadow import main
    outputs = []
    for run, name in ((jax_main, "jax"), (main, "port")):
        out = tmp_path / name
        out.mkdir()
        np.random.seed(0)
        run(["--loader_name=SyntheticDataLoader", f"--path={SYN}", f"--output_path={out}",
             *(["--device=cpu"] if name == "port" else [])])
        outputs.append((imread(str(out / "shadow_map.tif")), capsys.readouterr().out))
        assert (out / "shadow_map_before.png").exists() and (out / "shadow_map_after.png").exists()
    (want, want_out), (got, got_out) = outputs
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got_out == want_out and "Non-shadow validation samples:" in got_out


@pytest.mark.parametrize("pairing", ["random", "dummy"])
def test_shadow_ratio_statistics_are_the_jax_ones(tmp_path, monkeypatch, pairing):
    """The ratio's per-band mean and standard deviation within 1e-6 relative
    of the JAX tool's (numpy sums the float32 ratio in float32, the port in
    float64)."""
    from hypelcnn_tpu.utils import measure_targets_shadow_ratio as jax_tool
    from hypelcnn_tpu_torch.utils.measure_targets_shadow_ratio import main
    recorded = {}

    class RecordingNumpy:
        def __getattr__(self, name):
            return getattr(np, name)

        def mean(self, *args, **kwargs):
            recorded["mean"] = np.mean(*args, **kwargs)
            return recorded["mean"]

        def std(self, *args, **kwargs):
            recorded["std"] = np.std(*args, **kwargs)
            return recorded["std"]

    monkeypatch.setattr(jax_tool, "np", RecordingNumpy())
    args = ["--loader_name=SyntheticDataLoader", f"--path={SYN}",
            f"--pairing_method={pairing}", f"--output_path={tmp_path}"]
    np.random.seed(3)
    jax_tool.main(args)
    np.random.seed(3)
    mean, std = main([*args, "--device=cpu"])
    for got, want in ((mean, recorded["mean"]), (std, recorded["std"])):
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (8,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert any(f.endswith(".pdf") for f in os.listdir(tmp_path))


@pytest.fixture(scope="module")
def registration_root(tmp_path_factory):
    """GRSS2013 at 349 x 250 (band 8 enlarged 5 times) and the smallest
    GRSS2018 layout (CASI 1202 x 602; band 2 cropped and enlarged 2 times is
    1704 x 1054) in one directory."""
    root = str(tmp_path_factory.mktemp("registration"))
    layouts.write_grss2013(root, height=349, width=250, bands=9)
    layouts.write_grss2018(root, casi_height=1202, casi_width=602, bands=5, gt_width=8)
    return root


def test_lidar_matcher_finds_the_jax_corners(registration_root, tmp_path, capsys):
    from hypelcnn_tpu.utils.lidar_matcher import main as jax_main
    from hypelcnn_tpu_torch.utils.lidar_matcher import main
    jax_main([f"--path={registration_root}", f"--output_path={tmp_path}"])
    want = capsys.readouterr().out
    corners = main([f"--path={registration_root}", f"--output_path={tmp_path}", "--device=cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert f"Top Left {corners[0]}" in got and f"Bottom Right {corners[1]}" in got
    assert (tmp_path / "lidar_match.png").exists()


def _muufl_gt(height: int, width: int) -> np.ndarray:
    """A 1-indexed MUUFL GT (0 unlabelled) whose building-shadow regions
    include a ring around a hole with a shadow island in it, regions on the
    top and left edges, single pixels, a one-pixel-wide diagonal and a region
    walled in by buildings; none touches the last row or column, where the
    neighbour votes index past the image (as in the JAX package)."""
    rng = np.random.default_rng(21)
    others = np.array([0, 1, 2, 3, 4, 5, 8, 9, 10])
    gt = np.kron(others[rng.integers(0, others.size, (-(-height // 4), -(-width // 4)))],
                 np.ones((4, 4), dtype=int))[:height, :width]
    gt[6:9, 30:40] = BUILDING
    yy, xx = np.ogrid[:height, :width]
    ring = np.maximum(np.abs(yy - 15), np.abs(xx - 10))
    gt[(ring <= 5) & (ring >= 4)] = SHADOW
    gt[ring <= 3] = 2
    gt[ring <= 1] = SHADOW
    gt[0:3, 20:27] = SHADOW  # touches the top edge
    gt[25:31, 0:4] = SHADOW  # touches the left edge
    gt[35, 30] = gt[40, 10] = SHADOW
    for i in range(7):
        gt[28 + i, 16 + i] = SHADOW
    gt[38:45, 20:27] = BUILDING
    gt[40:43, 22:25] = SHADOW  # no neighbour but buildings
    labels = gt + 1
    labels[rng.random(labels.shape) < 0.05] = 0
    return labels.astype(np.uint8)


@pytest.fixture(scope="module")
def muufl_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("muufl")
    layouts.write_gulfport(str(root), height=48, width=44, bands=6)
    imwrite(str(root / "GULFPORT" / "muulf_gt.tif"), _muufl_gt(48, 44))
    return str(root)


def test_reveal_shadow_targets_writes_the_jax_tiffs(muufl_root, tmp_path, capsys):
    from hypelcnn_tpu.utils.reveal_shadow_targets import main as jax_main
    from hypelcnn_tpu_torch.utils.reveal_shadow_targets import main
    printed = {}
    for run, name in ((jax_main, "jax"), (main, "port")):
        out = tmp_path / name
        out.mkdir()
        np.random.seed(1)
        run(["--loader_name=GULFPORTDataLoader", f"--path={muufl_root}", f"--output_path={out}",
             *(["--device=cpu"] if name == "port" else [])])
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert "found contour with no proper neighbors" in printed["port"]
    assert printed["port"].count("shadow converted to neighboring target") >= 6
    files = {}
    for name in ("muulf_shadow_map.tif", "muulf_gt_shadow_corrected.tif",
                 "muulf_hsi_shadow_corrected.tif"):
        got, want = (imread(str(tmp_path / side / name)) for side in ("port", "jax"))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        files[name] = (got, want)
    for name in ("muulf_shadow_map.tif", "muulf_gt_shadow_corrected.tif"):
        np.testing.assert_array_equal(*files[name])
    np.testing.assert_allclose(*files["muulf_hsi_shadow_corrected.tif"], rtol=0, atol=1e-6)
    shadow = files["muulf_shadow_map.tif"][0]
    assert shadow[0].any() and shadow[:, 0].any() and not shadow[-1].any()
    assert (files["muulf_gt_shadow_corrected.tif"][0] != SHADOW + 1).sum() > \
        (shadow == 0).sum() - 60  # the shadow classes were reassigned


def test_reassign_shadow_contours_is_the_jax_one(muufl_root, capsys):
    from hypelcnn_tpu.utils.reveal_shadow_targets import reassign_shadow_contours as jax_reassign
    from hypelcnn_tpu_torch.utils.reveal_shadow_targets import (
        get_shadow_map,
        reassign_shadow_contours,
    )
    gt = _muufl_gt(48, 44).astype(np.int64) - 1
    target = np.where(gt < 0, 255, gt).astype(np.uint8)
    shadow = get_shadow_map(target)
    want = jax_reassign(shadow.copy(), target.copy())
    want_out = capsys.readouterr().out
    got = reassign_shadow_contours(shadow.copy(), target.copy())
    np.testing.assert_array_equal(got, want)
    assert capsys.readouterr().out == want_out


HYPEL = {"drop_out_ratio": 0.5, "learning_rate": 1e-3, "learning_rate_decay_factor": 0.96,
         "learning_rate_decay_step": 350, "filter_count": 32, "optimizer": "AdamOptimizer"}


def _jax_histograms(state_dict, data_shape, tmp_path):
    """The JAX tool's histograms from the port's weights, through the bridge."""
    from hypelcnn_tpu.utils.nn_layer_activation_graph import plot_activation_histograms
    from hypelcnn_tpu_torch.compat.flax_to_torch import flax_variables
    params, batch_stats = flax_variables(state_dict)
    variables = {"params": params, "batch_stats": batch_stats}
    return plot_activation_histograms("HYPELCNNModel", 4, data_shape, 2, str(tmp_path / "jax"),
                                      algorithm_params=HYPEL, variables=variables)


def _assert_histograms_close(got, want):
    assert sorted(got) == sorted(want) == ["classification", "spatial", "spectral_expansion",
                                           "spectral_reduction"]
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5, err_msg=name)


def test_activation_histograms_of_fresh_weights_are_the_jax_ones(tmp_path):
    from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
    from hypelcnn_tpu_torch.models.layers import init_parameters
    from hypelcnn_tpu_torch.utils.nn_layer_activation_graph import plot_activation_histograms
    data_shape = (3, 3, 9)
    got = plot_activation_histograms("HYPELCNNModel", 4, data_shape, 2, str(tmp_path / "port"),
                                     torch.device("cpu"), algorithm_params=HYPEL)
    module = HYPELCNNModel().create_module(4, {**HYPELCNNModel().default_params(), **HYPEL},
                                           list(data_shape))
    init_parameters(module, torch.Generator().manual_seed(0))
    _assert_histograms_close(got, _jax_histograms(module.state_dict(), data_shape, tmp_path))
    assert {f for f in os.listdir(tmp_path / "port")} == {
        f"activation_{name}.png" for name in got}


def test_activation_histograms_of_a_port_checkpoint_are_the_jax_ones(tmp_path, capsys):
    from hypelcnn_tpu_torch.apps.train_for_classification import main as train_main
    from hypelcnn_tpu_torch.train.checkpoint import restore_checkpoint
    from hypelcnn_tpu_torch.utils.nn_layer_activation_graph import main
    cfg = tmp_path / "alg.json"
    cfg.write_text(json.dumps(HYPEL))
    train_main(["--loader_name=SyntheticDataLoader",
                "--path=synthetic://?h=32&w=32&bands=8&classes=4", "--device=cpu",
                "--importer_name=GeneratorImporter", "--neighborhood=1", "--train_ratio=0.4",
                "--test_ratio=0.1", "--step=4", "--batch_size=8",
                f"--algorithm_param_path={cfg}", f"--base_log_path={tmp_path}",
                "--save_checkpoint_steps=4"])
    run_dir = next(tmp_path / d for d in os.listdir(tmp_path)
                   if (tmp_path / d / "checkpoints").is_dir())
    capsys.readouterr()
    got = main(["--model_name=HYPELCNNModel", "--neighborhood=1", "--class_count=4",
                "--bands=9", "--level_count=2", f"--algorithm_param_path={cfg}",
                f"--base_log_path={run_dir}", f"--output_path={tmp_path / 'act'}",
                "--device=cpu"])
    assert "Restored checkpoint at step 4" in capsys.readouterr().out
    state_dict = restore_checkpoint(str(run_dir))["state_dict"]
    _assert_histograms_close(got, _jax_histograms(state_dict, (3, 3, 9), tmp_path))


def test_activation_graph_refuses_an_empty_checkpoints_dir(tmp_path):
    from hypelcnn_tpu_torch.utils.nn_layer_activation_graph import main
    (tmp_path / "checkpoints").mkdir()
    with pytest.raises(FileNotFoundError, match="no restorable checkpoint"):
        main(["--model_name=HYPELCNNModel", "--neighborhood=1", "--class_count=4",
              "--bands=9", "--level_count=2", f"--base_log_path={tmp_path}",
              f"--output_path={tmp_path / 'act'}", "--device=cpu"])
