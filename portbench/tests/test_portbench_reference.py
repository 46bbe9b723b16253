"""The plain reference against the port, on the CPU at a tiny size."""

import importlib
import json

import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.core.registry import get_model_from_name
from hypelcnn_tpu_torch.core.rng import RngPool
from hypelcnn_tpu_torch.data.augmentation import AugmentationInfo, augment_batch
from hypelcnn_tpu_torch.data.scene import Scene
from hypelcnn_tpu_torch.ops.window_gather import gather_patches_torch
from hypelcnn_tpu_torch.train.trainer import make_epoch_index_stream
from portbench import scene as scene_lib
from portbench import weights as weights_lib
from portbench.reference import common
from portbench.tests import tiny

CONFIGS = {"hypelcnn480": 3, "dualcnn": 5}


def _model(config: str, classes=5, bands=9):
    cfg = json.loads((tiny.ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    params = {**cfg["params"], "filter_count": 32}
    k = 2 * cfg["neighborhood"] + 1
    module = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    return cfg, params, k, module.Model(params, classes, [k, k, bands])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_portbench_scene_equals_port_scene(config):
    cfg, _, k, _ = _model(config)
    arrays = scene_lib.make_scene({**cfg["scene"], **tiny.SCENE}, 5)
    port = Scene(arrays.casi.copy(), arrays.lidar.copy(), k // 2, True).device_scene("cpu")
    assert torch.equal(port, common.padded_scene(arrays.casi, arrays.lidar, k // 2, "cpu"))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_portbench_params_match_port_state_dict(config):
    cfg, params, k, model = _model(config)
    module = get_model_from_name(cfg["model"]).create_module(5, params, [k, k, 9])
    expected = {name: tuple(t.shape) for name, t in module.state_dict().items()}
    assert {p.name: p.shape for p in model.params()} == expected


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_portbench_eval_logits_match_port(config):
    cfg, params, k, model = _model(config)
    arrays = scene_lib.make_scene({**cfg["scene"], **tiny.SCENE}, 6)
    gen = torch.Generator().manual_seed(3)
    weights = weights_lib.make_weights(model, gen, "cpu")
    scene = common.padded_scene(arrays.casi, arrays.lidar, k // 2, "cpu")
    xy = torch.from_numpy(scene_lib.sample_pixels(20, 24, 96, 2))
    batch = common.windows(scene, xy, k)
    weights_lib.calibrate(model, weights, batch, gen)
    module = get_model_from_name(cfg["model"]).create_module(5, params, [k, k, 9])
    module.load_state_dict(weights)
    module.eval()
    with torch.no_grad():
        got = module(gather_patches_torch(scene, xy.to(torch.int32), k)).y_conv
        want, _ = model.forward(weights, batch, common.Norms("running"))
    scale = want.abs().max()
    assert torch.allclose(got, want, atol=1e-5 * scale, rtol=0)
    assert len(set(want.argmax(1).tolist())) > 1  # calibrated: not one class everywhere


def test_portbench_draws_match_port():
    seed = 2 ** 31 + 3
    pool = RngPool(seed)
    assert pool._generator_seed("augment", 7) == common.purpose_seed(seed, "augment", 7)
    stream = make_epoch_index_stream(50, 8, 20, pool.numpy_rng("epoch-shuffle"))
    assert np.array_equal(stream, common.epoch_rows(seed, 50, 8, 20))
    patches = torch.randn(16, 3, 3, 6)
    info = AugmentationInfo(perform_rotation_augmentation=True,
                            perform_reflection_augmentation=True,
                            perform_spectral_augmentation=0.05)
    port = augment_batch(patches, info, pool.generator("augment", 4, "cpu"))
    ref = common.augment(patches, {"rotation": True, "reflection": True, "spectral": 0.05},
                         common.generator(seed, "augment", 4, "cpu"))
    assert torch.equal(port, ref)


def test_portbench_adam_matches_torch():
    torch.manual_seed(0)
    p = torch.randn(30)
    q = p.clone().requires_grad_()
    opt = torch.optim.Adam([q], lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    ours = common.Adam([p])
    for _ in range(3):
        g = torch.randn(30)
        q.grad = g.clone()
        opt.step()
        ours.step([g], 3e-4)
    assert torch.allclose(p, q.detach(), atol=1e-7, rtol=0)


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_portbench_cell_runs_correct_on_cpu(workload):
    result = tiny.run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}
    assert list(result)[-1] == "checks"
