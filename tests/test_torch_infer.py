"""Full-scene inference and the infer CLI of the PyTorch port against the JAX
package, on the scene spec of ``tests/conftest.py`` with the same
weights. Class maps are compared exactly: the logits agree to float32
rounding (``test_torch_hypelcnn.py``) and no argmax sits that close to a tie
on this scene."""

import numpy as np
import pytest
import torch
from PIL import Image

from hypelcnn_tpu.data.loaders.base import SampleSet as JaxSampleSet
from hypelcnn_tpu.data.loaders.synthetic import SyntheticDataLoader as JaxSyntheticDataLoader
from hypelcnn_tpu.infer import scene_inference as jax_inference
from hypelcnn_tpu.utils.tiff_io import imwrite as jax_imwrite
from hypelcnn_tpu_torch.apps import infer_for_classification
from hypelcnn_tpu_torch.data.loaders.base import SampleSet
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.infer.scene_inference import (
    create_colored_image,
    create_target_image_via_samples,
    predict_full_scene,
    predict_targets,
)
from hypelcnn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from hypelcnn_tpu_torch.utils.tiff_io import imwrite, read_tags
from torch_parity import init_jax_hypelcnn, torch_module_from

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
CLASSES = 5
PARAMS = {"filter_count": 32}
NEIGHBORHOOD = 1
DATA_SHAPE = (3, 3, 13)


@pytest.fixture(scope="module")
def setup():
    jax_module, flax_params, batch_stats = init_jax_hypelcnn(CLASSES, PARAMS, DATA_SHAPE, seed=4)
    module = torch_module_from(flax_params, batch_stats, CLASSES, PARAMS, DATA_SHAPE)
    variables = {"params": flax_params, "batch_stats": batch_stats}
    jax_scene = JaxSyntheticDataLoader(SPEC).load_data(NEIGHBORHOOD, True)
    scene = SyntheticDataLoader(SPEC).load_data(NEIGHBORHOOD, True)
    return jax_module, variables, jax_scene, module, scene


@pytest.mark.parametrize("batch_rows", [16, 20, 50])
def test_full_scene_class_map_matches_jax(setup, batch_rows):
    # 20 leaves a last band that is moved up; 50 is taller than the scene
    jax_module, variables, jax_scene, module, scene = setup
    expected = jax_inference.predict_full_scene(jax_module, variables, jax_scene,
                                                batch_rows=batch_rows)
    got = predict_full_scene(module, scene, batch_rows=batch_rows, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (48, 64)
    assert len(np.unique(got)) > 1
    np.testing.assert_array_equal(got, expected)


def test_predict_targets_matches_jax(setup):
    jax_module, variables, jax_scene, module, scene = setup
    rng = np.random.default_rng(0)
    targets = np.stack([rng.integers(0, 64, 300), rng.integers(0, 48, 300),
                        rng.integers(0, CLASSES, 300)], axis=1).astype(np.int32)
    expected = jax_inference.predict_targets(jax_module, variables, jax_scene, targets,
                                             batch_size=128)
    got = predict_targets(module, scene, targets, device="cpu", batch_size=128)
    np.testing.assert_array_equal(got, expected)


def test_infer_cli_writes_the_tiffs(setup, tmp_path):
    jax_module, variables, jax_scene, module, _ = setup
    save_checkpoint(str(tmp_path / "log"), 7, module.state_dict())
    infer_for_classification.main([
        "--loader_name=SyntheticDataLoader", f"--path={SPEC}",
        f"--neighborhood={NEIGHBORHOOD}", "--algorithm_param_path",
        str(_write_params(tmp_path)), f"--base_log_path={tmp_path / 'log'}",
        f"--output_path={tmp_path / 'out'}", "--domain=all", "--device=cpu"])

    expected = jax_inference.predict_full_scene(jax_module, variables, jax_scene)
    colors = JaxSyntheticDataLoader(SPEC).get_samples_color_list()
    jax_colored = jax_inference.create_colored_image(expected, colors)
    jax_imwrite(str(tmp_path / "jax_raw.tif"), expected)
    jax_imwrite(str(tmp_path / "jax_colorized.tif"), jax_colored)
    for ours, theirs, shape in (("result_raw.tif", "jax_raw.tif", (48, 64)),
                                ("result_colorized.tif", "jax_colorized.tif", (48, 64, 3))):
        with Image.open(tmp_path / "out" / ours) as a, Image.open(tmp_path / theirs) as b:
            assert a.mode == b.mode
            got = np.asarray(a)
            assert got.shape == shape
            np.testing.assert_array_equal(got, np.asarray(b))
        assert read_tags(str(tmp_path / "out" / ours))[279] == int(np.prod(shape))


def _write_params(tmp_path):
    path = tmp_path / "params.json"
    path.write_text('{"filter_count": 32}')
    return path


def test_infer_cli_refuses_unported_domains_and_missing_checkpoints(tmp_path):
    base = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu",
            f"--base_log_path={tmp_path}", f"--output_path={tmp_path}"]
    for domain in ("sample", "gt"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            infer_for_classification.main(base + [f"--domain={domain}"])
    with pytest.raises(IOError, match="No checkpoint"):
        infer_for_classification.main(base + ["--domain=all"])


def test_checkpoint_restores_the_latest_step(tmp_path):
    assert restore_checkpoint(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 3, {"w": torch.zeros(2)})
    save_checkpoint(str(tmp_path), 12, {"w": torch.ones(2)})
    restored = restore_checkpoint(str(tmp_path))
    assert restored["step"] == 12
    assert torch.equal(restored["state_dict"]["w"], torch.ones(2))
    assert (tmp_path / "checkpoints" / "12" / "state.pt").is_file()


def test_image_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    class_map = rng.integers(0, CLASSES, (6, 9)).astype(np.uint8)
    colors = SyntheticDataLoader(SPEC).get_samples_color_list()
    np.testing.assert_array_equal(create_colored_image(class_map, colors),
                                  jax_inference.create_colored_image(class_map, colors))
    rows = [rng.integers(0, 5, (n, 3)) for n in (4, 3, 2)]
    np.testing.assert_array_equal(
        create_target_image_via_samples(SampleSet(*rows), (6, 9)),
        jax_inference.create_target_image_via_samples(JaxSampleSet(*rows), (6, 9)))
    imwrite(str(tmp_path / "m.npy"), class_map)
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"), class_map)
    with pytest.raises(ValueError):
        imwrite(str(tmp_path / "f.tif"), class_map.astype(np.float32))
