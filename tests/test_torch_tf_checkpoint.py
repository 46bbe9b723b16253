"""TF checkpoint import in the port against TensorFlow and the JAX package on
the CPU.

``tf.compat.v1.train.Saver`` writes V2 checkpoints here, under the
reference's scopes, with names made from flax-shaped templates through the
JAX importer's ``_LIN_LEAF``/``_BN_LEAF``: float32 and float64 weights, an
int32 and the int64 ``global_step``, a scalar, an empty tensor and Adam
slots. The numpy bundle reader equals ``tf.train.load_checkpoint`` bit for
bit; ``import_gan_generator_params`` (seven families) and
``import_classifier_variables`` (HYPELCNN unfused and fused, CONCNN, CAP)
give exactly the JAX importer's trees, and the port's ``state_dict`` imports
equal those trees through the weight bridge; logits agree with the JAX
module's to ``rtol=1e-5, atol=1e-6``; ``build_shadow_creators`` imports a
``model.ckpt-N`` and its shadowed batch equals JAX's to ``rtol=1e-5,
atol=1e-6`` at 12 bands, and to ``atol=1e-5`` at the fixture's 144, whose
144-tap convolutions the two frameworks sum in other orders (4.1e-6 measured
on this CPU).

``write_cycle_gan_fixture`` wrote ``tests/torch_fixtures/tf_cycle_gan_144``
once (TF 2.21): both cycle_gan generators at 144 bands with random weights
(normal, std 0.05, from ``FIXTURE_SEED``), both discriminators, every
variable's Adam slots and ``global_step`` 5000. The card has no TF, so that
fixture is what its smoke run imports.
"""

import os
import pathlib
import shutil
import struct

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hypelcnn_tpu.core.registry import get_model_from_name as jax_get_model  # noqa: E402
from hypelcnn_tpu.data.loaders.grss2013 import GRSS2013DataLoader as JaxGRSS2013  # noqa: E402
from hypelcnn_tpu.data.loaders.synthetic import SyntheticDataLoader as JaxSynthetic  # noqa: E402
from hypelcnn_tpu.gan import shadow_ops as jax_shadow_ops  # noqa: E402
from hypelcnn_tpu.utils import tf_checkpoint_import as jax_import  # noqa: E402
from hypelcnn_tpu_torch.compat.flax_to_torch import (  # noqa: E402
    flax_variables,
    variables_to_state_dict,
)
from hypelcnn_tpu_torch.core.registry import get_model_from_name  # noqa: E402
from hypelcnn_tpu_torch.data import layouts  # noqa: E402
from hypelcnn_tpu_torch.data.loaders.grss2013 import GRSS2013DataLoader  # noqa: E402
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader  # noqa: E402
from hypelcnn_tpu_torch.gan import shadow_ops  # noqa: E402
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict  # noqa: E402
from hypelcnn_tpu_torch.models.layers import init_parameters  # noqa: E402
from hypelcnn_tpu_torch.utils import tf_bundle, tf_checkpoint_import  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread)

FIXTURE = pathlib.Path(__file__).resolve().parent / "torch_fixtures" / "tf_cycle_gan_144"
FIXTURE_SEED = 20130144
FAMILIES = ["cycle_gan", "gan_x2y", "gan_y2x", "cut_x2y", "cut_y2x", "dcl_gan", "dcl_cycle_gan"]
CLASSES, CHANNELS = 5, 13


def _tf_names(tree, scope):
    """(TF name, flax path) of every leaf of a flax-shaped tree, as the
    reference names its variables (the inverse of the importer's walk)."""
    for key, sub in tree.items():
        if key in ("Conv_0", "Dense_0"):
            for leaf in sub:
                yield f"{scope}/{jax_import._LIN_LEAF[leaf]}", (key, leaf)
        elif key == "BatchNorm_0":
            for leaf in sub:
                yield f"{scope}/BatchNorm/{jax_import._BN_LEAF[leaf]}", (key, leaf)
        elif isinstance(sub, dict):
            for name, path in _tf_names(sub, f"{scope}/{key}"):
                yield name, (key,) + path
        else:
            yield f"{scope}/{jax_import._LIN_LEAF.get(key, key)}", (key,)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _random_like(rng, name, like, std=0.1):
    if name.endswith("moving_variance"):
        return rng.uniform(0.5, 2.0, like.shape).astype(np.float32)
    return rng.normal(0.0, std, like.shape).astype(np.float32)


def _with_adam_and_step(values, rng, step):
    out = dict(values)
    for name, value in values.items():
        out[f"{name}/Adam"] = rng.normal(0, 1e-3, value.shape).astype(np.float32)
        out[f"{name}/Adam_1"] = rng.uniform(0, 1e-6, value.shape).astype(np.float32)
    out["global_step"] = np.asarray(step, dtype=np.int64)
    return out


def write_tf_checkpoint(directory, values, step) -> str:
    """``values`` (TF name -> array) saved by ``tf.compat.v1.train.Saver`` as
    ``directory/model.ckpt-<step>``, with a relative ``checkpoint`` state file."""
    os.makedirs(directory, exist_ok=True)
    graph = tf.Graph()
    with graph.as_default():
        variables = [tf.compat.v1.Variable(value, name=name) for name, value in values.items()]
        assert [v.op.name for v in variables] == list(values)
        saver = tf.compat.v1.train.Saver(variables, save_relative_paths=True)
        with tf.compat.v1.Session(graph=graph) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            return saver.save(sess, os.path.join(str(directory), "model.ckpt"),
                              global_step=step, write_meta_graph=False)


def _gan_template(family, bands, seed=0):
    nets = get_trainer_dict({"patches": 3}, bands, 10)[family].build_nets()
    init_parameters(nets, torch.Generator().manual_seed(seed))
    return nets, flax_variables(nets.state_dict())[0]


def _generator_values(family, template, rng, std=0.1):
    values = {}
    for path, scope in jax_import.GAN_GENERATOR_SCOPES[family].items():
        subtree = _leaf(template, path)
        for name, leaf_path in _tf_names(subtree, scope):
            values[name] = _random_like(rng, name, _leaf(subtree, leaf_path), std)
    return values


def cycle_gan_fixture_values(seed=FIXTURE_SEED, bands=144):
    """The fixture's variables: generators and discriminators drawn from
    ``seed`` (std 0.05), Adam slots, ``global_step``."""
    rng = np.random.default_rng(seed)
    _, template = _gan_template("cycle_gan", bands)
    values = _generator_values("cycle_gan", template, rng, std=0.05)
    for net, scope in (("disc_x2y", "Model/ModelX2Y/Discriminator"),
                       ("disc_y2x", "Model/ModelY2X/Discriminator")):
        for name, path in _tf_names(template[net], scope):
            values[name] = _random_like(rng, name, _leaf(template[net], path), 0.05)
    return _with_adam_and_step(values, rng, 5000)


def write_cycle_gan_fixture(directory=FIXTURE) -> str:
    return write_tf_checkpoint(directory, cycle_gan_fixture_values(), 5000)


def _assert_bundle_equals_tf(prefix):
    ours = tf_bundle.load_checkpoint(prefix)
    theirs = tf.train.load_checkpoint(prefix)
    shapes = theirs.get_variable_to_shape_map()
    assert ours.variable_to_shape_map() == {k: tuple(v) for k, v in shapes.items()}
    for name in shapes:
        a, b = ours.get_tensor(name), theirs.get_tensor(name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    return ours


def test_bundle_reader_equals_tf_on_every_dtype(tmp_path):
    rng = np.random.default_rng(0)
    values = {"Model/w": rng.normal(size=(3, 4, 5)).astype(np.float32),
              "Model/w64": rng.normal(size=(7,)),
              "Model/count": np.asarray([3, -2, 2 ** 31 - 1], np.int32),
              "Model/scalar": np.float32(2.5),
              "Model/empty": np.zeros((0, 3), np.float32),
              "Model/flag": np.asarray([True, False])}
    prefix = write_tf_checkpoint(tmp_path, _with_adam_and_step(values, rng, 77), 77)
    assert prefix == str(tmp_path / "model.ckpt-77")
    ours = _assert_bundle_equals_tf(prefix)
    assert ours.get_tensor("global_step").dtype == np.int64
    assert int(ours.get_tensor("global_step")) == 77
    assert ours.header.num_shards == 1 and len(ours.entries) == 19
    # the directory form, through its state file, as tf.train.latest_checkpoint
    assert tf_bundle.latest_checkpoint(str(tmp_path)) == tf.train.latest_checkpoint(str(tmp_path))
    assert tf_checkpoint_import.load_tf_checkpoint_values(str(tmp_path)).keys() == \
        jax_import.load_tf_checkpoint_values(str(tmp_path)).keys()


def test_bundle_reader_refuses_corruption_and_compression(tmp_path):
    prefix = write_tf_checkpoint(tmp_path, {"a": np.arange(6, dtype=np.float32)}, 1)
    index = pathlib.Path(prefix + ".index").read_bytes()
    reader = tf_bundle.load_checkpoint(prefix)
    data_path = pathlib.Path(prefix + ".data-00000-of-00001")
    data = bytearray(data_path.read_bytes())
    data[reader.entries["a"].offset] ^= 1
    data_path.write_bytes(bytes(data))
    with pytest.raises(tf_bundle.BundleError, match="a: checksum"):
        tf_bundle.load_checkpoint(prefix).get_tensor("a")
    _, handle = tf_bundle.read_footer(index)
    offset, size = handle
    kind = offset + size
    patched = bytearray(index)
    patched[kind] = 1  # snappy, with the trailer's checksum made to match
    patched[kind + 1:kind + 5] = struct.pack(
        "<I", tf_bundle.masked_crc32c(bytes(patched[offset:kind + 1])))
    with pytest.raises(tf_bundle.BundleError, match="snappy-compressed"):
        next(tf_bundle.table_entries(bytes(patched)))
    patched[-1] ^= 0xFF
    with pytest.raises(tf_bundle.BundleError, match="magic"):
        tf_bundle.read_footer(bytes(patched))
    with pytest.raises(FileNotFoundError):
        tf_bundle.load_checkpoint(str(tmp_path / "nowhere"))


@pytest.mark.parametrize("family", FAMILIES)
def test_gan_generator_import_matches_jax(tmp_path, family):
    nets, template = _gan_template(family, 16)
    rng = np.random.default_rng(FAMILIES.index(family))
    values = _generator_values(family, template, rng)
    prefix = write_tf_checkpoint(tmp_path, _with_adam_and_step(values, rng, 10), 10)
    theirs = jax_import.import_gan_generator_params(family, template, prefix)
    ours = tf_checkpoint_import.import_gan_generator_params(family, template, prefix)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    before = nets.state_dict()
    state = tf_checkpoint_import.import_gan_generator_state_dict(family, nets, prefix)
    expected = variables_to_state_dict(theirs)
    assert state.keys() == expected.keys() == before.keys()
    generators = {k for k in state if any(k.startswith(".".join(path) + ".")
                                          for path in jax_import.GAN_GENERATOR_SCOPES[family])}
    assert generators and all(torch.equal(state[k], expected[k]) for k in state)
    assert all(torch.equal(state[k], before[k]) == (k not in generators) for k in state)


def _classifier(model_name, params, patch, fused=False):
    model = get_model_from_name(model_name)
    full = {**model.default_params(), **params, "fuse_level_convs": fused}
    module = model.create_module(CLASSES, full, (patch, patch, CHANNELS))
    init_parameters(module, torch.Generator().manual_seed(1))
    return module, full


@pytest.mark.parametrize("model_name, params, patch, fused", [
    ("HYPELCNNModel", {"filter_count": 32}, 3, False),
    ("HYPELCNNModel", {"filter_count": 32}, 5, True),
    ("CONCNNModel", {"filter_count": 16}, 5, False),
    ("CAPModel", {"feature_count": 16, "primary_capsule_count": 4}, 3, False),
], ids=["hypelcnn", "hypelcnn_fused", "concnn", "cap"])
def test_classifier_import_matches_jax(tmp_path, model_name, params, patch, fused):
    """The checkpoint holds the reference's branch layout (written from the
    unfused module's names); a fused template concatenates its BatchNorms."""
    branch_module, _ = _classifier(model_name, params, patch)
    branch_params, branch_stats = flax_variables(branch_module.state_dict())
    rng = np.random.default_rng(3)
    values = {}
    for tree in (branch_params, branch_stats):
        if "digitcaps_w" in tree:
            tree = {k: v for k, v in tree.items() if not k.startswith("digitcaps_")}
            for i, (w, b) in enumerate(zip(branch_params["digitcaps_w"],
                                           branch_params["digitcaps_b"])):
                name = f"nn_core/DigitCaps_layer/DigitCaps_layer_w_{i}"
                values[f"{name}/weights"] = rng.normal(0, 0.1, (1, 1) + w.shape).astype(np.float32)
                values[f"{name}/biases"] = rng.normal(0, 0.1, b.shape).astype(np.float32)
        for name, path in _tf_names(tree, "nn_core"):
            values[name] = _random_like(rng, name, _leaf(tree, path))
    prefix = write_tf_checkpoint(tmp_path, _with_adam_and_step(values, rng, 3), 3)

    module, full = _classifier(model_name, params, patch, fused)
    template_params, template_stats = flax_variables(module.state_dict())
    variables = {"params": template_params, "batch_stats": template_stats}
    theirs = jax_import.import_classifier_variables(variables, prefix)
    ours = tf_checkpoint_import.import_classifier_variables(variables, prefix)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert np.array_equal(a, b)
    state = tf_checkpoint_import.import_classifier_state_dict(module, prefix)
    expected = variables_to_state_dict(theirs["params"], theirs["batch_stats"])
    assert state.keys() == expected.keys()
    assert all(torch.equal(state[k], expected[k]) for k in state)

    module.load_state_dict(state, strict=True)
    x = np.random.default_rng(4).uniform(0, 1, (12, patch, patch, CHANNELS)).astype(np.float32)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x)).y_conv.numpy()
    jax_module = jax_get_model(model_name).create_module(CLASSES, full)
    expected_logits = np.asarray(jax.jit(
        lambda v, x: jax_module.apply(v, x, train=False).y_conv)(
        {"params": theirs["params"], "batch_stats": theirs["batch_stats"]}, jnp.asarray(x)))
    np.testing.assert_allclose(got, expected_logits, rtol=1e-5, atol=1e-6)


def test_shadow_creators_import_a_tf_checkpoint_as_jax_does(tmp_path):
    """A cycle_gan ``model.ckpt-N`` at the synthetic loader's declared path:
    the port and the JAX package shadow a batch alike."""
    bands = 12
    _, template = _gan_template("cycle_gan", bands)
    rng = np.random.default_rng(5)
    values = _with_adam_and_step(_generator_values("cycle_gan", template, rng, 0.05), rng, 9)
    base = tmp_path / "models"
    write_tf_checkpoint(base / "shadow_gen_model" / "cycle_gan", values, 9)
    spec = f"synthetic://?h=24&w=32&bands={bands}&classes=4&seed=3&base={base}"
    ours = shadow_ops.build_shadow_creators(SyntheticDataLoader(spec),
                                            SyntheticDataLoader(spec).load_data(1, True), 1, "cpu")
    jax_loader = JaxSynthetic(spec)
    theirs = jax_shadow_ops.build_shadow_creators(jax_loader, jax_loader.load_data(1, True), 1)
    assert sorted(ours) == sorted(theirs) == ["cycle_gan", "simple"]
    x = np.random.default_rng(6).uniform(0.05, 1.0, (16, 3, 3, bands + 1)).astype(np.float32)
    for name in ("shadow_fn", "deshadow_fn"):
        expected = np.asarray(jax.vmap(getattr(theirs["cycle_gan"], name))(jnp.asarray(x)))
        got = getattr(ours["cycle_gan"], name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)
        assert not np.allclose(got[..., :bands], x[..., :bands])


def test_committed_fixture_reads_as_tf_reads_it_and_is_its_writers(tmp_path):
    assert sorted(os.listdir(FIXTURE)) == ["checkpoint", "model.ckpt-5000.data-00000-of-00001",
                                           "model.ckpt-5000.index"]
    assert sum(p.stat().st_size for p in FIXTURE.iterdir()) < 1_600_000
    reader = _assert_bundle_equals_tf(str(FIXTURE / "model.ckpt-5000"))
    assert tf_bundle.latest_checkpoint(str(FIXTURE)) == str(FIXTURE / "model.ckpt-5000")
    expected = cycle_gan_fixture_values()
    assert sorted(reader.entries) == sorted(expected)
    for name, value in expected.items():
        assert np.array_equal(reader.get_tensor(name), value), name


def test_committed_fixture_shadows_a_grss2013_layout_as_jax_does(tmp_path):
    """The fixture at GRSS2013's declared ``model.ckpt-5000``, on a small
    layout at its 144 bands, through both packages' shadow creators."""
    layouts.write_grss2013(str(tmp_path), height=12, width=20)
    target = tmp_path / "2013_DFTC" / "shadow_gen_model" / "cycle_gan"
    shutil.copytree(FIXTURE, target)
    loader = GRSS2013DataLoader(str(tmp_path))
    ours = shadow_ops.build_shadow_creators(loader, loader.load_data(1, True), 1, "cpu")
    jax_loader = JaxGRSS2013(str(tmp_path))
    theirs = jax_shadow_ops.build_shadow_creators(jax_loader, jax_loader.load_data(1, True), 1)
    assert sorted(ours) == sorted(theirs) == ["cycle_gan", "simple"]
    x = np.random.default_rng(7).uniform(0.05, 1.0, (8, 3, 3, 145)).astype(np.float32)
    expected = np.asarray(jax.vmap(theirs["cycle_gan"].shadow_fn)(jnp.asarray(x)))
    np.testing.assert_allclose(ours["cycle_gan"].shadow_fn(torch.from_numpy(x)).numpy(),
                               expected, rtol=1e-5, atol=1e-5)
