"""The port's GAN networks, losses, TF Adam and pool against the JAX package
on the CPU, with the same weights (through the weight bridge), inputs and
random draws.

Tolerances: forwards to ``rtol=1e-5, atol=1e-6`` and gradients to 1e-5 of
the module's largest gradient (float32, sums in other orders: a bias's
gradient sums terms as large as the kernels'); the NCE
backward to ``rtol=1e-5``; five TF Adam
updates to 1e-6 of the larger of each tensor's largest magnitude and 1; the
pool exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypelcnn_tpu.gan import losses as jax_losses
from hypelcnn_tpu.gan import models as jax_models
from hypelcnn_tpu.gan.wrappers.base import PoolState, gan_adam, pool_apply
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.gan import losses, models
from hypelcnn_tpu_torch.gan.wrappers.base import GanAdam, Pool, gan_lr_schedule
from hypelcnn_tpu_torch.models.layers import init_parameters
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _random_params(params, seed=0):
    """Every leaf drawn at random (the generator starts at zero, which would
    test nothing)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.1, np.shape(a)).astype(np.float32), _numpy(params))


def _pixels(bands, n=6, seed=1, k=1):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, k, k, bands)).astype(np.float32)


def _close(ours, theirs, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=rtol, atol=atol,
                               err_msg=msg)


def _close_to_max(ours, theirs, tol=1e-5, msg="", scale=None):
    """Within ``tol`` of ``scale`` (the tensor's largest magnitude unless
    given): gradients sum many terms, so an entry near zero carries the
    others' rounding."""
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    scale = max(float(np.abs(theirs).max()), 1e-30) if scale is None else scale
    assert float(np.abs(ours - theirs).max()) <= tol * scale, msg


# (name, JAX module, port module, call arguments) at bands 16 (every
# generator kernel even: 16, 8, 4, 2) and 24 (24, 12, 6, 3: one odd)
def _cases(bands):
    return [
        ("generator", jax_models.ShadowGenerator(band_size=bands),
         models.ShadowGenerator(bands), {}),
        ("generator_encoder", jax_models.ShadowGenerator(band_size=bands),
         models.ShadowGenerator(bands), {"encoder_only": True}),
        ("generator_toeplitz", jax_models.ShadowGenerator(band_size=bands, impl="toeplitz"),
         models.ShadowGenerator(bands, "toeplitz"), {}),
        ("generator_simple", jax_models.ShadowGeneratorSimple(band_size=bands),
         models.ShadowGeneratorSimple(bands), {}),
        ("discriminator", jax_models.ShadowDiscriminator(band_size=bands),
         models.ShadowDiscriminator(bands), {"second": True}),
        ("discriminator_simple", jax_models.ShadowDiscriminatorSimple(band_size=bands),
         models.ShadowDiscriminatorSimple(bands), {"second": True}),
        ("feature_discriminator",
         jax_models.ShadowFeatureDiscriminator(band_size=bands, patch_count=3,
                                               embedded_feature_size=2),
         models.ShadowFeatureDiscriminator(bands, 3, 2), {}),
    ]


CASES = [(bands, i) for bands in (16, 24) for i in range(len(_cases(16)))]


@pytest.mark.parametrize("bands, index", CASES,
                         ids=[f"{_cases(16)[i][0]}-{b}" for b, i in CASES])
def test_forward_and_gradients_match_jax(bands, index):
    name, jax_module, module, kwargs = _cases(bands)[index]
    x = _pixels(bands)
    second = _pixels(bands, seed=2) if kwargs.get("second") else None
    args = (jnp.asarray(x),) + ((jnp.asarray(second),) if second is not None else ())
    encoder_only = kwargs.get("encoder_only", False)
    call = {"encoder_only": True} if encoder_only else {}
    params = _random_params(jax_module.init(jax.random.key(0), *args)["params"])
    weights = np.random.default_rng(3).normal(size=np.shape(jax_module.apply(
        {"params": params}, *args, **call))).astype(np.float32)

    def jax_objective(p):
        return jnp.sum(jax_module.apply({"params": p}, *args, **call) * weights)

    jax_out = jax_module.apply({"params": params}, *args, **call)
    jax_value, jax_grads = jax.value_and_grad(jax_objective)(params)

    module.load_state_dict(variables_to_state_dict(params), strict=True)
    torch_args = [torch.from_numpy(x)] + ([torch.from_numpy(second)] if second is not None else [])
    out = module(*torch_args, **call)
    _close(out.detach(), jax_out, msg=name)
    value = torch.sum(out * torch.from_numpy(weights))
    value.backward()
    _close(value.detach(), jax_value, msg=name)
    expected = variables_to_state_dict(_numpy(jax_grads))
    scale = max(float(g.abs().max()) for g in expected.values())
    for key, param in module.named_parameters():
        grad = torch.zeros_like(param) if param.grad is None else param.grad  # unused layers
        _close_to_max(grad, expected[key], msg=f"{name} {key}", scale=scale)


@pytest.mark.parametrize("bands", [16, 24])
def test_generator_padding_matches_flax(bands):
    """SAME padding: (k - 1) // 2 low and k // 2 high, for even and odd k."""
    for k in (bands, bands // 2, bands // 4, bands // 8):
        conv = models.SameConv1d(k, bands)
        assert conv.pad == ((k - 1) // 2, k // 2)
    # a one-hot kernel tap picks the shifted input, as flax's conv does
    jax_module = jax_models.ShadowGeneratorSimple(band_size=bands)
    x = _pixels(bands)
    params = _numpy(jax_module.init(jax.random.key(0), jnp.asarray(x))["params"])
    for tap in (0, bands // 2 - 1, bands // 2, bands - 1):
        kernel = np.zeros((bands, 1, 1), np.float32)
        kernel[tap] = 1.0
        p = {"conv": {"kernel": kernel, "bias": np.zeros(1, np.float32)}}
        module = models.ShadowGeneratorSimple(bands)
        module.load_state_dict(variables_to_state_dict(p), strict=True)
        np.testing.assert_array_equal(module(torch.from_numpy(x)).detach().numpy(),
                                      np.asarray(jax_module.apply({"params": p}, jnp.asarray(x))))


def test_zero_init_generator_and_leaky_relu_subgradient():
    """The generator starts at zero (output 0, encoder 5 x); tf_leaky_relu's
    gradient at exactly 0 is alpha, as JAX's ``tf_leaky_relu``'s is."""
    bands = 16
    module = models.ShadowGenerator(bands)
    init_parameters(module, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_pixels(bands))
    assert torch.equal(module(x), torch.zeros_like(x))
    torch.testing.assert_close(module(x, encoder_only=True), 5 * x, rtol=1e-6, atol=0)
    v = torch.zeros(3, requires_grad=True)
    models.tf_leaky_relu(v, 0.1).sum().backward()
    expected = jax.grad(lambda a: jnp.sum(jax_models.tf_leaky_relu(a, 0.1)))(jnp.zeros(3))
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(expected))
    assert float(v.grad[0]) == pytest.approx(0.1)


def test_discriminator_init_draws_he_truncated():
    """Dense kernels: truncated normal, fan-in, scale 2, within two standard
    deviations; biases zero."""
    module = models.ShadowDiscriminator(144)
    init_parameters(module, torch.Generator().manual_seed(0))
    std = np.sqrt(2.0 / 144) / 0.87962566103423978
    w = module.fc1.weight.detach().numpy()
    assert abs(w.std() - np.sqrt(2.0 / 144)) < 0.05 * np.sqrt(2.0 / 144)
    assert np.abs(w).max() <= 2 * std
    assert not module.fc1.bias.detach().any()


def test_tf_softmax_ce_backward_matches_jax_custom_vjp():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 9)).astype(np.float32)
    labels = np.tile(np.eye(3, dtype=np.float32).reshape(1, 9), (4, 1))
    g = rng.normal(size=(4,)).astype(np.float32)
    expected_value, vjp = jax.vjp(jax_losses._tf_softmax_ce, jnp.asarray(logits),
                                  jnp.asarray(labels))
    expected_grad, _ = vjp(jnp.asarray(g))
    t_logits = torch.from_numpy(logits).requires_grad_()
    value = losses.TFSoftmaxCrossEntropy.apply(t_logits, torch.from_numpy(labels))
    value.backward(torch.from_numpy(g))
    _close(value.detach(), expected_value)
    _close(t_logits.grad, expected_grad)
    # not the autograd derivative of the value: the labels sum to 3
    t2 = torch.from_numpy(logits).requires_grad_()
    (-(torch.from_numpy(labels) * torch.log_softmax(t2, -1)).sum(-1)).backward(
        torch.from_numpy(g))
    assert float((t2.grad - t_logits.grad).abs().max()) > 0.1


def test_nce_loss_matches_jax_and_tf_golden_values():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 6, 3)).astype(np.float32)
    k = rng.normal(size=(4, 6, 3)).astype(np.float32)
    value, grads = jax.value_and_grad(lambda a, b: jax_losses.nce_loss(a, b, 0.07),
                                      argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = (torch.from_numpy(a).requires_grad_() for a in (q, k))
    ours = losses.nce_loss(tq, tk, 0.07)
    ours.backward()
    _close(ours.detach(), value)
    _close_to_max(tq.grad, grads[0])
    _close_to_max(tk.grad, grads[1])


def test_l2_regularization_skips_biases_and_fc3():
    bands = 16
    jax_module = jax_models.ShadowDiscriminator(band_size=bands)
    params = _random_params(jax_module.init(jax.random.key(0), jnp.zeros((2, 1, 1, bands)))
                            ["params"])
    module = models.ShadowDiscriminator(bands)
    module.load_state_dict(variables_to_state_dict(params), strict=True)
    for exclude in ((), ("fc3",)):
        expected = jax_losses.l2_regularization(params, 1e-5, exclude=exclude)
        _close(losses.l2_regularization([module], 1e-5, exclude=exclude).detach(), expected)
    expected = 0.5 * 1e-5 * sum(float(np.sum(params[n]["kernel"] ** 2)) for n in ("fc1", "fc2"))
    assert float(losses.l2_regularization([module], 1e-5, exclude=("fc3",))) == \
        pytest.approx(expected, rel=1e-5)


@pytest.mark.parametrize("t_stride, t_phase", [(1, 1), (2, 1), (2, 2)])
def test_gan_adam_matches_jax(t_stride, t_phase):
    """Five updates from zero moments, the schedule decaying from update 4
    on (6 steps), eps on the uncorrected sqrt(v), bias correction at
    t = stride k + phase."""
    rng = np.random.default_rng(t_stride * 10 + t_phase)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 10.0 ** rng.integers(-4, 1), v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    tx = gan_adam(2e-4, 6, t_stride=t_stride, t_phase=t_phase)
    jax_params = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jax_params)
    ours = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    adam = GanAdam(2e-4, 6, t_stride=t_stride, t_phase=t_phase)
    state = adam.init(ours)
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state)
        jax_params = jax.tree_util.tree_map(lambda p, u: p + u, jax_params, updates)
        adam.apply(ours, [torch.from_numpy(g[k]) for k in ("a", "b")], state)
        for mine, key in zip(ours, ("a", "b")):
            theirs = np.asarray(jax_params[key])
            scale = max(1.0, float(np.abs(theirs).max()))
            assert float(np.abs(mine.numpy() - theirs).max()) <= 1e-6 * scale
    assert state.count == int(opt_state.count) == 5
    schedule = gan_lr_schedule(2e-4, 6)
    assert [float(schedule(c)) for c in range(7)] == pytest.approx(
        [2e-4, 2e-4, 2e-4, 2e-4, 2e-4 * 2 / 3, 2e-4 / 3, 0.0])


def _jax_pool_draws(key, pool_size, batch):
    k1, k2 = jax.random.split(key)
    slots = np.asarray(jax.random.choice(k1, pool_size, (batch,), replace=False))
    swap = np.asarray(jax.random.bernoulli(k2, 0.5, (batch,)))
    return torch.from_numpy(slots), torch.from_numpy(swap)


def test_pool_matches_jax_with_injected_draws():
    """Fill (appending, passing through), the step that fills it, then
    swaps with slots drawn without replacement; buffers and outputs exact."""
    bands, batch, size = 4, 32, 50
    jax_pool = PoolState.create(size, (1, 1, bands))
    pool = Pool.create(size, (1, 1, bands), "cpu")
    rng = np.random.default_rng(0)
    for step in range(5):
        data = rng.normal(size=(batch, 1, 1, bands)).astype(np.float32)
        inputs = rng.normal(size=(batch, 1, 1, bands)).astype(np.float32)
        key = jax.random.key(step)
        jax_pool, out, out_inputs = pool_apply(jax_pool, jnp.asarray(data), jnp.asarray(inputs),
                                               key)
        got, got_inputs = pool.apply(torch.from_numpy(data), torch.from_numpy(inputs),
                                     draws=_jax_pool_draws(key, size, batch))
        np.testing.assert_array_equal(got.numpy(), np.asarray(out))
        np.testing.assert_array_equal(got_inputs.numpy(), np.asarray(out_inputs))
        np.testing.assert_array_equal(pool.buffer.numpy(), np.asarray(jax_pool.buffer))
        np.testing.assert_array_equal(pool.inputs_buffer.numpy(),
                                      np.asarray(jax_pool.inputs_buffer))
        assert pool.count == int(jax_pool.count)
    assert pool.count == size


def test_pool_draws_from_a_generator():
    """Undrawn: slots distinct, about half the batch swapped."""
    pool = Pool.create(50, (1, 1, 3), "cpu")
    pool.count = 50
    data = torch.ones((32, 1, 1, 3))
    out, _ = pool.apply(data, data, generator=torch.Generator().manual_seed(0))
    swapped = int((out == 0).all(dim=(1, 2, 3)).sum())
    assert 4 < swapped < 28
    assert int((pool.buffer == 1).all(dim=(1, 2, 3)).sum()) == swapped
