"""CAP's two routes through the capsule layer (``models/cap.py``) on the CPU:
the folded route, which never forms ``u_hat``, against the ``u_hat`` route
and a float64 routing; which route a forward takes; the counters after each;
and the folded route's agreement all-reduced on a sharded mesh.

Tolerances: both routes compute the same sums in float32, in other orders.
Against the same routing in float64, on these cases, the routes' class scores
part by up to 8.6e-6 of the largest score (the couplings pass a logit's
rounding on to the scores) and their routing logits by up to 8.4e-7 of the
largest logit. Each route is held to float64, and the two routes to each
other, within ``SCORE_TOL`` and ``LOGIT_TOL`` of the largest float64 value,
about six times those; a term left out of either sum parts them by 1e-2 or
more."""

import copy

import pytest
import torch

from hypelcnn_tpu_torch.models.cap import CAPModel, CAPModule
from hypelcnn_tpu_torch.ops.nn import squash
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SMALL = {"feature_count": 16, "primary_capsule_count": 4, "digit_capsule_output_space": 8}
CLASSES, CHANNELS, BATCH = 5, 9, 64
SCORE_TOL, LOGIT_TOL = 5e-5, 5e-6
CASES = [(k, rounds, seed) for k in (1, 3) for rounds in (1, 3) for seed in range(3)]


def _module(k: int, rounds: int, seed: int):
    """A module with random capsule weights, a nonzero capsule bias, and a batch."""
    module = CAPModel().create_module(CLASSES, {**SMALL, "iter_routing": rounds},
                                      [k, k, CHANNELS])
    gen = torch.Generator().manual_seed(seed)
    module.init_parameters_(gen)
    with torch.no_grad():
        module.digitcaps_b.normal_(0.0, 0.1, generator=gen)
    return module, torch.rand(BATCH, k, k, CHANNELS, generator=gen)


def _primary_capsules(module, x):
    with torch.no_grad():
        net = module.PrimaryCaps_layer(module.Conv1_layer(x.permute(0, 3, 1, 2)))
        return net.permute(0, 2, 3, 1).reshape(x.shape[0], module.data_size, module.pco)


def _routing64(module, u):
    """The published routing in float64 over materialized prediction vectors:
    the class scores and the last round's routing logits."""
    d, p, j, c = module.data_size, module.pco, module.classes, module.dco
    w = module.digitcaps_w.detach().double().view(d, p, j, c)
    bias = module.digitcaps_b.detach().double().view(d, j, c)
    u_hat = torch.einsum("bdp,dpjc->bdjc", u.double(), w) + bias
    logits = torch.zeros(d, j, dtype=torch.float64)
    for round_ in range(module.iter_routing):
        v = squash(torch.einsum("bdjc,dj->bjc", u_hat, torch.softmax(logits, dim=1)), dim=-1)
        if round_ + 1 < module.iter_routing:
            logits = logits + torch.einsum("bdjc,bjc->dj", u_hat, v)
    return torch.linalg.vector_norm(v, dim=-1), logits


def _gap(got, want) -> float:
    """The largest difference, over the largest magnitude of ``want``."""
    scale = want.abs().max().item()
    return (got.double() - want.double()).abs().max().item() / scale if scale else 0.0


@pytest.mark.parametrize("k,rounds,seed", CASES)
def test_folded_route_matches_u_hat_route_and_float64(k, rounds, seed):
    module, x = _module(k, rounds, seed)
    u = _primary_capsules(module.eval(), x)
    with torch.no_grad():
        v_u, scores_u, logits_u = module.u_hat_route(u, 0)
        v_f, scores_f, logits_f = module.folded_route(u, 0)
    scores64, logits64 = _routing64(module, u)
    assert v_f.shape == v_u.shape == (CLASSES, module.dco, BATCH)
    assert scores_f.shape == scores_u.shape == (BATCH, CLASSES)
    for got in (scores_u, scores_f):
        assert _gap(got, scores64) <= SCORE_TOL
    assert _gap(scores_f, scores_u) <= SCORE_TOL
    if rounds == 1:  # no agreement: the logits stay 0
        assert not logits_u.any() and not logits_f.any()
        return
    for got in (logits_u, logits_f):
        assert _gap(got, logits64) <= LOGIT_TOL
    assert _gap(logits_f, logits_u) <= LOGIT_TOL


def _routes_taken(forward) -> dict:
    CAPModule.reset_routes()
    forward()
    return dict(CAPModule.routes)


def test_route_follows_grad_mode():
    module, x = _module(3, 3, 0)
    labels = torch.nn.functional.one_hot(torch.arange(BATCH) % CLASSES, CLASSES).float()
    module.eval()
    with torch.inference_mode():
        assert _routes_taken(lambda: module(x)) == {"u_hat": 0, "folded": 1}
    with torch.no_grad():
        assert _routes_taken(lambda: module(x)) == {"u_hat": 0, "folded": 1}
    # grad mode on, but nothing to differentiate: autograd records nothing
    frozen = copy.deepcopy(module).requires_grad_(False)
    assert _routes_taken(lambda: frozen(x)) == {"u_hat": 0, "folded": 1}
    assert _routes_taken(lambda: module(x)) == {"u_hat": 1, "folded": 0}
    module.train()
    assert _routes_taken(lambda: module(x, labels)) == {"u_hat": 1, "folded": 0}


def _u_hat_forward(module, x, labels):
    """CAP's training forward as it was before the folded route: the stem,
    the ``u_hat`` product with its bias added in place, the routing over it,
    the decoder."""
    batch = x.shape[0]
    d, j, c = module.data_size, module.classes, module.dco
    net = module.PrimaryCaps_layer(module.Conv1_layer(x.permute(0, 3, 1, 2)))
    u = net.permute(0, 2, 3, 1).reshape(batch, d, module.pco)
    u_hat = torch.bmm(module.digitcaps_w.transpose(1, 2), u.permute(1, 2, 0))
    u_hat.add_(module.digitcaps_b.unsqueeze(2))
    by_class = u_hat.view(d, j, c * batch).transpose(0, 1)
    b_ij = torch.zeros((d, j))
    for round_ in range(module.iter_routing):
        s = torch.bmm(torch.softmax(b_ij, dim=1).t().unsqueeze(1), by_class).view(j, c, batch)
        v = squash(s, dim=1)
        if round_ + 1 < module.iter_routing:
            b_ij = b_ij + torch.bmm(by_class, v.view(j, c * batch, 1)).squeeze(2).t()
    y_conv = torch.linalg.vector_norm(v, dim=1).t()
    masked_v = torch.einsum("jcb,bj->bc", v, labels)
    return y_conv, module.decoder_fc3(module.decoder_fc2(module.decoder_fc1(masked_v)))


@pytest.mark.parametrize("k", [1, 3])
def test_training_forward_keeps_its_gradients(k):
    """A training step's loss and every gradient, bit for bit as before."""
    module, x = _module(k, 3, k)
    labels = torch.nn.functional.one_hot(torch.arange(BATCH) % CLASSES, CLASSES).float()
    module.train()
    params = list(module.parameters())
    out = module(x, labels)
    loss = CAPModel().loss(out, labels).mean()
    got = torch.autograd.grad(loss, params)
    y_conv, image = _u_hat_forward(module, x, labels)
    want_loss = CAPModel().loss(out._replace(y_conv=y_conv, image_output=image), labels).mean()
    want = torch.autograd.grad(want_loss, params)
    assert torch.equal(loss, want_loss)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_counters_after_each_route():
    module, x = _module(3, 3, 1)
    full = module.data_size * CLASSES * module.dco * 4 * BATCH
    module.eval()
    with torch.inference_mode():
        module(x)
    assert (CAPModule.u_hat_bytes, CAPModule.routing_products) == (0, 5)
    module(x)
    assert (CAPModule.u_hat_bytes, CAPModule.routing_products) == (full, 5)
    single, _ = _module(3, 1, 1)
    with torch.no_grad():
        single.eval()(x)
    assert (CAPModule.u_hat_bytes, CAPModule.routing_products) == (0, 1)


class _DoublingMesh:
    """A data axis of two ranks that hold the same windows: the all-reduced
    sum is twice this rank's, and each call is recorded."""

    sharded = True

    def __init__(self):
        self.calls = []

    def all_reduce_sum(self, tensor):
        self.calls.append(tuple(tensor.shape))
        return tensor * 2


@pytest.mark.parametrize("route", ["folded_route", "u_hat_route"])
@pytest.mark.parametrize("rounds", [1, 3])
def test_sharded_route_all_reduces_each_agreement(route, rounds):
    """Each rank holds half of a global batch made of the same windows twice:
    the agreement is all-reduced once a round but the last, and the rank's
    scores are those of the global batch routed on one rank."""
    module, x = _module(3, rounds, 2)
    u = _primary_capsules(module.eval(), x)
    with torch.no_grad():
        _, scores, logits = getattr(module, route)(torch.cat([u, u]), 0)
        mesh = _DoublingMesh()
        module.mesh = mesh
        _, sharded_scores, sharded_logits = getattr(module, route)(u, 0)
    agreement = (module.data_size, CLASSES) if route == "folded_route" \
        else (CLASSES, module.data_size)
    assert mesh.calls == [agreement] * (rounds - 1)
    assert _gap(sharded_scores, scores[:BATCH]) <= SCORE_TOL
    assert _gap(sharded_logits, logits) <= LOGIT_TOL
