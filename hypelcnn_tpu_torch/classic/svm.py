"""The RBF support vector classifier of the classic-ML trainer, solved on the card.

Semantics of scikit-learn's ``SVC()`` at its defaults, which
``GridSearchCV(SVC(), ...)`` in ``hypelcnn_tpu/apps/classic_ml_trainer.py``
leaves alone: the RBF kernel ``exp(-gamma |x - x'|^2)``, ``tol=1e-3``, one
binary C-SVC per pair of classes (sorted labels; the first of a pair is +1,
its samples first, then the second's), and a vote whose ties go to the lower
class.

Each binary problem is libsvm's dual, ``min 1/2 a'Qa - e'a`` with ``0 <= a <=
C`` and ``y'a = 0``, solved by SMO with libsvm's second-order working-set
selection (Fan, Chen and Lin, 2005), its ties (the last maximum for ``i``,
the last minimum for ``j``), its two-variable update with clipping and its
stopping rule ``Gmax + Gmax2 < tol``; ``rho`` is libsvm's mean of ``y G`` over
the free vectors (or the middle of the bounds). As libsvm stores its kernel
cache, ``Q`` is kept in float32 and the rest in float64. Shrinking, which
changes libsvm's path but not its stopping rule, is not done. The
iterations are not capped: a problem runs until it meets the rule.

Every problem of a batch (every pair of every (C, gamma) cell) takes one
SMO step at a time together, as ``[problems, samples]`` tensors on the
card, so an iteration is a fixed number of launches whatever the batch;
problems that have met the rule stop changing. Plain torch: the JAX package
runs scikit-learn on the host, no TPU kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

TAU = 1e-12  # libsvm's floor for a non-positive second derivative
TOL = 1e-3  # SVC's default tol (libsvm's eps)
# the float32 kernel matrices of the cells solved at once are held under
# this many bytes (one cell's at least); the distances are held besides
CHUNK_BYTES = 1 << 30


def squared_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|a_i|^2 + |b_j|^2 - 2 a_i . b_j`` in float64, libsvm's RBF argument,
    over the last two dimensions (``[..., I, F]`` and ``[..., J, F]``)."""
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    return ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
            - 2.0 * (a @ b.transpose(-1, -2)))


def _pairs(n_classes: int) -> List[tuple]:
    return [(a, b) for a in range(n_classes) for b in range(a + 1, n_classes)]


def _last_arg(values: torch.Tensor, largest: bool) -> torch.Tensor:
    """Per row, the index of the last maximum (or minimum)."""
    flipped = values.flip(1)
    first = flipped.argmax(1) if largest else flipped.argmin(1)
    return values.shape[1] - 1 - first


def _smo(kernel: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> tuple:
    """Solve a batch of C-SVC duals. ``kernel`` ``[B, L, L]`` float32, ``y``
    ``[B, L]`` float64 labels in {+1, -1} (0 pads a shorter problem), ``c``
    ``[B]``. Returns ``(alpha [B, L], rho [B], iterations)``."""
    batch, length = y.shape
    device = y.device
    rows = torch.arange(batch, device=device)
    real = y != 0
    c = c[:, None].expand(batch, length)
    qd = torch.where(real, kernel.diagonal(dim1=1, dim2=2).to(torch.float64), 0.0)
    alpha = torch.zeros((batch, length), dtype=torch.float64, device=device)
    grad = torch.where(real, -1.0, 0.0).to(torch.float64)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    neg_inf = torch.tensor(-np.inf, dtype=torch.float64, device=device)
    pos_inf = torch.tensor(np.inf, dtype=torch.float64, device=device)
    iterations = 0
    while True:
        upper = alpha >= c
        lower = alpha <= 0
        pos = y > 0
        neg = y < 0
        in_up = (pos & ~upper) | (neg & ~lower)
        in_low = (pos & ~lower) | (neg & ~upper)
        yg = y * grad
        score_i = torch.where(in_up, -yg, neg_inf)
        i = _last_arg(score_i, largest=True)
        gmax = score_i[rows, i]
        gmax2 = torch.where(in_low, yg, neg_inf).max(1).values
        k_i = kernel[rows, i].to(torch.float64)
        grad_diff = gmax[:, None] + yg
        quad = qd[rows, i][:, None] + qd - 2.0 * k_i
        quad = torch.where(quad > 0, quad, TAU)
        obj = torch.where(in_low & (grad_diff > 0), -(grad_diff * grad_diff) / quad, pos_inf)
        j = _last_arg(obj, largest=False)
        found = obj[rows, j] < np.inf
        done |= (gmax + gmax2 < TOL) | ~found
        if bool(done.all()):
            break
        iterations += 1
        y_i, y_j = y[rows, i], y[rows, j]
        a_i, a_j = alpha[rows, i], alpha[rows, j]
        c_i, c_j = c[rows, i], c[rows, j]
        g_i, g_j = grad[rows, i], grad[rows, j]
        quad_ij = qd[rows, i] + qd[rows, j] - 2.0 * k_i[rows, j]
        quad_ij = torch.where(quad_ij > 0, quad_ij, TAU)
        # y_i != y_j: a_i - a_j is kept
        delta = (-g_i - g_j) / quad_ij
        diff = a_i - a_j
        ni, nj = a_i + delta, a_j + delta
        fix = (diff > 0) & (nj < 0)
        ni, nj = torch.where(fix, diff, ni), torch.where(fix, 0.0, nj)
        fix = (diff <= 0) & (ni < 0)
        ni, nj = torch.where(fix, 0.0, ni), torch.where(fix, -diff, nj)
        fix = (diff > c_i - c_j) & (ni > c_i)
        ni, nj = torch.where(fix, c_i, ni), torch.where(fix, c_i - diff, nj)
        fix = (diff <= c_i - c_j) & (nj > c_j)
        ni, nj = torch.where(fix, c_j + diff, ni), torch.where(fix, c_j, nj)
        opposite_i, opposite_j = ni, nj
        # y_i == y_j: a_i + a_j is kept
        delta = (g_i - g_j) / quad_ij
        total = a_i + a_j
        ni, nj = a_i - delta, a_j + delta
        fix = (total > c_i) & (ni > c_i)
        ni, nj = torch.where(fix, c_i, ni), torch.where(fix, total - c_i, nj)
        fix = (total <= c_i) & (nj < 0)
        ni, nj = torch.where(fix, total, ni), torch.where(fix, 0.0, nj)
        fix = (total > c_j) & (nj > c_j)
        ni, nj = torch.where(fix, total - c_j, ni), torch.where(fix, c_j, nj)
        fix = (total <= c_j) & (ni < 0)
        ni, nj = torch.where(fix, 0.0, ni), torch.where(fix, total, nj)
        same = y_i == y_j
        ni = torch.where(same, ni, opposite_i)
        nj = torch.where(same, nj, opposite_j)
        ni = torch.where(done, a_i, ni)
        nj = torch.where(done, a_j, nj)
        d_i, d_j = ni - a_i, nj - a_j
        alpha[rows, i] = ni
        alpha[rows, j] = nj
        # G_k += Q_ik d_i + Q_jk d_j, with Q_ik = y_i y_k K_ik
        k_j = kernel[rows, j].to(torch.float64)
        grad += (y_i[:, None] * y * k_i) * d_i[:, None] + (y_j[:, None] * y * k_j) * d_j[:, None]
    return alpha, _rho(alpha, grad, y, c), iterations


def _rho(alpha, grad, y, c) -> torch.Tensor:
    yg = y * grad
    real = y != 0
    upper = real & (alpha >= c)
    lower = real & (alpha <= 0)
    free = real & ~upper & ~lower
    pos, neg = y > 0, y < 0
    inf = torch.tensor(np.inf, dtype=torch.float64, device=y.device)
    ub_mask = (upper & neg) | (lower & pos)
    lb_mask = (upper & pos) | (lower & neg)
    ub = torch.where(ub_mask, yg, inf).min(1).values
    lb = torch.where(lb_mask, yg, -inf).max(1).values
    n_free = free.sum(1)
    sum_free = torch.where(free, yg, 0.0).sum(1)
    return torch.where(n_free > 0, sum_free / n_free.clamp_min(1), (ub + lb) / 2)


@dataclass
class SVMBatch:
    """Fitted one-vs-one RBF SVMs of several (C, gamma) cells on one training set."""

    classes: np.ndarray  # sorted labels
    x: torch.Tensor  # [N, F] training data
    gammas: torch.Tensor  # [cells] float64
    coef: torch.Tensor  # [cells, pairs, N] y * alpha, at each sample's index
    rho: torch.Tensor  # [cells, pairs]
    iterations: int

    def decision(self, x: torch.Tensor) -> torch.Tensor:
        """``[cells, pairs, M]`` decision values ``sum coef K - rho``."""
        dist = squared_distances(self.x, x.to(self.x.device))
        out = []
        for cell in range(self.gammas.shape[0]):
            k = torch.exp(-self.gammas[cell] * dist)
            out.append(self.coef[cell] @ k - self.rho[cell][:, None])
        return torch.stack(out)

    def predict(self, x: torch.Tensor) -> np.ndarray:
        """``[cells, M]`` labels by the one-vs-one vote, ties to the lower class."""
        dec = self.decision(x)
        n_classes = self.classes.shape[0]
        votes = torch.zeros((dec.shape[0], n_classes, dec.shape[2]), dtype=torch.int64,
                            device=dec.device)
        for p, (a, b) in enumerate(_pairs(n_classes)):
            wins = (dec[:, p] > 0).to(torch.int64)
            votes[:, a] += wins
            votes[:, b] += 1 - wins
        return self.classes[votes.argmax(1).cpu().numpy()]


def fit_many(x: torch.Tensor, y: np.ndarray, cs: Sequence[float],
             gammas: Sequence[float]) -> SVMBatch:
    """Fit ``SVC(C=cs[n], gamma=gammas[n])`` for every cell ``n`` on ``(x, y)``:
    ``x`` ``[N, F]`` on the device that solves, ``y`` host labels.

    Memory grows with the square of ``L``, the samples of the largest pair:
    each pair's ``[L, L]`` float64 distances are held for the whole grid,
    with one cell's float64 temporary, 16 bytes an entry; the float32 kernels
    of the cells solved at once add 4 bytes an entry a cell, as many cells as
    ``CHUNK_BYTES`` holds."""
    if len(cs) != len(gammas):
        raise ValueError("fit_many takes one C for each gamma")
    device = x.device
    y = np.asarray(y)
    classes = np.unique(y)
    if classes.shape[0] < 2:
        raise ValueError("an SVM needs at least two classes")
    pairs = _pairs(classes.shape[0])
    members = [np.concatenate([np.flatnonzero(y == classes[a]), np.flatnonzero(y == classes[b])])
               for a, b in pairs]
    length = max(m.shape[0] for m in members)
    index = torch.zeros((len(pairs), length), dtype=torch.int64)
    labels = torch.zeros((len(pairs), length), dtype=torch.float64)
    for p, (m, (a, _)) in enumerate(zip(members, pairs)):
        index[p, :m.shape[0]] = torch.from_numpy(m)
        labels[p, :m.shape[0]] = torch.from_numpy(np.where(y[m] == classes[a], 1.0, -1.0))
    index, labels = index.to(device), labels.to(device)
    rows = x.index_select(0, index.reshape(-1)).reshape(len(pairs), length, x.shape[1])
    dist = squared_distances(rows, rows)  # [pairs, L, L], from each pair's own rows
    dist.diagonal(dim1=1, dim2=2).zero_()  # libsvm's |x|^2 + |x|^2 - 2 x.x of one vector
    n = x.shape[0]
    cells = len(cs)
    coef = torch.zeros((cells, len(pairs), n), dtype=torch.float64, device=device)
    rho = torch.zeros((cells, len(pairs)), dtype=torch.float64, device=device)
    per_cell = max(1, CHUNK_BYTES // (len(pairs) * length * length * 4))
    iterations = 0
    gamma_t = torch.tensor(list(gammas), dtype=torch.float64, device=device)
    c_t = torch.tensor(list(cs), dtype=torch.float64, device=device)
    for start in range(0, cells, per_cell):
        stop = min(cells, start + per_cell)
        kernel = torch.empty((stop - start, *dist.shape), dtype=torch.float32, device=device)
        for cell in range(start, stop):
            kernel[cell - start] = (dist * -gamma_t[cell]).exp_()
        batch = (stop - start) * len(pairs)
        y_b = labels.repeat(stop - start, 1)
        alpha, rho_b, its = _smo(kernel.reshape(batch, length, length), y_b,
                                 c_t[start:stop].repeat_interleave(len(pairs)))
        iterations = max(iterations, its)
        scattered = torch.zeros((batch, n), dtype=torch.float64, device=device)
        scattered.scatter_add_(1, index.repeat(stop - start, 1), alpha * y_b)
        coef[start:stop] = scattered.reshape(stop - start, len(pairs), n)
        rho[start:stop] = rho_b.reshape(stop - start, len(pairs))
    return SVMBatch(classes=classes, x=x, gammas=gamma_t, coef=coef, rho=rho,
                    iterations=iterations)

