"""The random forest of the classic-ML trainer, grown on the card.

Semantics of the JAX trainer's estimator, scikit-learn's
``RandomForestClassifier(n_estimators=50, max_features=24)`` at its other
defaults (``hypelcnn_tpu/apps/classic_ml_trainer.py``):

- each tree is grown on a bootstrap of ``n`` draws with replacement, carried
  as integer sample weights (a sample drawn 0 times is not in the tree);
- Gini, full depth: a node is a leaf when it holds fewer than 2 distinct
  samples or one class, or when no feature splits it;
- a node visits the features in a random order: 24 of them, and past 24
  until it has visited one that is not constant in the node (max above min +
  1e-7, scikit-learn's ``FEATURE_THRESHOLD``); it splits on the best of the
  visited ones;
- a split sits between two consecutive sorted values more than 1e-7 apart,
  at their midpoint (the lower value when the midpoint rounds to the upper
  one), and a sample goes left when its value is at most the threshold;
- the best split maximises ``sum_k cL_k^2 / nL + sum_k cR_k^2 / nR`` over the
  weighted class counts (scikit-learn's proxy for the Gini decrease); ties go
  to the first visited feature, then the first position;
- the forest predicts the argmax of the mean over the trees of the leaf's
  class fractions, the first class on a tie.

Each tree grows **level by level**: all open nodes of a level at once, as
one sort of ``(node, value)`` keys for each of the visited features,
int64 prefix sums of the weighted class counts, float64 gains and a
segmented argmax. Trees are flat arrays (feature, threshold, left, right,
value), and prediction walks every tree a level at a time with gathers.

Every random draw (the per-tree seeds, the bootstraps and each node's
feature order) comes from CPU ``torch.Generator``s seeded from ``np.random``,
as scikit-learn draws from the global ``RandomState`` when it is given no
seed. The counts are integers and the gains elementwise float64, so the
forest grown on the card is node for node the one grown on the CPU from the
same ``np.random`` state. Plain torch: the JAX package runs scikit-learn on
the host, no TPU kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

FEATURE_THRESHOLD = 1e-7
# (tree, sample, visited feature) values sorted at once: the trees grown
# together are as many as keep a level's arrays near this many elements
ENTRY_BUDGET = 1 << 25
_SIGN_BIT = 1 << 31


@dataclass
class Tree:
    """One tree as flat arrays over its nodes, in level order (node 0 the root)."""

    feature: torch.Tensor  # int64 [nodes], -1 at a leaf
    threshold: torch.Tensor  # float64 [nodes]
    left: torch.Tensor  # int64 [nodes], -1 at a leaf
    right: torch.Tensor  # int64 [nodes]
    value: torch.Tensor  # float64 [nodes, classes], weighted class fractions
    depth: int


def _ordered_bits(values: torch.Tensor) -> torch.Tensor:
    """float32 values -> int64 in [0, 2^32) with the same order."""
    bits = values.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits >= 0, bits + _SIGN_BIT, -1 - bits)


def _segment_max(values: torch.Tensor, segment: torch.Tensor, count: int) -> torch.Tensor:
    out = torch.full((values.shape[0], count), -np.inf, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(1, segment.expand_as(values), values, "amax", include_self=True)


def _best_splits(x, labels, weights, samples, node, feats, totals, n_classes):
    """The best split of each node over its candidate features.

    Each of the ``n`` entries is one sample of one node: ``samples`` (its
    row of ``x``), ``labels``, ``weights`` and ``node`` (ids in ``[0, M)``).
    ``feats`` ``[M, J]`` are each node's features in visiting order,
    ``totals`` ``[M, K]`` int64 its weighted class counts. Returns ``(score
    [M] (-inf: no valid split), feature [M], threshold [M])``.
    """
    device = x.device
    n, (m, j) = samples.shape[0], feats.shape
    cols = feats.index_select(0, node)  # [n, J]
    vals = x[samples[:, None], cols].T.contiguous()  # [J, n] float32
    keys = (node[None, :] << 32) | _ordered_bits(vals)
    keys, order = torch.sort(keys, dim=1, stable=True)
    node_pos = keys[0] >> 32  # the node of each sorted position (same in every row)
    v = vals.gather(1, order).to(torch.float64)
    label = labels[order]  # [J, n]
    weight = weights[order]
    counts = torch.bincount(node, minlength=m)
    start = counts.cumsum(0) - counts

    def running(values, begin):
        """Inclusive running sums of ``values`` along each row, restarting at
        each position's group start ``begin``."""
        total = values.cumsum(1)
        return total - (total - values).gather(1, begin)

    # each sample's own class count up to and including it, in its node:
    # running sums over the positions ordered by (node, class); every row
    # holds the same samples, so a group starts at the same offset in each
    group = node_pos[None, :] * n_classes + label
    group, by_class = torch.sort(group, dim=1, stable=True)
    sizes = torch.bincount(group[0], minlength=m * n_classes)
    own = torch.empty_like(weight)
    own.scatter_(1, by_class, running(weight.gather(1, by_class), (sizes.cumsum(0) - sizes)[group]))
    # left side after each position: its weight, its sum of squared class
    # counts ((c + w)^2 - c^2 summed) and its counts' product with the node's
    node_begin = start[node_pos][None, :].expand(j, n)
    n_left = running(weight, node_begin)
    sq_left = running(2 * weight * own - weight * weight, node_begin)
    cross = running(weight * totals[node_pos[None, :], label], node_begin)
    n_total = totals.sum(1)[node_pos][None, :]
    sq_total = (totals * totals).sum(1)[node_pos][None, :]
    n_right = n_total - n_left
    sq_right = sq_total - 2 * cross + sq_left
    score = (sq_left.to(torch.float64) / n_left.to(torch.float64)
             + sq_right.to(torch.float64) / n_right.to(torch.float64))
    last = torch.zeros(n, dtype=torch.bool, device=device)
    last[start + counts - 1] = True
    nxt = torch.cat([v[:, 1:], v[:, -1:]], dim=1)
    valid = ~last[None, :] & (nxt > v + FEATURE_THRESHOLD)
    score = torch.where(valid, score, -np.inf)
    best = _segment_max(score, node_pos[None, :], m).max(0).values  # [M]
    # the first candidate (feature in visiting order, then position) at the best
    flat = torch.arange(j * n, device=device).reshape(j, n)
    hit = (score == best[node_pos][None, :]) & valid
    first = torch.full((m,), j * n, dtype=torch.int64, device=device)
    first.scatter_reduce_(0, node_pos.expand(j, n)[hit], flat[hit], "amin", include_self=True)
    ok = best > -np.inf
    first = torch.where(ok, first, 0)
    row, pos = first // n, first % n
    lo, hi = v[row, pos], v[row, (pos + 1).clamp_max(n - 1)]
    threshold = lo / 2.0 + hi / 2.0
    threshold = torch.where((threshold == hi) | torch.isinf(threshold), lo, threshold)
    feature = feats[torch.arange(m, device=device), row]
    return best, feature, threshold


def _first_non_constant(x, samples, node, perm, m):
    """For each node, the visiting position of its first feature that is not
    constant over its samples (``F`` when there is none)."""
    vals = x.index_select(0, samples).to(torch.float64)  # [n, F]
    f = x.shape[1]
    index = node[:, None].expand(-1, f)
    high = torch.full((m, f), -np.inf, dtype=torch.float64, device=x.device)
    high.scatter_reduce_(0, index, vals, "amax", include_self=True)
    low = torch.full((m, f), np.inf, dtype=torch.float64, device=x.device)
    low.scatter_reduce_(0, index, vals, "amin", include_self=True)
    varies = (high > low + FEATURE_THRESHOLD).gather(1, perm)
    position = torch.where(varies, torch.arange(f, device=x.device)[None, :], f)
    return position.min(1).values


def grow_trees(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor, n_classes: int,
               max_features: int, generators) -> List[Tree]:
    """Trees on ``x`` ``[N, F]`` float32 and class ids ``y`` ``[N]``, one for
    each row of the int64 sample weights ``weights`` ``[T, N]`` (all on one
    device), grown together level by level; tree ``t`` draws its feature
    orders from the CPU generator ``generators[t]``, so it does not depend on
    the other trees of the batch."""
    device = x.device
    n_trees = weights.shape[0]
    n_features = x.shape[1]
    visit = min(max_features, n_features)
    # one entry for each (tree, sample) in the tree, tree by tree; every
    # open node of a level belongs to one tree, and the nodes of a level are
    # in tree order
    tree_of, samples = torch.nonzero(weights > 0, as_tuple=True)
    entry_weight = weights[tree_of, samples]
    entry_label = y[samples]
    node = tree_of
    node_tree = torch.arange(n_trees, device=device)
    node_id = torch.zeros(n_trees, dtype=torch.int64, device=device)  # id within its tree
    next_id = torch.ones(n_trees, dtype=torch.int64, device=device)
    levels = []
    while node_tree.shape[0]:
        m = node_tree.shape[0]
        totals = torch.zeros((m, n_classes), dtype=torch.int64, device=device)
        totals.index_put_((node, entry_label), entry_weight, accumulate=True)
        value = totals.to(torch.float64) / totals.sum(1, keepdim=True).to(torch.float64)
        distinct = torch.bincount(node, minlength=m)
        can_split = (distinct >= 2) & ((totals > 0).sum(1) > 1)
        feature = torch.full((m,), -1, dtype=torch.int64, device=device)
        threshold = torch.zeros((m,), dtype=torch.float64, device=device)
        splitting = torch.nonzero(can_split).reshape(-1)
        per_tree = torch.bincount(node_tree[splitting], minlength=n_trees).tolist()
        n_split = int(splitting.shape[0])
        if n_split:
            # each splitting node's features in a random visiting order,
            # from its tree's generator
            keys = [torch.rand((count, n_features), generator=generators[t])
                    for t, count in enumerate(per_tree) if count]
            perm = torch.cat(keys).to(device).argsort(dim=1, stable=True)
            local = torch.full((m,), -1, dtype=torch.int64, device=device)
            local[splitting] = torch.arange(n_split, device=device)
            keep = local[node] >= 0
            s_samples, s_node = samples[keep], local[node[keep]]
            s_labels, s_weights = entry_label[keep], entry_weight[keep]
            s_totals = totals.index_select(0, splitting)
            score, feat, thr = _best_splits(x, s_labels, s_weights, s_samples, s_node,
                                            perm[:, :visit], s_totals, n_classes)
            stuck = torch.nonzero(score == -np.inf).reshape(-1)
            if visit < n_features and stuck.shape[0]:
                # nodes whose visited features are all constant visit on to the
                # first one that is not
                e_local = torch.full((n_split,), -1, dtype=torch.int64, device=device)
                e_local[stuck] = torch.arange(stuck.shape[0], device=device)
                e_keep = e_local[s_node] >= 0
                e_samples, e_node = s_samples[e_keep], e_local[s_node[e_keep]]
                e_perm = perm.index_select(0, stuck)
                position = _first_non_constant(x, e_samples, e_node, e_perm, stuck.shape[0])
                beyond = position >= visit
                e_feats = e_perm.gather(1, position.clamp_max(n_features - 1)[:, None])
                e_score, e_feat, e_thr = _best_splits(
                    x, s_labels[e_keep], s_weights[e_keep], e_samples, e_node, e_feats,
                    s_totals.index_select(0, stuck), n_classes)
                e_score = torch.where(beyond & (position < n_features), e_score, -np.inf)
                score[stuck], feat[stuck], thr[stuck] = e_score, e_feat, e_thr
            found = score > -np.inf
            feature[splitting] = torch.where(found, feat, -1)
            threshold[splitting] = torch.where(found, thr, 0.0)
        splits = feature >= 0
        rank = splits.cumsum(0) - 1
        # children ids within each tree: its next free id, 2 for each split
        # node of the tree before this one at this level
        tree_splits = torch.bincount(node_tree[splits], minlength=n_trees)
        before = (tree_splits.cumsum(0) - tree_splits)[node_tree]
        left = torch.where(splits, next_id[node_tree] + 2 * (rank - before), -1)
        right = torch.where(splits, left + 1, -1)
        levels.append((node_tree, node_id, feature, threshold, left, right, value))
        next_id = next_id + 2 * tree_splits
        # route the entries of the split nodes to their children
        moving = splits[node]
        samples, node = samples[moving], node[moving]
        entry_label, entry_weight = entry_label[moving], entry_weight[moving]
        go_left = (x[samples, feature[node]].to(torch.float64) <= threshold[node])
        node = 2 * rank[node] + torch.where(go_left, 0, 1)
        parents = torch.nonzero(splits).reshape(-1)
        node_tree = node_tree[parents].repeat_interleave(2)
        node_id = torch.stack([left[parents], right[parents]], dim=1).reshape(-1)
    columns = [torch.cat(column) for column in zip(*levels)]
    trees = []
    for t in range(n_trees):
        mine = torch.nonzero(columns[0] == t).reshape(-1)
        order = mine[columns[1][mine].argsort()]
        feature, threshold, left, right, value = (c[order] for c in columns[2:])
        depth = sum(int((level[0] == t).any()) for level in levels)
        trees.append(Tree(feature, threshold, left, right, value, depth=depth))
    return trees


class RandomForestClassifier:
    """The trainer's forest: ``fit(x, y)`` on the device of ``x``, then
    ``predict``. Seeds come from ``np.random`` at ``fit``."""

    def __init__(self, n_estimators: int = 50, max_features: int = 24) -> None:
        self.n_estimators = n_estimators
        self.max_features = max_features
        self.classes_: Optional[np.ndarray] = None
        self.trees: List[Tree] = []

    def get_params(self) -> dict:
        """scikit-learn's parameter names, with the values this forest uses."""
        return {"bootstrap": True, "ccp_alpha": 0.0, "class_weight": None,
                "criterion": "gini", "max_depth": None, "max_features": self.max_features,
                "max_leaf_nodes": None, "max_samples": None, "min_impurity_decrease": 0.0,
                "min_samples_leaf": 1, "min_samples_split": 2, "min_weight_fraction_leaf": 0.0,
                "monotonic_cst": None, "n_estimators": self.n_estimators, "n_jobs": None,
                "oob_score": False, "random_state": None, "verbose": False,
                "warm_start": False}

    def fit(self, x: torch.Tensor, y) -> "RandomForestClassifier":
        """Grow the trees on the device of ``x``, each from its own seed:
        on the card as many at a time as ``ENTRY_BUDGET`` allows (fewer
        launches), on the CPU one at a time (a tree's arrays stay in cache;
        eight at a time grew slower there). Either way each tree is the
        same."""
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        labels = torch.from_numpy(np.searchsorted(self.classes_, y)).to(x.device)
        seeds = np.random.randint(np.iinfo(np.int32).max, size=self.n_estimators)
        n, n_features = x.shape
        x = x.to(torch.float32).contiguous()
        per_batch = 1 if x.device.type == "cpu" else \
            max(1, ENTRY_BUDGET // (n * min(self.max_features, n_features)))
        self.trees = []
        for start in range(0, len(seeds), per_batch):
            generators, weights = [], []
            for seed in seeds[start:start + per_batch]:
                generator = torch.Generator().manual_seed(int(seed))
                draws = torch.randint(0, n, (n,), generator=generator)
                weights.append(torch.bincount(draws, minlength=n))
                generators.append(generator)
            self.trees += grow_trees(x, labels, torch.stack(weights).to(x.device),
                                     self.classes_.shape[0], self.max_features, generators)
        return self

    def _stacked(self, device):
        offsets, total = [], 0
        for tree in self.trees:
            offsets.append(total)
            total += tree.feature.shape[0]
        shift = torch.tensor(offsets, dtype=torch.int64)

        def cat(name, shifted=False):
            parts = [getattr(t, name).to(device) for t in self.trees]
            if shifted:
                parts = [torch.where(p >= 0, p + int(o), p) for p, o in zip(parts, offsets)]
            return torch.cat(parts)

        return (cat("feature"), cat("threshold"), cat("left", True), cat("right", True),
                cat("value"), shift.to(device), max(t.depth for t in self.trees))

    def predict_proba(self, x: torch.Tensor, batch_size: int = 65536) -> torch.Tensor:
        """``[N, classes]`` float64: the mean over the trees of the leaf's class
        fractions, summed tree by tree in order."""
        feature, threshold, left, right, value, roots, depth = self._stacked(x.device)
        out = []
        for start in range(0, x.shape[0], batch_size):
            xb = x[start:start + batch_size]
            rows = torch.arange(xb.shape[0], device=x.device)[None, :]
            at = roots[:, None].expand(-1, xb.shape[0]).contiguous()  # [trees, batch]
            for _ in range(depth):
                f = feature[at]
                go_left = xb[rows, f.clamp_min(0)].to(torch.float64) <= threshold[at]
                at = torch.where(f >= 0, torch.where(go_left, left[at], right[at]), at)
            proba = torch.zeros((xb.shape[0], value.shape[1]), dtype=torch.float64,
                                device=x.device)
            for t in range(at.shape[0]):
                proba += value[at[t]]
            out.append(proba / len(self.trees))
        return torch.cat(out)

    def predict(self, x: torch.Tensor, batch_size: int = 65536) -> np.ndarray:
        proba = self.predict_proba(x, batch_size)
        return self.classes_[proba.argmax(1).cpu().numpy()]
