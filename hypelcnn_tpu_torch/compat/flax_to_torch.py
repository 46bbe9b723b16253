"""Weight bridge from the JAX package's flax variables to a port ``state_dict``.

The caller passes the flax ``params`` and ``batch_stats`` trees as nested
dicts of numpy arrays (``np.asarray`` of each leaf); this module imports
neither jax nor flax. The port's layers keep the flax submodule names, so a
variable path maps to a ``state_dict`` key by name:

- ``.../Conv_0/kernel`` (HWIO) -> ``....Conv_0.weight`` (OIHW), and a 1-D
  conv kernel (``[k, in, out]``) -> ``[out, in, k]``: ``Conv_0`` and the GAN
  networks' ``net1`` .. ``net7`` and ``conv``;
- ``.../Dense_0/kernel`` (``[in, out]``) -> ``....Dense_0.weight`` (``[out, in]``),
  and so the GAN networks' ``fc1`` .. ``fc3`` and ``p{i}_fc1`` .. ``p{i}_fc4``;
- the ``bias`` of each of those layers -> ``....bias``;
- ``.../BatchNorm_0/bias`` (params), ``.../BatchNorm_0/mean|var``
  (batch_stats) -> ``....BatchNorm_0.bias|mean|var``;
- a fused multi-scale level's ``..._fused/conv{k}x{k}_kernel`` (HWIO) ->
  ``..._fused.conv{k}x{k}_kernel`` (OIHW), and its ``conv{k}x{k}_bias``;
- CAP's top-level ``digitcaps_w`` / ``digitcaps_b`` -> the same names, as they are.

Every source leaf is used exactly once; a leaf of any other name raises.
``flax_variables`` goes the other way, from a port ``state_dict`` to the
flax-shaped ``params`` and ``batch_stats`` trees, so that code written
against flax names (the TF checkpoint import, the orbax writer) fills a
port module or a JAX tree.

The JAX package's saved states (read from orbax with
:func:`hypelcnn_tpu_torch.compat.orbax.read_orbax`) come across whole:

- :func:`orbax_payload` makes the checkpoint dict every port reader takes
  (``step``, ``state_dict``) and keeps the tree under :data:`ORBAX_TREE`;
- :func:`optimizer_state_dict` turns a classifier ``TrainState``'s optax
  state into the ``torch.optim`` state: ``adam``'s ``ScaleByAdamState(count,
  mu, nu)`` into Adam's per-parameter ``step``, ``exp_avg`` and
  ``exp_avg_sq``, ``sgd``'s momentum ``trace`` into SGD's ``momentum_buffer``,
  each moment through the rules above (so with its weight's transpose) and
  in the module's parameter order; the schedule's count is the step;
- :func:`gan_state_payload` turns a GAN ``GANState`` (``params``,
  ``opt_states`` of ``gan_adam``, ``pool``) into the port's ``GANState``
  checkpoint: an optimizer named ``a.b`` is ``opt_states["a"]["b"]``, whose
  moments are the tree of its one network, or of several keyed by their
  names (cycle_gan's joint ``generators``); the pools keep their buffers.

and go back whole, as the trees the JAX package's trainers save (each
node in the order JAX flattens it: a dataclass's fields in order, a dict's
keys sorted; every leaf a ``torch.Tensor``, which the orbax writer saves as
a ``jax.Array``; steps and counts int32):

- :func:`train_state_tree` is the inverse of :func:`orbax_payload` and
  :func:`optimizer_state_dict`: ``TrainState(step, params, batch_stats,
  opt_state)`` with ``opt_state = (ScaleByAdamState(count, mu, nu) or
  TraceState(trace), ScaleByScheduleState(count))``; Adam's count is its
  own step count, the schedule's the state's step;
- :func:`gan_state_tree` is the inverse of :func:`gan_state_payload`:
  ``GANState(step, params, opt_states, pool)``, each optimizer nested by its
  dotted name, a one-network optimizer's moments that network's tree, one
  pool un-nested, several keyed by name, none ``None``;
- :func:`snapshot_tree` is a params snapshot's tree, numpy leaves, as the
  JAX package saves ``jax.device_get`` of a GAN's params.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_RULES = {
    # (collection, layer, leaf) -> (torch leaf, transpose)
    ("params", "BatchNorm_0", "bias"): ("bias", None),
    ("batch_stats", "BatchNorm_0", "mean"): ("mean", None),
    ("batch_stats", "BatchNorm_0", "var"): ("var", None),
}
_CONV_LAYER = re.compile(r"Conv_0|net[1-7]|conv")
_DENSE_LAYER = re.compile(r"Dense_0|fc[1-3]|p\d+_fc[1-4]")
_CONV_TRANSPOSE = {4: (3, 2, 0, 1), 3: (2, 1, 0)}  # by the kernel's rank
_TOP_LEVEL_RULES = {
    ("params", "digitcaps_w"): ("digitcaps_w", None),
    ("params", "digitcaps_b"): ("digitcaps_b", None),
}
_FUSED_LEAF = re.compile(r"conv\d+x\d+_(kernel|bias)")


def _rule(collection: str, path: Tuple[str, ...], ndim: int):
    """(torch leaf, transpose) for a flax leaf path of rank ``ndim``, or ``None``."""
    if len(path) == 1:
        return _TOP_LEVEL_RULES.get((collection, path[0]))
    layer, leaf = path[-2:]
    match = _FUSED_LEAF.fullmatch(leaf)
    if collection == "params" and layer.endswith("_fused") and match:
        return leaf, (3, 2, 0, 1) if match.group(1) == "kernel" else None
    for pattern, kernel_transpose in ((_CONV_LAYER, _CONV_TRANSPOSE.get(ndim, (3, 2, 0, 1))),
                                      (_DENSE_LAYER, (1, 0))):
        if collection == "params" and pattern.fullmatch(layer):
            if leaf == "kernel":
                return "weight", kernel_transpose
            return ("bias", None) if leaf == "bias" else None
    return _RULES.get((collection, layer, leaf))


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def variables_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                            ) -> Dict[str, torch.Tensor]:
    """Map flax ``params``/``batch_stats`` (numpy leaves) to a torch ``state_dict``."""
    state: Dict[str, torch.Tensor] = {}
    for collection, tree in (("params", params), ("batch_stats", batch_stats or {})):
        for path, leaf in _leaves(tree):
            rule = _rule(collection, path, np.ndim(leaf))
            if rule is None:
                raise KeyError(f"no mapping for flax {collection} leaf {'/'.join(path)}")
            name, transpose = rule
            key = ".".join(path[:-1] + (name,))
            if key in state:
                raise KeyError(f"two flax leaves map to {key}")
            array = np.asarray(leaf)
            if transpose is not None:
                if array.ndim != len(transpose):
                    raise ValueError(f"{collection} leaf {'/'.join(path)} has shape "
                                     f"{array.shape}, expected {len(transpose)} dims")
                array = array.transpose(transpose)
            state[key] = torch.tensor(array, dtype=torch.float32)
    return state


def load_flax_variables(module: torch.nn.Module, params: Mapping,
                        batch_stats: Optional[Mapping] = None) -> None:
    """Load flax variables into ``module``; raises on a leftover or missing key
    and on a shape that does not match."""
    module.load_state_dict(variables_to_state_dict(params, batch_stats), strict=True)


def _flax_leaf(path: Tuple[str, ...], ndim: int):
    """(collection, flax leaf, transpose) for a ``state_dict`` key's path."""
    if len(path) == 1:
        if ("params", path[0]) in _TOP_LEVEL_RULES:
            return "params", path[0], None
        return None
    layer, leaf = path[-2:]
    match = _FUSED_LEAF.fullmatch(leaf)
    if layer.endswith("_fused") and match:
        return "params", leaf, (2, 3, 1, 0) if match.group(1) == "kernel" else None
    for pattern, kernel_transpose in ((_CONV_LAYER, _CONV_TRANSPOSE.get(ndim, (3, 2, 0, 1))),
                                      (_DENSE_LAYER, (1, 0))):
        if pattern.fullmatch(layer):
            if leaf == "weight":
                return "params", "kernel", tuple(np.argsort(kernel_transpose))
            return ("params", "bias", None) if leaf == "bias" else None
    for (collection, rule_layer, flax_leaf), (torch_leaf, _) in _RULES.items():
        if rule_layer == layer and torch_leaf == leaf:
            return collection, flax_leaf, None
    return None


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order."""
    if isinstance(tree, dict):
        return {key: _sorted(tree[key]) for key in sorted(tree)}
    return tree


def flax_variables(state_dict: Mapping[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The flax ``(params, batch_stats)`` trees (numpy leaves) that
    :func:`variables_to_state_dict` maps to ``state_dict``."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        path = tuple(key.split("."))
        array = tensor.detach().cpu().numpy()
        rule = _flax_leaf(path, array.ndim)
        if rule is None:
            raise KeyError(f"no flax name for state_dict key {key}")
        collection, leaf, transpose = rule
        node = trees[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = array.transpose(transpose) if transpose is not None else array.copy()
    return trees["params"], trees["batch_stats"]


# ------------------------------------------------ the JAX package's states ----

ORBAX_TREE = "orbax_tree"  # the checkpoint dict's key of the tree it came from


def orbax_payload(tree: Mapping) -> Dict[str, Any]:
    """The port's checkpoint dict of a JAX ``TrainState`` or ``GANState``
    tree: its ``step``, the ``state_dict`` of its ``params`` (and
    ``batch_stats``), and the tree itself, from which the restores of
    :class:`~hypelcnn_tpu_torch.train.state.TrainState` and the GAN state
    convert the optimizer state."""
    return {"step": int(np.asarray(tree["step"])),
            "state_dict": variables_to_state_dict(tree["params"], tree.get("batch_stats") or None),
            ORBAX_TREE: tree}


def _moments(tree: Mapping, names: Sequence[str], what: str) -> Dict[str, torch.Tensor]:
    """A moment tree as a ``state_dict`` holding exactly ``names``."""
    moments = variables_to_state_dict(tree)
    if set(moments) != set(names):
        raise KeyError(f"{what}: the moments of {sorted(set(moments) ^ set(names))} "
                       "are not those of the parameters")
    return moments


def optimizer_state_dict(tree: Mapping, module: torch.nn.Module,
                         optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer``'s ``state_dict`` holding the optax state of the JAX
    ``TrainState`` ``tree`` (``opt_state`` = ``(adam or trace, schedule)``)."""
    names = [name for name, _ in module.named_parameters()]
    first = tree["opt_state"][0]
    if isinstance(optimizer, torch.optim.Adam) and "mu" in first:
        count = torch.tensor(float(np.asarray(first["count"])))
        mu = _moments(first["mu"], names, "adam mu")
        nu = _moments(first["nu"], names, "adam nu")
        state = {i: {"step": count.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                 for i, name in enumerate(names)}
    elif isinstance(optimizer, torch.optim.SGD) and "trace" in first:
        trace = _moments(first["trace"], names, "momentum trace")
        state = {i: {"momentum_buffer": trace[name]} for i, name in enumerate(names)}
    else:
        raise ValueError(f"the checkpoint's optimizer state ({sorted(first)}) is not "
                         f"that of {type(optimizer).__name__}")
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def gan_state_payload(tree: Mapping, nets: torch.nn.Module,
                      optimizers: Mapping[str, List[str]], pools: Sequence[str]
                      ) -> Dict[str, Any]:
    """The port's GAN state checkpoint (``GANState.checkpoint``'s form) of the
    JAX ``GANState`` tree: ``optimizers`` names each optimizer's networks
    (paths in ``nets``), ``pools`` the pools."""
    opt_states = {}
    for name, paths in optimizers.items():
        node = tree["opt_states"]
        for part in name.split("."):
            node = node[part]
        names = [f"{path}.{leaf}" for path in paths
                 for leaf, _ in nets.get_submodule(path).named_parameters()]
        moments = []
        for key in ("mu", "nu"):
            tree_of_paths = node[key] if len(paths) > 1 else {paths[0]: node[key]}
            moments.append(_moments(tree_of_paths, names, f"{name} {key}"))
        opt_states[name] = {"count": int(np.asarray(node["count"])),
                            "m": [moments[0][n] for n in names],
                            "v": [moments[1][n] for n in names]}
    pool_tree = tree.get("pool")
    if tuple(pools) == ("pool",):
        pool_tree = {"pool": pool_tree}
    saved_pools = {name: {"buffer": torch.from_numpy(np.array(pool_tree[name]["buffer"])),
                          "inputs_buffer": torch.from_numpy(
                              np.array(pool_tree[name]["inputs_buffer"])),
                          "count": int(np.asarray(pool_tree[name]["count"]))}
                   for name in pools}
    return {"step": int(np.asarray(tree["step"])),
            "state_dict": variables_to_state_dict(tree["params"]),
            "opt_states": opt_states, "pools": saved_pools}


def _int32(value) -> torch.Tensor:
    return torch.tensor(int(value), dtype=torch.int32)


def _tensors(tree):
    """A tree of numpy leaves as one of CPU tensors (sharing their memory)."""
    if isinstance(tree, dict):
        return {key: _tensors(value) for key, value in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def snapshot_tree(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The sorted flax ``params`` tree (numpy leaves) of a ``state_dict``
    that holds parameters only."""
    params, others = flax_variables(state_dict)
    if others:
        raise KeyError(f"a params tree holds no batch statistics: {sorted(others)}")
    return _sorted(params)


def _moment_tree(moments: Mapping[str, torch.Tensor]) -> dict:
    """The flax ``params``-shaped tree of per-parameter moments."""
    return _tensors(snapshot_tree(moments))


def train_state_tree(checkpoint: Mapping[str, Any], module: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The JAX ``TrainState`` tree of a :meth:`TrainState.checkpoint
    <hypelcnn_tpu_torch.train.state.TrainState.checkpoint>` dict; ``module``
    names the parameters and ``optimizer`` says which optax state they had.
    A moment the optimizer has not made yet is zero, as optax starts it."""
    state_dict = checkpoint["state_dict"]
    names = [name for name, _ in module.named_parameters()]
    state = checkpoint["optimizer"]["state"]

    def moment(key: str) -> dict:
        return _moment_tree({name: state[i][key] if key in state.get(i, {})
                             else torch.zeros_like(state_dict[name])
                             for i, name in enumerate(names)})

    if isinstance(optimizer, torch.optim.Adam):
        count = int(state[0]["step"]) if state.get(0) else 0
        first = {"count": _int32(count), "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}
    elif isinstance(optimizer, torch.optim.SGD):
        first = {"trace": moment("momentum_buffer")}
    else:
        raise ValueError(f"no optax state for {type(optimizer).__name__}")
    params, batch_stats = flax_variables(state_dict)
    step = _int32(checkpoint["step"])
    return {"step": step, "params": _tensors(_sorted(params)),
            "batch_stats": _tensors(_sorted(batch_stats)),
            "opt_state": [first, {"count": step.clone()}]}


def gan_state_tree(checkpoint: Mapping[str, Any], nets: torch.nn.Module,
                   optimizers: Mapping[str, List[str]], pools: Sequence[str]
                   ) -> Dict[str, Any]:
    """The JAX ``GANState`` tree of a ``GANState.checkpoint`` dict (the
    inverse of :func:`gan_state_payload`, with the same arguments)."""
    opt_states: dict = {}
    for name, paths in optimizers.items():
        entry = checkpoint["opt_states"][name]
        names = [f"{path}.{leaf}" for path in paths
                 for leaf, _ in nets.get_submodule(path).named_parameters()]
        moments = []
        for key in ("m", "v"):
            tree = _moment_tree(dict(zip(names, entry[key])))
            if len(paths) == 1:  # the one network's own tree
                for part in paths[0].split("."):
                    tree = tree[part]
            moments.append(tree)
        node = opt_states
        *parents, last = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = {"count": _int32(entry["count"]), "mu": moments[0], "nu": moments[1]}
    saved = {name: {"buffer": checkpoint["pools"][name]["buffer"],
                    "inputs_buffer": checkpoint["pools"][name]["inputs_buffer"],
                    "count": _int32(checkpoint["pools"][name]["count"])}
             for name in sorted(pools)}
    pool = saved["pool"] if tuple(pools) == ("pool",) else saved or None
    return {"step": _int32(checkpoint["step"]),
            "params": _tensors(snapshot_tree(checkpoint["state_dict"])),
            "opt_states": _sorted(opt_states), "pool": pool}
