"""Weight bridge from the JAX package's flax variables to a port ``state_dict``.

The caller passes the flax ``params`` and ``batch_stats`` trees as nested
dicts of numpy arrays (``np.asarray`` of each leaf); this module imports
neither jax nor flax. The port's layers keep the flax submodule names, so a
variable path maps to a ``state_dict`` key by name:

- ``.../Conv_0/kernel`` (HWIO) -> ``....Conv_0.weight`` (OIHW);
- ``.../Dense_0/kernel`` (``[in, out]``) -> ``....Dense_0.weight`` (``[out, in]``);
- ``.../Conv_0/bias``, ``.../Dense_0/bias`` -> ``....bias``;
- ``.../BatchNorm_0/bias`` (params), ``.../BatchNorm_0/mean|var``
  (batch_stats) -> ``....BatchNorm_0.bias|mean|var``.

Every source leaf is used exactly once; a leaf of any other name raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_RULES = {
    # (collection, layer, leaf) -> (torch leaf, transpose)
    ("params", "Conv_0", "kernel"): ("weight", (3, 2, 0, 1)),
    ("params", "Dense_0", "kernel"): ("weight", (1, 0)),
    ("params", "Conv_0", "bias"): ("bias", None),
    ("params", "Dense_0", "bias"): ("bias", None),
    ("params", "BatchNorm_0", "bias"): ("bias", None),
    ("batch_stats", "BatchNorm_0", "mean"): ("mean", None),
    ("batch_stats", "BatchNorm_0", "var"): ("var", None),
}


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
            rule = _RULES.get((collection, *path[-2:])) if len(path) >= 2 else None
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
