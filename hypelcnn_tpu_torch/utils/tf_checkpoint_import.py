"""Import the reference's TF ``model.ckpt-N`` checkpoints
(``hypelcnn_tpu/utils/tf_checkpoint_import.py``), read with numpy.

The reference trains classifiers (saved under the scopes ``nn_core``,
``global_step`` and ``training_optimizer``) and GAN generators (under
``Model[/ModelX2Y|/ModelY2X]/Generator``); the GRSS2013, GULFPORT-ALT and
AVON loaders declare such generator checkpoints for shadow augmentation.
``utils/tf_bundle.py`` reads them, where the JAX package calls
``tf.train.load_checkpoint``.

The two entry points fill a flax-shaped template, a nested dict of numpy
arrays named as the JAX package's variables, with every checkpoint leaf taken
at most once (``_Taken``):

  flax ``<scope>/Conv_0|Dense_0/kernel``  <- TF ``<scope>/weights``
  flax ``<scope>/.../bias``               <- TF ``<scope>/biases``
  flax ``<scope>/BatchNorm_0/bias``       <- TF ``<scope>/BatchNorm/beta``
  batch_stats ``mean``/``var``            <- ``moving_mean``/``moving_variance``
  directly-named flax layers (GAN nets)   <- same-scope ``weights``/``biases``

A fused multi-scale level (``fuse_level_convs``) takes each
``conv{k}x{k}_kernel`` from its branch conv, and its merged BatchNorm is the
ascending-k concatenation of the branches' BatchNorm vectors; CAP's
``DigitCaps`` per-capsule 1x1 convs stack into ``digitcaps_w``/``_b``.
Optimizer slots and ``global_step`` are not read.

``import_classifier_state_dict`` and ``import_gan_generator_state_dict`` do
the same for a port module: its ``state_dict`` goes to the flax-shaped
template through ``compat/flax_to_torch.py`` and back.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from hypelcnn_tpu_torch.compat.flax_to_torch import flax_variables, variables_to_state_dict
from hypelcnn_tpu_torch.utils.tf_bundle import load_checkpoint

_BN_LEAF = {"bias": "beta", "scale": "gamma",
            "mean": "moving_mean", "var": "moving_variance"}
_LIN_LEAF = {"kernel": "weights", "bias": "biases"}
_FUSED_KERNEL = re.compile(r"^(conv\d+x\d+)_kernel$")
_FUSED_BIAS = re.compile(r"^(conv\d+x\d+)_bias$")


def load_tf_checkpoint_values(ckpt_prefix: str) -> Dict[str, np.ndarray]:
    """Every variable of a TF checkpoint (a ``model.ckpt-N`` prefix or a
    directory holding a ``checkpoint`` state file) as numpy arrays."""
    reader = load_checkpoint(ckpt_prefix)
    return {name: reader.get_tensor(name) for name in reader.variable_to_shape_map()}


class _Taken:
    """Tracks which checkpoint variables were consumed."""

    def __init__(self, values: Dict[str, np.ndarray]):
        self.values = values
        self.used: set = set()

    def take(self, name: str, like: np.ndarray) -> np.ndarray:
        if name not in self.values:
            raise KeyError(f"checkpoint has no variable {name!r} "
                           f"(needed for a leaf of shape {like.shape})")
        val = np.asarray(self.values[name])
        if val.shape != tuple(like.shape):
            raise ValueError(f"{name}: checkpoint shape {val.shape} != "
                             f"template shape {tuple(like.shape)}")
        self.used.add(name)
        return val


def _fill_fused(module_tree: dict, scope_base: str, taken: _Taken) -> dict:
    """Fill a FusedMultiScaleLevel subtree from per-branch TF variables.

    ``scope_base`` is the TF prefix up to and including the level base name
    (e.g. ``nn_core/connector_0``); branch convs live at
    ``{scope_base}_conv{k}x{k}``.
    """
    out: dict = {}
    # branch kernel sizes come from the CHECKPOINT's own variable names so
    # a batch_stats tree (which holds only the merged BatchNorm) fuses too
    branch_pat = re.compile(re.escape(scope_base) + r"_conv(\d+)x(\d+)/")
    ks = sorted({int(m.group(1)) for name in taken.values
                 if (m := branch_pat.match(name))})
    for key, leaf in module_tree.items():
        if (m := _FUSED_KERNEL.match(key)):
            out[key] = taken.take(f"{scope_base}_{m.group(1)}/weights", leaf)
        elif (m := _FUSED_BIAS.match(key)):
            out[key] = taken.take(f"{scope_base}_{m.group(1)}/biases", leaf)
        elif key == "BatchNorm_0":
            sub = {}
            for bn_leaf, arr in leaf.items():
                tf_leaf = _BN_LEAF[bn_leaf]
                parts = [_take_bn_branch(taken, scope_base, k, tf_leaf)
                         for k in sorted(ks)]
                merged = np.concatenate(parts)
                if merged.shape != tuple(arr.shape):
                    raise ValueError(
                        f"{scope_base} fused BatchNorm {bn_leaf}: concat "
                        f"shape {merged.shape} != template {tuple(arr.shape)}")
                sub[bn_leaf] = merged
            out[key] = sub
        else:
            raise KeyError(f"unexpected fused-level key {key!r}")
    return out


def _take_bn_branch(taken: _Taken, scope_base: str, k: int, tf_leaf: str
                    ) -> np.ndarray:
    name = f"{scope_base}_conv{k}x{k}/BatchNorm/{tf_leaf}"
    if name not in taken.values:
        raise KeyError(f"checkpoint has no variable {name!r}")
    taken.used.add(name)
    return np.asarray(taken.values[name])


def _fill_tree(tree: dict, scope: str, taken: _Taken) -> dict:
    out: dict = {}
    for key, sub in tree.items():
        if key in ("Conv_0", "Dense_0"):
            out[key] = {leaf: taken.take(f"{scope}/{_LIN_LEAF[leaf]}", arr)
                        for leaf, arr in sub.items()}
        elif key == "BatchNorm_0":
            out[key] = {leaf: taken.take(f"{scope}/BatchNorm/{_BN_LEAF[leaf]}", arr)
                        for leaf, arr in sub.items()}
        elif isinstance(sub, dict):
            if key.endswith("_fused"):
                out[key] = _fill_fused(sub, f"{scope}/{key[:-len('_fused')]}",
                                       taken)
            else:
                out[key] = _fill_tree(sub, f"{scope}/{key}", taken)
        else:  # directly-named flax layer leaf (GAN convs: net1/kernel)
            out[key] = taken.take(f"{scope}/{_LIN_LEAF.get(key, key)}", sub)
    return out


def _cap_special_fill(params: dict, taken: _Taken, scope: str) -> dict:
    """CAP's DigitCaps per-capsule 1x1 convs, stacked into the fused
    ``digitcaps_w``/``digitcaps_b``."""
    out = dict(params)
    data_size = params["digitcaps_w"].shape[0]
    out["digitcaps_w"] = np.stack(
        [taken.take(f"{scope}/DigitCaps_layer/DigitCaps_layer_w_{i}/weights",
                    np.zeros((1, 1) + tuple(params["digitcaps_w"].shape[1:]),
                             np.float32))[0, 0]
         for i in range(data_size)])
    out["digitcaps_b"] = np.stack(
        [taken.take(f"{scope}/DigitCaps_layer/DigitCaps_layer_w_{i}/biases",
                    params["digitcaps_b"][i])
         for i in range(data_size)])
    rest = {k: v for k, v in params.items()
            if k not in ("digitcaps_w", "digitcaps_b")}
    out.update(_fill_tree(rest, scope, taken))
    return out


def import_classifier_variables(variables: dict, ckpt_path: str,
                                scope: str = "nn_core") -> dict:
    """Fill a classifier's ``{"params", "batch_stats"}`` template from a
    reference checkpoint.

    The template decides what is read: an inference template (no decoder
    heads) simply skips the ``image_gen_net_*`` variables; optimizer slots
    and ``global_step`` in the checkpoint are ignored.
    """
    values = load_tf_checkpoint_values(ckpt_path)
    taken = _Taken(values)
    params = dict(variables["params"])
    if "digitcaps_w" in params:
        filled_params = _cap_special_fill(params, taken, scope)
    else:
        filled_params = _fill_tree(params, scope, taken)
    out = {"params": filled_params}
    if "batch_stats" in variables:
        out["batch_stats"] = _fill_tree(dict(variables["batch_stats"]),
                                        scope, taken)
    return out


# GAN type -> (template param path) -> TF scope prefix of that generator:
# the one-direction families save under Model/Generator (CUT too), the
# two-direction ones under Model/ModelX2Y|ModelY2X/Generator.
GAN_GENERATOR_SCOPES: Dict[str, Dict[tuple, str]] = {
    "gan_x2y": {("generator",): "Model/Generator"},
    "gan_y2x": {("generator",): "Model/Generator"},
    "cycle_gan": {("gen_x2y",): "Model/ModelX2Y/Generator",
                  ("gen_y2x",): "Model/ModelY2X/Generator"},
    "cut_x2y": {("gen",): "Model/Generator"},
    "cut_y2x": {("gen",): "Model/Generator"},
    "dcl_gan": {("x2y", "gen"): "Model/ModelX2Y/Generator",
                ("y2x", "gen"): "Model/ModelY2X/Generator"},
    "dcl_cycle_gan": {("x2y", "gen"): "Model/ModelX2Y/Generator",
                      ("y2x", "gen"): "Model/ModelY2X/Generator"},
}


def import_gan_generator_params(gan_type: str, template_params: dict,
                                ckpt_path: str,
                                values: Optional[Dict[str, np.ndarray]] = None
                                ) -> dict:
    """Fill the generator entries of a GAN trainer's param template from a
    reference checkpoint; discriminator and feature-discriminator entries
    keep their template values (the reference's own generator restorer is
    generator-only)."""
    if gan_type not in GAN_GENERATOR_SCOPES:
        raise KeyError(f"unknown gan type {gan_type!r}; expected one of "
                       f"{sorted(GAN_GENERATOR_SCOPES)}")
    if values is None:
        values = load_tf_checkpoint_values(ckpt_path)
    taken = _Taken(values)

    def fill_at(tree: dict, path: tuple, scope: str) -> dict:
        key, rest = path[0], path[1:]
        sub = dict(tree)
        if rest:
            sub[key] = fill_at(sub[key], rest, scope)
        else:
            sub[key] = _fill_tree(dict(sub[key]), scope, taken)
        return sub

    out = dict(template_params)
    for path, scope in GAN_GENERATOR_SCOPES[gan_type].items():
        out = fill_at(out, path, scope)
    return out


def is_tf_checkpoint(path: str) -> bool:
    """True when ``path`` points at a TF checkpoint prefix or directory (an
    ``.index`` beside it or a ``checkpoint`` state file) rather than a
    params snapshot directory."""
    if os.path.isfile(path + ".index"):
        return True
    return os.path.isdir(path) and os.path.isfile(
        os.path.join(path, "checkpoint"))


def import_classifier_state_dict(module: torch.nn.Module, ckpt_path: str,
                                 scope: str = "nn_core") -> Dict[str, torch.Tensor]:
    """``module``'s ``state_dict`` with every entry from a reference classifier
    checkpoint."""
    params, batch_stats = flax_variables(module.state_dict())
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    filled = import_classifier_variables(variables, ckpt_path, scope)
    return variables_to_state_dict(filled["params"], filled.get("batch_stats"))


def import_gan_generator_state_dict(gan_type: str, nets: torch.nn.Module, ckpt_path: str,
                                    values: Optional[Dict[str, np.ndarray]] = None
                                    ) -> Dict[str, torch.Tensor]:
    """A GAN trainer's networks' ``state_dict`` with its generators from a
    reference checkpoint and the other networks as they are."""
    params, _ = flax_variables(nets.state_dict())
    return variables_to_state_dict(import_gan_generator_params(gan_type, params, ckpt_path,
                                                               values))
