"""Carry the JAX package's flax parameters into the port's modules.

A flax tree for FeedForwardActor/FeedForwardCritic looks like
`{"params": {"torso": {"Dense_0": {"kernel", "bias"}, ...}, "action_head": ...}}`
given as nested dicts of numpy arrays. The port names the same layers
`torso.dense.0.weight`, `action_head.dense.0.bias`, `torso.norm.0.weight`:

    Dense_i/kernel [in, out]  ->  dense.i.weight [out, in]   (transposed)
    Dense_i/bias              ->  dense.i.bias
    LayerNorm_i/scale         ->  norm.i.weight
    LayerNorm_i/bias          ->  norm.i.bias
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LAYER = re.compile(r"^(Dense|LayerNorm)_(\d+)$")
_LAYER_PREFIX = {"Dense": "dense", "LayerNorm": "norm"}
_LEAF_NAME = {("Dense", "kernel"): "weight", ("Dense", "bias"): "bias",
              ("LayerNorm", "scale"): "weight", ("LayerNorm", "bias"): "bias"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def flax_path_to_torch(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """Map one flax leaf path to (torch parameter name, transpose?)."""
    *modules, layer, leaf = path
    match = _LAYER.match(layer)
    if match is None or (match.group(1), leaf) not in _LEAF_NAME:
        raise KeyError(f"no torch counterpart for flax parameter {'/'.join(path)}")
    kind, index = match.group(1), match.group(2)
    name = ".".join([*modules, _LAYER_PREFIX[kind], index, _LEAF_NAME[(kind, leaf)]])
    return name, (kind == "Dense" and leaf == "kernel")


def _unwrap(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if set(tree) == {"params"} else tree


def load_flax_params(module: nn.Module, flax_params: Mapping[str, Any]) -> nn.Module:
    """Copy a flax parameter tree into `module`'s parameters, in place.

    Raises ValueError naming every missing key, extra key and wrong shape."""
    own = dict(module.named_parameters())
    incoming: Dict[str, np.ndarray] = {}
    errors = []
    for path, value in _flatten(_unwrap(flax_params)).items():
        try:
            name, transpose = flax_path_to_torch(path)
        except KeyError as err:
            errors.append(str(err.args[0]))
            continue
        array = np.asarray(value)
        incoming[name] = array.T if transpose else array
    errors += [f"missing flax parameter for {name}" for name in sorted(set(own) - set(incoming))]
    errors += [f"extra flax parameter {name}" for name in sorted(set(incoming) - set(own))]
    for name in sorted(set(own) & set(incoming)):
        if tuple(incoming[name].shape) != tuple(own[name].shape):
            errors.append(
                f"{name}: flax shape {incoming[name].shape} (after transpose) "
                f"!= torch shape {tuple(own[name].shape)}"
            )
    if errors:
        raise ValueError("flax params do not fit the module:\n  " + "\n  ".join(errors))
    with torch.no_grad():
        for name, param in own.items():
            value = torch.from_numpy(np.array(incoming[name], dtype=np.float32))
            param.copy_(value.to(param.dtype))
    return module
