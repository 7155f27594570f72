"""Carry the JAX package's flax parameters into the port's modules.

A flax tree for FeedForwardActor/FeedForwardCritic looks like
`{"params": {"torso": {"Dense_0": {"kernel", "bias"}, ...}, "action_head": ...}}`
given as nested dicts of numpy arrays. The port names the same layers
`torso.dense.0.weight`, `action_head.dense.0.bias`, `torso.norm.0.weight`:

    Dense_i/kernel [in, out]  ->  dense.i.weight [out, in]   (transposed)
    Dense_i/bias              ->  dense.i.bias
    LayerNorm_i/scale         ->  norm.i.weight
    LayerNorm_i/bias          ->  norm.i.bias

The window actor and critic of ff_trans_ppo add named submodules, a
DenseGeneral and a leaf that is neither kernel, bias nor scale:

    TransformerTorso_0            ->  torso
    CategoricalHead_0             ->  action_head
    ScalarCriticHead_0            ->  critic_head
    block_i                       ->  blocks.i
    MultiHeadSelfAttention_0      ->  attention
    qkv/kernel [F, 3, H, D]       ->  qkv.weight [3.H.D, F]  (flattened, transposed)
    qkv/bias [3, H, D]            ->  qkv.bias [3.H.D]
    out/kernel, out/bias          ->  out.weight (transposed), out.bias
    positional_embedding          ->  positional_embedding

The continuous heads are two Denses under `action_head`: Dense_0 (the loc,
or alpha) and Dense_1 (the scale, or beta) become `action_head.dense.0` and
`action_head.dense.1`. The recurrent actor and critic keep flax's
attribute names (`pre_torso`, `rnn`, `post_torso`, `action_head`,
`critic_head`); ScannedRNN's cell, flax's `GRUCell_0` or `LSTMCell_0`, is
`rnn.cell`, and each gate keeps its flax name:

    GRUCell_0/{ir,iz,in}/{kernel,bias}, {hr,hz}/kernel, hn/{kernel,bias}
        ->  rnn.cell.{ir,iz,in,hr,hz,hn}.{weight,bias}
    LSTMCell_0/{ii,if,ig,io}/kernel, {hi,hf,hg,ho}/{kernel,bias}
        ->  rnn.cell.{ii,if,ig,io,hi,hf,hg,ho}.{weight,bias}

and likewise OptimizedLSTMCell_0 (the LSTM's gates), MGUCell_0 ({if,in}
with a bias, hf without, hn with) and SimpleCell_0 (i with a bias, h
without).

The dueling heads (networks/dueling.py) hold two torsos, flax's MLPTorso_i
or NoisyMLPTorso_i, as `torsos.i`; a noisy torso's NoisyLinear_j is
`layers.j`, whose leaves keep flax's names and layout:

    NoisyLinear_j/{mu_w,sigma_w} [in, out]  ->  layers.j.{mu_w,sigma_w} [in, out]
    NoisyLinear_j/{mu_b,sigma_b} [out]      ->  layers.j.{mu_b,sigma_b}

Any other module name is kept as it is (`torso`, `action_head`). The Q heads
(DiscreteQNetworkHead, DistributionalDiscreteQNetwork, QuantileDiscreteQNetwork)
are one Dense under `action_head` (`action_head.dense.0`); the distributional
ones reshape its A.M or N.A outputs in flax's row-major order, so the carried
weights need no reordering.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_NUMBERED = re.compile(r"^(Dense|LayerNorm|block|NoisyLinear|MLPTorso|NoisyMLPTorso)_(\d+)$")
_NUMBERED_PREFIX = {"Dense": "dense", "LayerNorm": "norm", "block": "blocks",
                    "NoisyLinear": "layers", "MLPTorso": "torsos", "NoisyMLPTorso": "torsos"}
_MODULE_NAME = {"TransformerTorso_0": "torso", "CategoricalHead_0": "action_head",
                "ScalarCriticHead_0": "critic_head", "MultiHeadSelfAttention_0": "attention",
                **{f"{cell}_0": "cell" for cell in ("GRUCell", "LSTMCell", "OptimizedLSTMCell",
                                                    "MGUCell", "SimpleCell")}}
_LEAF_NAME = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def _module_name(name: str) -> str:
    match = _NUMBERED.match(name)
    if match is not None:
        return f"{_NUMBERED_PREFIX[match.group(1)]}.{match.group(2)}"
    return _MODULE_NAME.get(name, name)


def flax_path_to_torch(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """Map one flax leaf path to (torch parameter name, is it a kernel?). A
    kernel is flattened to [in, out] and transposed to torch's [out, in]."""
    *modules, leaf = path
    name = ".".join([*(_module_name(m) for m in modules), _LEAF_NAME.get(leaf, leaf)])
    return name, leaf == "kernel"


def flax_leaf_to_torch(array: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    """One flax leaf in the layout of its torch parameter: a kernel
    [in, out...] becomes [out, in], a bias [out...] becomes [out]."""
    if path[-1] == "kernel":
        return array.reshape(array.shape[0], -1).T
    if path[-1] == "bias":
        return array.reshape(-1)
    return array


def _unwrap(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if set(tree) == {"params"} else tree


def load_flax_params(module: nn.Module, flax_params: Mapping[str, Any]) -> nn.Module:
    """Copy a flax parameter tree into `module`'s parameters, in place.

    Raises ValueError naming every missing key, extra key and wrong shape."""
    own = dict(module.named_parameters())
    incoming: Dict[str, np.ndarray] = {
        flax_path_to_torch(path)[0]: flax_leaf_to_torch(np.asarray(value), path)
        for path, value in _flatten(_unwrap(flax_params)).items()
    }
    errors = [f"missing flax parameter for {name}" for name in sorted(set(own) - set(incoming))]
    errors += [f"extra flax parameter {name}" for name in sorted(set(incoming) - set(own))]
    for name in sorted(set(own) & set(incoming)):
        if tuple(incoming[name].shape) != tuple(own[name].shape):
            errors.append(
                f"{name}: flax shape {incoming[name].shape} (in torch's layout) "
                f"!= torch shape {tuple(own[name].shape)}"
            )
    if errors:
        raise ValueError("flax params do not fit the module:\n  " + "\n  ".join(errors))
    with torch.no_grad():
        for name, param in own.items():
            value = torch.from_numpy(np.array(incoming[name], dtype=np.float32))
            param.copy_(value.to(param.dtype))
    return module
