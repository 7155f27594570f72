"""The Disco update rule (counterpart of stoix_tpu/systems/disco/update_rule.py):
per-step losses from targets for each of the agent's five heads, and a
meta-state that carries the EMA of the agent's params.

  * `DiscoUpdateRule` in two modes (`system.rule_mode`):
      - "grounded" (the default): one-step bootstrapped returns from the
        EMA target network, two-hot projected on the support for the
        executed action's q (the target's own q elsewhere), a standardised
        and clipped advantage on the target's logits for the policy, a
        two-hot of the target's value for y, and the target's z and aux_pi;
      - "meta": a meta-network (an LSTM run backward over time from a zero
        carry, five Dense heads) reads per-step features and emits every
        head's target logits.
    The loss is the KL of each (stop-gradient) target to the prediction,
    pi + q + y + 0.1 (z + aux_pi), per step; the targets come from the
    target network without gradient, and the new meta-state's EMA is taken
    from the params the loss is evaluated at (the pre-update ones).
  * `flatten_meta_params` / `load_meta_params`: the meta-params as the JAX
    package's npz layout (one array a pytree path, `params/meta_lstm/ii/kernel`,
    kernels [in, out]), so a file either package writes loads in the other.
    `load_meta_params` reads only a local path: without one, or when the file
    does not fit the meta-network, the rule keeps its random meta-params and
    says so (`pretrained` False). The port opens no network connection.

The support is `torch.linspace(-vmax, vmax, num_bins)`; XLA's `jnp.linspace`
sits some float32 ulps off it (ROADMAP C17).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from stoix_tpu_torch.networks.cells import LSTMCell, lecun_normal
from stoix_tpu_torch.networks.disco import DiscoAgentOutput
from stoix_tpu_torch.ops.losses import categorical_l2_project
from stoix_tpu_torch.search.mcts import fused_multiply_add
from stoix_tpu_torch.utils.training import incremental_update

Params = Dict[str, torch.Tensor]
# agent_unroll_fn(params, observations [T, E]) -> DiscoAgentOutput [T, E, ...]
UnrollFn = Callable[[Params, Any], DiscoAgentOutput]


def get_logger() -> logging.Logger:
    return logging.getLogger("stoix_tpu_torch.disco")


class UpdateRuleInputs(NamedTuple):
    """One minibatch of trajectories, time-major [T, E, ...]."""

    observations: Any
    actions: torch.Tensor  # [T, E]
    rewards: torch.Tensor  # [T - 1, E]
    is_terminal: torch.Tensor  # [T - 1, E]
    agent_out: DiscoAgentOutput  # the current params' outputs, [T, E, ...]
    behaviour_agent_out: DiscoAgentOutput  # the rollout's outputs


class MetaState(NamedTuple):
    target_params: Params  # the EMA of the agent's params (the bootstrap source)
    num_updates: torch.Tensor  # int32 scalar


class MetaNetwork(nn.Module):
    """The LSTM over the flipped time axis (flax's `meta_lstm`) and the five
    target heads, flax's Dense_0 to Dense_4 (`dense.i`; LeCun-normal
    kernels, zero biases): pi [A], q [A.B], y [B], z [A.B], aux_pi [A.A]."""

    def __init__(self, num_actions: int, num_bins: int, feature_dim: int, hidden_size: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_actions, self.num_bins = int(num_actions), int(num_bins)
        self.meta_lstm = LSTMCell(feature_dim, hidden_size, generator)
        a, b = self.num_actions, self.num_bins
        self.dense = nn.ModuleList()
        for width in (a, a * b, b, a * b, a * a):
            layer = lecun_normal(nn.Linear(hidden_size, width), generator)
            nn.init.zeros_(layer.bias)
            self.dense.append(layer)

    def forward(self, feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        t_len, batch = feats.shape[:2]
        hidden_size = self.meta_lstm.ii.out_features
        carry = LSTMCell.initialize_carry(hidden_size, (batch,), feats.device)
        hidden = [None] * t_len
        for step in reversed(range(t_len)):
            carry, hidden[step] = self.meta_lstm(carry, feats[step])
        h = torch.stack(hidden)  # [T, E, H]
        a, b = self.num_actions, self.num_bins
        pi, q, y, z, aux_pi = (layer(h) for layer in self.dense)
        return {"pi": pi, "q": q.reshape(t_len, batch, a, b), "y": y,
                "z": z.reshape(t_len, batch, a, b), "aux_pi": aux_pi.reshape(t_len, batch, a, a)}


def _kl(target_logits: torch.Tensor, pred_logits: torch.Tensor) -> torch.Tensor:
    """KL(softmax(target) || softmax(pred)) over the last axis."""
    t = torch.log_softmax(target_logits, -1)
    p = torch.log_softmax(pred_logits, -1)
    return torch.sum(torch.exp(t) * (t - p), -1)


def _detached(out: DiscoAgentOutput) -> DiscoAgentOutput:
    return DiscoAgentOutput(*(x.detach() for x in out))


class DiscoUpdateRule:
    """The rule's call surface: `init_params`, `init_meta_state` and
    `rule(meta_params, agent_params, inputs, hyperparams, meta_state,
    agent_unroll_fn) -> (loss_per_step [T, E], new_meta_state, logs)`."""

    def __init__(self, num_actions: int, num_bins: int = 51, vmax: float = 500.0,
                 mode: str = "grounded", meta_hidden_size: int = 128, target_ema: float = 0.99,
                 policy_temperature: float = 0.5, advantage_clip: float = 2.0,
                 device: Any = "cpu"):
        if mode not in ("grounded", "meta"):
            raise ValueError(f"unknown disco rule mode '{mode}'")
        self.num_actions = int(num_actions)
        self.num_bins = int(num_bins)
        self.vmax = float(vmax)
        self.mode = mode
        self.meta_hidden_size = int(meta_hidden_size)
        self.target_ema = float(target_ema)
        self.policy_temperature = float(policy_temperature)
        self.advantage_clip = float(advantage_clip)
        self.device = torch.device(device)
        self.support = torch.linspace(-self.vmax, self.vmax, self.num_bins, device=self.device)
        self.meta_net = MetaNetwork(self.num_actions, self.num_bins, self.feature_dim(),
                                    self.meta_hidden_size).to(self.device)

    def feature_dim(self) -> int:
        # reward, continuation, the action one-hot, the behaviour's and the
        # current policy's probabilities, E[q] per action (current and
        # target), E[y].
        return 2 + 5 * self.num_actions + 1

    def init_params(self, generator: torch.Generator) -> Params:
        """Random meta-params, drawn on the CPU from `generator`, on the rule's device."""
        net = MetaNetwork(self.num_actions, self.num_bins, self.feature_dim(),
                          self.meta_hidden_size, generator)
        return {k: v.detach().to(self.device) for k, v in net.named_parameters()}

    @staticmethod
    def init_meta_state(agent_params: Params) -> MetaState:
        device = next(iter(agent_params.values())).device
        return MetaState({k: v.detach().clone() for k, v in agent_params.items()},
                         torch.zeros((), dtype=torch.int32, device=device))

    def expected(self, logits: torch.Tensor) -> torch.Tensor:
        """E over the support of softmax(logits) (an einsum "...b,b->..." in JAX)."""
        return torch.sum(torch.softmax(logits, -1) * self.support, -1)

    def two_hot(self, values: torch.Tensor) -> torch.Tensor:
        """[..., B]: each value's unit mass projected on the support."""
        flat = values.reshape(-1, 1)
        return categorical_l2_project(flat, torch.ones_like(flat), self.support).reshape(
            tuple(values.shape) + (self.num_bins,))

    def __call__(self, meta_params: Params, agent_params: Params, inputs: UpdateRuleInputs,
                 hyperparams: Dict[str, Any], meta_state: MetaState, agent_unroll_fn: UnrollFn
                 ) -> Tuple[torch.Tensor, MetaState, Dict[str, torch.Tensor]]:
        gamma = float(hyperparams.get("gamma", 0.99))
        with torch.no_grad():
            target_out = agent_unroll_fn(meta_state.target_params, inputs.observations)
            if self.mode == "meta":
                targets = self.meta_targets(meta_params, inputs, target_out, gamma)
            else:
                targets = self.grounded_targets(inputs, target_out, gamma)
        pred = inputs.agent_out
        loss_pi = _kl(targets["pi"], pred.logits)
        loss_q = torch.sum(_kl(targets["q"], pred.q), -1)
        loss_y = _kl(targets["y"], pred.y)
        loss_z = torch.sum(_kl(targets["z"], pred.z), -1)
        loss_aux = torch.sum(_kl(targets["aux_pi"], pred.aux_pi), -1)
        loss_per_step = loss_pi + loss_q + loss_y + 0.1 * (loss_z + loss_aux)
        new_meta_state = MetaState(
            incremental_update(meta_state.target_params,
                               {k: v.detach() for k, v in agent_params.items()},
                               self.target_ema),
            meta_state.num_updates + 1)
        logs = {"loss_pi": torch.mean(loss_pi), "loss_q": torch.mean(loss_q),
                "loss_y": torch.mean(loss_y)}
        return loss_per_step, new_meta_state, logs

    # -- the targets ---------------------------------------------------------

    def meta_targets(self, meta_params: Params, inputs: UpdateRuleInputs,
                     target_out: DiscoAgentOutput, gamma: float) -> Dict[str, torch.Tensor]:
        """The meta-network's target logits from the per-step features."""
        current, behaviour = _detached(inputs.agent_out), inputs.behaviour_agent_out
        t_len, batch = current.logits.shape[:2]
        ones = torch.ones((1, batch), device=current.logits.device)
        cont = torch.cat([gamma * (1.0 - inputs.is_terminal.to(torch.float32)), ones], 0)
        rewards = torch.cat([inputs.rewards, torch.zeros_like(ones)], 0)
        feats = torch.cat([
            rewards[..., None], cont[..., None],
            F.one_hot(inputs.actions.long(), self.num_actions).to(torch.float32),
            torch.softmax(behaviour.logits, -1), torch.softmax(current.logits, -1),
            self.expected(current.q), self.expected(target_out.q),
            self.expected(current.y)[..., None],
        ], -1)
        return functional_call(self.meta_net, meta_params, (feats,))

    def grounded_targets(self, inputs: UpdateRuleInputs, target_out: DiscoAgentOutput,
                         gamma: float) -> Dict[str, torch.Tensor]:
        """Targets from the target network's predictions, in the heads' spaces."""
        pi_tgt = torch.softmax(target_out.logits, -1)  # [T, E, A]
        q_tgt_probs = torch.softmax(target_out.q, -1)  # [T, E, A, B]
        e_q_tgt = torch.sum(q_tgt_probs * self.support, -1)  # [T, E, A]
        v_tgt = torch.sum(pi_tgt * e_q_tgt, -1)  # [T, E]
        # G_t = r_t + gamma (1 - terminal) v_target(s_{t+1}), one fused
        # multiply-add as XLA contracts it; the last step bootstraps.
        cont = gamma * (1.0 - inputs.is_terminal.to(torch.float32))
        g = torch.cat([fused_multiply_add(cont, v_tgt[1:], inputs.rewards), v_tgt[-1:]], 0)
        action_mask = F.one_hot(inputs.actions.long(), self.num_actions).to(
            torch.float32)[..., None]  # [T, E, A, 1]
        q_target_probs = (action_mask * self.two_hot(g)[:, :, None, :]
                          + (1.0 - action_mask) * q_tgt_probs)
        # The advantage standardised (population std over the minibatch),
        # clipped, on the target's logits at the policy temperature.
        adv = e_q_tgt - v_tgt[..., None]
        adv = adv / (torch.std(adv, correction=0) + 1e-5)
        adv = torch.clamp(adv, -self.advantage_clip, self.advantage_clip)
        return {
            "pi": target_out.logits + adv / self.policy_temperature,
            "q": torch.log(q_target_probs + 1e-8),
            "y": torch.log(self.two_hot(v_tgt) + 1e-8),
            "z": target_out.z,
            "aux_pi": target_out.aux_pi,
        }


# -- the meta-params' npz layout --------------------------------------------


def _flax_key(name: str) -> Tuple[str, bool]:
    """(the JAX package's npz key of a meta-network param, is it a kernel?):
    `meta_lstm.ii.weight` -> `params/meta_lstm/ii/kernel`, `dense.3.bias` ->
    `params/Dense_3/bias`."""
    *modules, leaf = name.split(".")
    if modules[0] == "dense":
        modules = [f"Dense_{modules[1]}"] + modules[2:]
    kernel = leaf == "weight"
    return "/".join(["params", *modules, "kernel" if kernel else leaf]), kernel


def flatten_meta_params(params: Params) -> Dict[str, np.ndarray]:
    """Meta-params -> {npz key: array} in the JAX package's layout (kernels
    [in, out]); `np.savez(path, **flat)` writes the file."""
    flat = {}
    for name, value in params.items():
        key, kernel = _flax_key(name)
        array = value.detach().cpu().numpy()
        flat[key] = np.ascontiguousarray(array.T if kernel else array)
    return flat


def params_from_flat(flat: Dict[str, np.ndarray], template: Params) -> Params:
    """Meta-params from npz entries: every template param must be there in
    the JAX layout's shape (KeyError, ValueError otherwise); extra entries
    are ignored."""
    out = {}
    for name, leaf in template.items():
        key, kernel = _flax_key(name)
        if key not in flat:
            raise KeyError(f"weights file is missing parameter '{key}'")
        array = np.asarray(flat[key])
        want = tuple(leaf.shape[::-1]) if kernel else tuple(leaf.shape)
        if array.shape != want:
            raise ValueError(f"parameter '{key}' has shape {array.shape}, expected {want}")
        array = np.ascontiguousarray(array.T if kernel else array)
        out[name] = torch.from_numpy(array).to(dtype=leaf.dtype, device=leaf.device)
    return out


def load_meta_params(rule: DiscoUpdateRule, generator: torch.Generator,
                     local_path: Optional[str] = None) -> Tuple[Params, bool]:
    """(meta-params, pretrained): the npz at `local_path`, or the rule's
    random meta-params (drawn from `generator`) when there is no path or the
    file does not fit, with a warning. Only a local file is read."""
    template = rule.init_params(generator)
    if local_path is None:
        get_logger().warning("[disco] no system.meta_params_path: random meta-params "
                             "(use rule_mode=grounded for learning)")
        return template, False
    try:
        with open(local_path, "rb") as f:
            flat = dict(np.load(f))
        return params_from_flat(flat, template), True
    except Exception as exc:  # noqa: BLE001 - any read or layout failure falls back
        get_logger().warning("[disco] pretrained meta-params unavailable (%s: %s); falling back "
                             "to random init - use rule_mode=grounded for learning",
                             type(exc).__name__, exc)
        return template, False
