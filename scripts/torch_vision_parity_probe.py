#!/usr/bin/env python3
"""Where the card and the CPU part on a conv ff_ppo update, on one CUDA card:

    python3 scripts/torch_vision_parity_probe.py [--out chiprun_out/parity_probe.json]

For cnn_atari (84x84x4 pixel Breakout) and visual_resnet (Breakout-minatar)
at 32 envs, TF32 off: a rollout on the card, then the same update on the
card and on the CPU (chip_smoke.py's vision_parity, without its bars) under
cuDNN's default algorithms, `cudnn.deterministic` and cuDNN off, over a
whole update (4 epochs x 4 minibatches) and over one Adam step: every
minibatch's losses relative to the CPU's, the params' absolute difference,
and one minibatch's gradients, each tensor's largest difference over its
scale and the elements whose sign differs where the CPU's exceeds 1e-5.
Prints one JSON line a case and writes them all to --out.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from stoix_tpu_torch import envs  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo  # noqa: E402
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps  # noqa: E402
from stoix_tpu_torch.utils.tree import tree_map, tree_merge_leading_dims  # noqa: E402


def run(overrides, extra):
    config = check_total_timesteps(cs.compose(overrides + extra + [
        "arch.total_num_envs=32", *cs.VISION_COMMON], cs.PPO_ROOT), 1)
    seed = int(config.arch.seed)
    setups = {side: ff_ppo.learner_setup(envs.make(config)[0], config, torch.device(side), seed)
              for side in ("cuda", "cpu")}
    card = setups["cuda"]
    torch.manual_seed(0)
    state, traj = card.learn.rollout(card.learner_state)
    n = int(config.system.rollout_length) * 32
    perms = [torch.randperm(n, generator=torch.Generator().manual_seed(e))
             for e in range(int(config.system.epochs))]
    res = {}
    for side, setup in setups.items():
        mv = (lambda x: x) if side == "cuda" else (lambda x: x.cpu())
        res[side] = setup.learn.update(tree_map(mv, state.params), tree_map(mv, state.opt_states),
                                       tree_map(mv, traj), permutations=[p.to(side) for p in perms])
    got, want = res["cuda"], res["cpu"]
    losses = {k: ((got.loss_info[k].cpu() - want.loss_info[k]).abs()
                  / want.loss_info[k].abs().clamp_min(1e-30)).reshape(-1).tolist()
              for k in ("actor_loss", "value_loss", "entropy")}
    # One minibatch's gradients from the same inputs (the card's advantages).
    learn = {s: setups[s].learn for s in setups}
    samples = (learn["cuda"].policy_input(traj), traj.action, traj.log_prob, traj.value,
               got.advantages, got.targets)
    flat = tree_merge_leading_dims(samples, 2)
    batch = tree_map(lambda x: x[:128], flat)
    grads = {}
    for side in ("cuda", "cpu"):
        mv = (lambda x: x) if side == "cuda" else (lambda x: x.cpu())
        p = tree_map(mv, state.params)
        grads[side] = learn[side].gradients(p, tree_map(mv, batch), p.actor_params, None)
    gerr = {}
    for part in (0, 1):
        for k, g in grads["cpu"][part].items():
            c = grads["cuda"][part][k].cpu()
            scale = float(g.abs().max())
            flips = int(((c.sign() != g.sign()) & (g.abs() > 1e-5)).sum())
            gerr[f"{part}:{k}"] = [float((c - g).abs().max()) / max(scale, 1e-30), scale, flips]
    return {"loss_rel_err_per_minibatch": losses,
            "params_abs_err": cs._max_err(got.params, want.params),
            "grad_rel_to_scale_err_scale_flips": gerr}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="chiprun_out/parity_probe.json")
    args = parser.parse_args()
    cs.phase_device()
    out = {}
    for label, overrides in (("cnn_atari", cs.PIXEL),
                             ("visual_resnet", ["env=breakout_jax", "network=visual_resnet"])):
        for mode in ("default", "deterministic", "no_cudnn"):
            torch.backends.cudnn.deterministic = mode == "deterministic"
            torch.backends.cudnn.enabled = mode != "no_cudnn"
            for steps, extra in (("16_steps", []),
                                 ("1_step", ["system.epochs=1", "system.num_minibatches=1"])):
                key = f"{label}/{mode}/{steps}"
                out[key] = run(overrides, extra)
                print(json.dumps({key: out[key]}), flush=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled = False, True
    with open(args.out, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
