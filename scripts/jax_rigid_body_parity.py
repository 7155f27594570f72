#!/usr/bin/env python3
"""How far one control step of the port's rigid-body engine lies from the JAX
package's, beside how far two XLA compilations of the JAX engine lie from
each other, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_rigid_body_parity.py [--envs 32] [--steps 41]

For each robot (Ant, Hopper, Walker2d, HalfCheetah) the JAX env runs a
random-action trajectory from its reset; every fourth state, one control
step is taken three ways: the JAX engine's `step` (its 16 substeps under
`lax.scan`, as the env compiles it), the same 16 substeps as 16 calls of a
separately jitted `_substep`, and the port's `rigid_body.step` from the same
state. Each field's error is reported as the largest |error| / (rtol |x| +
atol max|x|) over the envs and bodies (1.0 is the bound's edge), at the
bound (rtol 1e-5, atol 1e-6 of the field's scale) and at (1e-5, 1e-5). Also
the 27/11/17/17-wide observation of the next state (the JAX `_observe` of
the port's bodies). Prints one JSON object.

XLA rounds the engine's float32 arithmetic in ways that depend on how it
fuses and vectorises each program (a multiply feeding an add becomes one
fused multiply-add in some vector lanes and not in others), so the two JAX
compilations differ by a few ulps a substep, which the stiff joint springs
carry into the velocities over 16 substeps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stoix_tpu.envs import locomotion as jax_locomotion  # noqa: E402
from stoix_tpu.envs import rigid_body as jax_rigid_body  # noqa: E402
from stoix_tpu.envs.locomotion import LocoState  # noqa: E402
from stoix_tpu_torch.envs import locomotion, rigid_body  # noqa: E402


def ratio(want, got, atol_scale: float) -> float:
    want, got = np.asarray(want), np.asarray(got)
    bound = 1e-5 * np.abs(want) + atol_scale * np.abs(want).max()
    return float((np.abs(want - got) / bound).max())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--envs", type=int, default=32)
    parser.add_argument("--steps", type=int, default=41)
    args = parser.parse_args()
    torch.set_num_threads(1)
    out = {}
    for name in ("Ant", "Hopper", "Walker2d", "HalfCheetah"):
        jenv, env = getattr(jax_locomotion, name)(), getattr(locomotion, name)()
        sys_j, sys_p, nj = jenv._sys, env._system(torch.device("cpu")), jenv._sys.num_joints
        scan_step = jax.jit(jax.vmap(lambda s, a: jax_rigid_body.step(sys_j, s, a)))
        substep = jax.jit(jax.vmap(lambda s, a: jax_rigid_body._substep(sys_j, s, a)))
        observe = jax.jit(jax.vmap(jenv._observe))
        env_step = jax.jit(jax.vmap(jenv.step))
        state, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), args.envs))
        rng = np.random.default_rng(1)
        worst = {}
        for i in range(args.steps):
            action = rng.uniform(-1, 1, (args.envs, nj)).astype(np.float32)
            if i % 4 == 0:
                want = scan_step(state.body, jnp.asarray(action))
                other = state.body
                for _ in range(sys_j.substeps):
                    other = substep(other, jnp.asarray(action))
                port = rigid_body.step(sys_p, rigid_body.RigidBodyState(
                    *(torch.from_numpy(np.array(x)) for x in state.body)), torch.from_numpy(action))
                port = jax_rigid_body.RigidBodyState(*(jnp.asarray(x.numpy()) for x in port))
                for label, got in (("port", port), ("jax_substeps", other)):
                    for atol, tag in ((1e-6, "atol_1e-6"), (1e-5, "atol_1e-5")):
                        for field, x, y in zip(want._fields, want, got):
                            key = f"{label}/{tag}/{field}"
                            worst[key] = max(worst.get(key, 0.0), ratio(x, y, atol))
                        obs = [observe(LocoState(state.key, b, state.step_count + 1)).agent_view
                               for b in (want, got)]
                        key = f"{label}/{tag}/observation"
                        worst[key] = max(worst.get(key, 0.0), ratio(obs[0], obs[1], atol))
            state, _ = env_step(state, jnp.asarray(action))
        out[name] = worst
    print(json.dumps(out))


if __name__ == "__main__":
    main()
