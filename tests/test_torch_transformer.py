"""The port's transformer torso and ff_trans_ppo's window actor and critic
against the JAX package's flax modules, with the SAME parameters carried across
by utils/params.py::load_flax_params; its causality, its inits and the
loader's transformer paths.

Tolerance: 1e-5 relative (1e-6 absolute floor) in float32: the matmuls,
softmax and LayerNorm statistics reduce in another order than XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.networks.attention import TransformerTorso as JaxTransformerTorso
from stoix_tpu_torch.networks.attention import MultiHeadSelfAttention, TransformerTorso
from stoix_tpu_torch.ops import flash_attention
from stoix_tpu_torch.utils.params import load_flax_params
from torch_parity import n, paired_window_networks, t, to_flax_params

RTOL, ATOL = 1e-5, 1e-6
TORSO = dict(num_layers=2, num_heads=2, head_dim=8, ffn_dim=32)


def _paired_torso(input_dim=5, max_timesteps=16, seed=1, **torch_kwargs):
    jnet = JaxTransformerTorso(**TORSO, max_timesteps=max_timesteps)
    x = jnp.zeros((1, max_timesteps, input_dim))
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(seed), x))
    tnet = TransformerTorso(input_dim, **TORSO, max_timesteps=max_timesteps, **torch_kwargs)
    return jnet, params, load_flax_params(tnet, params)


@pytest.mark.parametrize("seq", [16, 7])
def test_torso_matches_flax(seq):
    jnet, params, tnet = _paired_torso()
    x = np.random.default_rng(seq).normal(size=(3, seq, 5)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = n(tnet(t(x)))
    assert got.shape == (3, seq, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_torso_through_the_flash_kernel_matches_flax():
    # attention_fn hook: the plain version of kernel B2 on the CPU.
    jnet, params, tnet = _paired_torso(attention_fn=flash_attention)
    x = np.random.default_rng(2).normal(size=(4, 16, 5)).astype(np.float32)
    with torch.no_grad():
        got = n(tnet(t(x)))
    np.testing.assert_allclose(got, np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_causality():
    # tests/test_attention.py::test_causality on the port: perturb the
    # future, the past must not change.
    _, _, tnet = _paired_torso()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16, 5)).astype(np.float32))
    x2 = x.clone()
    x2[:, 10:] += 3.0
    with torch.no_grad():
        out, out2 = n(tnet(x)), n(tnet(x2))
    np.testing.assert_allclose(out[:, :10], out2[:, :10], rtol=1e-5, atol=1e-5)
    assert not np.allclose(out[:, 10:], out2[:, 10:])


@pytest.mark.parametrize("lead", [(6,), (3, 2)])
def test_window_actor_and_critic_match_flax(lead):
    ja, jap, jc, jcp, ta, tc = paired_window_networks(6, 3, window=4, seed=3)
    ctx = np.random.default_rng(4).normal(size=lead + (4, 6)).astype(np.float32)
    ctx[..., :2, :] = 0.0  # zero padding, attended to as in the JAX package
    with torch.no_grad():
        got_logits, got_values = n(ta(t(ctx)).logits), n(tc(t(ctx)))
    assert got_logits.shape == lead + (3,) and got_values.shape == lead
    want_logits = jax.jit(lambda p, x: ja.apply(p, x).logits)(jap, jnp.asarray(ctx))
    np.testing.assert_allclose(got_logits, np.asarray(want_logits), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_values, np.asarray(jax.jit(jc.apply)(jcp, jnp.asarray(ctx))),
                               rtol=RTOL, atol=ATOL)


def test_loader_carries_the_window_tree_and_round_trips():
    _, jap, _, jcp, ta, tc = paired_window_networks(6, 3, window=4)
    block = jap["params"]["TransformerTorso_0"]["block_1"]["MultiHeadSelfAttention_0"]
    qkv = dict(ta.named_parameters())["torso.blocks.1.attention.qkv.weight"]
    np.testing.assert_array_equal(n(qkv), block["qkv"]["kernel"].reshape(16, 48).T)
    torso = jap["params"]["TransformerTorso_0"]
    np.testing.assert_array_equal(n(ta.torso.positional_embedding), torso["positional_embedding"])
    for module, flax_tree in ((ta, jap), (tc, jcp)):
        back = to_flax_params(dict(module.named_parameters()), flax_tree)
        jax.tree.map(np.testing.assert_array_equal, back, flax_tree)
    assert "critic_head.dense.0.weight" in dict(tc.named_parameters())


def test_loader_raises_on_missing_extra_and_misshapen_transformer_keys():
    _, jap, _, _, ta, _ = paired_window_networks(6, 3, window=4)

    def edited(edit):
        tree = jax.tree.map(lambda x: x, jap)  # a copy of the nested dicts
        edit(tree["params"]["TransformerTorso_0"])
        return tree

    missing = edited(lambda torso: torso["block_0"]["MultiHeadSelfAttention_0"].pop("qkv"))
    missing_qkv = r"missing flax parameter for torso\.blocks\.0\.attention\.qkv"
    with pytest.raises(ValueError, match=missing_qkv):
        load_flax_params(ta, missing)
    extra = edited(lambda torso: torso.update(block_2=torso["block_1"]))
    with pytest.raises(ValueError, match=r"extra flax parameter torso\.blocks\.2"):
        load_flax_params(ta, extra)
    wrong = edited(lambda torso: torso.update(positional_embedding=np.zeros((8, 16), np.float32)))
    with pytest.raises(ValueError, match="torso.positional_embedding: flax shape"):
        load_flax_params(ta, wrong)


def test_inits_follow_flax():
    gen = torch.Generator().manual_seed(0)
    attention = MultiHeadSelfAttention(16, num_heads=2, head_dim=8, generator=gen)
    # The qkv kernel [F, 3, H, D] is orthogonal as an [F.3.H, D] matrix (flax's
    # column axis -1): its D columns are orthonormal.
    kernel = attention.qkv.weight.detach().T.reshape(16 * 3 * 2, 8)
    np.testing.assert_allclose(n(kernel.T @ kernel), np.eye(8), atol=1e-5)
    assert torch.count_nonzero(attention.qkv.bias) == 0
    out = attention.out.weight.detach()
    np.testing.assert_allclose(n(out @ out.T), np.eye(16), atol=1e-5)
    torso = TransformerTorso(5, **TORSO, max_timesteps=512, generator=gen)
    ffn = torso.blocks[0].dense[0].weight.detach()  # [32, 16]: orthonormal columns x sqrt 2
    np.testing.assert_allclose(n(ffn.T @ ffn), 2.0 * np.eye(16), atol=1e-5)
    assert abs(float(torso.positional_embedding.detach().std()) - 0.02) < 2e-3
    assert torso.norm[0].eps == 1e-6 and torso.blocks[1].norm[1].eps == 1e-6
