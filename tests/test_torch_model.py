"""The port's causal decoder (pytorch_distributed_nn_tpu_torch/models)
against the JAX package's, on the CPU.

Both run GptTiny with the JAX model's parameters (the converter carries
them over), the JAX side with its Pallas LayerNorm and Pallas decode
attention in interpret mode. Tolerances: f32 logits and K/V at atol 1e-5
for one forward; 1e-4 across five teacher-forced decode steps, where the
two caches accumulate independent reduction-order differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.models import build_model as jax_build_model
from pytorch_distributed_nn_tpu.ops.pallas_kernels import (
    pallas_decode_attention,
)
from pytorch_distributed_nn_tpu.parallel.partitioning import unbox
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)


@pytest.fixture(scope="module")
def jax_model():
    m = jax_build_model("GptTiny", fused_ln=True,
                        decode_attn_fn=pallas_decode_attention)
    rng = jax.random.PRNGKey(0)
    variables = unbox(m.init({"params": rng, "dropout": rng},
                             jnp.zeros((1, 8), jnp.int32), train=False))
    params = jax.tree.map(np.asarray, variables["params"])
    # non-trivial LayerNorm params and biases: the converter must carry
    # every leaf, not only the random kernels
    rs = np.random.RandomState(0)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict)
                else (v + 0.05 * rs.randn(*v.shape)).astype(v.dtype)
                for k, v in tree.items()}

    return m, perturb(params)


@pytest.fixture(scope="module")
def torch_model(jax_model):
    _, params = jax_model
    model = build_model("GptTiny", fused_ln=True)
    model.load_state_dict(flax_to_state_dict(params))
    return model.eval()


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_converter_round_trip_is_exact(jax_model, torch_model):
    _, params = jax_model
    back = state_dict_to_flax(torch_model.state_dict(),
                              torch_model.config.num_heads)
    a, b = dict(_flat(params)), dict(_flat(back))
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key]), key
    # and the state_dict covers the port's module exactly (strict load)
    assert set(flax_to_state_dict(params)) == set(torch_model.state_dict())


def test_init_weights_follows_the_flax_scheme():
    m = build_model("GptTiny").init_weights(torch.Generator().manual_seed(0))
    sd = m.state_dict()
    assert torch.equal(sd["blocks.0.ln_attn.scale"], torch.ones(64))
    assert torch.equal(sd["lm_bias"], torch.zeros(256))
    assert abs(sd["token_embed.weight"].std().item() - 0.02) < 2e-3
    again = build_model("GptTiny").init_weights(
        torch.Generator().manual_seed(0))
    assert torch.equal(again.state_dict()["pos_embed"], sd["pos_embed"])


@pytest.mark.parametrize("B,L,pad", [(1, 8, 0), (2, 16, 5)])
def test_full_and_prefill_modes_match_jax(jax_model, torch_model, B, L, pad):
    m, params = jax_model
    rng = np.random.RandomState(L)
    tokens = rng.randint(0, 256, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[-1, L - pad:] = 0
    want = np.asarray(m.apply({"params": params}, jnp.asarray(tokens),
                              mask=jnp.asarray(mask)))
    want_kv_logits, want_kvs = m.apply(
        {"params": params}, jnp.asarray(tokens), mask=jnp.asarray(mask),
        return_kv=True)
    with torch.no_grad():
        t = torch.from_numpy(tokens).long()
        tm = torch.from_numpy(mask)
        got = torch_model(t, mask=tm)
        got_kv_logits, got_kvs = torch_model(t, mask=tm, return_kv=True)
    assert got.shape == (B, L, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got_kv_logits.numpy(),
                               np.asarray(want_kv_logits), atol=1e-5)
    assert len(got_kvs) == len(want_kvs) == 2
    for (gk, gv), (wk, wv) in zip(got_kvs, want_kvs):
        assert gk.shape == (B, L, 4, 16)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)


@pytest.mark.parametrize("B", [1, 2])
def test_teacher_forced_decode_matches_jax_cache(jax_model, torch_model, B):
    """Prefill a prompt into an S=32 cache on both sides, then five
    decode steps with the same forced tokens: logits stay within 1e-4
    and the port's decode equals its own full recompute."""
    m, params = jax_model
    S, P = 32, 6
    rng = np.random.RandomState(B)
    seq = rng.randint(1, 256, size=(B, P + 5)).astype(np.int32)
    _, jkvs = m.apply({"params": params}, jnp.asarray(seq[:, :P]),
                      return_kv=True)
    jcache = tuple(
        (jnp.zeros((B, S, 4, 16)).at[:, :P].set(k),
         jnp.zeros((B, S, 4, 16)).at[:, :P].set(v)) for k, v in jkvs)
    with torch.no_grad():
        _, tkvs = torch_model(torch.from_numpy(seq[:, :P]).long(),
                              return_kv=True)
        tcache = []
        for k, v in tkvs:
            kc, vc = torch.zeros(B, S, 4, 16), torch.zeros(B, S, 4, 16)
            kc[:, :P], vc[:, :P] = k, v
            tcache.append((kc, vc))
        full = torch_model(torch.from_numpy(seq).long()).numpy()
    jax_decode = jax.jit(lambda tok, cache, pos: m.apply(
        {"params": params}, tok[:, None], cache=cache, positions=pos))
    for step in range(5):
        pos = np.full((B,), P + step, np.int32)
        tok = seq[:, P + step]
        want, jcache = jax_decode(jnp.asarray(tok), jcache,
                                  jnp.asarray(pos))
        with torch.no_grad():
            got, tcache = torch_model(torch.from_numpy(tok).long()[:, None],
                                      cache=tuple(tcache),
                                      positions=torch.from_numpy(pos))
        assert got.shape == (B, 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(got.numpy(), full[:, P + step],
                                   atol=1e-5)


def test_bfloat16_config_runs_in_its_working_type():
    model = build_model("GptTiny", dtype="bfloat16").init_weights(
        torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():
        logits, kvs = model(torch.randint(0, 256, (1, 8)), return_kv=True)
    assert logits.dtype == torch.float32 and kvs[0][0].dtype == torch.bfloat16
    assert torch.isfinite(logits).all()
