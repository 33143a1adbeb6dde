"""The port's flash attention (pytorch_distributed_nn_tpu_torch/ops) against
the JAX package's Pallas flash kernels, on the CPU.

The port's wrappers run their plain versions here (CPU tensors); the
Pallas kernels run in interpret mode, as the JAX package's own tests run
them, with one block over the whole sequence as ``pallas_attention``
picks for L <= 512. Inputs come from ``np.random.RandomState`` and reach
both sides as numpy arrays. Tolerances, f32: forward out and lse at atol
1e-5 (both accumulate in f32 and differ in reduction order only); the
backward at atol 1e-4 against ``jax.vjp`` (dq/dk/dv sum up to L
products of O(1) terms, and the two sides' lse and delta differ in the
last bits first) and at 1e-5 plain-vs-Pallas on the same (out, lse,
dO). One bf16 case at atol 2e-2 on the outputs (bf16 keeps 8 bits) and
4e-2 on the gradients (those are rounded to bf16 too, up to a few units
in size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.ops.pallas_kernels import (
    _flash_backward,
    _flash_forward,
    pallas_attention,
)
from pytorch_distributed_nn_tpu_torch.ops import kernels, reference

B, H = 2, 2


def _inputs(L, D, seed, pad):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(4))
    mask = None
    if pad:
        mask = np.ones((B, L), np.int32)
        mask[-1, L - pad:] = 0  # every row keeps at least one key
    return q, k, v, do, mask


def _jmask(mask):
    return None if mask is None else jnp.asarray(mask)


def _tmask(mask):
    return None if mask is None else torch.from_numpy(mask)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("pad", [0, 5])
@pytest.mark.parametrize("L", [16, 64])
@pytest.mark.parametrize("D", [32, 64])
def test_flash_forward_matches_pallas(causal, pad, L, D):
    q, k, v, _, mask = _inputs(L, D, seed=L + D + pad, pad=pad)
    want_out, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _jmask(mask),
        causal, L, L)
    out, lse = kernels.flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)), _tmask(mask), causal)
    assert out.shape == (B, L, H, D) and lse.shape == (B, H, L)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(want_lse).reshape(B, H, L), atol=1e-5)


@pytest.mark.parametrize("causal,pad", [(False, 0), (True, 0), (False, 7),
                                        (True, 7)])
def test_flash_autograd_matches_jax_vjp(causal, pad):
    L, D = 64, 32
    q, k, v, do, mask = _inputs(L, D, seed=11 + pad, pad=pad)
    jm = _jmask(mask)
    out, vjp = jax.vjp(
        lambda a, b, c: pallas_attention(a, b, c, jm, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = kernels.flash_attention(*leaves, _tmask(mask), causal=causal)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5)
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("causal,pad,D", [(False, 0, 64), (True, 5, 32)])
def test_flash_backward_matches_pallas_backward(causal, pad, D):
    """The plain backward and ``_flash_backward`` on the same (out, lse,
    dO): the dq and dk/dv kernels' arithmetic alone."""
    L = 64
    q, k, v, do, mask = _inputs(L, D, seed=3 + D, pad=pad)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = _flash_forward(jq, jk, jv, _jmask(mask), causal, L, L)
    want = _flash_backward(jq, jk, jv, _jmask(mask), out, lse,
                           jnp.asarray(do), causal, L, L)
    got = reference.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v)), _tmask(mask),
        torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse).reshape(B, H, L)),
        torch.from_numpy(do), causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_flash_bfloat16_inputs():
    """bf16 q/k/v: outputs and gradients in bf16, p rounded to bf16 before
    P @ V and ds before ds @ K, as on the TPU."""
    L, D, causal = 64, 32, True
    q, k, v, do, _ = _inputs(L, D, seed=5, pad=0)
    jb = [jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: pallas_attention(a, b, c, None,
                                                        causal=causal), *jb)
    want = vjp(jnp.asarray(do).astype(jnp.bfloat16))
    leaves = [torch.from_numpy(t).to(torch.bfloat16).requires_grad_()
              for t in (q, k, v)]
    got = kernels.flash_attention(*leaves, None, causal=causal)
    got.backward(torch.from_numpy(do).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(out.astype(jnp.float32)),
                               atol=2e-2)
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=4e-2)


def test_flash_wrappers_count_no_launch_on_the_cpu():
    kernels.reset_launch_counts()
    q, k, v, do, mask = _inputs(16, 32, seed=0, pad=3)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    kernels.flash_attention(*leaves, _tmask(mask)).backward(
        torch.from_numpy(do))
    assert not any(kernels.launch_counts().values())
