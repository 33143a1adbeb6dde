"""The port's kernels (pytorch_distributed_nn_tpu_torch/ops) against the
JAX package's Pallas kernels, on the CPU.

Here the wrappers run their plain versions (CPU tensors); the Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
Inputs come from ``np.random.RandomState`` and reach both sides as numpy
arrays. Tolerances: f32 forwards at atol 1e-5 — both sides accumulate in
f32 and differ only in reduction order; the LayerNorm backward at 1e-4
(dgamma/dbeta sum up to N rows, dx subtracts two row means), dx from a
bf16 input at 1e-2 (it is rounded to bf16, 8 bits). The CUDA kernels themselves are
held against the same plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.ops.pallas_kernels import (
    _ln_fwd_call,
    fused_layer_norm,
    pallas_decode_attention,
)
from pytorch_distributed_nn_tpu_torch.ops import kernels, reference

H, D = 4, 32  # GptMini's heads


def _attn_inputs(B, S, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, H, D).astype(dtype)
    k = rng.randn(B, S, H, D).astype(dtype)
    v = rng.randn(B, S, H, D).astype(dtype)
    pos = rng.randint(0, S, size=B).astype(np.int32)
    pos[0] = 0
    pos[-1] = S - 1
    return q, k, v, pos


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", [16, 32, 64, 128])
def test_decode_attention_matches_pallas(S, B):
    q, k, v, pos = _attn_inputs(B, S, seed=S + B)
    want = np.asarray(pallas_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)))
    got = kernels.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos))
    assert got.shape == (B, 1, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_decode_attention_masks_dead_rows():
    """Rows past a sequence's position never reach the output: garbage
    there (other requests' stale pages) changes nothing."""
    q, k, v, _ = _attn_inputs(2, 32, seed=5)
    pos = np.asarray([4, 20], np.int32)
    base = reference.decode_attention(*map(torch.from_numpy, (q, k, v, pos)))
    k2, v2 = k.copy(), v.copy()
    k2[0, 5:], v2[0, 5:] = 1e3, -1e3
    k2[1, 21:], v2[1, 21:] = -1e3, 1e3
    again = reference.decode_attention(
        *map(torch.from_numpy, (q, k2, v2, pos)))
    assert torch.equal(base, again)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,Dm", [(16, 128), (300, 128), (7, 96), (33, 200)])
def test_layer_norm_matches_pallas(N, Dm, in_dtype):
    rng = np.random.RandomState(N + Dm)
    x = (rng.randn(N, Dm) * 3 + 1).astype(np.float32)
    g = (1 + 0.1 * rng.randn(Dm)).astype(np.float32)
    b = (0.1 * rng.randn(Dm)).astype(np.float32)
    jdt = jnp.bfloat16 if in_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if in_dtype == "bfloat16" else torch.float32
    want = np.asarray(fused_layer_norm(
        jnp.asarray(x).astype(jdt), jnp.asarray(g), jnp.asarray(b), 1e-6,
        out_dtype=jnp.float32))
    got = kernels.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(g),
                             torch.from_numpy(b), 1e-6, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    """On CPU tensors a wrapper runs the plain version; the launch
    counts move only where a kernel launches."""
    kernels.reset_launch_counts()
    q, k, v, pos = map(torch.from_numpy, _attn_inputs(2, 16, seed=1))
    assert torch.equal(kernels.decode_attention(q, k, v, pos),
                       reference.decode_attention(q, k, v, pos))
    x = torch.randn(4, 128)
    g, b = torch.ones(128), torch.zeros(128)
    assert torch.equal(kernels.layer_norm(x, g, b),
                       reference.layer_norm(x, g, b))
    assert set(kernels.launch_counts()) == set(kernels.KERNELS)
    assert not any(kernels.launch_counts().values())


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty((1, 1, H, D), device="meta")
    k = torch.empty((1, 16, H, D), device="meta")
    pos = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.decode_attention(q, k, k, pos)
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.layer_norm(torch.empty((2, 8), device="meta"),
                           torch.ones(8), torch.zeros(8))


def _ln_inputs(N, Dm, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, Dm) * 3 + 1).astype(np.float32)
    g = (1 + 0.1 * rng.randn(Dm)).astype(np.float32)
    b = (0.1 * rng.randn(Dm)).astype(np.float32)
    dy = rng.randn(N, Dm).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,Dm", [(16, 128), (37, 768), (300, 128),
                                  (13, 200), (64, 96)])
def test_layer_norm_autograd_matches_jax_vjp(N, Dm, in_dtype):
    """The port's differentiable ``layer_norm`` (plain forward and
    backward on the CPU): y, dx, dgamma and dbeta against
    ``jax.vjp(fused_layer_norm)``."""
    x, g, b, dy = _ln_inputs(N, Dm, seed=N * Dm)
    jdt = jnp.bfloat16 if in_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if in_dtype == "bfloat16" else torch.float32
    y, vjp = jax.vjp(
        lambda a, c, d: fused_layer_norm(a, c, d, 1e-6,
                                         out_dtype=jnp.float32),
        jnp.asarray(x).astype(jdt), jnp.asarray(g), jnp.asarray(b))
    want_dx, want_dg, want_db = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = kernels.layer_norm(tx, tg, tb, 1e-6, torch.float32)
    got.backward(torch.from_numpy(dy))
    assert got.dtype == torch.float32 and tx.grad.dtype == tdt
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(want_dx.astype(jnp.float32)),
                               atol=1e-2 if in_dtype == "bfloat16" else 1e-4)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want_dg),
                               atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_db),
                               atol=1e-4)


@pytest.mark.parametrize("N,Dm", [(16, 128), (300, 768)])
def test_layer_norm_statistics_match_pallas(N, Dm):
    """mu and rs of the plain forward (the training path's forward kernel
    writes them too) against ``_ln_fwd_call``'s."""
    x, g, b, _ = _ln_inputs(N, Dm, seed=1)
    _, want_mu, want_rs = _ln_fwd_call(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(b), 1e-6, jnp.float32)
    y, mu, rs = kernels.layer_norm_fwd(*map(torch.from_numpy, (x, g, b)),
                                       1e-6, torch.float32)
    assert mu.shape == rs.shape == (N,) and mu.dtype == torch.float32
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu)[:, 0],
                               atol=1e-5)
    np.testing.assert_allclose(rs.numpy(), np.asarray(want_rs)[:, 0],
                               atol=1e-5)
    assert torch.equal(y, reference.layer_norm(
        *map(torch.from_numpy, (x, g, b)), 1e-6, torch.float32))


def test_layer_norm_outside_autograd_is_the_serving_forward():
    """Without grad (serving, eval) ``layer_norm`` returns a plain tensor
    with no graph; under autograd it is differentiable."""
    x, g, b, _ = _ln_inputs(4, 128, seed=2)
    tx, tg, tb = map(torch.from_numpy, (x, g, b))
    assert kernels.layer_norm(tx, tg, tb).grad_fn is None
    tg.requires_grad_()
    assert kernels.layer_norm(tx, tg, tb).grad_fn is not None
    with torch.no_grad():
        assert kernels.layer_norm(tx, tg, tb).grad_fn is None
