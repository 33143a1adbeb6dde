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

import torch_cpu  # noqa: F401  (one intra-op thread)

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


def _bf16_backward_inputs(L, D, causal, pad, seed):
    """bf16 q/k/v/dO and the Pallas forward's (out, lse) on them, as numpy
    arrays and as the port's tensors."""
    q, k, v, do, mask = _inputs(L, D, seed=seed, pad=pad)
    jq, jk, jv, jdo = (jnp.asarray(t).astype(jnp.bfloat16)
                       for t in (q, k, v, do))
    out, lse = _flash_forward(jq, jk, jv, _jmask(mask), causal, L, L)
    tq, tk, tv, tdo, tout = (
        torch.from_numpy(np.array(t.astype(jnp.float32))).to(torch.bfloat16)
        for t in (jq, jk, jv, jdo, out))
    tlse = torch.from_numpy(np.array(lse).reshape(B, H, L))
    return (jq, jk, jv, jdo, out, lse), (tq, tk, tv, tdo, tout, tlse), mask


@pytest.mark.parametrize("causal,pad,D", [(False, 0, 64), (True, 0, 32),
                                          (False, 9, 16)])
def test_flash_bfloat16_split_backward_matches_pallas_backward(causal, pad,
                                                               D):
    """bf16 operands: the plain dq and dk/dv (p and ds carried into dk/dv's
    products as hi + lo, two bf16 terms, as the tensor-core kernel does)
    against ``_flash_backward`` (f32 p and ds) on the same (out, lse, dO).
    Every gradient is rounded to bf16 on both sides, so they may sit one
    bf16 step apart: |got - want| <= 2^-7 |want| + 1e-4. The f32 values
    before rounding differ by reduction order and by the split's 2^-17 of
    each term; near-zero gradients are sums of O(1) terms that cancel, so
    there those differences show as absolute error (2e-6 at most here)."""
    L = 64
    (jq, jk, jv, jdo, out, lse), (tq, tk, tv, tdo, tout, tlse), mask = \
        _bf16_backward_inputs(L, D, causal, pad, seed=21 + D)
    want = _flash_backward(jq, jk, jv, _jmask(mask), out, lse, jdo, causal,
                           L, L)
    got = reference.flash_attention_bwd(tq, tk, tv, _tmask(mask), tout, tlse,
                                        tdo, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-4)


def test_flash_bfloat16_split_keeps_p_and_ds_to_16_bits():
    """The hi + lo split of p and ds (``reference.split_bf16``) before
    dk/dv's products: each element within 2^-17 of the f32 value, and the
    products p^T dO and ds^T Q within 2^-16 of the unsplit f32 products,
    relative to sum |x| |y| (computed in f64, so only the split's error
    shows). One bf16 rounding alone (the FlashAttention choice) would be
    off by up to 2^-8 per element."""
    L, D = 64, 32
    _, (tq, tk, tv, tdo, tout, tlse), mask = _bf16_backward_inputs(
        L, D, causal=True, pad=0, seed=4)
    delta = reference.flash_attention_delta(tout, tdo)
    p, ds = reference._probs_and_ds(tq, tk, tv, None, tlse, delta, tdo, True)
    for x, y in ((p, tdo), (ds, tq)):
        split = reference.split_bf16(x)
        nz = x != 0
        rel = ((split - x).abs()[nz] / x.abs()[nz]).max().item()
        assert rel <= 2.0 ** -17
        one = ((x.to(torch.bfloat16).float() - x).abs()[nz]
               / x.abs()[nz]).max().item()
        assert 2.0 ** -12 < one <= 2.0 ** -8
        y64 = y.double()
        exact = torch.einsum("bhqk,bqhd->bkhd", x.double(), y64)
        got = torch.einsum("bhqk,bqhd->bkhd", split.double(), y64)
        size = torch.einsum("bhqk,bqhd->bkhd", x.double().abs(), y64.abs())
        assert ((got - exact).abs() <= 2.0 ** -16 * size).all()


def test_flash_operands_are_copied_unless_rows_are_16_byte_aligned():
    """What the flash wrappers hand the kernels (``_flash_operand``): an
    operand whose rows all start on a 16-byte boundary goes in place, a
    view off that boundary or with a head stride that is not a multiple of
    the elements of 16 bytes (8 bf16, 4 f32) is copied to a fresh
    contiguous tensor. Both dtypes: the f32 kernels stream their tiles
    with 16-byte ``cp.async`` copies too."""
    for dtype, elems in ((torch.bfloat16, 8), (torch.float32, 4)):
        x = torch.zeros((2, 8, 3, 32), dtype=dtype)
        assert kernels._flash_operand(x) is x
        heads_major = x.transpose(1, 2).contiguous().transpose(1, 2)
        assert kernels._flash_operand(heads_major) is heads_major
        buf = torch.zeros(x.numel() + 1, dtype=dtype)
        off = buf[1:].view(x.shape)
        odd = torch.zeros((2, 8, 3, 32 + elems // 2), dtype=dtype)[..., :32]
        for t in (off, odd):
            c = kernels._flash_operand(t)
            assert c.data_ptr() != t.data_ptr() and c.is_contiguous()
            assert c.data_ptr() % 16 == 0 and torch.equal(c, t)


def test_flash_tf32_split_rounds_as_cvt_rna():
    """``reference.tf32`` rounds as ``cvt.rna.tf32.f32``: 10 explicit
    mantissa bits (the low 13 of the f32 bits zero), to nearest, ties away
    from zero; and the hi + lo split keeps x to 2^-22."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(
        (rng.randn(4096) * 10.0 ** rng.uniform(-20, 20, 4096))
        .astype(np.float32))
    hi = reference.tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((hi - x).abs() <= 2.0 ** -11 * x.abs()).all()
    split = reference.split_tf32(x)
    assert ((split - x).abs() <= 2.0 ** -22 * x.abs()).all()
    # a tie (half a TF32 unit above 1) goes away from zero on both signs;
    # just below it, to the nearer value
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                         1 + 2.0 ** -11 - 2.0 ** -23, 3.0])
    assert reference.tf32(ties).tolist() == [1 + 2.0 ** -10,
                                             -(1 + 2.0 ** -10), 1.0, 3.0]


def test_flash_tf32_three_products_keep_f32_accuracy():
    """Three TF32 products of the split operands (``einsum_3xtf32``, the
    f32 kernels' products) against the f64 product, on p^T dO and ds^T Q
    of the dk/dv kernel and Q K^T of the forward: within 2^-20 of
    sum |x| |y| (each term taken in f64, so only the split's error shows).
    One TF32 rounding of each element (TF32 mode) would be off by more
    than 2^-13 of an element for some."""
    L, D = 64, 32
    q, k, v, do, _ = _inputs(L, D, seed=9, pad=0)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = reference.flash_attention_fwd(tq, tk, tv, None, True)
    delta = reference.flash_attention_delta(out, tdo)
    p, ds = reference._probs_and_ds(tq, tk, tv, None, lse, delta, tdo, True)

    def three(eq, a, b):
        a, b = a.double(), b.double()
        a_hi, b_hi = reference.tf32(a).double(), reference.tf32(b).double()
        a_lo = reference.tf32(a - a_hi).double()
        b_lo = reference.tf32(b - b_hi).double()
        return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
                + torch.einsum(eq, a_hi, b_hi))

    for eq, x, y in (("bhqk,bqhd->bkhd", p, tdo), ("bhqk,bqhd->bkhd", ds, tq),
                     ("bqhd,bkhd->bhqk", tq, tk)):
        nz = x != 0
        one = ((reference.tf32(x) - x).abs()[nz] / x.abs()[nz]).max().item()
        assert 2.0 ** -13 < one <= 2.0 ** -11
        exact = torch.einsum(eq, x.double(), y.double())
        size = torch.einsum(eq, x.double().abs(), y.double().abs())
        assert ((three(eq, x, y) - exact).abs() <= 2.0 ** -20 * size).all()


@pytest.mark.parametrize("causal,pad", [(False, 0), (True, 0), (False, 7)])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_flash_three_tf32_products_match_pallas(causal, pad, D):
    """The plain forward, dq and dk/dv with every product taken as the f32
    kernels take it (three TF32 products of split operands,
    ``reference.einsum_3xtf32``) against ``_flash_forward`` and
    ``_flash_backward`` in interpret mode (f32 ``jnp.dot``), the backward
    on the same (out, lse, dO): at 1e-5, the tolerance of the f32
    products themselves."""
    L = 64
    q, k, v, do, mask = _inputs(L, D, seed=31 + D + pad, pad=pad)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out, want_lse = _flash_forward(jq, jk, jv, _jmask(mask), causal, L,
                                        L)
    want = _flash_backward(jq, jk, jv, _jmask(mask), want_out, want_lse,
                           jnp.asarray(do), causal, L, L)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = reference.flash_attention_fwd(
        tq, tk, tv, _tmask(mask), causal, einsum=reference.einsum_3xtf32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(want_lse).reshape(B, H, L), atol=1e-5)
    got = reference.flash_attention_bwd(
        tq, tk, tv, _tmask(mask), torch.from_numpy(np.array(want_out)),
        torch.from_numpy(np.array(want_lse).reshape(B, H, L)), tdo, causal,
        einsum=reference.einsum_3xtf32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
