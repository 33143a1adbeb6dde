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

import torch_cpu  # noqa: F401  (one intra-op thread)

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


def test_decode_attention_matches_pallas_on_a_long_cache():
    """At BertBase's head width and a cache the kernel splits over the
    warps of a block (S = 512)."""
    rng = np.random.RandomState(11)
    B, S, nh, Dh = 2, 512, 12, 64
    q = rng.randn(B, 1, nh, Dh).astype(np.float32)
    k = rng.randn(B, S, nh, Dh).astype(np.float32)
    v = rng.randn(B, S, nh, Dh).astype(np.float32)
    pos = np.asarray([100, S - 1], np.int32)
    want = np.asarray(pallas_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)))
    got = kernels.decode_attention(*map(torch.from_numpy, (q, k, v, pos)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [16, 32, 64, 128])
def test_decode_launch_plan_gives_every_gptmini_bucket_one_warp(S, B, elem):
    """GptMini's decode buckets: one warp per (batch, head), a block of
    one warp, K and V of the head staged at once, no block barrier."""
    plan = kernels.decode_launch_plan(B, H, S, D, elem)
    assert plan["blocks"] == B * H
    assert plan["warps_per_head"] == 1 and plan["together"] == 1
    assert plan["keys_per_warp"] == plan["tile_keys"] == -(-S // 32) * 32
    row = D * elem + 16
    assert plan["smem_bytes"] == 2 * plan["keys_per_warp"] * row + 8 * D + 8


@pytest.mark.parametrize("S,elem,warps,keys,tile", [
    (512, 2, 4, 128, 128),
    (512, 4, 4, 128, 64),
    (2048, 2, 16, 128, 32),
    (2048, 4, 10, 224, 32),
    (8192, 4, 10, 832, 32),
    (16384, 2, 16, 1024, 32),
    (16384, 4, 10, 1664, 32),
    (50000, 4, 10, 5024, 32),
])
def test_decode_launch_plan_splits_long_caches(S, elem, warps, keys, tile):
    """Past 128 keys the keys are split over the warps of one block (128
    a warp, up to 16 warps, fewer where their smallest tiles would not fit
    the staging; any S), staged K tile by tile and then V, in tiles of a
    multiple of 32 keys under one staging budget whatever the number of
    heads."""
    for B, nh in ((2, 12), (64, 12)):
        plan = kernels.decode_launch_plan(B, nh, S, 64, elem)
        assert plan["blocks"] == B * nh
        assert (plan["warps_per_head"], plan["keys_per_warp"],
                plan["tile_keys"], plan["together"]) == (warps, keys, tile, 0)
        assert plan["smem_bytes"] <= 96 * 1024


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("Dh", [1, 16, 24, 32, 64, 256])
def test_decode_launch_plan_holds_every_key_in_its_staging(Dh, elem):
    """For any cache length: the warps' shares cover S and none is empty,
    tiles are whole slots of 32 keys within a share, K and V staged at
    once only by one warp, and the block's shared memory is its staging
    plus the warps' partial sums, q and statistics, under 96 KB."""
    row = -(-Dh * elem // 16) * 16 + 16
    for S in (1, 31, 33, 127, 128, 129, 300, 1000, 4097, 8193, 65537):
        plan = kernels.decode_launch_plan(1, 1, S, Dh, elem)
        W, C = plan["warps_per_head"], plan["keys_per_warp"]
        tile, together = plan["tile_keys"], plan["together"]
        assert 1 <= W <= 16 and (W - 1) * C < S <= W * C
        assert C % 32 == 0 and tile % 32 == 0 and 32 <= tile <= C
        assert not together or (W == 1 and tile == C <= 128)
        assert plan["smem_bytes"] == W * ((2 if together else 1) * tile * row
                                          + 8 * Dh + 8) <= 96 * 1024


def test_decode_launch_plan_refuses_what_one_block_cannot_hold():
    """Head dims past 256 (a lane's output elements); no cache length is
    refused: wide rows take fewer warps, and a warp's share any number
    of rounds."""
    with pytest.raises(ValueError, match="head dim"):
        kernels.decode_launch_plan(1, 1, 16, 257, 4)
    with pytest.raises(ValueError, match="head dim"):
        kernels.decode_launch_plan(1, 1, 16, 0, 4)
    plan = kernels.decode_launch_plan(1, 1, 3000, 256, 4)
    assert plan["warps_per_head"] == 2 and plan["keys_per_warp"] == 1504
    plan = kernels.decode_launch_plan(1, 1, 1 << 20, 64, 2)
    assert plan["warps_per_head"] == 16 and plan["keys_per_warp"] == 1 << 16


def test_decode_vector_loads_need_aligned_rows():
    """16-byte staging for caches whose every row starts on a 16-byte
    boundary; a cache one element off, or rows that are not a whole
    number of 16 bytes, take the kernel's scalar branch."""
    k = torch.zeros((2, 16, H, D))
    assert kernels.decode_vector_loads(k, k.clone())
    flat = torch.zeros(k.numel() + 1)
    off = flat[1:].view(k.shape)
    assert off.data_ptr() % 16 != 0
    assert not kernels.decode_vector_loads(off, k)
    assert not kernels.decode_vector_loads(k, off)
    odd = torch.zeros((2, 16, H, 6))  # 24-byte rows
    assert not kernels.decode_vector_loads(odd, odd.clone())
    page = torch.zeros((2, 24, H, D))  # a view into a longer panel
    assert kernels.decode_vector_loads(page[:, :16], page[:, :16])
    assert kernels.decode_vector_loads(k.bfloat16(), k.bfloat16())


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
@pytest.mark.parametrize("N,Dm", [(16, 128), (300, 128), (7, 96), (33, 200),
                                  (1, 768), (41, 768), (1, 64)])
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


@pytest.mark.parametrize("N,Dm", [(16, 128), (300, 768), (1, 768), (1, 64)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dm", [64, 128, 200, 768])
def test_layer_norm_fwd_dispatch_by_width_and_alignment(Dm, dtype):
    """The forward takes its vectorised kernel for the widths the
    backward's is built for (one table) when x, y, gamma and beta start
    on 16-byte boundaries, and its general kernel for any other width or
    an operand that is not aligned, x one element off its boundary
    included."""
    x = torch.zeros((5, Dm), dtype=dtype)
    y = torch.empty((5, Dm), dtype=torch.float32)
    g, b = torch.ones(Dm), torch.zeros(Dm)
    vec = Dm in kernels.LN_WIDTHS
    assert kernels.layer_norm_fwd_vectorised(x, y, g, b) == vec
    assert kernels.layer_norm_fwd_vectorised(x, y.to(dtype), g, b) == vec
    shifted = torch.zeros(5 * Dm + 1, dtype=dtype)[1:].view(5, Dm)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert not kernels.layer_norm_fwd_vectorised(shifted, y, g, b)
    g_off = torch.ones(Dm + 1)[1:]
    assert not kernels.layer_norm_fwd_vectorised(x, y, g_off, b)
    assert not kernels.layer_norm_fwd_vectorised(x, y, g, g_off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dm", [64, 96, 128, 200, 768, 1024])
def test_layer_norm_bwd_dispatch_by_width_and_alignment(Dm, dtype):
    """The backward takes its vectorised kernel for the widths it is built
    for when x, dy and dx start on 16-byte boundaries, and its general
    kernel for any other width or a row that is not aligned."""
    x = torch.zeros((5, Dm), dtype=dtype)
    dy = torch.zeros((5, Dm), dtype=torch.float32)
    dx = torch.empty_like(x)
    assert kernels.layer_norm_bwd_vectorised(x, dy, dx) == (
        Dm in kernels.LN_WIDTHS)
    flat = torch.zeros(5 * Dm + 1, dtype=dtype)
    shifted = flat[1:].view(5, Dm)  # one element off the boundary
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert not kernels.layer_norm_bwd_vectorised(shifted, dy, dx)
    assert kernels.LN_WIDTHS == (64, 128, 768)


@pytest.mark.parametrize("N,Dm", [(1, 64), (33, 128), (9, 768)])
def test_layer_norm_bwd_plain_matches_jax_vjp_at_kernel_widths(N, Dm):
    """At each width the vectorised kernel is built for, and one row,
    the plain backward (the kernel's CPU path) against
    ``jax.vjp(fused_layer_norm)``."""
    x, g, b, dy = _ln_inputs(N, Dm, seed=N + Dm)
    _, vjp = jax.vjp(
        lambda a, c, d: fused_layer_norm(a, c, d, 1e-6,
                                         out_dtype=jnp.float32),
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    tx, tg, tb, tdy = map(torch.from_numpy, (x, g, b, dy))
    _, mu, rs = kernels.layer_norm_fwd(tx, tg, tb, 1e-6, torch.float32)
    got = kernels.layer_norm_bwd(tx, tg, mu, rs, tdy)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4)
