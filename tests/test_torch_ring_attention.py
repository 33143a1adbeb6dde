"""Sequence parallelism of the port (pytorch_distributed_nn_tpu_torch/
parallel/ring_attention.py) and the flash kernel per head shard, on the
CPU: 2 and 4 gloo seq ranks as threads (tests/torch_ranks.py) against the
JAX package's ``ring_attention``/``ulysses_attention`` under shard_map on
as many devices of the 8-device CPU mesh, and against full attention.

Tolerances are the JAX suite's (test_sequence_parallel.py): the forward
within 2e-5, gradients within 1e-4. The tp flash path (plain version of
the kernel on the CPU; Pallas in interpret mode on the JAX side) within
2e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_distributed_nn_tpu.compat import shard_map
from pytorch_distributed_nn_tpu.parallel import (
    SEQ_AXIS,
    make_mesh,
    make_tp_flash_attn as jax_make_tp_flash_attn,
    ring_attention as jax_ring,
    ulysses_attention as jax_ulysses,
)
from pytorch_distributed_nn_tpu_torch.models.transformer import (
    full_attention,
)
from pytorch_distributed_nn_tpu_torch.parallel import ring_attention as ra
from pytorch_distributed_nn_tpu_torch.parallel.mesh import Mesh
from torch_ranks import run_ranks
import torch_cpu  # noqa: F401  (one intra-op thread)

FWD_TOL, GRAD_TOL = 2e-5, 1e-4
B, L, H, D = 2, 32, 4, 8


def _inputs(seed, pad):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, L, H, D).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((B, L), np.float32)
    if pad:
        mask[:, -pad:] = 0.0
    return q, k, v, w, mask


def _jax_sharded(impl, S, q, k, v, w, mask, causal):
    """The JAX function under shard_map over S seq devices: (out, dq, dk,
    dv) of sum(out * w)."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:S]), (SEQ_AXIS,))
    fn = {"ring": jax_ring, "ulysses": jax_ulysses}[impl]
    qspec, mspec = P(None, SEQ_AXIS, None, None), P(None, SEQ_AXIS)

    @partial(shard_map, mesh=mesh, in_specs=(qspec,) * 3 + (mspec,),
             out_specs=qspec, check_vma=False)
    def attn(q, k, v, m):
        return fn(q, k, v, m, causal=causal, axis_name=SEQ_AXIS)

    def loss(q, k, v):
        out = attn(q, k, v, jnp.asarray(mask))
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port_sharded(impl, S, q, k, v, w, mask, causal):
    """The port's function over S gloo seq ranks, each on its chunk; the
    chunks of (out, dq, dk, dv) concatenated."""
    c = L // S

    def rank_fn(r, group):
        sl = slice(r * c, (r + 1) * c)
        ts = [torch.tensor(a[:, sl], requires_grad=True) for a in (q, k, v)]
        fn = ra.make_seq_attn(impl, group)
        out = fn(*ts, torch.tensor(mask[:, sl]), causal=causal)
        (out * torch.tensor(w[:, sl])).sum().backward()
        return [out.detach().numpy()] + [t.grad.numpy() for t in ts]

    parts = run_ranks(S, rank_fn)
    return [np.concatenate([p[i] for p in parts], axis=1) for i in range(4)]


def _full(q, k, v, w, mask, causal):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = full_attention(*ts, torch.tensor(mask), causal=causal)
    (out * torch.tensor(w)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("causal,pad", [(False, 0), (False, 5), (True, 0),
                                        (True, 3)])
def test_seq_attention_matches_jax_and_full(impl, S, causal, pad):
    q, k, v, w, mask = _inputs(S + pad, pad)
    got = _port_sharded(impl, S, q, k, v, w, mask, causal)
    want = _jax_sharded(impl, S, q, k, v, w, mask, causal)
    full = _full(q, k, v, w, mask, causal)
    for i, (g, j, f) in enumerate(zip(got, want, full)):
        tol = FWD_TOL if i == 0 else GRAD_TOL
        np.testing.assert_allclose(g, j, rtol=tol, atol=tol)
        np.testing.assert_allclose(g, f, rtol=tol, atol=tol)


def test_ring_saves_no_block_of_probabilities():
    """The ring's backward keeps O(Lc * D) residuals: no saved tensor is
    an (Lc, Lc) block."""
    S = 2
    c = L // S
    q, k, v, w, mask = _inputs(1, 0)

    def rank_fn(r, group):
        shapes = []
        sl = slice(r * c, (r + 1) * c)
        ts = [torch.tensor(a[:, sl], requires_grad=True) for a in (q, k, v)]

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = ra.ring_attention(*ts, None, causal=True, group=group)
        (out * torch.tensor(w[:, sl])).sum().backward()
        return shapes

    for shapes in run_ranks(S, rank_fn):
        assert shapes, "the ring saved nothing for its backward"
        assert all(s[-2:] != (c, c) for s in shapes), shapes
        assert all(int(np.prod(s)) <= B * c * H * D for s in shapes)


@pytest.mark.parametrize("causal", [False, True])
def test_tp_flash_per_head_shard_matches_jax(causal):
    """make_tp_flash_attn at (dp 2, tp 2, sp 1): each rank runs the flash
    kernel (its plain version on the CPU) on its rows and its H / tp heads
    at the full sequence; assembled, against the JAX package's
    make_tp_flash_attn (Pallas, interpret mode) on 4 devices."""
    rng = np.random.RandomState(3)
    Bt = 4
    q, k, v = (rng.randn(Bt, L, H, D).astype(np.float32) for _ in range(3))
    mask = np.ones((Bt, L), np.float32)
    mask[:, -5:] = 0.0
    jmesh = make_mesh(2, 2, 1, devices=jax.devices()[:4])
    want = np.asarray(jax.jit(partial(jax_make_tp_flash_attn(jmesh),
                                      causal=causal))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    got = np.zeros_like(want)
    for d in range(2):
        for m in range(2):
            mesh = Mesh({"data": 2, "seq": 1, "model": 2},
                        {"data": d, "seq": 0, "model": m},
                        {"data": None, "seq": None, "model": None})
            fn = ra.make_tp_flash_attn(mesh)
            rows = slice(d * Bt // 2, (d + 1) * Bt // 2)
            heads = slice(m * H // 2, (m + 1) * H // 2)
            out = fn(*(torch.tensor(a[rows][:, :, heads]) for a in (q, k, v)),
                     torch.tensor(mask[rows]), causal=causal)
            got[rows, :, heads] = out.numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_tp_flash_refuses_seq_parallel():
    mesh = Mesh({"data": 1, "seq": 2, "model": 2},
                {"data": 0, "seq": 0, "model": 0},
                {"data": None, "seq": None, "model": None})
    with pytest.raises(ValueError, match="seq_parallel = 1"):
        ra.make_tp_flash_attn(mesh)


def test_ulysses_refuses_indivisible_heads():
    def rank_fn(r, group):
        x = torch.zeros(1, 4, 3, 2)
        with pytest.raises(ValueError, match="not divisible"):
            ra.ulysses_attention(x, x, x, group=group)

    run_ranks(2, rank_fn)


class _Recorder:
    """A stand-in seq group that records the order of a rank's posts."""

    def __init__(self):
        self.posts = []

    def send(self, tensors, peer, tag):
        self.posts.append(("send", peer, tag))
        return self

    def recv(self, tensors, peer, tag):
        self.posts.append(("recv", peer, tag))
        return self

    def wait(self):
        pass


@pytest.mark.parametrize("S", [2, 3, 4])
def test_ring_hop_posts_alternate_with_parity(S):
    """A hop posts every transfer before waiting, each tensor's send first
    on even ranks and its receive first on odd ones: at S = 2 the two
    ranks' posts to each other then pair up in order (NCCL runs them on
    one stream), never a send against a send."""
    x = torch.zeros(2, 3)
    posts = []
    for r in range(S):
        g = _Recorder()
        ra._hop([x, x, x], g, S, r)
        posts.append(g.posts)
        assert sorted(posts[r]) == sorted(
            [("send", (r + 1) % S, t) for t in range(3)]
            + [("recv", (r - 1) % S, t) for t in range(3)])
        first = "send" if r % 2 == 0 else "recv"
        assert [p[0] for p in posts[r][::2]] == [first] * 3
    if S == 2:
        for a, b in zip(posts[0], posts[1]):
            assert {a[0], b[0]} == {"send", "recv"} and a[2] == b[2]


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 2, 1), (1, 4, 1)])
def test_seq_parallel_check_tool_passes_over_gloo(shape):
    """tools/seq_parallel_check.py's cases on gloo ranks at a small shape:
    ring and Ulysses, causal and not, within the JAX suite's bounds of
    full attention at every rank."""
    from pytorch_distributed_nn_tpu_torch.tools import seq_parallel_check

    n = int(np.prod(shape))
    results = run_ranks(n, lambda r, group: seq_parallel_check.check_mesh(
        group, shape, B=2, L=32, H=4, D=8, seed=5, iters=1)[1])
    for cases in results:
        assert sorted(cases) == ["ring causal", "ring full",
                                 "ulysses causal", "ulysses full"]
        for row in cases.values():
            assert row["fwd_of_bound"] <= 1 and row["grad_of_bound"] <= 1
