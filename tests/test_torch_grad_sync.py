"""The port's GradSync (pytorch_distributed_nn_tpu_torch/parallel) over 2
and 4 gloo ranks, one thread each, against the JAX GradSync under
shard_map on as many devices of the 8-device CPU mesh.

Uncompressed results agree within 1e-6 (sums of 2-4 f32 values, taken
in another order). int8 runs on scale-exact gradients: integers in
[-127, 127] with an entry at +-127 on some rank, so the shared scale is 1
and q = g whatever the noise; there the two sides are equal bit for bit,
masks and divisors included. Each case has a kernel-sized leaf (>= 16384
elements) and a small one, so both quantizers run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_distributed_nn_tpu.compat import shard_map
from pytorch_distributed_nn_tpu.parallel import make_grad_sync as jax_make
from pytorch_distributed_nn_tpu.parallel import make_mesh
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    GradSyncConfig,
    make_grad_sync,
)
from torch_ranks import run_ranks
import torch_cpu  # noqa: F401  (one intra-op thread)

SHAPES = ((16384 + 5,), (12, 3))


def _grads(n, seed=0, exact=False):
    rng = np.random.RandomState(seed)
    out = []
    for shape in SHAPES:
        if exact:
            g = rng.randint(-127, 128, size=(n, *shape)).astype(np.float32)
            g.reshape(n, -1)[n - 1, 0] = 127.0
        else:
            g = rng.randn(n, *shape).astype(np.float32)
        out.append(g)
    return out


def _jax_sync(n, grads, **kw):
    sync = jax_make(**kw)
    mesh = make_mesh(n, 1, devices=jax.devices()[:n])

    @jax.jit
    @shard_map(mesh=mesh, in_specs=(P("data"), P()), out_specs=P("data"))
    def run(blocks, key):
        out, _ = sync([b[0] for b in blocks], None, key)
        return [o[None] for o in out]

    out = run([jnp.asarray(g) for g in grads], jax.random.PRNGKey(0))
    return [np.asarray(o) for o in out]


def _port_sync(n, grads, seed=5, **kw):
    def one(r, group):
        sync = make_grad_sync(group, **kw)
        return [t.numpy() for t in sync([torch.from_numpy(g[r].copy())
                                         for g in grads], seed)]

    per_rank = run_ranks(n, one)
    return [np.stack([per_rank[r][i] for r in range(n)])
            for i in range(len(grads))]


CASES = [
    dict(mode="allreduce"),
    dict(mode="ps", num_aggregate=1, arrival="rank"),
    dict(mode="ps", num_aggregate=3, arrival="rank"),
    dict(mode="allreduce", kill_ranks=(1,)),
    dict(mode="ps", num_aggregate=3, arrival="rank", kill_ranks=(0,)),
    dict(mode="ps", num_aggregate=2, arrival="rank", kill_ranks=(1,)),
]


def _ids(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kw", CASES, ids=_ids)
def test_uncompressed_sync_matches_jax(n, kw):
    if kw.get("num_aggregate", 0) > n:
        kw = {**kw, "num_aggregate": n}
    grads = _grads(n, seed=n)
    want = _jax_sync(n, grads, **kw)
    got = _port_sync(n, grads, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kw", CASES, ids=_ids)
def test_int8_sync_on_scale_exact_gradients_equals_jax_bitwise(n, kw):
    if kw.get("num_aggregate", 0) > n:
        kw = {**kw, "num_aggregate": n}
    grads = _grads(n, seed=10 + n, exact=True)
    want = _jax_sync(n, grads, compression="int8", **kw)
    got = _port_sync(n, grads, compression="int8", **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_fixed_ps_divisor_with_a_killed_rank():
    """PS mode divides by num_aggregate even when a killed rank leaves
    fewer contributors (the reference master's fixed divisor)."""
    n = 4
    grads = _grads(n, seed=3)
    got = _port_sync(n, grads, mode="ps", num_aggregate=3, arrival="rank",
                     kill_ranks=(1,))
    for g, out in zip(grads, got):
        np.testing.assert_allclose(out[2], (g[0] + g[2]) / 3, atol=1e-6)


@pytest.mark.parametrize("n,k", [(2, 1), (4, 2), (4, 3)])
def test_random_arrival_drops_exactly_n_minus_k(n, k):
    """One-hot gradients show who contributed: exactly k ranks each step,
    the same set on every rank, and another set for another seed."""
    grads = [np.eye(n, dtype=np.float32)[:, :, None].repeat(3, axis=2)]
    sets = set()
    for seed in range(12):
        def one(r, group):
            sync = make_grad_sync(group, mode="ps", num_aggregate=k,
                                  arrival="random")
            return sync([torch.from_numpy(grads[0][r].copy())], seed)[0]

        outs = run_ranks(n, one)
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
        picked = (outs[0][:, 0] * k).round().to(torch.int64)
        assert int(picked.sum()) == k and set(picked.tolist()) <= {0, 1}
        sets.add(tuple(picked.tolist()))
    assert len(sets) > 1


def test_local_mode_is_the_identity_and_needs_no_group():
    g = [torch.randn(3, 4)]
    out = make_grad_sync(None, mode="local")(g, 0)
    assert out[0] is g[0]


@pytest.mark.parametrize("kw", [dict(compression="topk"),
                                dict(bucket_bytes=1 << 20),
                                dict(straggler=object())])
def test_unported_options_raise_naming_their_roadmap_item(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 2"):
        GradSyncConfig(**kw)


def test_config_checks_match_the_jax_package():
    for kw in (dict(mode="x"), dict(compression="fp4"), dict(arrival="x"),
               dict(mode="local", kill_ranks=(0,))):
        with pytest.raises(ValueError):
            GradSyncConfig(**kw)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_estimate_sync_bytes_matches_jax(compression):
    tmpl = [np.zeros(s, np.float32) for s in SHAPES]
    want = jax_make("allreduce", compression=compression
                    ).estimate_sync_bytes(tmpl)

    def one(r, group):
        return make_grad_sync(group, compression=compression
                              ).estimate_sync_bytes(
            [torch.from_numpy(t) for t in tmpl])

    assert run_ranks(1, one) == [want]
