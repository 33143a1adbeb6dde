"""The port's GradSync (pytorch_distributed_nn_tpu_torch/parallel) over 2
and 4 gloo ranks, one thread each, against the JAX GradSync under
shard_map on as many devices of the 8-device CPU mesh.

Uncompressed results agree within 1e-6 (sums of 2-4 f32 values, taken
in another order). int8 runs on scale-exact gradients: integers in
[-127, 127] with an entry at +-127 on some rank, so the shared scale is 1
and q = g whatever the noise; there the two sides are equal bit for bit,
masks and divisors included. Each case has a kernel-sized leaf (>= 16384
elements) and a small one, so both quantizers run.

topk with error feedback runs on the same integer gradients and
residuals: every sum is exact, so the synced gradients and the new
residuals equal JAX's bit for bit, the random-arrival re-injection and
the permanent exclusion included (for the random arrival the port's seed
is chosen so that its permutation drops the ranks JAX's key drops: the
same law, other draws). Buckets: round trips at boundaries inside
leaves, and bucketed ``none`` (1e-6) and scale-exact ``int8`` (bit for
bit, every bucket holding a +-127) against JAX's. The straggler
simulator at ``sigma = 0`` (arrival times exactly ``mean`` plus the
delay entries): masks and every report key equal JAX's.
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
from pytorch_distributed_nn_tpu.resilience.stragglers import (
    StragglerSim as JaxStragglerSim,
)
from pytorch_distributed_nn_tpu_torch.ops import compression as C
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    GradSyncConfig,
    make_grad_sync,
)
from pytorch_distributed_nn_tpu_torch.resilience.stragglers import (
    StragglerSim,
    dropped_ranks,
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
        out, _ = sync([torch.from_numpy(g[r].copy()) for g in grads], None,
                      seed)
        return [t.numpy() for t in out]

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
            return sync([torch.from_numpy(grads[0][r].copy())], None,
                        seed)[0][0]

        outs = run_ranks(n, one)
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
        picked = (outs[0][:, 0] * k).round().to(torch.int64)
        assert int(picked.sum()) == k and set(picked.tolist()) <= {0, 1}
        sets.add(tuple(picked.tolist()))
    assert len(sets) > 1


def test_local_mode_is_the_identity_and_needs_no_group():
    g = [torch.randn(3, 4)]
    out, state = make_grad_sync(None, mode="local")(g, None, 0)
    assert out[0] is g[0] and state is None


@pytest.mark.parametrize("kw", [
    dict(compression="topk", topk_ratio=0.25),
    dict(bucket_bytes=1 << 10),
    dict(straggler=StragglerSim(deadline=1.0, sigma=0.0,
                                delays=((1, 1, 5.0),)))],
    ids=["topk", "bucket_bytes", "straggler"])
def test_unported_options_raise_naming_their_roadmap_item(kw):
    """The three options the sync refused before they were ported run
    over two ranks: topk keeps ceil(0.25 n) coordinates a leaf and the
    rest as residual, buckets give the plain mean, the simulator drops
    the delayed rank 1 (the synced gradient is rank 0's)."""
    grads = _grads(2, seed=1)

    def one(r, group):
        sync = make_grad_sync(group, **kw)
        state = sync.init_state([torch.from_numpy(g[r]) for g in grads])
        out, state = sync([torch.from_numpy(g[r].copy()) for g in grads],
                          state, 7, step=1)
        return out, state, sync.pop_report()

    (out, state, report), _ = run_ranks(2, one)
    if "compression" in kw:
        for g, e in zip(grads, state):
            assert int((g[0] != e.numpy()).sum()) == int(g[0].size * 0.25
                                                         + 0.999999)
    elif "bucket_bytes" in kw:
        for g, o in zip(grads, out):
            np.testing.assert_allclose(o.numpy(), g.mean(0), atol=1e-6)
    else:
        assert report["straggler_dropped"] == 1.0
        assert dropped_ranks(report["straggler_dropped_mask"]) == [1]
        for g, o in zip(grads, out):
            np.testing.assert_array_equal(o.numpy(), g[0])


def test_config_checks_match_the_jax_package():
    sim = StragglerSim(deadline=1.0)
    for kw, match in ((dict(mode="x"), "mode"),
                      (dict(compression="fp4"), "compression"),
                      (dict(arrival="x"), "arrival"),
                      (dict(mode="local", kill_ranks=(0,)), "kill_ranks"),
                      (dict(compression="topk", straggler=sim), "topk"),
                      (dict(mode="local", straggler=sim), "distributed"),
                      (dict(compression="topk", bucket_bytes=64), "topk"),
                      (dict(bucket_bytes=0), "positive")):
        with pytest.raises(ValueError, match=match):
            GradSyncConfig(**kw)


@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_estimate_sync_bytes_matches_jax(compression):
    tmpl = [np.zeros(s, np.float32) for s in SHAPES]
    want = jax_make("allreduce", compression=compression,
                    topk_ratio=0.3).estimate_sync_bytes(tmpl)

    def one(r, group):
        return make_grad_sync(group, compression=compression,
                              topk_ratio=0.3).estimate_sync_bytes(
            [torch.from_numpy(t) for t in tmpl])

    assert run_ranks(1, one) == [want]


# -- topk with error feedback ----------------------------------------------


def _jax_sync_ef(n, grads, ef, key, **kw):
    """The JAX GradSync with per-replica residuals: (synced, residuals),
    each stacked over the replicas."""
    sync = jax_make(**kw)
    mesh = make_mesh(n, 1, devices=jax.devices()[:n])

    @jax.jit
    @shard_map(mesh=mesh, in_specs=(P("data"), P("data"), P()),
               out_specs=(P("data"), P("data")))
    def run(blocks, ef_blocks, key):
        out, new = sync([b[0] for b in blocks], [e[0] for e in ef_blocks],
                        key)
        return [o[None] for o in out], [e[None] for e in new]

    out, new = run([jnp.asarray(g) for g in grads],
                   [jnp.asarray(e) for e in ef], key)
    return [np.asarray(o) for o in out], [np.asarray(e) for e in new]


def _port_sync_ef(n, grads, ef, seed, **kw):
    def one(r, group):
        sync = make_grad_sync(group, **kw)
        out, new = sync([torch.from_numpy(g[r].copy()) for g in grads],
                        [torch.from_numpy(e[r].copy()) for e in ef], seed)
        return [t.numpy() for t in out], [t.numpy() for t in new]

    per_rank = run_ranks(n, one)
    return tuple([np.stack([per_rank[r][j][i] for r in range(n)])
                  for i in range(len(grads))] for j in (0, 1))


def _jax_contributors(n, k, key):
    """The ranks JAX's random arrival order takes for ``key``."""
    perm = np.asarray(jax.random.permutation(jax.random.split(key)[0], n))
    return [float(int(np.argmax(perm == r)) < k) for r in range(n)]


def _port_seed_taking(n, k, mask):
    """A sync seed whose random arrival order takes the ranks of
    ``mask``."""
    sync = make_grad_sync(None, "local")
    sync.config = GradSyncConfig(mode="ps", num_aggregate=k)
    with_world = type("G", (), {"size": lambda self: n,
                                "rank": lambda self: 0})()
    sync.group = with_world
    for seed in range(500):
        if sync.masks(C.leaf_seeds(seed, 2)[0]) == mask:
            return seed
    raise AssertionError("no seed in 500 takes these ranks")


EF_CASES = [
    dict(mode="allreduce"),
    dict(mode="allreduce", kill_ranks=(1,)),
    dict(mode="ps", num_aggregate=1, arrival="rank"),   # permanent exclusion
    dict(mode="ps", num_aggregate=1, arrival="random"),  # re-injection
]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kw", EF_CASES, ids=_ids)
def test_topk_error_feedback_on_scale_exact_gradients_equals_jax(n, kw):
    grads = _grads(n, seed=20 + n, exact=True)
    ef = _grads(n, seed=40 + n, exact=True)
    key = jax.random.PRNGKey(3)
    kw = {**kw, "compression": "topk", "topk_ratio": 0.05}
    seed = 5
    if kw.get("arrival") == "random":
        taken = _jax_contributors(n, kw["num_aggregate"], key)
        seed = _port_seed_taking(n, kw["num_aggregate"], taken)
    want_out, want_ef = _jax_sync_ef(n, grads, ef, key, **kw)
    got_out, got_ef = _port_sync_ef(n, grads, ef, seed, **kw)
    for a, b in zip(got_out + got_ef, want_out + want_ef):
        np.testing.assert_array_equal(a, b)
    if kw.get("arrival") == "random":
        # the dropped ranks keep their whole accumulated gradient
        for r in range(n):
            if not taken[r]:
                for g, e0, e1 in zip(grads, ef, got_ef):
                    np.testing.assert_array_equal(e1[r], g[r] + e0[r])
    if kw.get("arrival") == "rank":
        # ranks excluded every step keep only the unsent part
        for g, e0, e1 in zip(grads, ef, got_ef):
            assert not np.array_equal(e1[n - 1], g[n - 1] + e0[n - 1])


def test_topk_mask_keeps_ties_and_at_least_k():
    g = torch.tensor([[3.0, -3.0, 1.0], [3.0, 0.5, -0.25]])
    mask = C.topk_mask_leaf(g, 0.3)  # k = 2: the threshold 3 has 3 ties
    assert mask.tolist() == [[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]]
    assert C.topk_mask_leaf(g, 1.0).sum() == 6
    for method in ("auto", "approx", "exact"):
        assert torch.equal(C.topk_mask_leaf(g, 0.3, method), mask)
    with pytest.raises(ValueError, match="topk method"):
        C.topk_mask_leaf(g, 0.3, "sort")


# -- buckets ---------------------------------------------------------------


def test_flatten_buckets_round_trip_at_unaligned_boundaries():
    rng = np.random.RandomState(0)
    leaves = [torch.from_numpy(rng.randn(7, 13).astype(np.float32)),
              torch.from_numpy(rng.randn(5).astype(np.float32)).bfloat16(),
              torch.from_numpy(rng.randn(3, 2, 4).astype(np.float32))]
    buckets, meta = C.flatten_buckets(leaves, bucket_bytes=64)
    assert all(b.dtype == torch.float32 and b.numel() <= 16
               for b in buckets)
    assert sum(b.numel() for b in buckets) == 7 * 13 + 5 + 24
    back = C.unflatten_buckets(buckets, meta)
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert C.flatten_buckets([], 64) == ([], [])


#: 16384 + 5 and 36 elements in buckets of 4096: boundaries inside the
#: first leaf and across the two
BUCKET_BYTES = 4096 * 4


def _bucket_exact(grads):
    """Scale-exact integer gradients with a 127 at the start of every
    bucket of the last rank's flattened leaves."""
    n = grads[0].shape[0]
    flat = np.concatenate([g[n - 1].reshape(-1) for g in grads])
    flat[::BUCKET_BYTES // 4] = 127.0
    off = 0
    for g in grads:
        size = g[n - 1].size
        g[n - 1] = flat[off:off + size].reshape(g.shape[1:])
        off += size
    return grads


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kw", [dict(mode="allreduce"),
                                dict(mode="ps", num_aggregate=1,
                                     arrival="rank"),
                                dict(mode="allreduce", kill_ranks=(0,))],
                         ids=_ids)
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_bucketed_sync_matches_jax(n, kw, compression):
    grads = _bucket_exact(_grads(n, seed=60 + n, exact=True))
    kw = {**kw, "compression": compression, "bucket_bytes": BUCKET_BYTES}
    want = _jax_sync(n, grads, **kw)
    got = _port_sync(n, grads, **kw)
    for a, b in zip(got, want):
        if compression == "int8":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


# -- the straggler simulator -----------------------------------------------


def _jax_mask_and_report(n, sim, step):
    mesh = make_mesh(n, 1, devices=jax.devices()[:n])

    @jax.jit
    @shard_map(mesh=mesh, in_specs=(P(),), out_specs=(P("data"), P()))
    def run(key):
        mask, report = sim.mask_and_report(key, step, "data")
        return mask[None], report

    mask, report = run(jax.random.PRNGKey(0))
    return [float(m) for m in np.asarray(mask)], \
        {k: float(v) for k, v in report.items()}


SIMS = [
    (4, dict(deadline=1.0, mean=0.01, delays=((3, 2, 50.0),)), 3),
    (4, dict(deadline=1.0, mean=0.01, delays=((3, 2, 50.0),)), 2),
    (4, dict(deadline=0.5, mean=0.1, delays=((2, None, 1.0),
                                             (2, 1, 0.25))), 2),
    (2, dict(deadline=1e-6, mean=0.5, min_keep=1), 1),
    (4, dict(deadline=1e-6, mean=0.5, min_keep=2,
             delays=((1, 0, 3.0),)), 1),
]


@pytest.mark.parametrize("n,kw,step", SIMS)
def test_mask_and_report_match_jax_at_sigma_zero(n, kw, step):
    want_mask, want = _jax_mask_and_report(
        n, JaxStragglerSim(sigma=0.0, **kw), step)
    got_mask, got = StragglerSim(sigma=0.0, **kw).mask_and_report(
        11, step, n)
    assert got_mask == want_mask
    assert got == want


def test_straggler_times_follow_the_lognormal_law():
    """sigma > 0: another draw per seed, the same on every call, and the
    log of the times centred on log(mean) with spread sigma."""
    sim = StragglerSim(deadline=1.0, mean=0.1, sigma=0.1)
    a, b = sim.times(1, 5, 4096), sim.times(2, 5, 4096)
    assert a.dtype == np.float32 and not np.array_equal(a, b)
    np.testing.assert_array_equal(a, sim.times(1, 5, 4096))
    logs = np.log(a.astype(np.float64))
    assert abs(logs.mean() - np.log(0.1)) < 0.01
    assert abs(logs.std() - 0.1) < 0.01


@pytest.mark.parametrize("n", [2, 4])
def test_straggler_sync_matches_jax(n):
    """The delayed rank 2 % n dropped at step 3 and the rest averaged over
    the live count, uncompressed and int8 (scale-exact: bit for bit)."""
    kw = dict(deadline=1.0, mean=0.01, sigma=0.0,
              delays=((3, n - 1, 50.0),))
    grads = _grads(n, seed=80 + n, exact=True)
    for compression in ("none", "int8"):
        mesh = make_mesh(n, 1, devices=jax.devices()[:n])
        sync = jax_make(compression=compression,
                        straggler=JaxStragglerSim(**kw))

        @jax.jit
        @shard_map(mesh=mesh, in_specs=(P("data"), P()),
                   out_specs=P("data"))
        def run(blocks, key):
            out, _ = sync([b[0] for b in blocks], None, key, step=3)
            return [o[None] for o in out]

        want = [np.asarray(o) for o in run([jnp.asarray(g) for g in grads],
                                           jax.random.PRNGKey(0))]

        def one(r, group):
            s = make_grad_sync(group, compression=compression,
                               straggler=StragglerSim(**kw))
            out, _ = s([torch.from_numpy(g[r].copy()) for g in grads], None,
                       9, step=3)
            return [t.numpy() for t in out], s.pop_report()

        per_rank = run_ranks(n, one)
        assert per_rank[0][1]["straggler_dropped"] == 1.0
        for i, w in enumerate(want):
            got = np.stack([per_rank[r][0][i] for r in range(n)])
            if compression == "int8":
                np.testing.assert_array_equal(got, w)
            else:
                np.testing.assert_allclose(got, w, rtol=0, atol=1e-6)
            np.testing.assert_allclose(
                got[0], grads[i][:n - 1].mean(0), rtol=0, atol=1e-5)


def test_straggler_stream_leaves_the_sync_bits_alone():
    """A simulator that drops no one gives the bits of a run without it
    (its seed is another stream of the sync seed)."""
    grads = _grads(2, seed=3)
    sim = StragglerSim(deadline=10.0, sigma=0.5)
    for kw in (dict(compression="int8"),
               dict(mode="ps", num_aggregate=1, arrival="random")):
        plain = _port_sync(2, grads, **kw)
        with_sim = _port_sync(2, grads, straggler=sim, **kw)
        for a, b in zip(plain, with_sim):
            np.testing.assert_array_equal(a, b)
