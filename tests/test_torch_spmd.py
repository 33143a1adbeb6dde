"""dp x tp x sp training of the port (pytorch_distributed_nn_tpu_torch/
parallel/partitioning.py, parallel/mesh.py's (data, seq, model) mesh,
models/transformer.py's tensor and sequence parallelism, ops/metrics'
vocab-parallel loss, ops/compression's int8 codec over regions and
training/spmd.py's step bodies) on the CPU: the ranks are gloo threads
(tests/torch_ranks.py), the JAX package runs on the suite's 8 virtual CPU
devices.

Everything at BertTiny/GptTiny test sizes: vocab 64, d 32, 4 heads, 2
layers, d_ff 64, L 32, B 8, dropout 0, f32, SGD with momentum 0.9 at lr
0.1 (the JAX suite's test_sequence_parallel.py setup), weights converted
from the JAX state, the JAX corpus's batches fed to both.

Tolerances: the first loss within 1e-5 relative and every parameter after
one step within 1e-5 of the JAX ``build_spmd_train_step`` at the same
mesh; 8 steps' losses within 2e-4 relative (the JAX suite's tp-vs-dp
bound); the port against itself: ``grad_accum`` against the full batch
within 1e-5, tp = 2 against dp = 4 within 2e-4; a leaf's int8 result at
tp = 2 equal to tp = 1's bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pytorch_distributed_nn_tpu.data.text import MLMBatches as JaxMLMBatches
from pytorch_distributed_nn_tpu.models import build_model as jax_build_model
from pytorch_distributed_nn_tpu.optim import build_optimizer as jax_opt
from pytorch_distributed_nn_tpu.parallel import (
    make_mesh as jax_make_mesh,
    make_mesh_attn as jax_mesh_attn,
    make_tp_flash_attn as jax_tp_flash,
)
from pytorch_distributed_nn_tpu.parallel.partitioning import (
    mesh_shardings as jax_mesh_shardings,
)
from pytorch_distributed_nn_tpu.training import config as jax_config
from pytorch_distributed_nn_tpu.training import spmd as jax_spmd
from pytorch_distributed_nn_tpu.training.trainer import Trainer as JaxTrainer
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    flax_to_state_dict,
    local_heads,
    state_dict_to_flax,
    tree_leaves,
)
from pytorch_distributed_nn_tpu_torch.ops import compression
from pytorch_distributed_nn_tpu_torch.optim import (
    build_optimizer,
    make_schedule,
)
from pytorch_distributed_nn_tpu_torch.parallel import partitioning as part
from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_coords,
)
from pytorch_distributed_nn_tpu_torch.parallel.ring_attention import (
    make_mesh_attn,
    make_tp_flash_attn,
)
from pytorch_distributed_nn_tpu_torch.training import spmd
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.trainer import (
    check_heads,
    validate,
)
from torch_ranks import run_ranks
import torch_cpu  # noqa: F401  (one intra-op thread)

KW = dict(vocab_size=64, max_len=32, d_model=32, num_heads=4, num_layers=2,
          d_ff=64, dropout_rate=0.0)
B, L, LR = 8, 32, 0.1
STEPS = 8


def _jax_model(net, attn_fn=None, **over):
    return jax_build_model(net, attn_fn=attn_fn, dtype=jnp.float32,
                           **{**KW, **over})


def _batches(n):
    data = JaxMLMBatches(vocab_size=64, seq_len=L, batch_size=B, seed=0)
    return [tuple(np.asarray(a) for a in xy) for _, xy in zip(range(n),
                                                              data)]


# -- partitioning ------------------------------------------------------------


def _abstract_params(net, **over):
    model = _jax_model(net, **over)
    opt = jax_opt("sgd", LR, momentum=0.9)
    return jax_spmd.abstract_spmd_state(model, opt, jax.random.PRNGKey(0),
                                        (B, L)), model


@pytest.mark.parametrize("net", ["BertTiny", "GptTiny"])
def test_logical_axes_equal_flax_partition_specs(net):
    """Every port parameter's logical axes (through its JAX path) equal
    ``nn.get_partition_spec`` of the JAX abstract state."""
    abstract, _ = _abstract_params(net)
    specs = nn.get_partition_spec(abstract.params)
    want = {path: tuple(spec) for path, spec in
            tree_leaves(jax.tree.map(lambda s: s, specs,
                                     is_leaf=lambda x: isinstance(
                                         x, jax.sharding.PartitionSpec)))}
    model = build_model(net, **KW, dtype="float32")
    tree = state_dict_to_flax(model.state_dict(), model.config.num_heads)
    got = {path: part.logical_axes(path) for path, _ in tree_leaves(tree)}
    assert set(got) == set(want)
    for path in want:
        assert got[path] == want[path], path


#: (dp, sp, tp) in the mesh's axis order
MESHES = [(2, 2, 1), (1, 2, 2), (2, 1, 2), (2, 2, 2), (1, 4, 1), (1, 1, 4)]


@pytest.mark.parametrize("dp,sp,tp", MESHES)
def test_regions_equal_devices_indices_map(dp, sp, tp):
    """Rank r's region of every leaf (JAX shape and axis order) equals
    ``NamedSharding.devices_indices_map`` of device r, and the rank that
    writes it to a checkpoint holds the JAX replica 0."""
    abstract, _ = _abstract_params("BertTiny")
    mesh = jax_make_mesh(dp, tp, sp, devices=jax.devices()[:dp * sp * tp])
    shardings = jax_mesh_shardings(abstract, mesh).params
    shapes = jax.tree.map(lambda a: a.shape, nn.meta.unbox(abstract.params))
    shape = {"data": dp, "seq": sp, "model": tp}
    flat_sh = dict(tree_leaves(jax.tree.map(
        lambda s: s, shardings,
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))))
    for path, shp in tree_leaves(jax.tree.map(
            lambda s: s, shapes, is_leaf=lambda x: isinstance(x, tuple))):
        sharding = flat_sh[path]
        index_map = sharding.devices_indices_map(shp)
        arr = jax.device_put(jnp.zeros(shp, jnp.float32), sharding)
        replica = {s.device: s.replica_id for s in arr.addressable_shards}
        for r, dev in enumerate(mesh.devices.flat):
            coords = mesh_coords(shape, r)
            region = part.leaf_region(path, shp, shape, coords)
            want = tuple((sl.start or 0, shp[i] if sl.stop is None
                          else sl.stop)
                         for i, sl in enumerate(index_map[dev]))
            assert region == want, (path, r)
            assert part.owns_region(path, coords) == (replica[dev] == 0), \
                (path, r)


def test_uneven_vocabulary_blocks():
    """A vocabulary that tp does not divide: the port splits it in
    ceil-sized blocks, the last one shorter (GSPMD's padded-shard
    convention), each element in exactly one region. The JAX package's
    jax (0.9) refuses such a sharding outright, so there is no JAX
    map to hold it against: the test pins the refusal beside the port's
    blocks."""
    assert [part.block(30522, 4, m) for m in range(4)] == [
        (0, 7631), (7631, 15262), (15262, 22893), (22893, 30522)]
    shape = {"data": 1, "seq": 1, "model": 4}
    path = ("encoder", "token_embed", "embedding")
    seen = np.zeros((66, 32), int)
    for m in range(4):
        coords = {"data": 0, "seq": 0, "model": m}
        region = part.leaf_region(path, (66, 32), shape, coords)
        assert part.owns_region(path, coords)
        seen[tuple(slice(a, b) for a, b in region)] += 1
    assert (seen == 1).all()
    mesh = jax_make_mesh(1, 4, 1, devices=jax.devices()[:4])
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("model", None))
    with pytest.raises(ValueError, match="divisible|evenly divide"):
        jax.device_put(jnp.zeros((66, 32)), sharding)


def test_rule_helpers():
    rules = part.DEFAULT_RULES
    assert part.rules_dict(rules)["vocab"] == "model"
    assert part.rules_dict(part.drop_rule(rules, "vocab"))["vocab"] is None
    assert part.rules_dict(
        part.override_rule(rules, "mlp", "seq"))["mlp"] == "seq"
    m = Mesh({"data": 2, "seq": 4, "model": 2},
             {"data": 0, "seq": 0, "model": 0}, {})
    assert (part.tp_degree(m), part.sp_degree(m)) == (2, 4)


# -- the step against the JAX package -----------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_run(net, dp, tp, sp, impl, steps=STEPS):
    """The JAX GSPMD step at (dp, tp, sp): (initial params, params after
    one step, the losses)."""
    mesh = jax_make_mesh(dp, tp, sp, devices=jax.devices()[:dp * tp * sp])
    attn = None
    if impl == "tp_flash":
        attn = jax_tp_flash(mesh)
    elif sp > 1:
        attn = jax_mesh_attn(mesh, impl)
    model = _jax_model(net, attn)
    opt = jax_opt("sgd", LR, momentum=0.9)
    state, shardings = jax_spmd.create_spmd_state(
        model, opt, jax.random.PRNGKey(0), (B, L), mesh)
    init = jax.tree.map(np.asarray, state.params)
    step = jax_spmd.build_spmd_train_step(model, opt, mesh, shardings,
                                          donate=False)
    bspec = jax_spmd.text_batch_sharding(mesh)
    losses, after1 = [], None
    for x, y in _batches(steps):
        state, m = step(state, (jax.device_put(jnp.asarray(x), bspec),
                                jax.device_put(jnp.asarray(y), bspec)),
                        jax.random.PRNGKey(7))
        losses.append(float(m["loss"]))
        if after1 is None:
            after1 = jax.tree.map(np.asarray, state.params)
    return init, after1, losses


def _port_run(net, dp, tp, sp, impl, params, steps=STEPS, compression="none",
              grad_accum=1, batches=None):
    """The port's spmd step over dp * tp * sp gloo ranks from the whole
    JAX ``params``: (params after one step, assembled; the losses)."""
    full = build_model(net, **KW, dtype="float32")
    full.load_state_dict(flax_to_state_dict(params))
    batches = batches or _batches(steps)
    sched = make_schedule(LR)

    def rank_fn(r, group):
        mesh = make_mesh(group, dp, tp, sp)
        attn = None
        if impl == "tp_flash":
            attn = make_tp_flash_attn(mesh)
        elif sp > 1:
            attn = make_mesh_attn(mesh, impl)
        local = build_model(net, **KW, dtype="float32", mesh=mesh,
                            attn_fn=attn)
        spmd.shard_model(full, local, mesh)
        state = spmd.create_spmd_state(
            local, lambda p: build_optimizer("sgd", p, sched, momentum=0.9),
            mesh, "cpu", seed=1)
        step = spmd.build_spmd_train_step(mesh, compression=compression,
                                          grad_accum=grad_accum)
        d = mesh.coords["data"]
        rows = slice(d * B // dp, (d + 1) * B // dp)
        losses, after1 = [], None
        for i, (x, y) in enumerate(batches[:steps]):
            m = step(state, (torch.from_numpy(x[rows]).long(),
                             torch.from_numpy(y[rows]).long()), seed=11 + i)
            losses.append(float(m["loss"]))
            if after1 is None:
                after1 = state_dict_to_flax(
                    {k: v.clone() for k, v in local.state_dict().items()},
                    local_heads(local))
        return mesh.coords, after1, losses

    results = run_ranks(dp * tp * sp, rank_fn, timeout=300)
    shape = {"data": dp, "seq": sp, "model": tp}
    assembled = {}
    for path, a in tree_leaves(params):
        full_leaf = np.full(np.shape(a), np.nan, np.float32)
        for coords, tree, _ in results:
            region = part.leaf_region(path, np.shape(a), shape, coords)
            leaf = dict(tree_leaves(tree))[path]
            full_leaf[tuple(slice(x, y) for x, y in region)] = leaf
        assembled[path] = full_leaf
    for _, _, losses in results[1:]:
        np.testing.assert_array_equal(losses, results[0][2])
    return assembled, results[0][2]


#: (net, dp, tp, sp, attention): the make_mesh argument order
STEP_MESHES = [
    ("BertTiny", 2, 1, 1, "full"),
    ("BertTiny", 2, 2, 1, "full"),
    ("BertTiny", 2, 1, 2, "ring"),
    ("BertTiny", 2, 1, 2, "ulysses"),
    ("BertTiny", 2, 2, 2, "ring"),
    ("BertTiny", 2, 2, 1, "tp_flash"),
    ("GptTiny", 1, 2, 2, "ring"),
]


@pytest.mark.parametrize("net,dp,tp,sp,impl", STEP_MESHES)
def test_step_matches_jax(net, dp, tp, sp, impl):
    init, after1, jax_losses = _jax_run(net, dp, tp, sp, impl)
    got, losses = _port_run(net, dp, tp, sp, impl, init)
    np.testing.assert_allclose(losses[0], jax_losses[0], rtol=1e-5)
    for path, a in tree_leaves(after1):
        np.testing.assert_allclose(got[path], a, rtol=1e-5, atol=1e-5,
                                   err_msg=str(path))
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-4)


# -- the port against itself ------------------------------------------------


def _init_params(net="BertTiny"):
    model = build_model(net, **KW, dtype="float32")
    model.init_weights(torch.Generator().manual_seed(0))
    return state_dict_to_flax(model.state_dict(), model.config.num_heads)


@pytest.mark.parametrize("dp,tp,sp,accum", [(2, 2, 2, 2), (2, 2, 1, 4)])
def test_grad_accum_equals_full_batch(dp, tp, sp, accum):
    params = _init_params()
    impl = "ring" if sp > 1 else "full"
    whole, l1 = _port_run("BertTiny", dp, tp, sp, impl, params, steps=1)
    acc, l2 = _port_run("BertTiny", dp, tp, sp, impl, params, steps=1,
                        grad_accum=accum)
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for path in whole:
        np.testing.assert_allclose(acc[path], whole[path], rtol=1e-5,
                                   atol=1e-5, err_msg=str(path))


def test_tp_matches_dp():
    params = _init_params()
    _, l_tp = _port_run("BertTiny", 2, 2, 1, "full", params)
    _, l_dp = _port_run("BertTiny", 4, 1, 1, "full", params)
    np.testing.assert_allclose(l_tp, l_dp, rtol=2e-4)


@pytest.mark.parametrize("dp,tp,sp", [(2, 2, 2), (1, 2, 1)])
def test_int8_first_step_matches_dense(dp, tp, sp):
    """The int8 body's loss comes from the same forward as the dense
    body's (only the dp payload is quantized); at dp = 1 it runs the
    codec's single-contributor mode. Its update stays within the
    quantization's reach of the dense one."""
    params = _init_params()
    impl = "ring" if sp > 1 else "full"
    p8, l8 = _port_run("BertTiny", dp, tp, sp, impl, params, steps=2,
                       compression="int8")
    pd, ld = _port_run("BertTiny", dp, tp, sp, impl, params, steps=1)
    np.testing.assert_allclose(l8[0], ld[0], rtol=1e-5)
    assert np.isfinite(l8).all()
    moved = 0.0
    for path in pd:
        delta = np.abs(pd[path] - params_leaf(params, path)).max()
        gap = np.abs(p8[path] - pd[path]).max()
        assert gap <= 0.5 * delta + 1e-6, (path, gap, delta)
        moved += delta
    assert moved > 0


def params_leaf(params, path):
    return dict(tree_leaves(params))[path]


@pytest.mark.parametrize("scale_exact", [False, True])
def test_int8_leaf_independent_of_tp(scale_exact):
    """``int8_psum_mean`` of a leaf split over 2 model ranks (its regions,
    the MAX of the amax over the model group) equals the leaf's at tp = 1
    bit for bit: row splits, a transposed (input-dimension) split, a 1-D
    leaf split at an offset that is not a multiple of 4, and leaves on
    either side of the kernel's size threshold."""
    rng = np.random.default_rng(5)
    shapes = [((128, 160), False), ((96, 256), True), ((16387,), False),
              ((40, 24), False), ((24, 40), True)]
    leaves = []
    for shape, _ in shapes:
        g = rng.standard_normal(shape).astype(np.float32)
        if scale_exact:  # multiples of the scale: rounding is exact
            amax = np.abs(g).max()
            g = (np.round(g / amax * 127) * (amax / 127)).astype(np.float32)
        leaves.append(g)
    whole = compression.int8_psum_mean(
        [torch.from_numpy(g) for g in leaves], 123, None, denom=3.0,
        regions=[compression.LeafRegion(
            g.shape[1] if t else g.shape[0], 0, t)
            for g, (_, t) in zip(leaves, shapes)])

    def rank_fn(r, group):
        parts, regions = [], []
        for g, (_, t) in zip(leaves, shapes):
            rows = g.shape[1] if t else g.shape[0]
            a, b = part.block(rows, 2, r)
            parts.append(torch.from_numpy(
                np.ascontiguousarray(g[:, a:b] if t else g[a:b])))
            regions.append(compression.LeafRegion(rows, a, t))
        out = compression.int8_psum_mean(parts, 123, None, denom=3.0,
                                         regions=regions,
                                         amax_groups=(group,))
        return [o.numpy() for o in out]

    halves = run_ranks(2, rank_fn)
    for i, (g, (_, t)) in enumerate(zip(leaves, shapes)):
        got = np.concatenate([h[i] for h in halves], axis=1 if t else 0)
        np.testing.assert_array_equal(got, whole[i].numpy())


def test_seq_chunk_and_refusals():
    m = Mesh({"data": 1, "seq": 2, "model": 1},
             {"data": 0, "seq": 1, "model": 0}, {})
    x = torch.arange(16).reshape(2, 8)
    assert torch.equal(spmd.seq_chunk(x, m), x[:, 4:])
    with pytest.raises(ValueError, match="compression"):
        spmd.build_spmd_train_step(m, compression="topk")
    with pytest.raises(ValueError, match="grad_accum>1 with compression"):
        spmd.build_spmd_train_step(m, compression="int8", grad_accum=2)


# -- the trainer's refusals, with the JAX trainer's reasons --------------------

_BASE = dict(network="BertTiny", dataset="MLMSynth", batch_size=8,
             test_batch_size=8, seq_len=32, vocab_size=64, max_steps=1)
REFUSALS = [
    dict(network="LeNet", dataset="MNIST", tensor_parallel=2),
    dict(tensor_parallel=2, sync_mode="ps"),
    dict(tensor_parallel=2, compression="topk"),
    dict(tensor_parallel=2, kill_ranks=[1]),
    dict(tensor_parallel=2, compression="int8", grad_accum=2),
    dict(seq_parallel=2, attn_impl="pallas"),
    dict(tensor_parallel=2, fused_ln=True),
    dict(seq_parallel=2, seq_attn="zigzag"),
    dict(tensor_parallel=2, straggler_deadline=1.0),
    dict(tensor_parallel=2, skip_nonfinite=True),
]


@pytest.mark.parametrize("kw", REFUSALS, ids=lambda kw: ",".join(kw))
def test_trainer_refusals_match_jax(kw):
    cfg = {**_BASE, **kw}
    with pytest.raises(ValueError) as want:
        JaxTrainer(jax_config.TrainConfig(**cfg))
    with pytest.raises(ValueError) as got:
        validate(TrainConfig(**cfg))
    assert str(got.value) == str(want.value)


def test_head_split_refusals_match_jax():
    """heads % tp and, for Ulysses, heads / tp % sp: the JAX trainer's
    messages (it checks them once the model is built)."""
    c = TrainConfig(**{**_BASE, "tensor_parallel": 8})
    with pytest.raises(ValueError) as got:
        check_heads(c, 4)
    with pytest.raises(ValueError) as want:
        JaxTrainer(jax_config.TrainConfig(**{**_BASE, "tensor_parallel": 8,
                                             "vocab_size": 64}))
    assert str(got.value) == str(want.value)
    c = TrainConfig(**{**_BASE, "tensor_parallel": 2, "seq_parallel": 4,
                       "seq_attn": "ulysses"})
    with pytest.raises(ValueError, match="ulysses needs heads/tp=2 "
                                         "divisible by seq_parallel=4"):
        check_heads(c, 4)


def test_warm_start_with_resume_refused():
    c = TrainConfig(**{**_BASE, "warm_start": "x", "resume": True})
    with pytest.raises(ValueError, match="warm_start and resume are "
                                         "mutually exclusive"):
        validate(c)


def test_config_fields_match_jax():
    assert {f.name for f in dataclasses.fields(TrainConfig)} == {
        f.name for f in dataclasses.fields(jax_config.TrainConfig)}


def test_meshes_over_one_group_rendezvous_under_their_own_prefixes(
        monkeypatch):
    """Two meshes over one world of 4 ranks, (2, 2, 1) then (1, 4, 1):
    the first's seq group of ranks 0 and 1 and the second's seq group
    share coordinates (data 0, model 0), yet their groups meet in the
    store under prefixes of their own. NCCL keeps a communicator's id
    there under keys every group reuses: on a shared prefix the second
    group's ranks could read the first one's stale id.

    Each rank keeps both meshes until every rank has built its own: the
    ranks are threads of one process, and a gloo group torn down in one
    thread while another thread connects a new group can break that
    connect (under load, a peer's "Connection closed by peer" or a rank
    left waiting out the timeout)."""
    import collections
    import threading

    from pytorch_distributed_nn_tpu_torch.parallel import mesh as pmesh

    real, seen = pmesh.dist.PrefixStore, collections.defaultdict(list)

    def recording(prefix, store):
        seen[threading.get_ident()].append(prefix)
        return real(prefix, store)

    monkeypatch.setattr(pmesh.dist, "PrefixStore", recording)

    def rank_fn(r, group):
        mine = seen[threading.get_ident()]
        start = len(mine)
        meshes = [make_mesh(group, 2, 1, 2)]
        mid = len(mine)
        meshes.append(make_mesh(group, 1, 1, 4))
        return mine[start:mid], mine[mid:], meshes

    results = run_ranks(4, rank_fn)
    first = {p for a, _, _ in results for p in a}
    second = {p for _, b, _ in results for p in b}
    assert first and second and not first & second, (first, second)
