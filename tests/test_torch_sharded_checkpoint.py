"""Sharded checkpoint directories of the port (pytorch_distributed_nn_tpu_torch/
training/checkpoint.py's ``pdtn-sharded-v1`` path, training/async_ckpt.py's
sharded writer, training/evaluator.py on a directory) against the JAX
package's ``save_sharded``/``restore_sharded``/``restore_resharded``, on
the CPU: the port's ranks are gloo threads (tests/torch_ranks.py), the
JAX package runs on the suite's 8 virtual CPU devices.

BertTiny at the trainer's widths (d 128, 4 heads, 4 layers, d_ff 512)
with vocab 64, L 32, B 8, f32, no dropout, and Adam, one step taken so
the optimizer's moments are not zero. Every comparison is bit for bit: a directory
carries the leaves' values, which neither package changes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.data.text import MLMBatches as JaxMLMBatches
from pytorch_distributed_nn_tpu.models import build_model as jax_build_model
from pytorch_distributed_nn_tpu.optim import build_optimizer as jax_opt
from pytorch_distributed_nn_tpu.parallel import make_mesh as jax_make_mesh
from pytorch_distributed_nn_tpu.training import checkpoint as jckpt
from pytorch_distributed_nn_tpu.training import spmd as jax_spmd
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    shard_state_tree,
    state_leaves,
)
from pytorch_distributed_nn_tpu_torch.optim import (
    build_optimizer,
    make_schedule,
)
from pytorch_distributed_nn_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_nn_tpu_torch.resilience.supervisor import (
    resume_latest_valid,
)
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training import spmd
from pytorch_distributed_nn_tpu_torch.training.async_ckpt import (
    AsyncCheckpointer,
)
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.evaluator import Evaluator
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    create_train_state,
)
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
from torch_ranks import run_ranks
import torch_cpu  # noqa: F401  (one intra-op thread)

KW = dict(vocab_size=64, max_len=32, dropout_rate=0.0)
B, L = 8, 32


def _batch():
    x, y = next(iter(JaxMLMBatches(vocab_size=64, seq_len=L, batch_size=B,
                                   seed=0)))
    return np.asarray(x), np.asarray(y)


def _jax_state(dp, tp, sp):
    mesh = jax_make_mesh(dp, tp, sp, devices=jax.devices()[:dp * tp * sp])
    model = jax_build_model("BertTiny", dtype=jnp.float32, **KW)
    opt = jax_opt("adam", 1e-2)
    state, shardings = jax_spmd.create_spmd_state(
        model, opt, jax.random.PRNGKey(0), (B, L), mesh)
    return mesh, model, opt, state, shardings


def _jax_stepped(dp, tp, sp):
    mesh, model, opt, state, shardings = _jax_state(dp, tp, sp)
    step = jax_spmd.build_spmd_train_step(model, opt, mesh, shardings,
                                          donate=False)
    bspec = jax_spmd.text_batch_sharding(mesh)
    x, y = _batch()
    state, _ = step(state, (jax.device_put(jnp.asarray(x), bspec),
                            jax.device_put(jnp.asarray(y), bspec)),
                    jax.random.PRNGKey(1))
    return mesh, state, shardings


def _jax_tree(state) -> dict:
    """The JAX state as the port's whole-state tree: {key: array}."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in leaves}


def _port_state(mesh=None, step=False):
    sched = make_schedule(1e-2)
    full = build_model("BertTiny", **KW, dtype="float32")
    full.init_weights(torch.Generator().manual_seed(0))

    def opt(p):
        return build_optimizer("adam", p, sched)

    if mesh is None:
        state = create_train_state(full, opt, "cpu")
    else:
        local = build_model("BertTiny", **KW, dtype="float32", mesh=mesh)
        state = spmd.create_spmd_state(spmd.shard_model(full, local, mesh),
                                       opt, mesh, "cpu")
    if step:
        x, y = _batch()
        d, dp = mesh.coords["data"], mesh.shape["data"]
        rows = slice(d * B // dp, (d + 1) * B // dp)
        spmd.build_spmd_train_step(mesh)(
            state, (torch.from_numpy(x[rows]).long(),
                    torch.from_numpy(y[rows]).long()))
    return state


def _flat(tree) -> dict:
    return {k: np.asarray(a) for k, _, a in state_leaves(tree)}


def _assert_trees_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A JAX ``save_sharded`` directory at (dp 2, tp 2, sp 2), step 1,
    and the JAX state's leaves."""
    mesh, state, _ = _jax_stepped(2, 2, 2)
    d = str(tmp_path_factory.mktemp("jax"))
    path = jckpt.save_sharded(d, state, step=1,
                              geometry=jckpt.mesh_geometry(mesh))
    return d, path, _jax_tree(state)


def test_jax_directory_restores_on_the_port_mesh(jax_dir):
    """Each of the 8 ranks at (2, 2, 2) restores its regions of the JAX
    leaves, bit for bit."""
    _, path, want = jax_dir

    def rank_fn(r, group):
        mesh = make_mesh(group, 2, 2, 2)
        state = _port_state(mesh)
        ckpt.restore_checkpoint(path, state)
        whole = ckpt.load_tree(path)
        mine = shard_state_tree(whole, mesh.shape, mesh.coords)
        _assert_trees_equal(_flat(ckpt.state_tree(state)), _flat(mine))
        return state.step

    assert run_ranks(8, rank_fn) == [1] * 8
    _assert_trees_equal(_flat(ckpt.load_tree(path)), want)


def test_jax_directory_restores_on_one_rank(jax_dir):
    """Elastic: the (2, 2, 2) directory on one rank without a mesh, and
    through the trainer's resume (an ``elastic_resume`` event)."""
    d, path, want = jax_dir
    state = _port_state()
    ckpt.restore_resharded(path, state)
    _assert_trees_equal(_flat(ckpt.state_tree(state)), want)
    cfg = TrainConfig(network="BertTiny", dataset="MLMSynth",
                      optimizer="adam", lr=1e-2, batch_size=B,
                      test_batch_size=B, seq_len=L, vocab_size=64,
                      max_steps=2, eval_batches=1, train_dir=d, resume=True,
                      metrics_path=os.path.join(d, "resume.jsonl"))
    t = Trainer(cfg, device="cpu")
    try:
        assert t.start_step == 1
        _assert_trees_equal(_flat(ckpt.state_tree(t.state)), want)
        losses = [h["loss"] for h in t.train()]
    finally:
        t.close()
    assert len(losses) == 1 and np.isfinite(losses).all()
    with open(os.path.join(d, "resume.jsonl")) as f:
        kinds = [json.loads(line).get("type") for line in f]
    assert "elastic_resume" in kinds


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    """The port's ``save_sharded`` at (2, 2, 2), step 1, from 8 ranks."""
    d = str(tmp_path_factory.mktemp("port"))

    def rank_fn(r, group):
        mesh = make_mesh(group, 2, 2, 2)
        state = _port_state(mesh, step=True)
        return ckpt.save_sharded(d, state, geometry={
            "devices": 8, "processes": 8,
            "mesh": {"data": 2, "seq": 2, "model": 2}})

    path = run_ranks(8, rank_fn)[0]
    return d, path


def test_port_directory_restores_in_jax(port_dir):
    """JAX ``restore_sharded`` on the same mesh and ``restore_resharded``
    on another read the port's directory bit for bit."""
    _, path = port_dir
    want = _flat(ckpt.load_tree(path))
    assert want[".step"] == 1
    for dp, tp, sp, fn in ((2, 2, 2, jckpt.restore_sharded),
                           (1, 2, 1, jckpt.restore_resharded)):
        _, _, _, template, shardings = _jax_state(dp, tp, sp)
        got = _jax_tree(fn(path, template, shardings))
        _assert_trees_equal(got, want)


def test_meta_json_fields_equal(port_dir, jax_dir):
    _, jpath, _ = jax_dir
    _, ppath = port_dir
    with open(os.path.join(jpath, "meta.json")) as f:
        jm = json.load(f)
    with open(os.path.join(ppath, "meta.json")) as f:
        pm = json.load(f)
    assert set(pm) == set(jm)
    assert pm["format"] == jm["format"] == "pdtn-sharded-v1"
    assert pm["step"] == jm["step"] == 1
    assert pm["shapes"] == jm["shapes"]
    assert pm["geometry"]["mesh"] == jm["geometry"]["mesh"]
    assert pm["processes"] == 8 == len(pm["crc32"])
    ok, reason = jckpt.verify_checkpoint(ppath)
    assert (ok, reason) == ckpt.verify_checkpoint(ppath) == (True, "ok")
    # each unique region once: the shard files' keys are disjoint
    keys = []
    for f in sorted(os.listdir(ppath)):
        if f.endswith(".npz"):
            with np.load(os.path.join(ppath, f)) as z:
                keys += z.files
    assert len(keys) == len(set(keys))


def test_torn_shard_is_convicted_and_quarantined(tmp_path):
    """A torn shard file fails verification, the JAX reason, and the
    resume scan quarantines its directory and restores the older one."""
    d = str(tmp_path)

    def rank_fn(r, group):
        mesh = make_mesh(group, 1, 2, 1)
        state = _port_state(mesh)
        for s in (1, 2):
            state.step = s
            ckpt.save_sharded(d, state)
        return True

    run_ranks(2, rank_fn)
    bad = ckpt.checkpoint_path(d, 2)
    shard = os.path.join(bad, "shards_p00001.npz")
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    assert ckpt.verify_checkpoint(bad) == jckpt.verify_checkpoint(bad) == (
        False, "shards_p00001.npz: CRC32 mismatch")
    state = _port_state()
    assert resume_latest_valid(d, state) is state
    assert state.step == 1
    assert ckpt.all_steps(d) == [1]
    assert os.path.isdir(os.path.join(d, ckpt.QUARANTINE_DIR,
                                      "model_step_2"))


def test_async_directory_equals_sync(tmp_path):
    """The async writer's directory is the synchronous save's, byte for
    byte, at (1, 2, 2) (the commit deferred to the training thread) and on
    one rank (published by the writer)."""
    for dp, tp, sp in ((1, 2, 2), (1, 1, 1)):
        a, b = str(tmp_path / f"sync{tp}"), str(tmp_path / f"async{tp}")

        def rank_fn(r, group):
            mesh = make_mesh(group, dp, tp, sp)
            state = _port_state(mesh, step=True)
            ckpt.save_sharded(a, state, step=3)
            w = AsyncCheckpointer(b, mesh=mesh)
            try:
                w.save(state, step=3)
                w.drain()
            finally:
                w.close()
            return True

        run_ranks(dp * tp * sp, rank_fn)
        pa, pb = ckpt.checkpoint_path(a, 3), ckpt.checkpoint_path(b, 3)
        assert sorted(os.listdir(pa)) == sorted(os.listdir(pb))
        for f in os.listdir(pa):
            with open(os.path.join(pa, f), "rb") as x, \
                    open(os.path.join(pb, f), "rb") as y:
                assert x.read() == y.read(), f


def test_evaluator_scores_a_directory(tmp_path):
    """A tp/sp trainer's directories: the evaluator (one rank) scores the
    last one as the trainer scores its final state."""
    d = str(tmp_path)
    cfg = dict(network="BertTiny", dataset="MLMSynth", batch_size=B,
               test_batch_size=B, seq_len=L, vocab_size=64, max_steps=2,
               eval_batches=2, eval_freq=2, train_dir=d,
               tensor_parallel=2, seq_parallel=2)

    def rank_fn(r, group):
        t = Trainer(TrainConfig(**cfg), device="cpu", group=group)
        try:
            t.train()
            return t.evaluate()
        finally:
            t.close()

    trained = run_ranks(4, rank_fn)[0]
    one = TrainConfig(**{**cfg, "tensor_parallel": 1, "seq_parallel": 1,
                         "eval_freq": 0, "train_dir": str(tmp_path / "e")})
    t = Trainer(one, device="cpu")
    try:
        ev = Evaluator(t.state, t.test_loader, d, eval_freq=2)
        got = ev.evaluate_checkpoint(2)
    finally:
        t.close()
    for k in ("loss", "acc1", "acc5"):
        np.testing.assert_allclose(got[k], trained[k], rtol=1e-5, atol=1e-6)
