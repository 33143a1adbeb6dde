"""Data-parallel MLM training of the port (pytorch_distributed_nn_tpu_torch:
ops/metrics' global forms, training/train_step's MLM step with a
GradSync, data/text's rank split, the trainer across ranks with the
straggler simulator and the overlapped eval, and ``--multihost``) on the
CPU, 2 gloo ranks as threads (tests/torch_ranks.py), against the JAX
package on as many devices of the 8-device CPU mesh.

Tolerances:

- the global masked loss and metrics: 1e-6 (one reduction over the same
  logits, summed in another order);
- one BertTiny DP step (narrowed: 1 layer, d 32, L 16, f32, no dropout,
  plain attention on both sides; the kernels are held against Pallas in
  their own tests) against the JAX shard_map step on 2 devices, SGD at lr
  0.5: the loss within 1e-5 and every parameter within 1e-5, the
  single-device step's tolerance (test_torch_train.py). Under int8 the
  two packages draw other rounding noise (Philox and ``torch.rand``
  against JAX's PRNG), so each synced leaf is within two int8 steps of
  the other (each side within one step, ``amax / 127``, of the exact
  mean) and a parameter within ``lr * 2 * amax / 127 + 1e-5``, amax the
  leaf's largest gradient entry over the ranks;
- the overlapped eval at 2 ranks against the inline eval of the same
  state: 1e-6.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_distributed_nn_tpu.compat import shard_map
from pytorch_distributed_nn_tpu.models import build_model as jax_build_model
from pytorch_distributed_nn_tpu.ops import metrics as jax_metrics
from pytorch_distributed_nn_tpu.optim import sgd as jax_sgd
from pytorch_distributed_nn_tpu.parallel import make_grad_sync as jax_sync
from pytorch_distributed_nn_tpu.parallel import make_mesh
from pytorch_distributed_nn_tpu.parallel.mesh import DATA_AXIS
from pytorch_distributed_nn_tpu.parallel.partitioning import unbox
from pytorch_distributed_nn_tpu.training.train_step import (
    build_train_step as jax_build_train_step,
)
from pytorch_distributed_nn_tpu.training.train_step import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_nn_tpu_torch.data.text import MLMBatches, MLMLoader
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    flax_to_state_dict,
)
from pytorch_distributed_nn_tpu_torch.ops import metrics
from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
from pytorch_distributed_nn_tpu_torch.parallel import mesh
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    make_grad_sync,
)
from pytorch_distributed_nn_tpu_torch.resilience.stragglers import (
    dropped_ranks,
)
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    build_train_step,
    create_train_state,
    sync_seed,
)
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
from torch_ranks import run_ranks
import torch_cpu  # noqa: F401  (one intra-op thread)

TOL = 1e-5
LR = 0.5
KW = dict(vocab_size=64, max_len=16, d_model=32, num_heads=2, num_layers=1,
          d_ff=64)
L, B = 16, 8


def _logits_labels(rank):
    rng = np.random.RandomState(rank)
    logits = rng.randn(2, 12, 40).astype(np.float32)
    labels = rng.randint(0, 40, size=(2, 12)).astype(np.int32)
    # rank 1 masks most positions: the ranks' counts differ
    labels[rng.rand(2, 12) < (0.3 if rank == 0 else 0.8)] = -1
    logits[0, :3] = 0.0  # ties count against the label
    return logits, labels


def test_global_masked_loss_and_metrics_match_jax():
    data = [_logits_labels(r) for r in range(2)]
    mesh2 = make_mesh(2, 1, devices=jax.devices()[:2])
    jloss = jax_metrics.make_global_masked_cross_entropy(DATA_AXIS)
    jmets = jax_metrics.make_global_mlm_metrics(DATA_AXIS)

    @jax.jit
    @shard_map(mesh=mesh2, in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
               out_specs=P(DATA_AXIS))
    def run(lg, lb):
        m = {"loss": jloss(lg, lb), **jmets(lg, lb)}
        return {k: v[None] for k, v in m.items()}

    want = run(jnp.asarray(np.concatenate([d[0] for d in data])),
               jnp.asarray(np.concatenate([d[1] for d in data])))

    def one(r, group):
        lg, lb = (torch.from_numpy(a) for a in data[r])
        return {"loss": metrics.make_global_masked_cross_entropy(group)(
            lg, lb.long()), **metrics.make_global_mlm_metrics(group)(
            lg, lb.long())}

    got = run_ranks(2, one)
    for k in ("loss", "acc1", "acc5"):
        for r in range(2):
            assert abs(float(got[r][k]) - float(want[k][r])) <= 1e-6, (k, r)
    # the mean over the ranks is the global masked mean
    mask = np.concatenate([d[1] for d in data]) != -1
    tl = torch.from_numpy(np.concatenate([d[0] for d in data]))
    tlab = torch.from_numpy(np.concatenate([d[1] for d in data])).long()
    whole = float(metrics.masked_cross_entropy(tl, tlab))
    assert abs(sum(float(g["loss"]) for g in got) / 2 - whole) <= 1e-6
    assert mask.sum() > 0


def test_ranks_take_contiguous_rows_of_one_global_mlm_batch():
    kw = dict(vocab_size=64, seq_len=L, batch_size=B, seed=3)
    whole = MLMLoader(MLMBatches(**kw), "cpu").next_batch()
    parts = [MLMLoader(MLMBatches(**kw), "cpu", rank=r, world=2).next_batch()
             for r in range(2)]
    for i in range(2):
        assert torch.equal(torch.cat([p[i] for p in parts]), whole[i])
    with pytest.raises(ValueError, match="divisible"):
        MLMLoader(MLMBatches(**kw), "cpu", rank=0, world=3)


@pytest.fixture(scope="module")
def bert():
    model = jax_build_model("BertTiny", dtype=jnp.float32, dropout_rate=0.0,
                            **KW)
    rng = jax.random.PRNGKey(0)
    variables = unbox(model.init({"params": rng, "dropout": rng},
                                 jnp.zeros((1, L), jnp.int32), train=False))
    return model, jax.tree.map(np.asarray, variables["params"])


SYNCS = {"allreduce": dict(),
         "ps": dict(mode="ps", num_aggregate=1, arrival="rank"),
         "int8": dict(compression="int8"),
         "topk": dict(compression="topk", topk_ratio=0.1)}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("sync", list(SYNCS))
def test_berttiny_dp_step_matches_jax(bert, sync, accum):
    model, params = bert
    kw = SYNCS[sync]
    opt = jax_sgd(LR)
    jsync = jax_sync(**kw)
    mesh2 = make_mesh(2, 1, 1, devices=jax.devices()[:2])
    jstate = jax_create_train_state(model, opt, jsync,
                                    jax.random.PRNGKey(0), (L,),
                                    num_replicas=2, input_dtype=jnp.int32)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params))
    jstep = jax_build_train_step(
        model, opt, jsync, mesh2,
        loss_fn=jax_metrics.make_global_masked_cross_entropy(DATA_AXIS),
        metrics_fn=jax_metrics.make_global_mlm_metrics(DATA_AXIS),
        donate=False, grad_accum=accum,
        pair_accum_fn=jax_metrics.mlm_sums if accum > 1 else None)
    x, y = next(MLMBatches(vocab_size=64, seq_len=L, batch_size=B, seed=5))
    jstate, jm = jstep(jstate, (x, y), jax.random.PRNGKey(1))
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))

    def one(r, group):
        port = build_model("BertTiny", dtype="float32", dropout_rate=0.0,
                           **KW)
        port.load_state_dict(flax_to_state_dict(params))
        gs = make_grad_sync(group, **kw)
        seen = []

        class Recording:
            """The sync, recording the gradients it is given."""
            group = gs.group

            def __call__(self, grads, state, seed, step=None):
                seen.append([g.clone() for g in grads])
                return gs(grads, state, seed, step=step)

            def pop_report(self):
                return gs.pop_report()

        rec = Recording()
        state = create_train_state(
            port, lambda ps: build_optimizer("sgd", ps, LR), "cpu",
            grad_sync=gs)
        rows = slice(r * B // 2, (r + 1) * B // 2)
        m = build_train_step(rec, grad_accum=accum)(
            state, (torch.from_numpy(x[rows]).long(),
                    torch.from_numpy(y[rows]).long()), sync_seed(1, 0))
        return (float(m["loss"]), {k: float(v) for k, v in m.items()},
                {k: v.clone() for k, v in port.state_dict().items()},
                seen[0], [n for n, _ in port.named_parameters()])

    results = run_ranks(2, one)
    amax = {n: max(float(results[r][3][i].abs().max()) for r in range(2))
            for i, n in enumerate(results[0][4])}
    for loss, m, sd, _, _ in results:
        assert abs(loss - float(jm["loss"])) <= TOL
        for k in ("acc1", "acc5"):
            assert abs(m[k] - float(jm[k])) <= TOL, k
        for name, v in want.items():
            tol = TOL
            if sync == "int8" and name in amax:
                tol += LR * 2 * amax[name] / 127
            np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=0,
                                       atol=tol, err_msg=name)
    # the ranks hold the same model after the step
    for name, v in results[0][2].items():
        assert torch.equal(v, results[1][2][name]), name


# -- the trainer across ranks ----------------------------------------------

_LENET = dict(network="LeNet", dataset="MNIST", batch_size=16,
              test_batch_size=32, synthetic_size=64, num_workers=2)
_BERT = dict(network="BertTiny", dataset="MLMSynth", batch_size=8,
             test_batch_size=8, seq_len=16, vocab_size=64, eval_batches=2,
             num_workers=2)


def _stream(d):
    with open(os.path.join(d, "telemetry.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("base", [_LENET, _BERT], ids=["LeNet", "BertTiny"])
def test_overlapped_eval_at_two_ranks_equals_the_inline_eval(base,
                                                             tmp_path):
    cfg = TrainConfig(**base, max_steps=4, eval_freq=2, overlap_eval=True,
                      train_dir=str(tmp_path))

    def one(rank, group):
        trainer = Trainer(dataclasses.replace(cfg), device="cpu",
                          group=group)
        try:
            trainer.train()
            return trainer.evaluate()
        finally:
            trainer.close()

    finals = run_ranks(2, one)
    overlap = [e for e in _stream(str(tmp_path))
               if e.get("type") == "eval_result" and e["source"] == "overlap"]
    assert [e["step"] for e in overlap] == [2, 4]
    for k in ("loss", "acc1", "acc5"):
        assert abs(overlap[-1][k] - finals[0][k]) <= 1e-6, k
        assert finals[0][k] == finals[1][k]


def test_simulated_delay_drops_rank_one_and_trips_straggler_burst(tmp_path):
    """delay@2:p1:9s with the simulator on: step 2 drops rank 1 (mean
    0.1 s arrivals against a 1 s deadline), steps 1 and 3 drop none,
    nothing sleeps, and the straggler_drop event opens a straggler_burst
    bundle."""
    cfg = TrainConfig(**_LENET, max_steps=3, straggler_deadline=1.0,
                      faults="delay@2:p1:9s", train_dir=str(tmp_path),
                      metrics_path=str(tmp_path / "telemetry.jsonl"),
                      flightrec="straggler_burst:count=1:window=5,"
                                "capture_steps=1")

    def one(rank, group):
        trainer = Trainer(dataclasses.replace(cfg), device="cpu",
                          group=group)
        try:
            hist = trainer.train()
            return hist, (trainer._flightrec.bundles
                          if trainer._flightrec is not None else None)
        finally:
            trainer.close()

    (hist, bundles), (hist1, _) = run_ranks(2, one, timeout=60.0)
    by_step = {r["step"]: r for r in hist}
    assert by_step[2]["straggler_dropped"] == 1.0
    assert dropped_ranks(by_step[2]["straggler_dropped_mask"]) == [1]
    assert by_step[2]["straggler_skew"] > 5.0
    assert by_step[1]["straggler_dropped"] == by_step[3]["straggler_dropped"] \
        == 0.0
    assert [r["straggler_dropped"] for r in hist1] == [0.0, 1.0, 0.0]
    events = _stream(str(tmp_path))
    drops = [e for e in events if e.get("type") == "straggler_drop"]
    assert [(e["step"], e["dropped"], e["ranks"]) for e in drops] == \
        [(2, 1, [1])]
    # no host sleep: the step's wall is far below the 9 s delay
    assert by_step[2]["step_ms"] < 5000
    assert [os.path.basename(b) for b in bundles] == ["2-straggler_burst"]


def test_simulated_delay_at_world_one_sleeps_nowhere(tmp_path):
    """One rank: the delay is consumed as a simulated arrival time
    (``fault_injected`` with ``simulated: true``), nothing sleeps, and
    min_keep keeps the only rank."""
    cfg = TrainConfig(**{**_LENET, "num_workers": None}, max_steps=3,
                      straggler_deadline=1.0, faults="delay@2:p0:9s",
                      metrics_path=str(tmp_path / "telemetry.jsonl"))
    trainer = Trainer(cfg, device="cpu")
    try:
        hist = trainer.train()
    finally:
        trainer.close()
    assert [r["straggler_dropped"] for r in hist] == [0.0, 0.0, 0.0]
    assert hist[1]["straggler_arrival_max"] > 9.0
    assert hist[1]["step_ms"] < 5000
    fired = [e for e in _stream(str(tmp_path))
             if e.get("type") == "fault_injected"]
    assert [(e["step"], e["simulated"]) for e in fired] == [(2, True)]


# -- --multihost -----------------------------------------------------------


def test_multihost_raises_without_the_torchrun_environment(monkeypatch):
    for k in mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="RANK, LOCAL_RANK, MASTER_ADDR, "
                                           "MASTER_PORT not set"):
        mesh.init_group(torch.device("cpu"), multihost=True)
    from pytorch_distributed_nn_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="--multihost needs the torchrun"):
        main(["train", "--multihost", "--device", "cpu", "--network",
              "LeNet", "--dataset", "MNIST", "--synthetic-size", "64",
              "--max-steps", "1", "--batch-size", "16"])


def test_multihost_retries_a_failing_store(monkeypatch):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    real, calls, sleeps = mesh.dist.TCPStore, [], []

    def flaky(*args, **kwargs):
        calls.append(args)
        if len(calls) < 3:
            raise RuntimeError("connection refused")
        return real(*args, **kwargs)

    monkeypatch.setattr(mesh.dist, "TCPStore", flaky)
    store = mesh.tcp_store(0, 1, multihost=True, sleep=sleeps.append)
    store.set("k", "v")
    assert store.get("k") == b"v"
    assert len(calls) == 3 and len(sleeps) == 2
    assert 2.0 <= sleeps[0] <= 3.0 and 4.0 <= sleeps[1] <= 6.0
    calls.clear()

    def down(*args, **kwargs):
        calls.append(args)
        raise OSError("down")

    monkeypatch.setattr(mesh.dist, "TCPStore", down)
    with pytest.raises(OSError, match="down"):
        mesh.tcp_store(0, 1, multihost=True, sleep=sleeps.append)
    assert len(calls) == 4  # the JAX CLI's 4 attempts
