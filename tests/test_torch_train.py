"""The port's MLM training slice (pytorch_distributed_nn_tpu_torch: models,
data, metrics, optim, training, cli) against the JAX package, on the CPU.

The JAX side runs its Pallas flash attention and LayerNorm in interpret
mode; the port's kernel wrappers run their plain versions (CPU tensors).
Weights come from the JAX model's init and cross through the converter;
data comes from the two packages' own ``MLMBatches`` with the same seeds.
Tolerances: the converter and the batches exactly; f32 logits at atol
1e-5; loss and metrics at 1e-6 (one reduction over the same logits);
optimizer updates at 1e-6; three whole train steps at 1e-5 on each
step's loss and 1e-5 on the parameters after the third (SGD at lr 0.5
moves them by O(1e-2) per step, and the gradients of the two sides agree
to about 1e-7).
"""

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.data.text import MLMBatches as JaxBatches
from pytorch_distributed_nn_tpu.models import build_model as jax_build_model
from pytorch_distributed_nn_tpu.ops import metrics as jax_metrics
from pytorch_distributed_nn_tpu.ops.pallas_kernels import pallas_attention
from pytorch_distributed_nn_tpu.optim import adam as jax_adam
from pytorch_distributed_nn_tpu.optim import sgd as jax_sgd
from pytorch_distributed_nn_tpu.parallel import make_grad_sync, make_mesh
from pytorch_distributed_nn_tpu.parallel.mesh import DATA_AXIS
from pytorch_distributed_nn_tpu.parallel.partitioning import unbox
from pytorch_distributed_nn_tpu.training.train_step import (
    build_train_step as jax_build_train_step,
)
from pytorch_distributed_nn_tpu.training.train_step import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_nn_tpu_torch.data.text import MLMBatches
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from pytorch_distributed_nn_tpu_torch.ops import kernels, metrics
from pytorch_distributed_nn_tpu_torch.optim import (
    build_optimizer,
    make_schedule,
)
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    build_train_step,
    create_train_state,
)
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
from torch_ranks import run_ranks

import torch_cpu  # one intra-op thread here and in subprocesses

#: BertTiny cut to test size, f32, no dropout
BERT_KW = dict(vocab_size=64, max_len=32, d_model=64, num_heads=4,
               num_layers=2, d_ff=128)
L = 32


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _jax_model(network, **kw):
    if network == "BertTiny":
        kw = {**BERT_KW, **kw}
    model = jax_build_model(network, attn_fn=pallas_attention, fused_ln=True,
                            dtype=jnp.float32, dropout_rate=0.0, **kw)
    rng = jax.random.PRNGKey(0)
    variables = unbox(model.init({"params": rng, "dropout": rng},
                                 jnp.zeros((1, L), jnp.int32), train=False))
    return model, jax.tree.map(np.asarray, variables["params"])


def _port_model(network, params, **kw):
    if network == "BertTiny":
        kw = {**BERT_KW, **kw}
    model = build_model(network, attn_fn=kernels.flash_attention,
                        fused_ln=True, dtype="float32", dropout_rate=0.0,
                        **kw)
    model.load_state_dict(flax_to_state_dict(params))
    return model


@pytest.fixture(scope="module")
def bert():
    return _jax_model("BertTiny")


@pytest.mark.parametrize("tie", [True, False])
def test_bert_converter_round_trip_is_exact(tie):
    _, params = _jax_model("BertTiny", tie_embeddings=tie)
    model = _port_model("BertTiny", params, tie_embeddings=tie)
    assert set(flax_to_state_dict(params)) == set(model.state_dict())
    back = state_dict_to_flax(model.state_dict(), model.config.num_heads)
    a, b = dict(_flat(params)), dict(_flat(back))
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])


@pytest.mark.parametrize("pad", [0, 6])
def test_bert_logits_match_jax(bert, pad):
    model, params = bert
    rng = np.random.RandomState(pad)
    tokens = rng.randint(0, 64, size=(2, L)).astype(np.int32)
    mask = None
    if pad:
        mask = np.ones((2, L), np.int32)
        mask[-1, L - pad:] = 0
    want = model.apply({"params": params}, jnp.asarray(tokens),
                       mask=None if mask is None else jnp.asarray(mask))
    port = _port_model("BertTiny", params).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long(),
                   None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, L, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mlm_batches_are_byte_identical():
    kw = dict(vocab_size=200, seq_len=24, batch_size=5, seed=3,
              mask_prob=0.2, branching=6, corpus_seed=1)
    mine, theirs = MLMBatches(**kw), JaxBatches(**kw)
    for _ in range(3):
        for a, b in zip(next(mine), next(theirs)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for (xa, ya), (xb, yb) in zip(mine.eval_set(2), theirs.eval_set(2)):
        assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()


def test_masked_loss_and_metrics_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 16, 40).astype(np.float32)
    labels = rng.randint(0, 40, size=(3, 16)).astype(np.int32)
    labels[rng.rand(3, 16) < 0.6] = -1
    logits[0, :4] = 0.0                   # ties count against the label
    logits[1, 0, labels[1, 0] if labels[1, 0] >= 0 else 0] = np.nan
    labels[1, 0] = max(labels[1, 0], 0)   # a NaN label logit is no hit
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels).long()
    want = {"acc1": jax_metrics.masked_accuracy(jl, jy),
            "acc5": jax_metrics.masked_topk_accuracy(jl, jy, 5)}
    got = metrics.mlm_metrics(tl, ty)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    keep = np.isfinite(logits).all(-1)  # the NaN row's loss is NaN on both
    y2 = np.where(keep, labels, -1)
    np.testing.assert_allclose(
        float(metrics.masked_cross_entropy(tl, torch.from_numpy(y2).long())),
        float(jax_metrics.masked_cross_entropy(jl, jnp.asarray(y2))),
        atol=1e-6)
    sums = metrics.mlm_sums(tl, torch.from_numpy(y2).long())
    jsums = jax_metrics.mlm_sums(jl, jnp.asarray(y2))
    for k in jsums:
        np.testing.assert_allclose(float(sums[k]), float(jsums[k]),
                                   atol=1e-5)


def _schedule_jax(lr, warm, decay, factor):
    def f(count):
        scale = jnp.minimum(1.0, (count + 1) / warm) if warm else 1.0
        if decay:
            scale = scale * factor ** (count // decay)
        return lr * scale
    return f


@pytest.mark.parametrize("name,kw,jax_opt", [
    ("sgd", dict(momentum=0.9, weight_decay=0.01, nesterov=True),
     lambda lr: jax_sgd(lr, momentum=0.9, weight_decay=0.01, nesterov=True)),
    ("sgd", dict(momentum=0.9),
     lambda lr: jax_sgd(lr, momentum=0.9)),
    ("adam", dict(weight_decay=0.01, amsgrad=True),
     lambda lr: jax_adam(lr, weight_decay=0.01, amsgrad=True)),
    ("adam", dict(), lambda lr: jax_adam(lr)),
])
@pytest.mark.parametrize("warmup", [0, 3])
def test_optimizer_updates_match_jax(name, kw, jax_opt, warmup):
    """Three updates on the same gradients, with and without the
    trainer's warmup + step decay schedule (step 1 uses lr(0))."""
    rng = np.random.RandomState(1)
    p0 = {"w": rng.randn(3, 4).astype(np.float32),
          "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              p0.items()} for _ in range(3)]
    decay = 2 if warmup else None
    lr = _schedule_jax(0.1, warmup, decay, 0.5) if warmup else 0.1
    opt = jax_opt(lr)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = build_optimizer(name, tp.values(),
                           make_schedule(0.1, warmup, decay, 0.5), **kw)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k in jp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6)


def _batches(vocab, seed=0):
    return MLMBatches(vocab_size=vocab, seq_len=L, batch_size=4, seed=seed)


def _three_steps_against_jax(network, grad_accum=1):
    """Three SGD steps of the port's train step against the JAX
    package's, same weights, same batches; with ``grad_accum`` > 1 the
    JAX step accumulates ``mlm_sums`` pairs, as its trainer does."""
    model, params = _jax_model(network)
    vocab = model.config.vocab_size
    opt = jax_sgd(0.5, momentum=0.9)
    mesh = make_mesh(1, 1, 1, devices=jax.devices()[:1])
    jstep = jax_build_train_step(
        model, opt, make_grad_sync("local"), mesh,
        loss_fn=jax_metrics.make_global_masked_cross_entropy(DATA_AXIS),
        metrics_fn=jax_metrics.make_global_mlm_metrics(DATA_AXIS),
        donate=False, grad_accum=grad_accum,
        pair_accum_fn=jax_metrics.mlm_sums if grad_accum > 1 else None)
    jstate = jax_create_train_state(
        model, opt, make_grad_sync("local"), jax.random.PRNGKey(0), (L,),
        input_dtype=jnp.int32)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params))
    port = _port_model(network, params)
    state = create_train_state(
        port, lambda ps: build_optimizer("sgd", ps, 0.5, momentum=0.9),
        "cpu")
    step = build_train_step(grad_accum=grad_accum)
    data = _batches(vocab)
    for _ in range(3):
        x, y = next(data)
        jstate, jm = jstep(jstate, (x, y), jax.random.PRNGKey(1))
        m = step(state, (torch.from_numpy(x).long(),
                         torch.from_numpy(y).long()))
        for k in ("loss", "acc1", "acc5"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-5, k
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    for name, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("network", ["BertTiny", "GptTiny"])
def test_three_train_steps_match_jax(network):
    """The slice as a whole: three SGD steps against the JAX package."""
    _three_steps_against_jax(network)


def test_three_grad_accum_steps_match_jax():
    """grad_accum=2 (the exact (sum of loss, count) pairing) against the
    JAX step with grad_accum=2 and ``pair_accum_fn=mlm_sums``."""
    _three_steps_against_jax("BertTiny", grad_accum=2)


def test_grad_accum_matches_the_whole_batch():
    """grad_accum=2 accumulates (sum of masked CE, count) pairs: the
    same update as one step over the whole batch."""
    _, params = _jax_model("BertTiny")
    x, y = next(_batches(64, seed=4))
    batch = (torch.from_numpy(x).long(), torch.from_numpy(y).long())
    out = []
    for accum in (1, 2):
        state = create_train_state(
            _port_model("BertTiny", params),
            lambda ps: build_optimizer("sgd", ps, 0.5), "cpu")
        m = build_train_step(grad_accum=accum)(state, batch)
        out.append((m, state.model.state_dict()))
    for k in ("loss", "acc1", "acc5"):
        assert abs(float(out[0][0][k]) - float(out[1][0][k])) <= 1e-6
    for name, p in out[0][1].items():
        np.testing.assert_allclose(p.numpy(), out[1][1][name].numpy(),
                                   atol=1e-6)


def test_cli_train_on_the_cpu(tmp_path):
    metrics_path = tmp_path / "m.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "train",
         "--device", "cpu", "--network", "BertTiny", "--dataset",
         "MLMSynth", "--optimizer", "adam", "--learning-rate", "1e-3",
         "--attn-impl", "pallas", "--fused-ln", "--batch-size", "4",
         "--seq-len", "32", "--max-steps", "2", "--eval-batches", "1",
         "--test-batch-size", "4", "--metrics-path", str(metrics_path)],
        capture_output=True, text=True, timeout=300,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]),
        env=torch_cpu.SUBPROCESS_ENV)
    assert proc.returncode == 0, proc.stderr
    records = [json.loads(line) for line in metrics_path.read_text().split(
        "\n") if line]
    assert records[0]["kind"] == "manifest"
    steps = [r for r in records if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert np.isfinite(r["loss"]) and r["step_ms"] > 0
        assert r["tokens_per_sec"] > 0 and 0 <= r["acc1"] <= r["acc5"] <= 1
    assert "Validation" in proc.stderr
    assert records[-1]["type"] == "eval_result"
    assert records[-1]["sequences"] == 4


_BASE = dict(network="BertTiny", dataset="MLMSynth", batch_size=4,
             test_batch_size=4, seq_len=32, max_steps=1, eval_batches=1)


@pytest.mark.parametrize("field,value", [
    ("tensor_parallel", 2), ("seq_parallel", 2), ("remat", True),
    ("warm_start", "ckpt"),
])
def test_unsupported_flags_raise_naming_their_roadmap_item(field, value,
                                                           tmp_path):
    """The four flags of ROADMAP Queue 1 item 1 used to raise naming it;
    they run now: tp and sp a step on two gloo ranks (the loss equal on
    both), remat and warm start a step on one."""
    cfg = {**_BASE, field: value, "seq_len": 32}
    ranks = 2 if field in ("tensor_parallel", "seq_parallel") else 1
    if field == "warm_start":
        src = TrainConfig(**{**_BASE, "vocab_size": 48, "eval_freq": 1,
                             "train_dir": str(tmp_path / "src"),
                             "async_ckpt": False})
        t = Trainer(src, device="cpu")
        try:
            t.train()
        finally:
            t.close()
        cfg["warm_start"] = str(tmp_path / "src" / "model_step_1")
        cfg["vocab_size"] = 64

    def run(r, group):
        t = Trainer(TrainConfig(**cfg), device="cpu", group=group)
        try:
            losses = [h["loss"] for h in t.train()]
        finally:
            t.close()
        report = t.warm_start_report
        return losses, report

    out = run_ranks(ranks, run)
    losses, report = out[0]
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert all(o[0] == losses for o in out)
    if field == "warm_start":
        assert report["sliced"] == 2 and report["unused"] == 0


@pytest.fixture(scope="module")
def token_shards(tmp_path_factory):
    from pytorch_distributed_nn_tpu_torch.data.streaming import (
        export_text_corpus,
    )

    d = str(tmp_path_factory.mktemp("tokens"))
    export_text_corpus(d, shards=2, sequences=32, vocab_size=64,
                       min_len=8, max_len=40)
    return d


@pytest.mark.parametrize("flags", [
    {"loader_workers": 0}, {"loader_workers": 2},
    {"loader_workers": 2, "stream_prefetch": 0},
])
def test_data_flags_now_run_on_the_text_models(token_shards, flags):
    """``data_path`` and ``loader_workers``, which the text trainer
    refused before streaming input was ported: two steps from a token
    shard directory, with the transform on 0 or 2 threads, prefetched
    or not."""
    from pytorch_distributed_nn_tpu_torch.data.streaming import (
        StreamingLoader,
    )

    cfg = TrainConfig(**{**_BASE, "vocab_size": 64, "max_steps": 2,
                         "data_path": token_shards, **flags})
    trainer = Trainer(cfg, device="cpu")
    try:
        history = trainer.train()
        assert isinstance(trainer.train_loader, StreamingLoader)
        assert trainer.train_loader.state()["consumed"] == 2
    finally:
        trainer.close()
    assert [r["step"] for r in history] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in history)


@pytest.mark.parametrize("field,value", [
    ("sync_mode", "ps"), ("compression", "int8"), ("num_workers", 2),
    ("straggler_deadline", 1.0), ("bucket_bytes", 1024), ("kill_ranks", (1,)),
])
def test_gradient_sync_flags_now_run_on_the_text_models(field, value):
    """The flags the single-rank MLM step refused, each now one step of a
    2-rank BertTiny run (every rank the same finite loss)."""
    cfg = TrainConfig(**{**_BASE, "num_workers": 2, field: value})

    def one(rank, group):
        trainer = Trainer(dataclasses.replace(cfg), device="cpu",
                          group=group)
        try:
            return [r["loss"] for r in trainer.train()]
        finally:
            trainer.close()

    losses = run_ranks(2, one)
    assert losses[0] == losses[1] and np.isfinite(losses[0]).all()


def test_trainer_runs_on_the_card_or_raises():
    cfg = TrainConfig(**_BASE)
    if torch.cuda.is_available():
        assert Trainer(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg)


def test_trainer_trains_and_evaluates_on_the_cpu():
    cfg = dataclasses.replace(TrainConfig(**_BASE), max_steps=3,
                              optimizer="adam", lr=1e-3, attn_impl="pallas",
                              fused_ln=True, warmup_steps=2)
    trainer = Trainer(cfg, device="cpu")
    try:
        history = trainer.train()
        ev = trainer.evaluate()
    finally:
        trainer.close()
    assert [r["step"] for r in history] == [1, 2, 3]
    assert trainer.state.step == 3
    assert set(ev) == {"loss", "acc1", "acc5"} and np.isfinite(ev["loss"])
