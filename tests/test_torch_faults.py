"""The port's fault plan (``resilience/faults.py``) and its hooks in the
trainer and the checkpoint writer, held against the JAX package's: the
same grammar, descriptions and errors over the JAX tests' specs, the
same poisoned batches, and one LeNet run per package under the same
faults giving the same ``fault_injected``, ``nonfinite_skip`` and
``retry`` sequence, and the same quarantine and restored step on
resume."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one intra-op thread)
from pytorch_distributed_nn_tpu.resilience import faults as jfaults
from pytorch_distributed_nn_tpu.training.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_nn_tpu.training.trainer import Trainer as JaxTrainer
from pytorch_distributed_nn_tpu_torch.observability import core as obs
from pytorch_distributed_nn_tpu_torch.resilience import faults
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

GOOD = [
    "delay@120:p3:2.5s,crash@200,nan_grad@150,torn_ckpt@100",
    "delay@5",
    "preempt@50",
    "flaky_io@3, torn_ckpt@4",
    "slow_infer@1:0.06s:x400",
    "conn_reset@25,http_503@40:x3",
    "slow_infer@1:0.2s:x8,conn_reset@12,http_503@15:x3",
    "",
]
BAD = [
    "boom@3", "crash@0", "crash@3:p1", "delay@3:q7", "delay",
    "slow_infer@1:p2", "crash@3:x2", "http_503@1:x0", "nan_grad@2:0.5s",
]


@pytest.mark.parametrize("spec", GOOD)
def test_parse_and_describe_equal_jax(spec):
    ours = faults.FaultPlan.parse(spec, seed=7)
    want = jfaults.FaultPlan.parse(spec, seed=7)
    assert ours.describe() == want.describe()
    assert [dataclasses.astuple(e) for e in ours.entries] == [
        dataclasses.astuple(e) for e in want.entries]
    assert ours.delay_table() == want.delay_table()
    assert ours.max_rank_referenced() == want.max_rank_referenced()
    assert ours.has_serving_faults() == want.has_serving_faults()
    for i in range(1, 50):
        assert ours.serving_delay(i) == want.serving_delay(i)
        assert ours.should_conn_reset(i) == want.should_conn_reset(i)
        assert ours.should_503(i) == want.should_503(i)
        assert ours.should_tear(i) == want.should_tear(i)
        assert ours.should_flake(i) == want.should_flake(i)
        assert ours.poison_step(i) == want.poison_step(i)
    if spec:
        again = faults.FaultPlan.parse(ours.describe())
        assert again.describe() == ours.describe()


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_raise_the_jax_error(spec):
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        faults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def _events(telemetry):
    seen = []
    telemetry.subscribe(seen.append)
    return seen


def test_pre_step_fires_and_delays_sleep_their_rank(monkeypatch):
    slept = []
    monkeypatch.setattr(faults.time, "sleep", slept.append)
    tel = obs.Telemetry()
    seen = _events(tel)
    prev = obs.install(tel)
    try:
        plan = faults.FaultPlan.parse("delay@2:p1:0.5s,delay@3:0.25s,"
                                      "crash@4")
        plan.pre_step(1, rank=0)
        plan.pre_step(2, rank=0)  # rank 1's delay: rank 0 records it only
        plan.pre_step(2, rank=1)
        plan.pre_step(3, rank=0)  # no rank: every rank sleeps
        with pytest.raises(faults.InjectedCrash, match="crash@4"):
            plan.pre_step(4, rank=0)
    finally:
        obs.uninstall(tel, prev)
    assert slept == [0.5, 0.25]
    assert [(r["step"], r["fault"], r.get("rank")) for r in seen] == [
        (2, "delay", 1), (2, "delay", 1), (3, "delay", None), (4, "crash",
                                                               None)]


def test_poison_batch_equals_jax_on_numpy_and_cpu_tensors():
    rng = np.random.RandomState(0)
    imgs = rng.randn(4, 2, 2, 1).astype(np.float32)
    labels = rng.randint(0, 10, size=4).astype(np.int32)
    ours = faults.FaultPlan.parse("nan_grad@2")
    want = jfaults.FaultPlan.parse("nan_grad@2")
    assert ours.poison_batch(1, (imgs, labels))[0] is imgs
    got_np = ours.poison_batch(2, (imgs, labels))
    want_np = want.poison_batch(2, (imgs, labels))
    for a, b in zip(got_np, want_np):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    got_t = ours.poison_batch(2, (torch.from_numpy(imgs),
                                  torch.from_numpy(labels)))
    assert torch.isnan(got_t[0]).all() and got_t[0].dtype == torch.float32
    assert torch.equal(got_t[1], torch.from_numpy(labels))
    with pytest.raises(ValueError) as w:
        want.poison_batch(2, (labels,))
    with pytest.raises(ValueError) as g:
        ours.poison_batch(2, (torch.from_numpy(labels),))
    assert str(g.value) == str(w.value)


def test_flaky_and_torn_checkpoint_hooks(tmp_path):
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        create_train_state,
    )

    model = build_model("LeNet").init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda ps: build_optimizer(
        "sgd", ps, 0.1), "cpu")
    plan = faults.FaultPlan.parse("flaky_io@1,torn_ckpt@2")
    tel = obs.Telemetry()
    seen = _events(tel)
    prev = obs.install(tel)
    try:
        d = str(tmp_path)
        ckpt.save_checkpoint(d, state, step=1, fault_plan=plan)
        ckpt.save_checkpoint(d, state, step=2, fault_plan=plan)
    finally:
        obs.uninstall(tel, prev)
    kinds = [(r["type"], r.get("step"), r.get("fault")) for r in seen]
    assert kinds == [("fault_injected", 1, "flaky_io"), ("retry", None, None),
                     ("checkpoint_write", 1, None),
                     ("fault_injected", 2, "torn_ckpt"),
                     ("checkpoint_write", 2, None)]
    assert ckpt.verify_checkpoint(ckpt.checkpoint_path(d, 1))[0]
    ok, reason = ckpt.verify_checkpoint(ckpt.checkpoint_path(d, 2))
    assert not ok and "size mismatch" in reason


# -- one run per package under the same faults --------------------------------

#: the torn checkpoint is the one the crash's emergency save rewrites (the
#: last completed step), so the resume meets it, quarantines it and falls
#: back a step: in both packages a torn file older than a valid newer one
#: is never read by the resume's newest-first scan
SPEC = "nan_grad@2,flaky_io@3,torn_ckpt@5,crash@6"
RUN = dict(network="LeNet", dataset="MNIST", batch_size=16,
           test_batch_size=16, synthetic_size=32, max_steps=6, eval_freq=1,
           async_ckpt=False, data_layout="host", skip_nonfinite=True)
WATCHED = ("fault_injected", "nonfinite_skip", "retry")


def _watched(train_dir):
    with open(os.path.join(train_dir, "telemetry.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [(r["type"], r.get("step"), r.get("fault")) for r in recs
            if r.get("type") in WATCHED]


def _quarantined(train_dir):
    q = os.path.join(train_dir, ckpt.QUARANTINE_DIR)
    return sorted(os.listdir(q)) if os.path.isdir(q) else []


def _crash_then_resume(make, crash_exc, train_dir):
    trainer = make(dict(RUN, faults=SPEC, train_dir=train_dir))
    try:
        with pytest.raises(crash_exc, match="crash@6"):
            trainer.train()
    finally:
        trainer.close()
    events = _watched(train_dir)
    trainer = make(dict(RUN, resume=True, train_dir=train_dir))
    try:
        start = trainer.start_step
        steps = [r["step"] for r in trainer.train()]
    finally:
        trainer.close()
    return events, start, steps, _quarantined(train_dir)


def test_lenet_fault_run_and_resume_equal_jax(tmp_path):
    want = _crash_then_resume(
        lambda kw: JaxTrainer(JaxTrainConfig(num_workers=1, **kw)),
        jfaults.InjectedCrash, str(tmp_path / "jax"))
    got = _crash_then_resume(
        lambda kw: Trainer(TrainConfig(**kw), device="cpu"),
        faults.InjectedCrash, str(tmp_path / "port"))
    assert got == want
    events, start, steps, quarantined = got
    assert events == [
        ("fault_injected", 2, "nan_grad"), ("nonfinite_skip", 2, None),
        ("fault_injected", 3, "flaky_io"), ("retry", None, None),
        ("fault_injected", 5, "torn_ckpt"), ("fault_injected", 6, "crash"),
        ("fault_injected", 5, "torn_ckpt")]
    assert start == 4 and steps == [5, 6]
    assert quarantined == ["model_step_5", "model_step_5.meta.json"]


def test_trainer_refuses_what_jax_refuses(tmp_path):
    base = dict(network="LeNet", dataset="MNIST", batch_size=16,
                test_batch_size=16, synthetic_size=32, max_steps=1,
                train_dir=str(tmp_path))
    with pytest.raises(ValueError, match="rank p9"):
        Trainer(TrainConfig(**base, faults="delay@1:p9"), device="cpu")
    with pytest.raises(ValueError, match="data_layout"):
        Trainer(TrainConfig(**base, faults="nan_grad@1",
                            data_layout="device"), device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        Trainer(TrainConfig(network="BertTiny", dataset="MLMSynth",
                            batch_size=4, seq_len=32, max_steps=1,
                            faults="nan_grad@1"), device="cpu")
    with pytest.raises(ValueError, match="unknown fault kind"):
        Trainer(TrainConfig(**base, faults="boom@1"), device="cpu")
