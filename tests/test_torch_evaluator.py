"""The port's polling evaluator, CLI subcommands, supervisor and non-finite
guard (training/evaluator.py, cli.py ``single``/``evaluator``,
resilience/supervisor.py, train_step's guard, the trainer's stream)
against the JAX package, on the CPU.

- The port's ``Evaluator`` reads the JAX ``Trainer``'s checkpoints at
  steps 5 and 10 (LeNet) and scores them as the JAX ``Evaluator`` does on
  the same test set: loss within 1e-5 (f32 sums of the same logits in
  other orders), prec@1 and prec@5 equal. It skips a corrupt step and
  stops on an empty eval set.
- ``single`` and ``evaluator --max-evals 2 --timeout 60 --device cpu``
  run as subprocesses; SIGTERM to a supervised ``train`` subprocess leaves
  an emergency checkpoint that a resume continues from.
- ``--skip-nonfinite`` on a NaN batch keeps the parameters and reports
  ``skipped_nonfinite`` 1, as the JAX step does.
- The stream starts with a ``manifest``; its events carry the JAX
  package's field names.

Each subprocess and poll loop has its own deadline (``timeout=``,
``max_evals``); past it the test fails and kills what it started.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.data import DataLoader as JaxDataLoader
from pytorch_distributed_nn_tpu.data import load_dataset as jax_load_dataset
from pytorch_distributed_nn_tpu.models import build_model as jax_build_model
from pytorch_distributed_nn_tpu.optim import sgd as jax_sgd
from pytorch_distributed_nn_tpu.parallel import batch_sharding
from pytorch_distributed_nn_tpu.parallel import make_grad_sync as jax_sync
from pytorch_distributed_nn_tpu.parallel import make_mesh
from pytorch_distributed_nn_tpu.training.evaluator import (
    Evaluator as JaxEvaluator,
)
from pytorch_distributed_nn_tpu.training.train_step import (
    build_train_step as jax_build_train_step,
)
from pytorch_distributed_nn_tpu.training.train_step import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_nn_tpu_torch.data.datasets import load_dataset
from pytorch_distributed_nn_tpu_torch.data.loader import DataLoader
from pytorch_distributed_nn_tpu_torch.data.text import MLMBatches, MLMLoader
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import cnn_to_state_dict
from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    make_grad_sync,
)
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.evaluator import Evaluator
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    build_image_train_step,
    create_train_state,
)
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
import torch_cpu
from torch_jax_runs import lenet_run

REPO = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
DEADLINE = 60.0  # seconds for each subprocess and poll loop
_DATA = ["--network", "LeNet", "--dataset", "MNIST", "--synthetic-size",
         "64", "--batch-size", "16", "--test-batch-size", "32"]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Trainer's LeNet run: checkpoints at steps 5 and 10, and its
    telemetry stream."""
    return lenet_run()


def _port_evaluator(model_dir, **kw):
    state = create_train_state(build_model("LeNet"), lambda ps: build_optimizer(
        "sgd", ps, 0.1), "cpu")
    test = load_dataset("MNIST", train=False, synthetic_size=64)
    loader = DataLoader(test, 32, shuffle=False, prefetch=0, device="cpu")
    return Evaluator(state, loader, model_dir, eval_freq=5,
                     eval_interval=0.01, **kw)


def test_port_evaluator_scores_jax_checkpoints_as_the_jax_evaluator(jax_run):
    trainer, d = jax_run
    loader = JaxDataLoader(
        jax_load_dataset("MNIST", train=False, synthetic_size=64), 32,
        shuffle=False, prefetch=0, sharding=batch_sharding(trainer.mesh))
    want = []
    JaxEvaluator(trainer.model, trainer.state, trainer.mesh, loader, d,
                 eval_freq=5, eval_interval=0.01).run(
        max_evals=2, timeout=DEADLINE,
        on_metrics=lambda s, m: want.append((s, m)))
    got = []
    ev = _port_evaluator(d)
    assert ev.run(max_evals=2, timeout=DEADLINE,
                  on_metrics=lambda s, m: got.append((s, m))) == 2
    assert [s for s, _ in got] == [s for s, _ in want] == [5, 10]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g["loss"] - float(w["loss"])) <= LOSS_TOL
        assert g["acc1"] == pytest.approx(float(w["acc1"]), abs=1e-6)
        assert g["acc5"] == pytest.approx(float(w["acc5"]), abs=1e-6)
    assert set(ev.timings[10]) == {"restore_ms", "eval_ms"}


def test_evaluator_skips_a_corrupt_step_and_stops_on_an_empty_set(
        jax_run, tmp_path):
    _, d = jax_run
    for s in (5, 10):
        for f in (ckpt.checkpoint_path(d, s), ckpt.meta_path(
                ckpt.checkpoint_path(d, s))):
            with open(f, "rb") as src, open(str(tmp_path / os.path.basename(
                    f)), "wb") as dst:
                dst.write(src.read())
    torn = ckpt.checkpoint_path(str(tmp_path), 5)
    with open(torn, "r+b") as f:
        f.truncate(100)
    seen = []
    assert _port_evaluator(str(tmp_path)).run(
        max_evals=1, timeout=DEADLINE,
        on_metrics=lambda s, m: seen.append(s)) == 1
    assert seen == [10]
    # an empty eval set ends the loop at once, with no metrics
    state = create_train_state(build_model("BertTiny"), lambda ps:
                               build_optimizer("sgd", ps, 0.1), "cpu")
    empty = MLMLoader(MLMBatches(vocab_size=state.model.config.vocab_size,
                                 seq_len=16, batch_size=2), "cpu",
                      eval_batches=0)
    ev = Evaluator(state, empty, str(tmp_path), eval_freq=5,
                   eval_interval=0.01)
    assert ev.evaluate_checkpoint(5) == Evaluator.CORRUPT  # not a BertTiny
    ev.model_dir = str(tmp_path / "bert")
    ckpt.save_checkpoint(ev.model_dir, state, step=5)
    t0 = time.monotonic()
    calls = []
    assert ev.run(max_evals=3, timeout=DEADLINE,
                  on_metrics=lambda s, m: calls.append(s)) == 0
    assert calls == [] and time.monotonic() - t0 < DEADLINE / 2


def _cli(*args, timeout=DEADLINE):
    try:
        return subprocess.run(
            [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", *args],
            capture_output=True, text=True, timeout=timeout, cwd=str(REPO),
            env=torch_cpu.SUBPROCESS_ENV)
    except subprocess.TimeoutExpired as e:  # run() killed it
        pytest.fail(f"{args[0]} did not finish in {timeout} s: {e.stderr}")


def test_cli_single_trains_on_the_cpu(tmp_path):
    proc = _cli("single", "--device", "cpu", *_DATA, "--max-steps", "2",
                "--metrics-path", str(tmp_path / "m.jsonl"))
    assert proc.returncode == 0, proc.stderr
    with open(tmp_path / "m.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records[0]["kind"] == "manifest"
    assert records[0]["config"]["sync_mode"] == "local"
    assert [r["step"] for r in records if r["kind"] == "step"] == [1, 2]


def test_cli_evaluator_on_jax_checkpoints(jax_run):
    _, d = jax_run
    proc = _cli("evaluator", "--model-dir", d, *_DATA[:6],
                "--test-batch-size", "32", "--eval-freq", "5",
                "--eval-interval", "0.1", "--max-evals", "2", "--timeout",
                "60", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    want = {}
    _port_evaluator(d).run(max_evals=2, timeout=DEADLINE,
                           on_metrics=lambda s, m: want.__setitem__(s, m))
    assert sorted(out["evaluated"]) == ["10", "5"]
    for s, m in want.items():
        for k in ("loss", "acc1", "acc5"):
            assert out["evaluated"][str(s)][k] == m[k]
    assert out["launches"]["flash_attention_fwd"] == 0


def test_sigterm_leaves_an_emergency_checkpoint_a_resume_continues(
        tmp_path):
    d = str(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "train",
         "--device", "cpu", *_DATA, "--max-steps", "100000", "--supervise",
         "--train-dir", d, "--log-every", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(REPO), env=torch_cpu.SUBPROCESS_ENV)
    try:
        deadline = time.monotonic() + DEADLINE
        while not os.path.exists(os.path.join(d, "heartbeat.json")):
            assert proc.poll() is None, proc.communicate()[1]
            assert time.monotonic() < deadline, "no heartbeat"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=DEADLINE)
    assert proc.returncode == 0, err
    with open(os.path.join(d, "telemetry.jsonl")) as f:
        stream = [json.loads(line) for line in f]
    preempt = [e for e in stream if e.get("type") == "preempt"]
    assert len(preempt) == 1 and preempt[0]["signal"] == signal.SIGTERM
    step = preempt[0]["step"]
    assert step >= 1 and ckpt.all_steps(d) == [step]
    assert ckpt.verify_checkpoint(ckpt.checkpoint_path(d, step)) == (True,
                                                                    "ok")
    trainer = Trainer(TrainConfig(
        network="LeNet", dataset="MNIST", synthetic_size=64, batch_size=16,
        test_batch_size=32, max_steps=step + 2, resume=True, train_dir=d),
        device="cpu")
    try:
        assert trainer.start_step == step
        assert [r["step"] for r in trainer.train()] == [step + 1, step + 2]
    finally:
        trainer.close()


def _nan_batch(B=8):
    rng = np.random.RandomState(3)
    x = rng.randn(B, 28, 28, 1).astype(np.float32)
    x[0, 3, 3, 0] = np.nan
    return x, rng.randint(0, 10, size=B).astype(np.int32)


def test_skip_nonfinite_keeps_the_state_as_the_jax_step_does():
    model = jax_build_model("LeNet", 10)
    opt = jax_sgd(0.1, momentum=0.9)
    sync = jax_sync("allreduce")
    jstate = jax_create_train_state(model, opt, sync, jax.random.PRNGKey(0),
                                    (28, 28, 1))
    jstep = jax_build_train_step(model, opt, sync,
                                 make_mesh(1, 1, devices=jax.devices()[:1]),
                                 donate=False, nonfinite_guard=True)
    x, y = _nan_batch()
    jnew, jm = jstep(jstate, (x, y), jax.random.PRNGKey(1))
    assert float(jm["skipped_nonfinite"]) == 1.0

    port = build_model("LeNet")
    port.load_state_dict(cnn_to_state_dict(
        *jax.tree.map(np.asarray, (jstate.params, jstate.batch_stats))))
    state = create_train_state(port, lambda ps: build_optimizer(
        "sgd", ps, 0.1, momentum=0.9), "cpu")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    step = build_image_train_step(make_grad_sync(None, "local"),
                                  nonfinite_guard=True)
    m = step(state, (torch.from_numpy(x), torch.from_numpy(y).long()), 0)
    assert float(m["skipped_nonfinite"]) == 1.0
    assert all(torch.equal(v, port.state_dict()[k])
               for k, v in before.items())
    # the step advances, the optimizer's count (its schedule) does not
    assert (state.step, state.optimizer.count) == (1, 0)
    assert (int(jnew.step), int(jnew.opt_state.count)) == (1, 0)
    want = cnn_to_state_dict(*jax.tree.map(np.asarray, (jnew.params,
                                                        jnew.batch_stats)))
    for k, v in want.items():
        assert torch.equal(port.state_dict()[k], v), k
    x[0, 3, 3, 0] = 0.0  # a finite batch updates
    m = step(state, (torch.from_numpy(x), torch.from_numpy(y).long()), 1)
    assert float(m["skipped_nonfinite"]) == 0.0 and state.optimizer.count == 1


def test_stream_starts_with_a_manifest_and_events_carry_jax_fields(
        jax_run, tmp_path):
    _, jax_dir = jax_run
    with open(os.path.join(jax_dir, "telemetry.jsonl")) as f:
        jax_stream = [json.loads(line) for line in f]
    trainer = Trainer(TrainConfig(
        network="LeNet", dataset="MNIST", synthetic_size=64, batch_size=16,
        test_batch_size=32, max_steps=10, eval_freq=5, keep_last=1,
        train_dir=str(tmp_path)), device="cpu")
    try:
        trainer.train()
        trainer.evaluate()
    finally:
        trainer.close()
    with open(tmp_path / "telemetry.jsonl") as f:
        stream = [json.loads(line) for line in f]
    assert stream[0]["kind"] == "manifest" and jax_stream[0]["kind"] == \
        "manifest"
    assert {"run_id", "schema", "config", "start_step"} <= set(stream[0])
    assert [r["step"] for r in stream if r["kind"] == "step"] == list(
        range(1, 11))

    def fields(records, etype):
        return {k for e in records if e.get("type") == etype for k in e}

    for etype in ("checkpoint_write", "eval_result"):
        ours, theirs = fields(stream, etype), fields(jax_stream, etype)
        assert ours and ours <= theirs | {"images"}, (etype, ours - theirs)
    assert {"path", "bytes", "write_ms", "stall_ms", "format"} <= fields(
        stream, "checkpoint_write")
    assert {"step", "deleted", "kept", "keep_last", "bytes_freed"} <= fields(
        stream, "checkpoint_gc")


@pytest.mark.parametrize("cmd", ["train", "single", "evaluator"])
def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(cmd):
    from pytorch_distributed_nn_tpu_torch.cli import main

    args = [cmd, *_DATA[:6]] + (["--model-dir", "unused"]
                                if cmd == "evaluator" else [])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
