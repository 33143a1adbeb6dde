"""The port's background checkpoint writer (training/async_ckpt.py) and
the trainer's use of it, on the CPU: the async file equals the sync one
byte for byte; a second save waits for the first and says so; a writer
failure surfaces at the next wait point; the checkpoint of step N holds
step N's weights although step N + 1 ran while it was written (in-place
safety); the overlapped eval scores the snapshot. Every thread a test
starts has its own deadline (``timeout=`` on each wait and join).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.observability import core as obs
from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    make_grad_sync,
)
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training.async_ckpt import (
    AsyncCheckpointer,
)
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    build_image_train_step,
    create_train_state,
)
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
import torch_cpu  # noqa: F401  (one intra-op thread)

DEADLINE = 60.0  # seconds any one wait or join of these tests may take


@pytest.fixture
def lenet():
    model = build_model("LeNet")
    model.init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda ps: build_optimizer(
        "sgd", ps, 0.1, momentum=0.9), "cpu")
    step = build_image_train_step(make_grad_sync(None, "local"))
    rng = np.random.RandomState(0)

    def run_step():
        x = torch.from_numpy(rng.randn(8, 28, 28, 1).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 10, size=8)).long()
        step(state, (x, y), 0)

    run_step()  # momentum buffers exist
    return state, run_step


@pytest.fixture
def events(tmp_path):
    """The events the process default telemetry receives."""
    path = str(tmp_path / "stream.jsonl")
    tel = obs.Telemetry.for_run(path, obs.run_manifest())
    prev = obs.install(tel)

    def read():
        tel.flush()
        with open(path) as f:
            return [json.loads(line) for line in f]

    yield read
    obs.uninstall(tel, prev)
    tel.close()


def _close(ac):
    ac.close(timeout=DEADLINE)
    assert not ac._thread.is_alive()


def test_async_file_equals_the_sync_file(tmp_path, lenet, events):
    state, _ = lenet
    sync = ckpt.save_checkpoint(str(tmp_path / "sync"), state)
    ac = AsyncCheckpointer(str(tmp_path / "async"))
    try:
        handle = ac.save(state)
        assert handle.done.wait(DEADLINE)
        ac.wait()
    finally:
        _close(ac)
    with open(sync, "rb") as a, open(handle.path, "rb") as b:
        assert a.read() == b.read()
    writes = [e for e in events() if e.get("type") == "checkpoint_write"]
    assert [w["async"] for w in writes if "async" in w] == [True]
    for w in writes:
        assert {"path", "bytes", "write_ms", "stall_ms", "format"} <= set(w)
        assert w["format"] == "file" and w["bytes"] > 0


def test_second_save_waits_for_the_first_and_says_so(tmp_path, lenet,
                                                     events):
    state, _ = lenet
    release = threading.Event()

    def slow_write(*args, **kw):
        assert release.wait(DEADLINE)
        return ckpt.save_checkpoint(*args, **kw)

    ac = AsyncCheckpointer(str(tmp_path), write_fn=slow_write)
    try:
        ac.save(state, step=1)
        timer = threading.Timer(0.2, release.set)
        timer.start()
        t0 = time.perf_counter()
        second = ac.save(state, step=2)
        assert time.perf_counter() - t0 >= 0.15 and second.stall_ms >= 150
        ac.wait()
        timer.join(DEADLINE)
    finally:
        release.set()
        _close(ac)
    bp = [e for e in events() if e.get("type") == "ckpt_backpressure"]
    assert len(bp) == 1 and bp[0]["blocked_on_step"] == 1
    assert bp[0]["step"] == 2 and bp[0]["waited_ms"] >= 150
    assert ckpt.all_steps(str(tmp_path)) == [1, 2]


@pytest.mark.parametrize("where", ["save", "wait", "drain"])
def test_writer_error_surfaces_at_the_next_wait_point(tmp_path, lenet, where):
    state, _ = lenet

    def broken(*args, **kw):
        raise OSError("disk full")

    ac = AsyncCheckpointer(str(tmp_path), write_fn=broken)
    try:
        handle = ac.save(state, step=1)
        assert handle.done.wait(DEADLINE)
        call = {"save": lambda: ac.save(state, step=2), "wait": ac.wait,
                "drain": ac.drain}[where]
        with pytest.raises(OSError, match="disk full"):
            call()
        ac.wait()  # raised once, then cleared
    finally:
        _close(ac)


def test_checkpoint_of_step_n_holds_step_n_weights(tmp_path, lenet):
    """In-place safety: the writer reads the snapshot only after step N+1
    has updated the parameters and momentum in place."""
    state, run_step = lenet
    stepped = threading.Event()

    def late_write(*args, **kw):
        assert stepped.wait(DEADLINE)
        return ckpt.save_checkpoint(*args, **kw)

    want = ckpt.state_tree(state)
    ac = AsyncCheckpointer(str(tmp_path), write_fn=late_write)
    try:
        handle = ac.save(state, step=state.step)
        run_step()  # step N + 1, in place, while step N is being written
        after = ckpt.state_tree(state)
        stepped.set()
        ac.wait()
    finally:
        stepped.set()
        _close(ac)
    got = ckpt.load_raw(handle.path)
    conv1 = ("params", "conv1", "kernel")
    leaf = lambda t: t[conv1[0]][conv1[1]][conv1[2]]  # noqa: E731
    assert not np.array_equal(leaf(after), leaf(want))
    np.testing.assert_array_equal(leaf(got), leaf(want))
    assert int(got["step"]) == 1 and int(after["step"]) == 2
    bufs_now = after["opt_state"]["momentum_buf"]["conv1"]["kernel"]
    bufs = got["opt_state"]["momentum_buf"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        bufs, want["opt_state"]["momentum_buf"]["conv1"]["kernel"])
    assert not np.array_equal(bufs, bufs_now)


def test_async_gc_after_publish(tmp_path, lenet, events):
    state, run_step = lenet
    ac = AsyncCheckpointer(str(tmp_path), keep_last=1)
    try:
        for s in (1, 2, 3):
            ac.save(state, step=s)
            ac.wait()
    finally:
        _close(ac)
    assert ckpt.all_steps(str(tmp_path)) == [3]
    gc = [e for e in events() if e.get("type") == "checkpoint_gc"]
    assert [e["deleted"] for e in gc] == [[1], [2]]


_LENET = dict(network="LeNet", dataset="MNIST", batch_size=16,
              test_batch_size=32, synthetic_size=64)


def test_trainer_overlapped_eval_scores_the_snapshot(tmp_path):
    cfg = TrainConfig(**_LENET, max_steps=4, eval_freq=2, overlap_eval=True,
                      keep_last=1, train_dir=str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    try:
        trainer.train()
        final = trainer.evaluate()
    finally:
        trainer.close()
    with open(os.path.join(str(tmp_path), "telemetry.jsonl")) as f:
        stream = [json.loads(line) for line in f]
    assert stream[0]["kind"] == "manifest"
    overlap = [e for e in stream if e.get("type") == "eval_result"
               and e["source"] == "overlap"]
    assert [e["step"] for e in overlap] == [2, 4]
    for k in ("loss", "acc1", "acc5"):
        assert abs(overlap[-1][k] - final[k]) <= 1e-6, k
    assert ckpt.all_steps(str(tmp_path)) == [4]
    gc = [e for e in stream if e.get("type") == "checkpoint_gc"]
    assert gc and gc[-1]["kept"] == [4]


def test_trainer_sync_and_async_checkpoints_are_the_same_bytes(tmp_path):
    paths = []
    for async_ckpt in (True, False):
        d = str(tmp_path / str(async_ckpt))
        trainer = Trainer(TrainConfig(**_LENET, max_steps=2, eval_freq=2,
                                      async_ckpt=async_ckpt, train_dir=d),
                          device="cpu")
        try:
            trainer.train()
        finally:
            trainer.close()
        paths.append(ckpt.checkpoint_path(d, 2))
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
