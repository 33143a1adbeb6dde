"""The port's loader worker pool (``DataLoader(workers=N)``,
pytorch_distributed_nn_tpu_torch/data/{loader,_pool}.py) and native
augment binding (data/native_augment.py) against the JAX package's, on
the CPU.

The pool's batches equal, bit for bit, the JAX ``_pool_make_batch``
called in this process on the same indices and seeds (the JAX pool is
never spawned here); at 2 ranks each rank's rows come from the global
draws, so the rows put together are the JAX batch. ``close()`` returns
within its deadline with no worker left and the shared block unlinked;
a pool that produces nothing raises JAX's message. The native engine's
bytes equal the JAX binding's and the numpy gather's; outside its
contract it declines as the JAX binding does. Each test that spawns or
runs threads has its own deadline.
"""

import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from pytorch_distributed_nn_tpu.data import datasets as jax_datasets
from pytorch_distributed_nn_tpu.data import loader as jax_loader
from pytorch_distributed_nn_tpu.data import native_augment as jax_native
from pytorch_distributed_nn_tpu_torch.data import _pool, datasets
from pytorch_distributed_nn_tpu_torch.data import native_augment
from pytorch_distributed_nn_tpu_torch.data.loader import DataLoader
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
import torch_cpu  # one intra-op thread here and in subprocesses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a spawned pool's deadline (the first batch pays the workers' start)
DEADLINE = 90.0
B, N_BATCHES = 16, 6  # 64 images: 4 batches an epoch, so 6 cross one


def within(fn, seconds=DEADLINE):
    """fn() on a thread, failing if it takes more than ``seconds``."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # re-raised on the caller's thread
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if err:
        raise err[0]
    return out[0]


def _workers(loader):
    """The worker processes of ``loader``'s pool."""
    return list(loader._pool._processes.values())


@pytest.fixture(scope="module")
def cifar():
    return datasets.load_dataset("Cifar10", True, synthetic_size=64)


def _jax_pool_batches(ds, seed, n):
    """The JAX ``_pool_make_batch`` in this process, on the indices the
    port's loader of ``seed`` walks and the JAX pool's (seed, counter)
    seeds."""
    jds = jax_datasets.load_dataset("Cifar10", True, synthetic_size=64)
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(create=True, size=jds.raw_images.nbytes)
    try:
        np.ndarray(jds.raw_images.shape, np.uint8,
                   buffer=shm.buf)[:] = jds.raw_images
        jax_loader._pool_init(shm.name, jds.raw_images.shape, jds.labels,
                              jds.mean, jds.std, jds.augment)
        order = DataLoader(ds, B, seed=seed, prefetch=0)
        out = [jax_loader._pool_make_batch(order._next_idx(), (seed, k + 1))
               for k in range(n)]
    finally:
        jax_loader._POOL_STATE = None
        shm.close()
        shm.unlink()
    return out


def test_pool_batches_equal_the_jax_pool_make_batch(cifar):
    """Two workers, 6 batches over an epoch boundary, then close():
    within 10 s, no worker process left, the shared block unlinked."""
    want = _jax_pool_batches(cifar, 7, N_BATCHES)

    def run():
        loader = DataLoader(cifar, B, seed=7, workers=2, device="cpu")
        try:
            got = [loader.next_batch() for _ in range(N_BATCHES)]
            name = loader._shm.name
            procs = _workers(loader)
        finally:
            t0 = time.monotonic()
            loader.close()
            close_s = time.monotonic() - t0
        return got, name, close_s, procs

    got, name, close_s, procs = within(run)
    for (x, y), (wx, wy) in zip(got, want):
        assert x.dtype.is_floating_point and y.dtype.itemsize == 8
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)
    assert close_s < DataLoader.CLOSE_TIMEOUT_S
    assert len(procs) == 2 and not any(p.is_alive() for p in procs)
    assert not os.path.exists(f"/dev/shm/{name}")


def test_pool_rows_of_two_ranks_come_from_the_global_draws(cifar):
    """Ranks 0 and 1 of 2 (one pool each): each rank's rows, put
    together, equal the JAX batch drawn for the global batch."""
    want = _jax_pool_batches(cifar, 11, 3)

    def run():
        parts, procs = [], []
        for rank in range(2):
            loader = DataLoader(cifar, B, seed=11, workers=1, rank=rank,
                                world=2, device="cpu")
            try:
                parts.append([loader.next_batch() for _ in range(3)])
                procs += _workers(loader)
            finally:
                loader.close()
        return parts, procs

    parts, procs = within(run)
    for i, (wx, wy) in enumerate(want):
        x = np.concatenate([p[i][0].numpy() for p in parts])
        y = np.concatenate([p[i][1].numpy() for p in parts])
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
    assert procs and not any(p.is_alive() for p in procs)


class _Silent:
    """An executor whose batches never come."""

    def submit(self, *args, **kwargs):
        return Future()

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def test_a_pool_that_produces_nothing_raises_the_jax_message(cifar):
    loader = DataLoader(cifar, B, workers=2, device="cpu")
    loader._pool = _Silent()
    loader.FIRST_BATCH_TIMEOUT_S = 0.2
    with pytest.raises(RuntimeError, match=r"loader worker pool produced no "
                       r"batch for 0\.2s — a worker process likely died"):
        within(loader.next_batch, 10.0)
    loader.close()


def test_worker_module_imports_no_torch():
    """A spawned worker imports data/_pool.py (and through it the
    datasets and the native binding) and not torch."""
    code = ("import sys; import pytorch_distributed_nn_tpu_torch.data._pool; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=REPO,
                         env=torch_cpu.SUBPROCESS_ENV)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_attach_leaves_the_block_to_its_creator():
    """A worker's attach does not register the block for cleanup: after
    it closes, the creator still unlinks it."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(create=True, size=64)
    try:
        other = _pool.attach(shm.name)
        other.buf[0] = 7
        other.close()
        assert shm.buf[0] == 7
    finally:
        shm.close()
        shm.unlink()


def _draws(n, seed):
    rng = np.random.RandomState(seed)
    return datasets.augment_draws(rng, n)


@pytest.mark.parametrize("name,n", [("Cifar10", 16), ("SVHN", 7)])
def test_native_engine_bytes_equal_the_jax_binding_and_the_gather(name, n):
    assert native_augment.available() and jax_native.available()
    x = datasets.load_dataset(name, True, synthetic_size=n).images
    ys, xs, flip = _draws(n, 5)
    got = native_augment.augment_f32(x, ys, xs, flip)
    np.testing.assert_array_equal(got, jax_native.augment_f32(x, ys, xs,
                                                              flip))
    np.testing.assert_array_equal(got, datasets.augment_gather(x, ys, xs,
                                                               flip))
    np.testing.assert_array_equal(
        datasets.augment_batch(x, np.random.RandomState(9)),
        jax_datasets.augment_batch(x, np.random.RandomState(9)))


@pytest.mark.parametrize("case", ["float64", "tiny"])
def test_native_engine_declines_outside_its_contract(case):
    x = np.random.RandomState(0).rand(3, 8, 8, 2)
    if case == "tiny":
        x = x[:, :4, :4].astype(np.float32)
    ys, xs, flip = _draws(3, 1)
    assert native_augment.augment_f32(x, ys, xs, flip) is None
    assert jax_native.augment_f32(x, ys, xs, flip) is None
    if case == "float64":  # the dispatch falls back to the gather
        np.testing.assert_array_equal(
            datasets.augment(x, ys, xs, flip),
            datasets.augment_gather(x, ys, xs, flip))


def test_trainer_host_layout_runs_the_pool():
    """``loader_workers`` on the host layout: the trainer's batches come
    from the pool (JAX seeding), and closing the trainer stops it."""
    def run():
        trainer = Trainer(TrainConfig(
            network="LeNet", dataset="MNIST", batch_size=16,
            test_batch_size=32, synthetic_size=64, max_steps=2,
            data_layout="host", loader_workers=2), device="cpu")
        try:
            history = trainer.train()
            procs = _workers(trainer.train_loader)
        finally:
            trainer.close()
        return history, procs

    history, procs = within(run)
    assert procs and [r["step"] for r in history] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in history)
    assert not any(p.is_alive() for p in procs)
