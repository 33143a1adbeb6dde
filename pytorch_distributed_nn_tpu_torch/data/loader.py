"""Image batch loaders: the port of ``DataLoader`` and ``DeviceDataLoader``
(``pytorch_distributed_nn_tpu/data/loader.py``).

Both walk the same per-epoch (optionally shuffled) index order, drop the
short tail batch by default and wrap across epochs. Data parallelism:
every rank walks the same order (the same seed), takes the same global
batch and keeps its contiguous slice ``[rank * B / world, (rank + 1) *
B / world)``, which is what the JAX package's ``P("data")`` sharding of
the global batch gives each replica. A batch is ``(images, labels)``:
NHWC f32 normalised images and int64 labels on the loader's device.

- :class:`DataLoader`: normalise + augment on the host (numpy and the
  native engine, draws from a ``RandomState`` in the JAX host loader's
  order, for the whole global batch), one background thread keeps
  ``prefetch`` batches ready. ``workers=N`` runs the JAX loader's worker
  pool instead: N spawned processes (``data/_pool.py``, numpy only) share
  the uint8 set through ``SharedMemory``, and each batch is built as the
  JAX ``_pool_make_batch`` builds it (normalise, then augment with the
  draws of ``RandomState([seed, counter])`` for the global batch), the
  rank's rows of it. Batches come back in the order they were submitted.
  The pool shuts down without ``Pool.terminate``, whose shutdown can
  deadlock under load: the executor is shut down, its workers get a
  deadline to exit, and only one that misses it is killed.
- :class:`DeviceDataLoader`: the uint8 dataset lives on the device; per
  batch the host sends the index slice and the device gathers, pads,
  crops, flips and normalises with torch ops. The crop and flip draws
  come from a device ``torch.Generator`` (seeded per loader, drawn for the
  whole global batch, so every rank sees the same draws); they differ
  from the host loader's numpy draws, the transform is the same.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing as mp
import queue
import threading
import time
from collections import deque
from concurrent.futures.process import BrokenProcessPool
from multiprocessing import shared_memory
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_distributed_nn_tpu_torch.data import _pool
from pytorch_distributed_nn_tpu_torch.data.datasets import (
    Dataset,
    augment,
    augment_draws,
)

Batch = Tuple[torch.Tensor, torch.Tensor]


class _IndexedLoader:
    """Per-epoch index orders, drop-last, the wrap-around cursor, and this
    rank's slice of each global batch."""

    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool,
                 seed: int, drop_last: bool, rank: int, world: int,
                 device):
        if batch_size > len(dataset):
            raise ValueError(f"batch_size {batch_size} exceeds dataset size "
                             f"{len(dataset)}")
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{world} data-parallel workers")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self._rng = np.random.RandomState(seed)
        self._epoch = 0
        self._order: Optional[np.ndarray] = None
        self._pos = 0
        self.last_wait_ms = 0.0  # how long the last next_batch() blocked

    @property
    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _epoch_index_slices(self, order: np.ndarray) -> Iterator[np.ndarray]:
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                break
            yield idx

    def _next_idx(self) -> np.ndarray:
        exhausted = self._order is None or (
            self._pos >= len(self._order)
            or (self.drop_last
                and self._pos + self.batch_size > len(self._order)))
        if exhausted:
            if self._order is not None:
                self._epoch += 1
            self._order = self._epoch_order()
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return idx

    def _local(self, n: int) -> slice:
        """This rank's rows of a global batch of n."""
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


class DataLoader(_IndexedLoader):
    """Host-side loader with one prefetch thread, or with ``workers``
    processes (module docstring).

    ``host_transform(k, (x, y))`` (set before the first ``next_batch``),
    when given, is applied to the k-th batch ``next_batch`` returns
    (1-indexed) while it is still on the host (numpy), on the calling
    thread, before the copy to the device: the fault plan's ``nan_grad``
    hook."""

    #: how long the pool's first batch (which pays the workers' start) and
    #: each later one may take before the loader gives up on the pool
    FIRST_BATCH_TIMEOUT_S = 600.0
    BATCH_TIMEOUT_S = 120.0
    #: how long close() waits for the workers to exit before killing them
    CLOSE_TIMEOUT_S = 10.0

    def __init__(self, dataset: Dataset, batch_size: int, shuffle=True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 rank: int = 0, world: int = 1, device="cpu",
                 workers: int = 0):
        super().__init__(dataset, batch_size, shuffle, seed, drop_last, rank,
                         world, device)
        self.prefetch = max(0, prefetch)
        self.workers = max(0, workers)
        self._seed = seed
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.host_transform = None
        self._drawn = 0  # batches next_batch returned
        self._pool: Optional[concurrent.futures.ProcessPoolExecutor] = None
        self._shm: Optional[shared_memory.SharedMemory] = None
        self._pending: deque = deque()
        self._aug_counter = 0
        self._pool_batches = 0  # batches the pool returned

    def _host_batch(self, idx: np.ndarray):
        local = self._local(len(idx))
        x = self.dataset.images[idx[local]]
        if self.dataset.augment:
            ys, xs, flip = augment_draws(self._rng, len(idx))
            x = augment(x, ys[local], xs[local], flip[local])
        return np.ascontiguousarray(x), self.dataset.labels[idx[local]]

    def _to_device(self, host) -> Batch:
        x, y = host
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y.astype(np.int64)).to(self.device))

    def _make_batch(self, idx: np.ndarray, host: bool = False):
        batch = self._host_batch(idx)
        return batch if host else self._to_device(batch)

    def _produce(self, host: bool):
        while not self._stop.is_set():
            for idx in self._epoch_index_slices(self._epoch_order()):
                batch = self._make_batch(idx, host)
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._epoch += 1

    # -- the worker pool (workers > 0) ------------------------------------

    def _ensure_pool(self) -> None:
        if self._pool is not None:
            return
        raw = self.dataset.raw_images
        self._shm = shared_memory.SharedMemory(create=True, size=raw.nbytes)
        np.ndarray(raw.shape, dtype=np.uint8, buffer=self._shm.buf)[:] = raw
        self._pool = concurrent.futures.ProcessPoolExecutor(
            self.workers, mp_context=mp.get_context("spawn"),
            initializer=_pool.init,
            initargs=(self._shm.name, raw.shape, self.dataset.labels,
                      self.dataset.mean, self.dataset.std,
                      self.dataset.augment))

    def _submit_one(self) -> None:
        self._aug_counter += 1
        idx = self._next_idx()
        local = self._local(len(idx))
        self._pending.append(self._pool.submit(
            _pool.make_batch, idx, (self._seed, self._aug_counter),
            (local.start, local.stop)))

    def _pool_next(self):
        """The next host batch from the pool, in submission order."""
        self._ensure_pool()
        while len(self._pending) < max(self.prefetch, self.workers):
            self._submit_one()
        # the first batch also pays the workers' start (fresh interpreters
        # importing numpy) and the shared copy of the dataset
        timeout = (self.FIRST_BATCH_TIMEOUT_S if self._pool_batches == 0
                   else self.BATCH_TIMEOUT_S)
        try:
            batch = self._pending.popleft().result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            raise RuntimeError(
                f"loader worker pool produced no batch for {timeout:g}s — a "
                "worker process likely died (OOM-killed or crashed); rerun "
                "with workers=0 to use the in-process loader") from None
        except BrokenProcessPool as e:
            raise RuntimeError(
                f"loader worker pool lost a worker process ({e}); rerun "
                "with workers=0 to use the in-process loader") from e
        self._pool_batches += 1
        return batch

    def _close_pool(self) -> None:
        """Shut the pool down within CLOSE_TIMEOUT_S: queued batches are
        cancelled, each worker finishes its batch and exits, and one that
        has not exited by the deadline is killed. Then the parent unlinks
        the shared block."""
        pool, self._pool = self._pool, None
        if pool is not None:
            procs = list((getattr(pool, "_processes", None) or {}).values())
            pool.shutdown(wait=False, cancel_futures=True)
            deadline = time.monotonic() + self.CLOSE_TIMEOUT_S
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(1.0)
            self._pending.clear()
        if self._shm is not None:
            self._shm.close()
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
            self._shm = None

    def next_batch(self) -> Batch:
        t0 = time.perf_counter()
        host = self.host_transform is not None
        try:
            if self.workers > 0:
                batch = self._pool_next()
                if not host:
                    batch = self._to_device(batch)
            elif self.prefetch == 0:
                batch = self._make_batch(self._next_idx(), host)
            else:
                if self._thread is None:
                    self._queue = queue.Queue(maxsize=self.prefetch)
                    self._thread = threading.Thread(
                        target=self._produce, args=(host,), daemon=True)
                    self._thread.start()
                batch = self._queue.get()
            self._drawn += 1
            if host:
                batch = self._to_device(
                    self.host_transform(self._drawn, batch))
            return batch
        finally:
            self.last_wait_ms = (time.perf_counter() - t0) * 1000

    def epoch_batches(self) -> Iterator[Batch]:
        """One full epoch in order (the eval pass)."""
        for idx in self._epoch_index_slices(self._epoch_order()):
            yield self._make_batch(idx)

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._close_pool()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def augment_on_device(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                      flip: torch.Tensor) -> torch.Tensor:
    """Reflect-pad 4, crop at (dy, dx), flip where ``flip``: x (B, H, W, C)
    f32, dy/dx (B,) int64 in [0, 9), flip (B,) bool; two gathers."""
    B, H, W, _ = x.shape
    padded = F.pad(x.permute(0, 3, 1, 2), (4, 4, 4, 4), mode="reflect")
    rows = dy[:, None] + torch.arange(H, device=x.device)  # (B, H)
    cols = dx[:, None] + torch.arange(W, device=x.device)  # (B, W)
    b = torch.arange(B, device=x.device)[:, None, None]
    out = padded[b, :, rows[:, :, None], cols[:, None, :]]  # (B, H, W, C)
    return torch.where(flip[:, None, None, None], out.flip(2), out)


class DeviceDataLoader(_IndexedLoader):
    """Device-resident loader: the whole uint8 dataset on ``device``, each
    batch built there (module docstring)."""

    def __init__(self, dataset: Dataset, batch_size: int, device,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 rank: int = 0, world: int = 1):
        super().__init__(dataset, batch_size, shuffle, seed, drop_last, rank,
                         world, device)
        self.images = torch.from_numpy(dataset.raw_images).to(self.device)
        self.labels = torch.from_numpy(
            dataset.labels.astype(np.int64)).to(self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._mean = torch.tensor(dataset.mean, dtype=torch.float32,
                                  device=self.device) * 255.0
        self._std = torch.tensor(dataset.std, dtype=torch.float32,
                                 device=self.device) * 255.0

    def _batch_for(self, idx: np.ndarray) -> Batch:
        local = self._local(len(idx))
        idx_dev = torch.from_numpy(idx[local].astype(np.int64)).to(
            self.device, non_blocking=True)
        x = self.images[idx_dev].to(torch.float32)
        if self.dataset.augment:
            n, g = len(idx), self._gen
            dy = torch.randint(0, 9, (n,), generator=g, device=self.device)
            dx = torch.randint(0, 9, (n,), generator=g, device=self.device)
            flip = torch.rand(n, generator=g, device=self.device) < 0.5
            x = augment_on_device(x, dy[local], dx[local], flip[local])
        return (x - self._mean) / self._std, self.labels[idx_dev]

    def next_batch(self) -> Batch:
        t0 = time.perf_counter()
        out = self._batch_for(self._next_idx())
        self.last_wait_ms = (time.perf_counter() - t0) * 1000
        return out

    def epoch_batches(self) -> Iterator[Batch]:
        for idx in self._epoch_index_slices(self._epoch_order()):
            yield self._batch_for(idx)

    def close(self):
        self.images = self.labels = None
