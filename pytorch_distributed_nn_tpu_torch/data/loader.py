"""Image batch loaders: the port of ``DataLoader`` and ``DeviceDataLoader``
(``pytorch_distributed_nn_tpu/data/loader.py``).

Both walk the same per-epoch (optionally shuffled) index order, drop the
short tail batch by default and wrap across epochs. Data parallelism:
every rank walks the same order (the same seed), takes the same global
batch and keeps its contiguous slice ``[rank * B / world, (rank + 1) *
B / world)``, which is what the JAX package's ``P("data")`` sharding of
the global batch gives each replica. A batch is ``(images, labels)``:
NHWC f32 normalised images and int64 labels on the loader's device.

- :class:`DataLoader`: normalise + augment on the host (numpy, draws from
  a ``RandomState`` in the JAX host loader's order, for the whole global
  batch), one background thread keeps ``prefetch`` batches ready. The
  JAX loader's worker-process pool is not ported (ROADMAP Queue 1 item 3).
- :class:`DeviceDataLoader`: the uint8 dataset lives on the device; per
  batch the host sends the index slice and the device gathers, pads,
  crops, flips and normalises with torch ops. The crop and flip draws
  come from a device ``torch.Generator`` (seeded per loader, drawn for the
  whole global batch, so every rank sees the same draws); they differ
  from the host loader's numpy draws, the transform is the same.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_distributed_nn_tpu_torch.data.datasets import (
    Dataset,
    augment_draws,
    augment_gather,
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
    """Host-side loader with one prefetch thread (module docstring).

    ``host_transform(k, (x, y))`` (set before the first ``next_batch``),
    when given, is applied to the k-th batch ``next_batch`` returns
    (1-indexed) while it is still on the host (numpy), on the calling
    thread, before the copy to the device: the fault plan's ``nan_grad``
    hook."""

    def __init__(self, dataset: Dataset, batch_size: int, shuffle=True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 rank: int = 0, world: int = 1, device="cpu"):
        super().__init__(dataset, batch_size, shuffle, seed, drop_last, rank,
                         world, device)
        self.prefetch = max(0, prefetch)
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.host_transform = None
        self._drawn = 0  # batches next_batch returned

    def _host_batch(self, idx: np.ndarray):
        local = self._local(len(idx))
        x = self.dataset.images[idx[local]]
        if self.dataset.augment:
            ys, xs, flip = augment_draws(self._rng, len(idx))
            x = augment_gather(x, ys[local], xs[local], flip[local])
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

    def next_batch(self) -> Batch:
        t0 = time.perf_counter()
        host = self.host_transform is not None
        try:
            if self.prefetch == 0:
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
