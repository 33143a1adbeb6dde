"""Sharded streaming input with checkpointable iterator state: the port of
``pytorch_distributed_nn_tpu/data/streaming.py``.

- **Record format** (``.pdsr`` shards), the JAX package's byte for byte:
  a ``<4sIQ`` header (``b"PDSR"``, version 1, record count), then a
  ``u32`` length before each record. Image records are a little-endian
  ``u32`` label and the raw uint8 NHWC pixels; token records are
  little-endian int32 ids of any length. A ``dataset.json`` manifest
  (``format: pdtn-stream-v1``) at the directory's root describes the
  kind, the per-shard record counts and the decode parameters.
  :func:`export_image_dataset` and :func:`export_text_corpus` write the
  same files as the JAX exporters for the same inputs (``data export``).
- **Per-host shards**: a host reads ``shards[host_index::host_count]``.
- **Pipeline**: a reader thread walks the shards in a per-epoch seeded
  order, a pool of ``workers`` threads normalises and augments (images)
  or BERT-masks (tokens) each batch, and an output thread copies the
  batch to the loader's device and keeps ``prefetch`` batches ready.
  ``prefetch=0`` runs everything on the caller's thread.
- **Iterator state**: the batch sequence is a function of ``(seed,
  shard layout, consumed count)``. ``state()`` is the JAX package's
  ``pdtn-stream-state-v1`` JSON field for field, so a checkpoint's
  ``.data.json`` sidecar written by either package restores in the
  other; the snapshot rides with each batch, so with batches in flight
  it is the state of the last one ``next_batch`` returned.

Data parallelism follows the port's rule (``data/loader.py``): every rank
of one node is one JAX "host" (index 0 of 1), reads that host's shards,
draws the transform for the whole host batch of ``batch_size`` rows (the
crop and flip draws for every row, the mask over the whole block) and
keeps its contiguous rows ``[rank * B / world, (rank + 1) * B /
world)``. Put together, the ranks' rows are the JAX single-controller
batch bit for bit at any world size, and a resume on another world size
sees the same shard list. Across nodes (``host_count`` > 1) the node is
the JAX host: it reads its own shards and rank ``r`` keeps the same rows
of its node's batch, the rows a JAX device of global index ``r`` takes of
its host's batch.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.data.datasets import (
    augment,
    augment_draws,
    normalize,
)
from pytorch_distributed_nn_tpu_torch.data.text import (
    BigramCorpus,
    mask_tokens,
)
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device

MAGIC = b"PDSR"
VERSION = 1
META_NAME = "dataset.json"
META_FORMAT = "pdtn-stream-v1"
STATE_FORMAT = "pdtn-stream-state-v1"
_HEADER = struct.Struct("<4sIQ")  # magic, version, record_count
_LEN = struct.Struct("<I")

HostBatch = Tuple[np.ndarray, np.ndarray]


# -- record format ------------------------------------------------------------


class ShardWriter:
    """Write one ``.pdsr`` shard atomically (tmp + rename on close)."""

    def __init__(self, path: str):
        self.path = path
        self._tmp = path + ".tmp"
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self._tmp, "wb")
        self._f.write(_HEADER.pack(MAGIC, VERSION, 0))
        self.count = 0

    def write(self, payload: bytes) -> None:
        self._f.write(_LEN.pack(len(payload)))
        self._f.write(payload)
        self.count += 1

    def close(self) -> None:
        if self._f is None:
            return
        self._f.seek(0)
        self._f.write(_HEADER.pack(MAGIC, VERSION, self.count))
        self._f.flush()
        self._f.close()
        self._f = None
        os.replace(self._tmp, self.path)


class ShardReader:
    """Sequential record reader over one shard; ``seek(n)`` walks the
    length prefixes to record ``n`` (paid on open and restore only)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        magic, version, count = _HEADER.unpack(self._f.read(_HEADER.size))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a PDSR shard (bad magic)")
        if version != VERSION:
            raise ValueError(f"{path}: unsupported shard version {version}")
        self.count = count
        self.pos = 0  # next record index

    def seek(self, record: int) -> None:
        if record < self.pos:
            self._f.seek(_HEADER.size)
            self.pos = 0
        while self.pos < record:
            (length,) = _LEN.unpack(self._f.read(_LEN.size))
            self._f.seek(length, os.SEEK_CUR)
            self.pos += 1

    def read(self) -> Optional[bytes]:
        """The next record's payload, or None at the end of the shard."""
        if self.pos >= self.count:
            return None
        (length,) = _LEN.unpack(self._f.read(_LEN.size))
        payload = self._f.read(length)
        if len(payload) != length:
            raise ValueError(f"{self.path}: torn record {self.pos} "
                             f"({len(payload)} of {length} bytes)")
        self.pos += 1
        return payload

    def read_fixed(self, n: int, length: int) -> Optional[np.ndarray]:
        """The next ``k`` (1 <= k <= n, up to the end of the shard)
        records, each of ``length`` bytes, as a (k, length) uint8 view
        of one read; None at the end of the shard. Raises on a torn
        record or one of another length."""
        n = min(n, self.count - self.pos)
        if n <= 0:
            return None
        step = _LEN.size + length
        buf = self._f.read(n * step)
        if len(buf) != n * step:
            raise ValueError(f"{self.path}: torn record "
                             f"{self.pos + len(buf) // step}")
        rows = np.frombuffer(buf, np.uint8).reshape(n, step)
        lengths = rows[:, :_LEN.size].copy().view("<u4")[:, 0]
        bad = np.flatnonzero(lengths != length)
        if len(bad):
            raise ValueError(f"{self.path}: record {self.pos + bad[0]} is "
                             f"{lengths[bad[0]]} bytes, not {length}")
        self.pos += n
        return rows[:, _LEN.size:]

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def iter_records(path: str) -> Iterator[bytes]:
    r = ShardReader(path)
    try:
        while True:
            payload = r.read()
            if payload is None:
                return
            yield payload
    finally:
        r.close()


def load_meta(path: str) -> dict:
    """Read and validate a shard directory's ``dataset.json`` manifest."""
    meta_file = os.path.join(path, META_NAME)
    if not os.path.isfile(meta_file):
        raise FileNotFoundError(
            f"{path}: no {META_NAME} — not a streaming shard directory "
            "(create one with `cli data export`)")
    with open(meta_file) as f:
        meta = json.load(f)
    if meta.get("format") != META_FORMAT:
        raise ValueError(
            f"{path}: unknown shard-dir format {meta.get('format')!r}")
    return meta


def _write_meta(out_dir: str, meta: dict) -> None:
    tmp = os.path.join(out_dir, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, sort_keys=True, indent=1)
    os.replace(tmp, os.path.join(out_dir, META_NAME))


# -- export -----------------------------------------------------------------


def export_image_dataset(dataset, out_dir: str, shards: int = 8) -> dict:
    """Write an in-memory image ``Dataset`` (``data/datasets.py``) as a
    shard directory of uint8 records (normalisation and augmentation
    happen at load time). Returns the written manifest."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    n = len(dataset)
    if n < shards:
        shards = max(1, n)
    os.makedirs(out_dir, exist_ok=True)
    raw = dataset.raw_images
    labels = np.asarray(dataset.labels, np.int64)
    bounds = [(i * n) // shards for i in range(shards + 1)]
    entries = []
    for s in range(shards):
        fname = f"shard-{s:05d}.pdsr"
        w = ShardWriter(os.path.join(out_dir, fname))
        for i in range(bounds[s], bounds[s + 1]):
            w.write(_LEN.pack(int(labels[i])) + raw[i].tobytes())
        w.close()
        entries.append({"file": fname, "records": w.count})
    meta = {
        "format": META_FORMAT,
        "kind": "image",
        "name": dataset.name,
        "shape": list(raw.shape[1:]),
        "num_classes": int(dataset.num_classes),
        "mean": list(dataset.mean),
        "std": list(dataset.std),
        "augment": bool(dataset.augment),
        "num_records": int(n),
        "shards": entries,
    }
    _write_meta(out_dir, meta)
    return meta


def export_text_corpus(out_dir: str, shards: int = 4, sequences: int = 4096,
                       vocab_size: int = 1024, branching: int = 8,
                       min_len: int = 16, max_len: int = 128, seed: int = 0,
                       corpus_seed: Optional[int] = None) -> dict:
    """Draw ``sequences`` token sequences of lengths in ``[min_len,
    max_len]`` from the synthetic bigram corpus (``data/text.py``) and
    write them as token shards, in the JAX exporter's draw order. Returns
    the written manifest."""
    if not 2 <= min_len <= max_len:
        raise ValueError(f"bad length range [{min_len}, {max_len}]")
    if corpus_seed is None:
        corpus_seed = seed
    corpus = BigramCorpus(vocab_size, branching=branching, seed=corpus_seed)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(
        np.random.MT19937(np.random.SeedSequence((seed, 0xD47A))))
    lengths = rng.randint(min_len, max_len + 1, size=sequences)
    entries = []
    total_tokens = 0
    bounds = [(i * sequences) // shards for i in range(shards + 1)]
    for s in range(shards):
        fname = f"shard-{s:05d}.pdsr"
        w = ShardWriter(os.path.join(out_dir, fname))
        tokens_here = 0
        for i in range(bounds[s], bounds[s + 1]):
            toks = corpus.sample_tokens(rng, 1, int(lengths[i]))[0]
            w.write(toks.astype("<i4").tobytes())
            tokens_here += int(lengths[i])
        w.close()
        entries.append({"file": fname, "records": w.count,
                        "tokens": tokens_here})
        total_tokens += tokens_here
    meta = {
        "format": META_FORMAT,
        "kind": "tokens",
        "vocab_size": int(vocab_size),
        "branching": int(branching),
        "corpus_seed": int(corpus_seed),
        "num_records": int(sequences),
        "num_tokens": int(total_tokens),
        "min_len": int(min_len),
        "max_len": int(max_len),
        "shards": entries,
    }
    _write_meta(out_dir, meta)
    return meta


# -- the streaming loader -----------------------------------------------------


class _Cursor:
    """The reader's position; ``carry`` is the token packer's leftover
    tokens (images never carry)."""

    __slots__ = ("epoch", "shard_pos", "record_pos", "consumed", "carry")

    def __init__(self, epoch=0, shard_pos=0, record_pos=0, consumed=0,
                 carry=None):
        self.epoch = epoch
        self.shard_pos = shard_pos
        self.record_pos = record_pos
        self.consumed = consumed
        self.carry = np.zeros((0,), np.int32) if carry is None else carry


class StreamingLoader:
    """Sharded streaming batch source with checkpointable iterator state
    (module docstring), with the in-memory loaders' surface
    (``steps_per_epoch``, ``next_batch``, ``epoch_batches``, ``skip``,
    ``close``, ``last_wait_ms``) and ``state``, ``restore`` and
    ``restore_repartitioned``.

    - kind ``"image"``: batches of ``batch_size`` records, normalised and
      (when the manifest says so) augmented as ``DataLoader`` does; the
      shard order is reshuffled each epoch, records stay in order within
      a shard, and an epoch's partial tail batch is dropped.
    - kind ``"tokens"``: sequences packed into ``(batch_size, seq_len)``
      blocks by concatenation (the leftover tokens carry into the next
      block) and BERT-masked per batch; the corpus is an endless stream
      whose epochs only mark shard-order reshuffles.

    A batch is this rank's rows as tensors on ``device`` (default: the
    card; raises without one): f32 NHWC images and int64 labels, or int64
    (inputs, labels). ``host_transform(k, (x, y))``, set before the first
    ``next_batch``, is applied to the k-th batch (1-indexed) on the host,
    on the calling thread, before the copy to the device: the fault
    plan's ``nan_grad`` hook.
    """

    def __init__(self, path: str, batch_size: int, *,
                 seq_len: Optional[int] = None, mask_prob: float = 0.15,
                 vocab_size: Optional[int] = None, seed: int = 0,
                 prefetch: int = 2, workers: int = 0,
                 host_index: Optional[int] = None,
                 host_count: Optional[int] = None, rank: int = 0,
                 world: int = 1, device=None):
        self.path = path
        self.meta = load_meta(path)
        self.kind = self.meta["kind"]
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.prefetch = max(0, int(prefetch))
        self.workers = max(0, int(workers))
        self.mask_prob = float(mask_prob)
        self.last_wait_ms = 0.0
        self.host_transform = None
        self._drawn = 0  # batches next_batch returned
        if self.batch_size % world:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{world} data-parallel workers")
        per = self.batch_size // world
        self._rows = slice(rank * per, (rank + 1) * per)
        self.device = resolve_device(device)
        if host_index is None or host_count is None:
            host_index, host_count = 0, 1
        if not 0 <= host_index < host_count:
            raise ValueError(f"host_index {host_index} out of range for "
                             f"{host_count} hosts")
        # strided, so adding a shard never reshuffles every host's set
        self.shards = self.meta["shards"][host_index::host_count]
        if not self.shards:
            raise ValueError(
                f"{path}: {len(self.meta['shards'])} shard(s) leave none "
                f"for host {host_index} of {host_count} — export with at "
                "least one shard per host")
        if self.kind == "image":
            self._shape = tuple(self.meta["shape"])
            self._mean = tuple(self.meta["mean"])
            self._std = tuple(self.meta["std"])
            self._augment = bool(self.meta.get("augment"))
            self._rec_per_epoch = sum(s["records"] for s in self.shards)
            if self.batch_size > self._rec_per_epoch:
                raise ValueError(f"batch_size {batch_size} exceeds this "
                                 f"host's {self._rec_per_epoch} records")
        elif self.kind == "tokens":
            if seq_len is None:
                raise ValueError("kind 'tokens' requires seq_len")
            self.seq_len = int(seq_len)
            self.vocab_size = int(vocab_size if vocab_size is not None
                                  else self.meta["vocab_size"])
            self._tok_per_epoch = sum(int(s.get("tokens", 0))
                                      for s in self.shards)
        else:
            raise ValueError(f"{path}: unknown dataset kind {self.kind!r}")
        self._order: Tuple[int, Optional[np.ndarray]] = (-1, None)
        self._cursor = _Cursor()
        self._last_state = self._snapshot(self._cursor)
        self._reader: Optional[ShardReader] = None
        self._reader_key: Optional[tuple] = None
        # the pipeline (prefetch > 0)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._pool: Optional[ThreadPoolExecutor] = None
        self._fqueue: Optional[queue.Queue] = None
        self._ready: Optional[queue.Queue] = None

    # -- order ------------------------------------------------------------

    def _shard_order(self, epoch: int) -> np.ndarray:
        """The epoch's shard order, a function of (seed, epoch); the
        reader asks for it at every record, so the last one is kept."""
        if self._order[0] == epoch:
            return self._order[1]
        rng = np.random.RandomState(np.random.MT19937(
            np.random.SeedSequence((self.seed + 23, epoch))))
        order = np.arange(len(self.shards))
        rng.shuffle(order)
        self._order = (epoch, order)
        return order

    def _batch_rng(self, index: int) -> np.random.RandomState:
        """The transform's draws for batch ``index``, a function of (seed,
        index): never of the thread that transforms it."""
        return np.random.RandomState(np.random.MT19937(
            np.random.SeedSequence((self.seed + 1, index))))

    @property
    def steps_per_epoch(self) -> int:
        if self.kind == "image":
            return max(1, self._rec_per_epoch // self.batch_size)
        block = self.batch_size * self.seq_len
        return (max(1, self._tok_per_epoch // block) if self._tok_per_epoch
                else 100)

    # -- the in-order reader ----------------------------------------------

    def _ensure_reader(self, cur: _Cursor) -> ShardReader:
        order = self._shard_order(cur.epoch)
        shard = self.shards[int(order[cur.shard_pos])]
        key = (cur.epoch, cur.shard_pos)
        if self._reader is None or self._reader_key != key:
            if self._reader is not None:
                self._reader.close()
            self._reader = ShardReader(os.path.join(self.path, shard["file"]))
            self._reader_key = key
        self._reader.seek(cur.record_pos)
        return self._reader

    def _advance_shard(self, cur: _Cursor) -> bool:
        """Move to the next shard; True when an epoch ended."""
        cur.shard_pos += 1
        cur.record_pos = 0
        if cur.shard_pos >= len(self.shards):
            cur.epoch += 1
            cur.shard_pos = 0
            return True
        return False

    def _next_raw(self):
        """``(index, raw, state_after)`` of the next batch in order; the
        snapshot is what ``state()`` reports once it is consumed."""
        cur = self._cursor
        if self.kind == "image":
            raw = self._next_raw_image(cur)
        else:
            raw = self._next_raw_tokens(cur)
        index = cur.consumed
        cur.consumed += 1
        return index, raw, self._snapshot(cur)

    def _next_raw_image(self, cur: _Cursor):
        """(uint8 NHWC images, int32 labels) of the next batch: records
        of one length, read a shard's run at a time."""
        length = _LEN.size + int(np.prod(self._shape))
        parts, have = [], 0
        while have < self.batch_size:
            rows = self._ensure_reader(cur).read_fixed(
                self.batch_size - have, length)
            if rows is None:
                epoch_end = self._advance_shard(cur)
                if epoch_end and have:
                    parts, have = [], 0  # drop_last: the tail is dropped
                continue
            parts.append(rows)
            have += len(rows)
            cur.record_pos += len(rows)
        rows = parts[0] if len(parts) == 1 else np.concatenate(parts)
        labels = rows[:, :_LEN.size].copy().view("<u4")[:, 0]
        imgs = rows[:, _LEN.size:].reshape(len(rows), *self._shape)
        return imgs, labels.astype(np.int32)

    def _next_raw_tokens(self, cur: _Cursor):
        need = self.batch_size * self.seq_len
        parts = [cur.carry]
        have = len(cur.carry)
        while have < need:
            payload = self._ensure_reader(cur).read()
            if payload is None:
                self._advance_shard(cur)  # an endless stream: wrap epochs
                continue
            toks = np.frombuffer(payload, "<i4").astype(np.int32)
            parts.append(toks)
            have += len(toks)
            cur.record_pos += 1
        flat = np.concatenate(parts)
        cur.carry = flat[need:].copy()
        return flat[:need].reshape(self.batch_size, self.seq_len)

    # -- the transform (the worker threads) -------------------------------

    def _transform(self, raw, index: int) -> HostBatch:
        """This rank's rows of batch ``index``, from the host batch's
        draws."""
        rng = self._batch_rng(index)
        rows = self._rows
        if self.kind == "image":
            imgs, labels = raw
            x = normalize(imgs[rows], self._mean, self._std)
            if self._augment:
                ys, xs, flip = augment_draws(rng, len(imgs))
                x = augment(x, ys[rows], xs[rows], flip[rows])
            return x, labels[rows]
        inputs, labels = mask_tokens(raw, rng, self.vocab_size,
                                     self.mask_prob)
        return (np.ascontiguousarray(inputs[rows]),
                np.ascontiguousarray(labels[rows]))

    def _to_device(self, batch: HostBatch):
        x, y = batch
        if self.kind == "tokens":
            x = x.astype(np.int64)
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y.astype(np.int64)).to(self.device))

    # -- the pipeline (prefetch > 0) --------------------------------------

    def _ensure_pipeline(self, host: bool) -> None:
        if self._threads:
            return
        self._stop.clear()
        depth = max(1, self.prefetch)
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, self.workers),
            thread_name_prefix="pdtn-stream-worker")
        self._fqueue = queue.Queue(maxsize=depth)
        self._ready = queue.Queue(maxsize=depth)
        reader = threading.Thread(target=self._reader_loop,
                                  name="pdtn-stream-reader", daemon=True)
        output = threading.Thread(target=self._output_loop, args=(host,),
                                  name="pdtn-stream-output", daemon=True)
        self._threads = [reader, output]
        reader.start()
        output.start()

    def _put_until_stop(self, q: queue.Queue, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _reader_loop(self) -> None:
        try:
            while not self._stop.is_set():
                index, raw, state = self._next_raw()
                fut = self._pool.submit(self._transform, raw, index)
                if not self._put_until_stop(self._fqueue, (fut, state)):
                    return
        except Exception as e:  # surfaced to the consumer via the queue
            self._put_until_stop(self._fqueue, (e, None))

    def _output_loop(self, host: bool) -> None:
        while not self._stop.is_set():
            try:
                fut, state = self._fqueue.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                if isinstance(fut, Exception):
                    raise fut
                batch = fut.result()
                if not host:
                    batch = self._to_device(batch)
            except Exception as e:
                self._put_until_stop(self._ready, (e, None))
                return
            if not self._put_until_stop(self._ready, (batch, state)):
                return

    def _stop_pipeline(self) -> None:
        if not self._threads:
            return
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self._fqueue = None
        self._ready = None
        # the reader ran ahead of the consumer: back to the last batch
        # next_batch returned, so a restart reproduces the stream
        self._set_cursor(self._last_state)

    def _ready_get(self):
        """The next ready batch; raises if the pipeline's threads stopped
        without handing one over (the wait is never unbounded)."""
        while True:
            try:
                return self._ready.get(timeout=1.0)
            except queue.Empty:
                if not all(t.is_alive() for t in self._threads):
                    try:
                        return self._ready.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            "streaming pipeline stopped without a "
                            "batch") from None

    # -- public surface ---------------------------------------------------

    def next_batch(self):
        t0 = time.perf_counter()
        host = self.host_transform is not None
        if self.prefetch == 0:
            index, raw, state = self._next_raw()
            batch = self._transform(raw, index)
            if not host:
                batch = self._to_device(batch)
        else:
            self._ensure_pipeline(host)
            batch, state = self._ready_get()
            if isinstance(batch, Exception):
                raise RuntimeError(
                    f"streaming pipeline failed: {batch!r}") from batch
        self._last_state = state
        self._drawn += 1
        if host:
            batch = self._to_device(self.host_transform(self._drawn, batch))
        self.last_wait_ms = (time.perf_counter() - t0) * 1000
        return batch

    def epoch_batches(self):
        """One nominal epoch, synchronously."""
        for _ in range(self.steps_per_epoch):
            index, raw, _ = self._next_raw()
            yield self._to_device(self._transform(raw, index))

    def skip(self, n: int) -> None:
        """Fast-forward ``n`` batches without transforming them."""
        if self._threads:
            raise RuntimeError("skip() requires a stopped pipeline")
        for _ in range(int(n)):
            *_, state = self._next_raw()
            self._last_state = state

    def state(self) -> dict:
        """The iterator state after the last batch ``next_batch``
        returned (JSON)."""
        return json.loads(json.dumps(self._last_state))

    def _check_state(self, state: dict) -> None:
        if state.get("format") != STATE_FORMAT:
            raise ValueError(
                f"unknown iterator-state format {state.get('format')!r}")
        if state.get("kind") != self.kind:
            raise ValueError(f"iterator state is kind {state.get('kind')!r}, "
                             f"this loader is {self.kind!r}")

    def restore(self, state: dict) -> None:
        """Continue the exact stream a saved ``state()`` describes."""
        self._check_state(state)
        if list(state.get("shards") or []) != [s["file"] for s in self.shards]:
            raise ValueError(
                "iterator state was saved against a different shard "
                "layout; resume needs the same data_path and host count")
        self._stop_pipeline()
        self._set_cursor(state)
        self._last_state = self._snapshot(self._cursor)

    def restore_repartitioned(self, state: dict) -> dict:
        """Restore a state saved under another per-host shard assignment
        (a changed host count): the same layout takes :meth:`restore`;
        another one re-derives the cursor after ``state["consumed"]``
        batches of this layout (images by arithmetic over the manifest's
        record counts, tokens by :meth:`skip`). Returns ``repartitioned``,
        ``consumed``, ``saved_shards`` and ``shards`` for the trainer's
        ``data_refastforward`` event. Raises on another kind or seed."""
        self._check_state(state)
        saved_shards = list(state.get("shards") or [])
        consumed = int(state.get("consumed", 0))
        if saved_shards == [s["file"] for s in self.shards]:
            self.restore(state)
            return {"repartitioned": False, "consumed": consumed,
                    "saved_shards": len(saved_shards),
                    "shards": len(self.shards)}
        if int(state.get("seed", self.seed)) != self.seed:
            raise ValueError(
                f"iterator state was saved with seed {state.get('seed')} "
                f"but this loader uses seed {self.seed}; the re-derived "
                "stream position would be meaningless")
        self._stop_pipeline()
        self._close_reader()
        self._cursor = _Cursor()
        if self.kind == "image":
            self._cursor = self._image_cursor_at(consumed)
        else:
            self._last_state = self._snapshot(self._cursor)
            self.skip(consumed)
        self._cursor.consumed = consumed
        self._last_state = self._snapshot(self._cursor)
        return {"repartitioned": True, "consumed": consumed,
                "saved_shards": len(saved_shards), "shards": len(self.shards)}

    def _image_cursor_at(self, consumed: int) -> _Cursor:
        """The cursor after ``consumed`` image batches of this layout,
        from the manifest's per-shard record counts alone."""
        per_epoch = self.steps_per_epoch
        epoch = consumed // per_epoch
        records = (consumed % per_epoch) * self.batch_size
        cur = _Cursor(epoch=epoch, consumed=consumed)
        order = self._shard_order(epoch)
        for pos in range(len(self.shards)):
            count = int(self.shards[int(order[pos])]["records"])
            if records <= count:
                cur.shard_pos = pos
                cur.record_pos = records
                break
            records -= count
        return cur

    def _close_reader(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None
            self._reader_key = None

    def close(self) -> None:
        self._stop_pipeline()
        self._close_reader()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- state plumbing ---------------------------------------------------

    def _snapshot(self, cur: _Cursor) -> dict:
        state = {
            "format": STATE_FORMAT,
            "kind": self.kind,
            "seed": self.seed,
            "shards": [s["file"] for s in self.shards],
            "epoch": int(cur.epoch),
            "shard_pos": int(cur.shard_pos),
            "record_pos": int(cur.record_pos),
            "consumed": int(cur.consumed),
        }
        if self.kind == "tokens":
            state["carry"] = [int(t) for t in cur.carry]
        return state

    def _set_cursor(self, state: dict) -> None:
        self._cursor = _Cursor(
            epoch=int(state["epoch"]),
            shard_pos=int(state["shard_pos"]),
            record_pos=int(state["record_pos"]),
            consumed=int(state["consumed"]),
            carry=np.asarray(state.get("carry") or [], np.int32),
        )
        self._reader_key = None  # re-open and seek
