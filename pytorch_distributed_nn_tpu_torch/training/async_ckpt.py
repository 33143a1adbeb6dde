"""Checkpoints written while training goes on: the port's
``pytorch_distributed_nn_tpu/training/async_ckpt.py``.

A save splits in two::

    save(state)                        # the training loop pays this
      ├─ backpressure wait             # depth 1: one save in flight
      ├─ snapshot: a device clone of every tensor of the state, enqueued
      │  on the step's stream, and a CUDA event after it
      └─ enqueue, return               # stall_ms = all of the above
    writer thread                      # overlaps the next steps
      ├─ wait on the event, copy into page-locked host tensors on its
      │  own stream
      ├─ the JAX state dict, msgpack, host codec
      ├─ the same atomic publish, manifest and retry as a sync save
      └─ --keep-last GC

Contracts:

- **In-place safety** (the JAX package's donation safety). The port's
  step updates parameters, optimizer state and BatchNorm statistics in
  place, so the snapshot may not alias them: the clones are enqueued on
  the step's stream before the next step, which the stream orders after
  them, and the writer copies to the host only after their event. The
  checkpoint of step N holds step N's state although step N + 1 ran while
  it was written. Cost: one transient copy of the state on the device.
- **The host copy is DMA.** The writer copies into page-locked host
  tensors, pinned once by ``warmup`` and reused by every save: a copy to
  pageable memory is staged through the CPU by the driver, and held the
  training thread's launches back for its length (a ResNet-18 step at
  2x, PERF.md §6).
- **Byte identity.** The writer publishes through
  :func:`.checkpoint.save_checkpoint`, from the same host state dict a
  sync save builds: the files are the same bytes.
- **Bounded, never lossy.** A save arriving while one is in flight waits
  for it and emits ``ckpt_backpressure``; none is dropped.
- **Errors surface at the next wait point**: a writer failure is raised
  by the next ``save``, ``wait`` or ``drain``.

``checkpoint_write`` events carry ``async``, ``stall_ms``, ``queued_ms``
and ``fetch_ms`` besides the sync fields.

Sharded directories (a tp/sp state: every rank runs a writer): the
writer thread takes the rank's regions from the host copy
(:func:`.checkpoint.shards_of`) and writes its shard file into the
staging directory; the commit (the CRC32s, ``meta.json`` and the rename,
on rank 0) needs every rank's file, a collective, so over several ranks
it runs on the training thread at the next ``save``, ``wait``, ``drain``
or ``close``, as the JAX writer defers it; on one rank the writer
publishes at once. The directory's bytes are the synchronous
:func:`.checkpoint.save_sharded`'s.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Optional

import torch

from pytorch_distributed_nn_tpu_torch.models.convert import (
    train_state_tensors,
    train_state_to_flax,
)
from pytorch_distributed_nn_tpu_torch.observability.core import get_telemetry
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

logger = logging.getLogger(__name__)

_STOP = object()
#: the writer thread's nice level: serialisation and compression are CPU
#: work, which at nice 15 stretches the write, not the steps (Linux;
#: best effort)
WRITER_NICE = 15


class Snapshot:
    """A device copy of a training state's tensors (keyed as
    :func:`..models.convert.train_state_tensors` keys them), its layout,
    and the event after the copies (``None`` on the CPU)."""

    def __init__(self, layout: dict, tensors: dict,
                 event: Optional[torch.cuda.Event]):
        self.layout, self.tensors, self.event = layout, tensors, event

    @property
    def step(self) -> int:
        return self.layout["step"]

    def wait(self, stream=None) -> None:
        """Make ``stream`` (default: the current one) wait for the copies."""
        if self.event is not None:
            (stream or torch.cuda.current_stream()).wait_event(self.event)


@torch.no_grad()
def snapshot(state, ef_rows=None) -> Snapshot:
    """Clone every tensor of ``state`` on the device, enqueued on the
    current stream (the step's), and record an event after them;
    ``ef_rows``, every rank's residuals gathered for the save, are cloned
    with them."""
    layout, tensors = train_state_tensors(state, ef_rows)
    clones = {k: t.clone() for k, t in tensors.items()}
    event = None
    device = next(iter(tensors.values())).device
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return Snapshot(layout, clones, event)


def _pinned_like(tensors: dict) -> dict:
    return {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for k, t in tensors.items()}


class SaveHandle:
    """One save: its snapshot (``dev_state``; the overlapped eval runs on
    it, so the writer drops it only without ``retain_device_state``), and
    ``done``, set once the checkpoint is published or failed. The writer
    reads the snapshot through a reference of its own, which it drops
    once fetched: the overlapped eval may finish, and drop
    ``dev_state``, before the writer starts."""

    def __init__(self, step: int, dev_state: Snapshot,
                 retain_device_state: bool = False, data_state=None,
                 fault_plan=None):
        self.step = step
        self.dev_state = dev_state
        self._writer_snap: Optional[Snapshot] = dev_state
        # the injection hooks ride with the save (checkpoint.py)
        self.fault_plan = fault_plan
        self.retain_device_state = retain_device_state
        self.data_state = data_state
        self.stall_ms = 0.0
        self.enqueued_at = 0.0
        self.path: Optional[str] = None
        self.done = threading.Event()


class AsyncCheckpointer:
    """Depth-1 background checkpoint writer over the sync writer. The
    training thread calls ``save``/``wait``/``drain``/``close``; one
    daemon thread copies, serialises and publishes."""

    def __init__(self, directory: str, *, keep_last: Optional[int] = None,
                 write_fn=None, geometry: Optional[dict] = None,
                 mesh=None):
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = directory
        # a tp/sp run's mesh: the saves are sharded directories
        self.mesh = mesh
        self._pending_commit = None
        self.keep_last = keep_last
        self.geometry = geometry
        # test seam: stands in for checkpoint.save_checkpoint
        self._write_fn = write_fn
        self._stream = None
        self._host: Optional[dict] = None  # page-locked, the writer's
        self._cv = threading.Condition()
        self._in_flight: Optional[SaveHandle] = None
        self._error: Optional[BaseException] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._worker,
                                        name="pdtn-ckpt-writer", daemon=True)
        self._thread.start()

    # -- the training thread -----------------------------------------------

    def warmup(self, state) -> None:
        """Create the writer's copy stream on the state's device, and the
        page-locked host tensors it copies into, ahead of the first save
        (pinning the state's size takes a while)."""
        device = next(state.model.parameters()).device
        if device.type != "cuda":
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if self._host is None:
            # the residuals' rows are pinned at the first save (their
            # replica count is the gather's)
            self._host = _pinned_like(train_state_tensors(state, ())[1])

    def save(self, state, step: Optional[int] = None,
             retain_device_state: bool = False,
             data_state: Optional[dict] = None,
             fault_plan=None, ef_rows=None) -> SaveHandle:
        """Hand one checkpoint of ``state`` to the writer. Blocks for a
        save still in flight (emitting ``ckpt_backpressure``) and for the
        snapshot's enqueue; ``handle.stall_ms`` is that time. ``ef_rows``:
        every rank's residuals, gathered (:func:`snapshot`)."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        t0 = time.perf_counter()
        self._raise_pending()
        self._wait_idle(next_step=step)
        self._raise_pending()
        self._commit_pending()
        if self.mesh is not None:
            ckpt.refuse_file(ckpt.checkpoint_path(
                self.directory, int(state.step if step is None else step)))
        self.warmup(state)
        snap = snapshot(state, ef_rows)
        handle = SaveHandle(int(state.step if step is None else step), snap,
                            retain_device_state=retain_device_state,
                            data_state=data_state, fault_plan=fault_plan)
        handle.stall_ms = (time.perf_counter() - t0) * 1e3
        handle.enqueued_at = time.perf_counter()
        reg = get_telemetry().registry
        reg.gauge("ckpt_queue_depth", help="checkpoint saves in flight").set(1)
        reg.counter("ckpt_stall_ms_total",
                    help="cumulative train-loop ms blocked on "
                         "checkpointing").inc(handle.stall_ms)
        with self._cv:
            self._in_flight = handle
        self._queue.put(handle)
        return handle

    def wait(self) -> None:
        """Block until the save in flight has published; raise a stored
        writer error."""
        self._wait_idle(emit=False)
        self._raise_pending()
        self._commit_pending()

    def drain(self, raise_errors: bool = True) -> None:
        """``wait``, with errors logged instead of raised when
        ``raise_errors`` is false (the emergency path)."""
        try:
            self.wait()
        except Exception:
            if raise_errors:
                raise
            logger.exception("async checkpoint drain: in-flight save failed")

    def close(self, raise_errors: bool = False,
              timeout: float = 600.0) -> None:
        """Drain and stop the writer thread (idempotent)."""
        if self._closed:
            return
        self.drain(raise_errors=raise_errors)
        self._closed = True
        self._queue.put(_STOP)
        self._thread.join(timeout=timeout)
        self._host = None

    # -- internals -----------------------------------------------------------

    def _commit_pending(self) -> None:
        """The training thread's commit of a sharded save of several ranks
        (every rank's file is written once each rank's writer is idle)."""
        pending, self._pending_commit = self._pending_commit, None
        if pending is None:
            return
        tmp, final, step, shapes, fields, data_state = pending
        mesh = self.mesh
        ckpt.barrier(mesh)
        if mesh.rank == 0:
            ckpt.publish_sharded(tmp, final, step, shapes, mesh.size,
                                 self.geometry)
            if data_state is not None:
                ckpt.save_data_state(final, data_state)
        ckpt.barrier(mesh)
        get_telemetry().emit("checkpoint_write", step=step, **fields)
        self._gc()

    def _gc(self) -> None:
        if self.keep_last is not None and (self.mesh is None
                                           or self.mesh.rank == 0):
            try:
                ckpt.gc_checkpoints(self.directory, self.keep_last)
            except Exception:
                logger.exception("checkpoint GC failed (non-fatal)")

    def _write_sharded(self, item: SaveHandle, layout: dict, host: dict,
                       fields: dict) -> None:
        t0 = time.perf_counter()
        shards, shapes = ckpt.shards_of(layout, host)
        final = ckpt.checkpoint_path(self.directory, item.step)
        tmp = final + ".tmp"
        ckpt.write_sharded_local(tmp, shards, self.mesh.rank)
        fields = {"path": final, "format": "sharded",
                  "process": self.mesh.rank,
                  "bytes": sum(int(v.nbytes) for v in shards.values()),
                  "write_ms": round((time.perf_counter() - t0) * 1e3, 3),
                  **fields}
        if self.mesh.size > 1:
            self._pending_commit = (tmp, final, item.step, shapes, fields,
                                    item.data_state)
            return
        ckpt.publish_sharded(tmp, final, item.step, shapes, 1,
                             self.geometry)
        if item.data_state is not None:
            ckpt.save_data_state(final, item.data_state)
        get_telemetry().emit("checkpoint_write", step=item.step, **fields)
        self._gc()

    def _raise_pending(self) -> None:
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _wait_idle(self, next_step: Optional[int] = None,
                   emit: bool = True) -> float:
        with self._cv:
            if self._in_flight is None:
                return 0.0
            blocked_on = self._in_flight.step
            t0 = time.perf_counter()
            while self._in_flight is not None:
                self._cv.wait()
            waited_ms = (time.perf_counter() - t0) * 1e3
        if emit:
            get_telemetry().emit("ckpt_backpressure", step=next_step,
                                 blocked_on_step=blocked_on,
                                 waited_ms=round(waited_ms, 3))
            logger.warning(
                "checkpoint backpressure: save of step %s waited %.0f ms for "
                "the in-flight save of step %d (the writer is slower than "
                "the checkpoint interval)", next_step, waited_ms, blocked_on)
        return waited_ms

    def _worker(self) -> None:
        try:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(),
                           WRITER_NICE)
        except (AttributeError, OSError):
            pass
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            try:
                self._process(item)
            except BaseException as e:  # raised at the next wait point
                logger.exception("async checkpoint of step %d failed",
                                 item.step)
                with self._cv:
                    if self._error is None:
                        self._error = e
            finally:
                item.done.set()
                get_telemetry().registry.gauge(
                    "ckpt_queue_depth",
                    help="checkpoint saves in flight").set(0)
                with self._cv:
                    self._in_flight = None
                    self._cv.notify_all()

    @torch.no_grad()
    def _process(self, item: SaveHandle) -> None:
        t_run = time.perf_counter()
        queued_ms = (t_run - item.enqueued_at) * 1e3
        snap, item._writer_snap = item._writer_snap, None
        if snap.event is not None:
            host = self._fetch(snap)
        else:
            host = snap.tensors  # CPU clones: already the host's
        layout = snap.layout
        fetch_ms = (time.perf_counter() - t_run) * 1e3
        if not item.retain_device_state:
            item.dev_state = None
        del snap
        extra = {"async": True, "stall_ms": round(item.stall_ms, 3),
                 "queued_ms": round(queued_ms, 3),
                 "fetch_ms": round(fetch_ms, 3)}
        if self.mesh is not None:
            self._write_sharded(item, layout, host, extra)
            item.path = ckpt.checkpoint_path(self.directory, item.step)
            return
        writer = self._write_fn or ckpt.save_checkpoint
        item.path = writer(
            self.directory, train_state_to_flax(layout, host), step=item.step,
            data_state=item.data_state, geometry=self.geometry,
            fault_plan=item.fault_plan,
            event_extra=extra)
        self._gc()

    def _fetch(self, snap: Snapshot) -> dict:
        """The snapshot copied into the page-locked host tensors, on the
        writer's stream after the snapshot's event. They are this
        thread's alone and read only until the next fetch: the save is
        written before it."""
        host = self._host = self._host or {}
        # pinned once per key: the residuals' (n, ...) rows join at the
        # first save that carries them
        host.update(_pinned_like({
            k: t for k, t in snap.tensors.items()
            if k not in host or host[k].shape != t.shape
            or host[k].dtype != t.dtype}))
        with torch.cuda.stream(self._stream):
            snap.wait(self._stream)
            for k, t in snap.tensors.items():
                host[k].copy_(t, non_blocking=True)
        self._stream.synchronize()
        return {k: host[k] for k in snap.tensors}
