"""Checkpoints in the JAX package's FILE format: the port's
``pytorch_distributed_nn_tpu/training/checkpoint.py`` for what a
single-process run writes and reads.

A checkpoint is ``<train_dir>/model_step_<N>``: 4 magic bytes (``PDTN``
raw, ``PDTZ`` compressed with the native host codec, level 1, shuffle
width 4) and then the flax msgpack of the JAX ``TrainState``'s state dict
``{step, params, opt_state, batch_stats, ef_state}``
(:func:`..models.convert.train_state_to_flax`). Beside it:

- ``model_step_<N>.meta.json``: format, step, bytes and CRC32 of the file,
  and the geometry it was written on;
- ``model_step_<N>.data.json``: the data loader's iterator state, so a
  resumed run continues the exact batch stream (MLM);
- ``published.json``: the steps frozen into serving artifacts, which GC
  never deletes.

Either package reads the other's files: the same bytes describe the same
state, leaf for leaf. Every write is atomic (a tmp file and
``os.replace``) under :func:`..resilience.retry.retry_call`, so a polling
evaluator never reads a torn file and a transient ``OSError`` costs a
retry. :func:`verify_checkpoint` checks size and CRC32 against the
manifest without a restore; a manifest-less file is legacy-unverified,
not corrupt. Without the native codec the writer falls back to raw
``PDTN``, as the JAX package does.

The sharded DIRECTORY format (``model_step_<N>/``) is written only by the
JAX package's tp/sp runs, which the port does not run: reading one
raises, naming ROADMAP Queue 1 item 1.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
import zlib
from typing import Optional, Tuple

import torch

from pytorch_distributed_nn_tpu_torch.models.convert import (
    load_train_state,
    train_state_tensors,
    train_state_to_flax,
)
from pytorch_distributed_nn_tpu_torch.observability.core import get_telemetry
from pytorch_distributed_nn_tpu_torch.resilience.retry import retry_call
from pytorch_distributed_nn_tpu_torch.utils import flax_msgpack

logger = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^model_step_(\d+)$")
MAGIC_RAW = b"PDTN"  # raw msgpack
MAGIC_LZ = b"PDTZ"  # host-codec-compressed msgpack
_FILE_META_FORMAT = "pdtn-file-meta-v1"
_DATA_STATE_FORMAT = "pdtn-data-state-v1"
_PUBLISHED_FORMAT = "pdtn-published-v1"
QUARANTINE_DIR = "quarantine"
PUBLISHED_FILE = "published.json"
_SHARDED = "ROADMAP Queue 1 item 1 (dp x tp x sp training)"


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"model_step_{step}")


def meta_path(path: str) -> str:
    """The integrity manifest beside a FILE checkpoint (never matches the
    step scan)."""
    return path + ".meta.json"


def data_state_path(path: str) -> str:
    """The data loader's iterator-state sidecar of checkpoint ``path``."""
    return path + ".data.json"


def _publish_json(path: str, doc: dict, label: str, **dump_kw) -> None:
    tmp = path + ".tmp"

    def _publish():
        with open(tmp, "w") as f:
            json.dump(doc, f, **dump_kw)
        os.replace(tmp, path)

    retry_call(_publish, attempts=3, base_delay=0.05, retry_on=(OSError,),
               label=label)


def save_data_state(path: str, state: dict) -> None:
    """Publish the iterator-state sidecar of checkpoint ``path``, after
    the checkpoint itself: a crash between the two leaves a checkpoint
    without one, which resume treats as legacy (skip-based)."""
    _publish_json(data_state_path(path),
                  {"format": _DATA_STATE_FORMAT, "state": state},
                  f"data-state write {path}", sort_keys=True)


def load_data_state(path: str) -> Optional[dict]:
    """The iterator state saved beside checkpoint ``path``, or ``None``
    (no sidecar, or one that cannot be read: resume then skips)."""
    sidecar = data_state_path(path)
    if not os.path.isfile(sidecar):
        return None
    try:
        with open(sidecar) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        logger.warning("unreadable iterator-state sidecar %s (%s); resume "
                       "falls back to skip-based fast-forward", sidecar, e)
        return None
    if doc.get("format") != _DATA_STATE_FORMAT:
        logger.warning("unknown iterator-state format %r in %s; ignoring",
                       doc.get("format"), sidecar)
        return None
    return doc.get("state")


def _codec():
    from pytorch_distributed_nn_tpu_torch.ops import host_codec

    return host_codec if host_codec.available() else None


def _refuse_directory(path: str) -> None:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a sharded checkpoint DIRECTORY (written by a tp/sp "
            f"run of the JAX package); the port reads FILE checkpoints "
            f"only: {_SHARDED}")


def default_geometry() -> dict:
    """The geometry a manifest records when its writer gives none: the
    process group's size, else one process."""
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_available()
             and torch.distributed.is_initialized() else 1)
    return {"devices": int(world), "processes": int(world)}


@torch.no_grad()
def state_tree(state) -> dict:
    """The JAX state dict of a port ``TrainState``, copied to the host (a
    copy on the CPU too: the tree outlives the state's next step)."""
    layout, tensors = train_state_tensors(state)
    return train_state_to_flax(
        layout, {k: v.to("cpu", copy=True) for k, v in tensors.items()})


def save_checkpoint(directory: str, state, step: Optional[int] = None,
                    compress: bool = True,
                    event_extra: Optional[dict] = None,
                    data_state: Optional[dict] = None,
                    geometry: Optional[dict] = None,
                    fault_plan=None) -> str:
    """Write one atomic FILE checkpoint, its CRC32 manifest and, given
    ``data_state``, its iterator-state sidecar; emit ``checkpoint_write``.

    ``state`` is a port ``TrainState`` (copied to the host here) or the
    host state dict of one (:func:`state_tree`; the async writer's
    snapshot): both give the same bytes. ``write_ms`` is this call's
    time; ``stall_ms`` is what the training loop lost, the whole write
    here, which an overlapped caller overrides in ``event_extra``.

    ``fault_plan`` (:class:`..resilience.faults.FaultPlan`) is the
    injection hook: a ``flaky_io`` step fails its first publish attempt
    with ``OSError`` (the retry absorbs it and emits ``retry``), and a
    ``torn_ckpt`` step's file is truncated after its publish, which the
    manifest then convicts on resume."""
    t0 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    tree = state if isinstance(state, dict) else state_tree(state)
    step = int(tree["step"]) if step is None else int(step)
    path = checkpoint_path(directory, step)
    tmp = path + ".tmp"
    for p_ in (path, tmp):
        if os.path.isdir(p_):
            raise ValueError(
                f"{p_} exists as a sharded checkpoint DIRECTORY; the port "
                "writes FILE checkpoints: use a fresh --train-dir")
    # one buffer each for the msgpack and the codec's output, written
    # piece by piece: the writer thread holds the GIL for no copy of them
    payload = flax_msgpack.pack_array(tree)
    codec = _codec() if compress else None
    parts = ((MAGIC_LZ, *codec.compress_parts(payload)) if codec is not None
             else (MAGIC_RAW, payload))
    del payload
    nbytes = sum(len(p_) for p_ in parts)
    crc = 0
    for p_ in parts:
        crc = zlib.crc32(p_, crc)

    flake = [fault_plan is not None and fault_plan.should_flake(step)]

    def _publish():
        if flake[0]:
            flake[0] = False
            get_telemetry().emit("fault_injected", step=step,
                                 fault="flaky_io", path=path)
            raise OSError(f"fault: flaky_io@{step} — injected transient EIO")
        with open(tmp, "wb") as f:
            for p_ in parts:
                f.write(p_)
        os.replace(tmp, path)

    retry_call(_publish, attempts=3, base_delay=0.05, retry_on=(OSError,),
               label=f"checkpoint write {path}")
    # the manifest after the data: a crash in between leaves a
    # manifest-less (legacy-unverified) checkpoint, never a corrupt one
    _publish_json(meta_path(path), {
        "format": _FILE_META_FORMAT, "step": step, "bytes": nbytes,
        "crc32": crc & 0xFFFFFFFF,
        "geometry": geometry or default_geometry(),
    }, f"manifest write {path}")
    if data_state is not None:
        save_data_state(path, data_state)
    if fault_plan is not None and fault_plan.should_tear(step):
        _tear_file(path)
        get_telemetry().emit("fault_injected", step=step, fault="torn_ckpt",
                             path=path)
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    fields = {"path": path, "bytes": nbytes,
              "seconds": round(elapsed_ms / 1e3, 6), "format": "file",
              "write_ms": round(elapsed_ms, 3),
              "stall_ms": round(elapsed_ms, 3)}
    if event_extra:
        fields.update(event_extra)
    get_telemetry().emit("checkpoint_write", step=step, **fields)
    return path


def _tear_file(path: str) -> None:
    """torn_ckpt fault: truncate the published file to half its bytes,
    the corruption an atomic writer cannot produce by itself."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size // 2, 1))
    logger.warning("fault: torn_ckpt — truncated %s from %d to %d bytes",
                   path, size, max(size // 2, 1))


def checkpoint_geometry(path: str) -> Optional[dict]:
    """The geometry recorded when checkpoint ``path`` was written, or
    ``None`` (a manifest without one, or none readable)."""
    meta_file = (os.path.join(path, "meta.json") if os.path.isdir(path)
                 else meta_path(path))
    try:
        with open(meta_file) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    geom = meta.get("geometry")
    return dict(geom) if isinstance(geom, dict) else None


def _decode_payload(path: str, blob: bytes) -> memoryview:
    magic, payload = blob[:4], memoryview(blob)[4:]
    if magic == MAGIC_LZ:
        codec = _codec()
        if codec is None:
            raise RuntimeError(f"{path} is host-codec compressed but the "
                               "native codec is unavailable")
        return codec.decompress(payload)
    if magic != MAGIC_RAW:
        raise ValueError(f"{path}: not a pytorch_distributed_nn_tpu "
                         "checkpoint (bad magic bytes)")
    return payload


def load_raw(path: str) -> dict:
    """A FILE checkpoint's state dict, no template: nested dicts of numpy
    arrays (``{"step", "params", "opt_state", "batch_stats",
    "ef_state"}``)."""
    _refuse_directory(path)
    with open(path, "rb") as f:
        blob = f.read()
    return flax_msgpack.unpackb(_decode_payload(path, blob))


def restore_checkpoint(path: str, state, params_only: bool = False):
    """Restore checkpoint ``path`` into the port ``TrainState`` ``state``
    in place and return it. ``params_only`` restores the step, parameters
    and BatchNorm statistics and leaves the optimizer alone (the
    evaluator's template need not match the trainer's optimizer).
    Raises when the file's tree is not the state's."""
    load_train_state(state, load_raw(path), params_only=params_only)
    return state


def all_steps(directory: str) -> list:
    """Every checkpointed step in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(directory)
                  if (m := _STEP_RE.match(name)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _verify_blob(path: str, blob: bytes) -> Tuple[bool, str]:
    if blob[:4] not in (MAGIC_RAW, MAGIC_LZ):
        return False, "bad magic bytes"
    try:
        with open(meta_path(path)) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return True, "ok (no manifest — legacy, unverified)"
    except (OSError, ValueError) as e:
        return False, f"unreadable manifest: {e}"
    if meta.get("bytes") is not None and meta["bytes"] != len(blob):
        return False, f"size mismatch: {len(blob)} != {meta['bytes']}"
    if meta.get("crc32") is not None and \
            (zlib.crc32(blob) & 0xFFFFFFFF) != meta["crc32"]:
        return False, "CRC32 mismatch"
    return True, "ok"


def verify_checkpoint(path: str) -> Tuple[bool, str]:
    """``(ok, reason)`` without a restore: magic bytes, then length and
    CRC32 against the manifest; a file with no manifest is
    ``ok (no manifest — legacy, unverified)``."""
    if not os.path.exists(path):
        return False, "missing"
    _refuse_directory(path)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        return False, f"unreadable: {e}"
    return _verify_blob(path, blob)


def load_verified(path: str) -> dict:
    """:func:`verify_checkpoint` and :func:`load_raw` from one read of the
    file (a GB-sized checkpoint is read once, and a GC that unlinks it
    meanwhile cannot tear the read). Raises ``ValueError`` naming what
    failed, ``OSError`` when the file cannot be read."""
    _refuse_directory(path)
    with open(path, "rb") as f:
        blob = f.read()
    ok, reason = _verify_blob(path, blob)
    if not ok:
        raise ValueError(f"{path}: {reason}")
    return flax_msgpack.unpackb(_decode_payload(path, blob))


def quarantine_checkpoint(path: str) -> str:
    """Move a corrupt ``model_step_<N>`` and its sidecars into
    ``<dir>/quarantine/`` (renames: the step scan no longer sees it, the
    evidence stays)."""
    directory = os.path.dirname(path) or "."
    qdir = os.path.join(directory, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    dest = os.path.join(qdir, os.path.basename(path))
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = os.path.join(qdir, f"{os.path.basename(path)}.{n}")
    os.replace(path, dest)
    for sidecar in (meta_path, data_state_path):
        if os.path.exists(sidecar(path)):
            os.replace(sidecar(path), sidecar(dest))
    return dest


# -- the published-step registry: what GC never deletes --------------------


def published_path(directory: str) -> str:
    return os.path.join(directory, PUBLISHED_FILE)


def _read_published(directory: str) -> dict:
    path = published_path(directory)
    if not os.path.isfile(path):
        return {"format": _PUBLISHED_FORMAT, "artifacts": []}
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != _PUBLISHED_FORMAT:
        raise ValueError(f"{path}: unknown published-step registry format "
                         f"{doc.get('format')!r}")
    return doc


def published_steps(directory: str) -> set:
    """Steps recorded as frozen into serving artifacts. An unreadable
    registry raises: GC must not delete a published step."""
    return {int(e["step"]) for e in _read_published(directory)["artifacts"]}


def record_published_step(directory: str, step: int, artifact: str) -> dict:
    """Record that ``artifact`` was frozen from ``step`` (idempotent)."""
    doc = _read_published(directory)
    entry = {"step": int(step), "artifact": os.path.abspath(artifact),
             "time": time.time()}
    if not any(e.get("step") == entry["step"]
               and e.get("artifact") == entry["artifact"]
               for e in doc["artifacts"]):
        doc["artifacts"].append(entry)
    _publish_json(published_path(directory), doc,
                  f"published-step registry {directory}", indent=2,
                  sort_keys=True)
    return doc


def release_published_step(directory: str, step: int,
                           artifact: Optional[str] = None) -> dict:
    """Drop the records of ``step`` (of one ``artifact``, or all); the
    step's protection ends with its last record."""
    if not os.path.isfile(published_path(directory)):
        return {"format": _PUBLISHED_FORMAT, "artifacts": []}
    doc = _read_published(directory)
    want = os.path.abspath(artifact) if artifact is not None else None
    doc["artifacts"] = [
        e for e in doc["artifacts"]
        if not (int(e.get("step", -1)) == int(step)
                and (want is None or e.get("artifact") == want))]
    _publish_json(published_path(directory), doc,
                  f"published-step registry {directory}", indent=2,
                  sort_keys=True)
    return doc


# -- retention (--keep-last) -----------------------------------------------


def _checkpoint_bytes(path: str) -> int:
    total = 0
    for p_ in (path, meta_path(path), data_state_path(path)):
        try:
            total += os.path.getsize(p_)
        except OSError:
            pass
    return total


def gc_checkpoints(directory: str, keep_last: int, protect=()) -> dict:
    """Delete checkpoints older than the newest ``keep_last`` steps, but
    never the resume target (the newest step that verifies), a step in
    ``protect`` or in the published registry, or one that fails
    verification (corruption evidence: quarantine's job). Emits
    ``checkpoint_gc`` when it deletes; returns ``{"deleted", "kept",
    "bytes_freed"}``."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    protect = set(protect) | published_steps(directory)
    steps = all_steps(directory)
    if len(steps) <= keep_last:
        return {"deleted": [], "kept": steps, "bytes_freed": 0}
    resume_target = next(
        (s for s in steps[::-1]
         if verify_checkpoint(checkpoint_path(directory, s))[0]), None)
    deleted, freed = [], 0
    for s in steps[:-keep_last]:
        if s == resume_target or s in protect:
            continue
        path = checkpoint_path(directory, s)
        if not verify_checkpoint(path)[0]:
            continue
        size = _checkpoint_bytes(path)
        try:
            os.remove(path)
            for sidecar in (meta_path(path), data_state_path(path)):
                if os.path.exists(sidecar):
                    os.remove(sidecar)
        except OSError:
            logger.exception("checkpoint GC could not delete %s", path)
            continue
        freed += size
        deleted.append(s)
    kept = all_steps(directory)
    if deleted:
        get_telemetry().emit("checkpoint_gc", step=steps[-1], deleted=deleted,
                             kept=kept, keep_last=keep_last,
                             bytes_freed=freed)
    return {"deleted": deleted, "kept": kept, "bytes_freed": freed}
