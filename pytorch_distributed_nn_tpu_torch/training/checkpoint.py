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

The sharded DIRECTORY format of tp/sp runs, the JAX package's
``pdtn-sharded-v1``: ``model_step_<N>/`` holds one ``shards_p<rank:05d>.npz``
per rank and ``meta.json`` (format, step, process count, the CRC32 of
each shard file, every leaf's whole shape, and ``geometry`` with the mesh
``{"data", "seq", "model"}``). A shard file's keys are the JAX
``keystr`` of a ``TrainState`` leaf and its region's index key
(``.params['encoder']['token_embed']['embedding']|0:33,0:32``), its arrays
the regions in the JAX leaf shapes; each unique region is written once,
by the lowest rank that holds it (the JAX replica 0), and the step and
the optimizer count by rank 0. Directories carry no error-feedback
residuals. :func:`save_sharded` is collective over the mesh's ranks
(every rank writes its file into a staging directory, rank 0 checksums
them, writes ``meta.json`` and renames the directory into place);
:func:`collect_host_shards`, :func:`write_sharded_local` and
:func:`publish_sharded` are its stages, which the async writer runs on
its thread. A restore reads every shard file (each CRC-checked),
assembles the whole leaves and takes the live rank's regions: a
directory resumes on any mesh, and on one rank (the evaluator), and a
FILE checkpoint restores onto a tp/sp state the same way. Either
package reads the other's directories.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.models.convert import (
    full_leaf_shape,
    load_train_state,
    shard_state_tree,
    state_leaves,
    state_tree_from_leaves,
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
_SHARDED_FORMAT = "pdtn-sharded-v1"
QUARANTINE_DIR = "quarantine"
PUBLISHED_FILE = "published.json"


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
        raise ValueError(
            f"{path} is a sharded GSPMD checkpoint DIRECTORY (written by "
            "a tp/sp>1 run); load_raw reads FILE checkpoints only. Rewrite "
            "it as a file first: restore it on one rank via "
            "restore_checkpoint(params_only=True) + save_checkpoint")


def default_geometry() -> dict:
    """The geometry a manifest records when its writer gives none: the
    process group's size, else one process."""
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_available()
             and torch.distributed.is_initialized() else 1)
    return {"devices": int(world), "processes": int(world)}


@torch.no_grad()
def state_tree(state, ef_rows=None) -> dict:
    """The JAX state dict of a port ``TrainState``, copied to the host (a
    copy on the CPU too: the tree outlives the state's next step).
    ``ef_rows``: every rank's residuals, gathered
    (:func:`..models.convert.train_state_tensors`)."""
    layout, tensors = train_state_tensors(state, ef_rows)
    return train_state_to_flax(
        layout, {k: v.to("cpu", copy=True) for k, v in tensors.items()})


def save_checkpoint(directory: str, state, step: Optional[int] = None,
                    compress: bool = True,
                    event_extra: Optional[dict] = None,
                    data_state: Optional[dict] = None,
                    geometry: Optional[dict] = None,
                    fault_plan=None, ef_rows=None) -> str:
    """Write one atomic FILE checkpoint, its CRC32 manifest and, given
    ``data_state``, its iterator-state sidecar; emit ``checkpoint_write``.

    ``state`` is a port ``TrainState`` (copied to the host here) or the
    host state dict of one (:func:`state_tree`; the async writer's
    snapshot): both give the same bytes. ``write_ms`` is this call's
    time; ``stall_ms`` is what the training loop lost, the whole write
    here, which an overlapped caller overrides in ``event_extra``.
    ``ef_rows``: a state of several ranks' residuals, gathered (see
    :func:`state_tree`).

    ``fault_plan`` (:class:`..resilience.faults.FaultPlan`) is the
    injection hook: a ``flaky_io`` step fails its first publish attempt
    with ``OSError`` (the retry absorbs it and emits ``retry``), and a
    ``torn_ckpt`` step's file is truncated after its publish, which the
    manifest then convicts on resume."""
    t0 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    tree = state if isinstance(state, dict) else state_tree(state, ef_rows)
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


def restore_checkpoint(path: str, state, params_only: bool = False,
                       ef: str = "raise", ef_rows: Optional[list] = None):
    """Restore checkpoint ``path`` (a FILE or a sharded directory) into the
    port ``TrainState`` ``state`` in place and return it (a tp/sp state
    takes its regions). ``params_only`` restores the step, parameters
    and BatchNorm statistics and leaves the optimizer alone (the
    evaluator's template need not match the trainer's optimizer). ``ef``
    and ``ef_rows``: the error-feedback residuals
    (:func:`..models.convert.load_train_state`; by default residuals of
    another replica count raise, naming both geometries). Raises when
    the file's tree is not the state's."""
    load_train_state(state, state_tree_for(state, load_tree(path)),
                     params_only=params_only, ef=ef, ef_rows=ef_rows,
                     where=path)
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
    ``ok (no manifest — legacy, unverified)``. A sharded directory: its
    ``meta.json``, the count of shard files and each one's CRC32."""
    if not os.path.exists(path):
        return False, "missing"
    if os.path.isdir(path):
        return _verify_directory(path)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        return False, f"unreadable: {e}"
    return _verify_blob(path, blob)


def load_verified(path: str) -> dict:
    """:func:`verify_checkpoint` and :func:`load_raw` from one read of the
    file (a GB-sized checkpoint is read once, and a GC that unlinks it
    meanwhile cannot tear the read); a sharded directory is assembled
    from its CRC-checked shard files (:func:`load_tree`). Raises
    ``ValueError`` naming what failed, ``OSError`` when the file cannot
    be read."""
    if os.path.isdir(path):
        return load_tree(path)
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
    if os.path.isdir(path):
        for fname in os.listdir(path):
            try:
                total += os.path.getsize(os.path.join(path, fname))
            except OSError:
                pass
    for p_ in (path, meta_path(path), data_state_path(path)):
        if os.path.isdir(p_):
            continue
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
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
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



# -- sharded directories (the tp/sp path) -----------------------------------


def _mesh_of(state):
    return getattr(state, "mesh", None)


def state_tree_for(state, tree: dict) -> dict:
    """A whole ``TrainState`` tree cut to ``state``'s regions (itself for
    a state without a mesh)."""
    mesh = _mesh_of(state)
    if mesh is None:
        return tree
    return shard_state_tree(tree, mesh.shape, mesh.coords)


def collect_host_shards(state) -> Tuple[dict, dict]:
    """This rank's regions that it holds replica 0 of, on the host:
    ``({"<leaf key>|<index key>": array}, {leaf key: whole shape})``. No
    collective: safe off the main thread (the async writer)."""
    layout, tensors = train_state_tensors(state)
    return shards_of(layout, {k: v.to("cpu", copy=True)
                              for k, v in tensors.items()})


def shards_of(layout: dict, tensors: dict) -> Tuple[dict, dict]:
    """:func:`collect_host_shards` of a tp/sp state's host tensors (keyed
    as :func:`..models.convert.train_state_tensors` keys them)."""
    from pytorch_distributed_nn_tpu_torch.parallel.partitioning import (
        index_key,
        leaf_region,
        owns_region,
    )

    mesh = layout.get("mesh")
    if mesh is None:
        raise ValueError("a sharded checkpoint needs a tp/sp state (a mesh)")
    tree = train_state_to_flax(layout, tensors)
    coords = mesh.coords
    first = all(c == 0 for c in coords.values())
    shards, shapes = {}, {}
    for key, path, a in state_leaves(tree):
        a = np.asarray(a)
        if path is None:  # the step and the count: rank 0's
            shapes[key] = []
            if first:
                shards[f"{key}|"] = a
            continue
        full = full_leaf_shape(path, a.shape, layout["config"], layout["tp"])
        shapes[key] = list(full)
        region = leaf_region(path, full, mesh.shape, coords)
        if tuple(b - s for s, b in region) != a.shape:
            raise ValueError(f"{key}: region {region} of {full} does not "
                             f"match this rank's leaf {a.shape}")
        if owns_region(path, coords):
            shards[f"{key}|{index_key(region)}"] = a
    return shards, shapes


def shard_file(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"shards_p{rank:05d}.npz")


def write_sharded_local(tmp: str, shards: dict, rank: int) -> str:
    """This rank's shard file in the staging directory: an uncompressed
    npz (``np.load`` reads it) whose members carry a fixed timestamp, so
    the same shards give the same bytes (``np.savez`` stamps the time of
    the write)."""
    import io
    import zipfile

    os.makedirs(tmp, exist_ok=True)
    out = shard_file(tmp, rank)
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for key, arr in shards.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asanyarray(arr),
                                      allow_pickle=False)
            info = zipfile.ZipInfo(key + ".npy", date_time=(1980, 1, 1, 0,
                                                            0, 0))
            z.writestr(info, buf.getvalue())
    return out


def publish_sharded(tmp: str, final: str, step: int, shapes: dict,
                    processes: int, geometry: Optional[dict] = None) -> None:
    """Rank 0's commit, once every shard file is complete: the CRC32 of
    each (a file of a rank beyond ``processes``, left by a crashed save of
    a larger world, is removed), ``meta.json``, and the rename of the
    staging directory into place."""
    crcs = {}
    ours = {os.path.basename(shard_file(tmp, r)) for r in range(processes)}
    for fname in sorted(os.listdir(tmp)):
        if fname.startswith("shards_p") and fname.endswith(".npz"):
            if fname not in ours:
                os.remove(os.path.join(tmp, fname))
                continue
            with open(os.path.join(tmp, fname), "rb") as f:
                crcs[fname] = zlib.crc32(f.read()) & 0xFFFFFFFF
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"format": _SHARDED_FORMAT, "step": step,
                   "processes": processes, "crc32": crcs, "shapes": shapes,
                   "geometry": geometry or default_geometry()}, f)
    os.replace(tmp, final)


def refuse_file(final: str) -> None:
    for p_ in (final, final + ".tmp"):
        if os.path.isfile(p_):
            raise ValueError(
                f"{p_} exists as a replicated FILE checkpoint; this run's "
                "config writes sharded DIRECTORY checkpoints — use a fresh "
                "--train-dir or the matching parallelism config")


def barrier(mesh) -> None:
    if mesh.world is not None and mesh.size > 1:
        from pytorch_distributed_nn_tpu_torch.parallel.mesh import all_reduce

        all_reduce(torch.zeros(1, device=mesh.device), "sum", mesh.world)


def save_sharded(directory: str, state, step: Optional[int] = None,
                 event_extra: Optional[dict] = None,
                 data_state: Optional[dict] = None,
                 geometry: Optional[dict] = None) -> str:
    """Write ``model_step_<N>/`` (module docstring); every rank of the
    mesh calls it at the same step. Emits ``checkpoint_write`` (format
    ``sharded``) with this rank's bytes."""
    t0 = time.perf_counter()
    mesh = state.mesh
    step = int(state.step) if step is None else int(step)
    final = checkpoint_path(directory, step)
    tmp = final + ".tmp"
    rank0 = mesh.rank == 0
    refuse_file(final)
    shards, shapes = collect_host_shards(state)
    write_sharded_local(tmp, shards, mesh.rank)
    barrier(mesh)
    if rank0:
        publish_sharded(tmp, final, step, shapes, mesh.size, geometry)
        if data_state is not None:
            save_data_state(final, data_state)
    barrier(mesh)
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    fields = {"path": final,
              "bytes": sum(int(v.nbytes) for v in shards.values()),
              "seconds": round(elapsed_ms / 1e3, 6), "format": "sharded",
              "process": mesh.rank, "write_ms": round(elapsed_ms, 3),
              "stall_ms": round(elapsed_ms, 3)}
    if event_extra:
        fields.update(event_extra)
    get_telemetry().emit("checkpoint_write", step=step, **fields)
    return final


def _read_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _shard_files(path: str) -> list:
    return sorted(f for f in os.listdir(path)
                  if f.startswith("shards_p") and f.endswith(".npz"))


def _verify_directory(path: str) -> Tuple[bool, str]:
    try:
        meta = _read_meta(path)
    except (OSError, ValueError) as e:
        return False, f"unreadable meta.json: {e}"
    if meta.get("format") != _SHARDED_FORMAT:
        return False, f"unknown sharded format {meta.get('format')!r}"
    files = _shard_files(path)
    expected = meta.get("processes")
    if expected is not None and len(files) != expected:
        return False, f"{len(files)} shard file(s), expected {expected}"
    crcs = meta.get("crc32") or {}
    for fname in files:
        want = crcs.get(fname)
        if want is None:
            continue
        with open(os.path.join(path, fname), "rb") as f:
            if (zlib.crc32(f.read()) & 0xFFFFFFFF) != want:
                return False, f"{fname}: CRC32 mismatch"
    return True, "ok"


def _load_shard_files(path: str):
    """({leaf key: {index key: array}}, meta) from every shard file, each
    checked against its CRC32; a missing or torn file raises."""
    import io

    meta = _read_meta(path)
    if meta.get("format") != _SHARDED_FORMAT:
        raise ValueError(f"{path}: unknown sharded checkpoint format {meta}")
    files = _shard_files(path)
    expected = meta.get("processes")
    if expected is not None and len(files) != expected:
        raise ValueError(
            f"{path}: found {len(files)} shard file(s) but the checkpoint "
            f"was written by {expected} process(es) — partial copy or "
            "deleted shards; refusing to zero-fill the gaps")
    crcs = meta.get("crc32") or {}
    out: Dict[str, dict] = {}
    for fname in files:
        with open(os.path.join(path, fname), "rb") as f:
            raw = f.read()
        want = crcs.get(fname)
        if want is not None and (zlib.crc32(raw) & 0xFFFFFFFF) != want:
            raise ValueError(
                f"{path}/{fname}: CRC32 mismatch against meta.json — "
                "corrupt or torn shard file")
        with np.load(io.BytesIO(raw)) as z:
            for k in z.files:
                leaf, _, ikey = k.rpartition("|")
                out.setdefault(leaf, {})[ikey] = z[k]
    return out, meta


def _assemble_full(entries: dict, shape) -> np.ndarray:
    from pytorch_distributed_nn_tpu_torch.parallel.partitioning import (
        parse_index_key,
    )

    if list(entries) == [""]:
        return np.asarray(entries[""])
    dtype = next(iter(entries.values())).dtype
    full = np.zeros(shape, dtype)
    covered = 0
    for ikey, data in entries.items():
        full[parse_index_key(ikey)] = data
        covered += int(np.asarray(data).size)
    if covered != full.size:
        raise ValueError(f"regions cover {covered} of {full.size} elements")
    return full


def load_tree(path: str) -> dict:
    """The whole ``TrainState`` tree of checkpoint ``path``: a FILE's
    (:func:`load_raw`), or a sharded directory's, assembled from every
    shard file."""
    if not os.path.isdir(path):
        return load_raw(path)
    data, meta = _load_shard_files(path)
    shapes = meta.get("shapes", {})
    leaves = {}
    for key, entries in data.items():
        if key not in shapes:
            raise KeyError(f"{path}: leaf {key} has no shape in meta.json")
        try:
            leaves[key] = _assemble_full(entries, tuple(shapes[key]))
        except ValueError as e:
            raise ValueError(f"{path}: leaf {key}: {e}") from None
    missing = sorted(set(shapes) - set(leaves))
    if missing:
        raise KeyError(f"{path}: leaves {missing[:3]} missing")
    return state_tree_from_leaves(leaves)


def restore_sharded(path: str, state):
    """A sharded directory onto ``state``'s mesh (any geometry): the JAX
    ``restore_sharded`` and ``restore_resharded``, in place."""
    if os.path.isfile(path):
        raise ValueError(
            f"{path} is a replicated FILE checkpoint (written by a tp=sp=1 "
            "run) but this config's sharded restore needs a model_step_<N>/ "
            "DIRECTORY — use restore_resharded, or a fresh --train-dir")
    return restore_checkpoint(path, state)


def restore_resharded(path: str, state, ef: str = "reset"):
    """Elastic restore of a checkpoint taken on any mesh, FILE or
    directory, onto ``state`` (its regions); residuals of another replica
    count reset (directories carry none)."""
    return restore_checkpoint(path, state, ef=ef)
