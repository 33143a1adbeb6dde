"""Shared fleet cache: content-addressed plan/calibration artifacts (the
port's copy of the JAX package's ``experiments/fleet/cache.py``).

Sibling trials of one sweep — and a migrated trial's re-dispatch — keep
re-deriving the same expensive host-side facts: the planner's ranked mesh
for (model, device count), a host family's calibration profile. This
cache gives them one shared, crash-safe home under
``<sweep_dir>/cache/``:

- **content-addressed entries**: a key is the SHA-256 of the entry's
  canonical identity — ``kind`` plus the (model, mesh/devices, torch
  version) tuple — so two hosts computing "the plan for LeNet on 2
  devices under torch X" independently land on the SAME file, and a
  torch upgrade can never serve a stale plan (the version is *in* the
  address).
- **atomic publishes** (tmp + rename, the checkpoint writers' contract):
  a reader never sees a torn entry; concurrent writers of the same key
  are idempotent because the content is a pure function of the key.
- **verified reads**: each entry stores its identity alongside its
  value; a hash collision or a hand-edited file is detected and treated
  as a miss, never trusted.

The JAX cache also hands every trial a shared XLA compilation-cache
directory. The port has no compiled-program cache to share: its kernels
are built once per host under ``utils/native_build.py``'s file lock, so
there is no ``xla_cache_dir`` here.

The cache imports no torch: the torch *version* comes from package
metadata (``importlib.metadata``), never from importing torch — the
orchestrator's no-torch invariant holds.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from typing import Optional

logger = logging.getLogger(__name__)

CACHE_SUBDIR = "cache"


def torch_version() -> str:
    """The installed torch version WITHOUT importing torch (metadata
    only)."""
    from importlib.metadata import PackageNotFoundError, version

    try:
        return version("torch")
    except PackageNotFoundError:  # pragma: no cover - no torch dist
        return "unknown"


def cache_key(kind: str, **ident) -> str:
    """Content address for one entry: sha256 over the canonical identity
    JSON (sorted keys, so dict order can never split the cache)."""
    canon = json.dumps(
        {"kind": str(kind), **{k: ident[k] for k in sorted(ident)}},
        sort_keys=True, default=str,
    )
    return hashlib.sha256(canon.encode()).hexdigest()[:24]


class FleetCache:
    """Get/put JSON values content-addressed by (kind, identity)."""

    def __init__(self, root: str):
        self.root = root
        self.hits = 0
        self.misses = 0

    @classmethod
    def for_sweep(cls, sweep_dir: str) -> "FleetCache":
        return cls(os.path.join(sweep_dir, CACHE_SUBDIR))

    def _path(self, kind: str, ident: dict) -> str:
        return os.path.join(
            self.root, f"{kind}-{cache_key(kind, **ident)}.json"
        )

    def get(self, kind: str, **ident) -> Optional[dict]:
        path = self._path(kind, ident)
        try:
            with open(path) as f:
                entry = json.load(f)
        except (OSError, ValueError):
            self.misses += 1
            return None
        want = {k: str(v) for k, v in ident.items()}
        got = {
            k: str(v) for k, v in (entry.get("ident") or {}).items()
        }
        if entry.get("kind") != kind or got != want:
            # hash collision or a corrupted/hand-edited entry: a cache
            # must degrade to a miss, never serve the wrong value
            logger.warning("fleet cache: identity mismatch in %s "
                           "(expected %s, found %s) — treating as miss",
                           path, want, got)
            self.misses += 1
            return None
        self.hits += 1
        return entry.get("value")

    def put(self, kind: str, value: dict, **ident) -> str:
        os.makedirs(self.root, exist_ok=True)
        path = self._path(kind, ident)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(
                    {"kind": str(kind),
                     "ident": {k: ident[k] for k in sorted(ident)},
                     "value": value},
                    f, default=str,
                )
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def stats(self) -> dict:
        try:
            entries = sum(
                1 for n in os.listdir(self.root) if n.endswith(".json")
            )
        except OSError:
            entries = 0
        return {"hits": self.hits, "misses": self.misses,
                "entries": entries}
