"""Model registry: versioned serving artifacts with labels and rollback.

The port's copy of ``pytorch_distributed_nn_tpu/serving/registry.py``:
the same ``pdtn-registry-v1`` index, so either package reads and
writes a registry the other wrote.

The reference's evaluator polled checkpoints off shared NFS — the seed of
continuous deployment. This module is the grown-up form: one directory
(`registry.json` index) that records every serving artifact as an
IMMUTABLE versioned entry and moves mutable *labels* over them:

    <registry>/registry.json
      format: pdtn-registry-v1
      entries:  [{version, artifact, manifest, manifest_crc32, created}]
      labels:   {"stable": <version>, "canary": <version>}
      history:  {"stable": [<older versions, newest last>]}

- **Versions are immutable.** The id is the artifact manifest's own
  identity stamp (`serving.artifact.artifact_version`:
  ``<train_dir>@<step>:<quantize>`` — the same string every serving
  record carries, so `obs compare --by-version` and the registry name
  the same thing). Publishing a DIFFERENT artifact under an existing
  version is an error; re-publishing the same one is idempotent.
- **Entries are CRC-verified.** `publish` refuses an artifact whose
  params blob fails its manifest CRC32 (a torn copy must never become
  deployable), and each entry stores a copy of the manifest plus the
  CRC32 of that copy, so a corrupted index row is convicted on read
  (`verify`) instead of silently serving the wrong provenance.
- **Labels move atomically.** `label`/`set_labels` rewrite the index in
  one `os.replace`; `rollback` restores a label's previous holder from
  its history — the operator-facing undo, and what the canary router
  calls when it convicts a canary.
- **GC releases checkpoint protection.** `serve export` registers its
  source step in the train_dir's `published.json` so `--keep-last` can
  never delete production provenance; `gc` retires entries that are
  neither labeled nor among the newest K and RELEASES that protection
  (`checkpoint.release_published_step`) — the full closure, tested.
- **Watch mode.** `scan_dir` picks up new artifact exports from a
  directory the way the reference evaluator polled NFS; `watch_labels`
  (used by ``serve run --reload-poll``) diffs the label map so a live
  server can follow `stable` (hot-swap) and `canary` (ramp) moves.

Everything here is host-side json/os — no torch import, usable from any
login node, like the rest of the `obs` tooling.
"""

from __future__ import annotations

import json
import logging
import os
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

REGISTRY_FORMAT = "pdtn-registry-v1"
INDEX_NAME = "registry.json"

#: the label vocabulary (docs/serving.md "Deployment lifecycle"):
#: ``stable`` is what full traffic serves, ``canary`` is what the router
#: ramps a traffic fraction onto. Unknown labels are rejected at the API
#: boundary so a typo cannot strand an artifact under an unreachable name.
LABELS = ("stable", "canary")


def _canonical(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


class RegistryError(ValueError):
    """Contract violations: unknown version/label, identity conflicts,
    corrupt entries. A CLI surface turns these into exit 2."""


class Registry:
    """The versioned artifact store. Stateless between calls: every
    operation is a read-modify-write of ``registry.json`` published with
    ``os.replace`` (the checkpoint registry's atomicity discipline), so
    a reader never observes a torn index."""

    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(root, INDEX_NAME)

    # -- index I/O ---------------------------------------------------------

    def load(self) -> dict:
        if not os.path.isfile(self.path):
            return {"format": REGISTRY_FORMAT, "entries": [],
                    "labels": {}, "history": {}}
        with open(self.path) as f:
            doc = json.load(f)
        if doc.get("format") != REGISTRY_FORMAT:
            raise RegistryError(
                f"{self.path}: unknown registry format "
                f"{doc.get('format')!r}"
            )
        doc.setdefault("entries", [])
        doc.setdefault("labels", {})
        doc.setdefault("history", {})
        return doc

    def _save(self, doc: dict) -> None:
        from pytorch_distributed_nn_tpu_torch.resilience.retry import retry_call

        os.makedirs(self.root, exist_ok=True)
        tmp = self.path + ".tmp"

        def _publish():
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
            os.replace(tmp, self.path)

        retry_call(_publish, attempts=3, base_delay=0.05,
                   retry_on=(OSError,), label=f"registry {self.path}")

    # -- queries -----------------------------------------------------------

    def entries(self) -> List[dict]:
        """All entries, oldest first (publish order)."""
        return list(self.load()["entries"])

    def labels(self) -> Dict[str, str]:
        return dict(self.load()["labels"])

    def get(self, version: str) -> Optional[dict]:
        for e in self.load()["entries"]:
            if e["version"] == version:
                return e
        return None

    def resolve(self, ref: str) -> dict:
        """Entry for a version id OR a label name — the one lookup every
        consumer (CLI, router, watcher) goes through."""
        doc = self.load()
        if ref in doc["labels"]:
            ref = doc["labels"][ref]
        for e in doc["entries"]:
            if e["version"] == ref:
                return e
        raise RegistryError(
            f"registry {self.root}: no entry or label {ref!r} "
            f"(have {[e['version'] for e in doc['entries']]}, "
            f"labels {doc['labels']})"
        )

    def verify(self, version: str) -> Tuple[bool, str]:
        """CRC-verify one entry: the stored manifest copy against its
        recorded CRC32, and the artifact's params blob against the
        manifest's CRC32 — the registry-level twin of
        ``checkpoint.verify_checkpoint``. ``(ok, reason)``."""
        entry = self.get(version)
        if entry is None:
            return False, f"no entry {version!r}"
        want = entry.get("manifest_crc32")
        got = zlib.crc32(_canonical(entry.get("manifest") or {})) & 0xFFFFFFFF
        if want != got:
            return False, (
                f"entry manifest CRC mismatch (index crc {want} vs "
                f"recomputed {got}) — corrupt registry row"
            )
        from pytorch_distributed_nn_tpu_torch.serving.artifact import PARAMS_NAME

        blob_path = os.path.join(entry["artifact"], PARAMS_NAME)
        try:
            with open(blob_path, "rb") as f:
                crc = zlib.crc32(f.read()) & 0xFFFFFFFF
        except OSError as e:
            return False, f"artifact blob unreadable: {e}"
        if crc != entry["manifest"].get("crc32"):
            return False, (
                f"artifact blob CRC mismatch ({crc} vs manifest "
                f"{entry['manifest'].get('crc32')}) — torn or replaced"
            )
        return True, "ok"

    # -- mutations ---------------------------------------------------------

    def publish(self, artifact_dir: str,
                labels: Sequence[str] = ()) -> dict:
        """Register one exported artifact; returns its (new or existing)
        entry. Verifies the blob CRC first — a torn artifact is refused,
        never becomes deployable. Idempotent for identical re-publishes;
        a different artifact under an existing version id is an error
        (versions are immutable)."""
        from pytorch_distributed_nn_tpu_torch.observability.core import (
            get_telemetry,
        )
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            PARAMS_NAME,
            artifact_version,
            load_manifest,
        )

        for lb in labels:
            if lb not in LABELS:
                raise RegistryError(
                    f"unknown label {lb!r}; expected one of {LABELS}"
                )
        artifact_dir = os.path.abspath(artifact_dir)
        manifest = load_manifest(artifact_dir)
        with open(os.path.join(artifact_dir, PARAMS_NAME), "rb") as f:
            blob_crc = zlib.crc32(f.read()) & 0xFFFFFFFF
        if manifest.get("crc32") is not None \
                and blob_crc != manifest["crc32"]:
            raise RegistryError(
                f"refusing to publish {artifact_dir}: params blob CRC "
                f"{blob_crc} does not match its manifest "
                f"({manifest['crc32']}) — torn or corrupt artifact"
            )
        version = artifact_version(manifest)
        doc = self.load()
        existing = next(
            (e for e in doc["entries"] if e["version"] == version), None
        )
        if existing is not None:
            same = (
                existing["artifact"] == artifact_dir
                and existing["manifest"].get("crc32") == manifest.get("crc32")
            )
            if not same:
                raise RegistryError(
                    f"version {version!r} is already published from "
                    f"{existing['artifact']} — versions are immutable; "
                    "re-export at a new step or quantize mode"
                )
            entry = existing
        else:
            entry = {
                "version": version,
                "artifact": artifact_dir,
                "manifest": manifest,
                "manifest_crc32":
                    zlib.crc32(_canonical(manifest)) & 0xFFFFFFFF,
                "created": time.time(),
            }
            doc["entries"].append(entry)
        for lb in labels:
            self._move_label(doc, lb, version)
        self._save(doc)
        if existing is None:
            get_telemetry().emit(
                "registry_publish", version=version, artifact=artifact_dir,
                labels=list(labels), registry=self.root,
            )
            logger.info("registry %s: published %s%s", self.root, version,
                        f" labels={list(labels)}" if labels else "")
        return entry

    def _move_label(self, doc: dict, label: str, version: Optional[str]):
        """In-place label move with history push (callers save)."""
        if label not in LABELS:
            raise RegistryError(
                f"unknown label {label!r}; expected one of {LABELS}"
            )
        prev = doc["labels"].get(label)
        if version is None:
            doc["labels"].pop(label, None)
        else:
            if not any(e["version"] == version for e in doc["entries"]):
                raise RegistryError(
                    f"cannot label {label}={version!r}: no such entry"
                )
            doc["labels"][label] = version
        if prev is not None and prev != version:
            doc["history"].setdefault(label, []).append(prev)

    def label(self, label: str, version: Optional[str]) -> dict:
        """Point ``label`` at ``version`` (None clears it). Atomic; the
        previous holder is pushed onto the label's history so
        :meth:`rollback` can restore it."""
        doc = self.load()
        self._move_label(doc, label, version)
        self._save(doc)
        return dict(doc["labels"])

    def set_labels(self, moves: Dict[str, Optional[str]]) -> dict:
        """Several label moves in ONE index write — how promote/rollback
        keep ``stable``/``canary`` consistent under a crash between them
        (there is no intermediate state on disk)."""
        doc = self.load()
        for label, version in moves.items():
            self._move_label(doc, label, version)
        self._save(doc)
        return dict(doc["labels"])

    def rollback(self, label: str = "stable") -> Tuple[str, str]:
        """Restore ``label`` to its previous holder; returns
        ``(from_version, to_version)``. The history entry is consumed —
        two rollbacks walk two steps back."""
        doc = self.load()
        cur = doc["labels"].get(label)
        hist = doc["history"].get(label) or []
        if not hist:
            raise RegistryError(
                f"label {label!r} has no history to roll back to"
            )
        prev = hist.pop()
        # the rolled-back holder is NOT pushed back to history — rollback
        # walks backward, it must not create a 2-cycle
        doc["labels"][label] = prev
        self._save(doc)
        logger.warning("registry %s: rolled back %s %s -> %s",
                       self.root, label, cur, prev)
        return str(cur), prev

    def gc(self, keep_last: int, delete_artifacts: bool = False) -> dict:
        """Retire entries that are neither labeled nor among the newest
        ``keep_last``, releasing each one's ``published.json`` checkpoint
        protection (the closure ``--keep-last`` GC depends on). Artifact
        directories are left on disk unless ``delete_artifacts`` —
        retiring provenance and destroying bytes are different decisions.
        Returns ``{"retired": [versions], "kept": [versions]}`` and emits
        one ``registry_gc`` event when anything was retired."""
        from pytorch_distributed_nn_tpu_torch.observability.core import (
            get_telemetry,
        )
        from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

        if keep_last < 1:
            raise RegistryError(
                f"keep_last must be >= 1, got {keep_last}"
            )
        doc = self.load()
        labeled = set(doc["labels"].values())
        keep = {e["version"] for e in doc["entries"][-keep_last:]} | labeled
        retired = [e for e in doc["entries"] if e["version"] not in keep]
        if not retired:
            return {"retired": [],
                    "kept": [e["version"] for e in doc["entries"]]}
        doc["entries"] = [
            e for e in doc["entries"] if e["version"] in keep
        ]
        # labels' history may reference retired versions; rollback to a
        # retired version must fail loudly at resolve() — keep history
        # as-is, resolution is what enforces existence
        self._save(doc)
        for e in retired:
            src = (e.get("manifest") or {}).get("source") or {}
            train_dir, step = src.get("train_dir"), src.get("step")
            if train_dir and step is not None and os.path.isdir(train_dir):
                try:
                    ckpt.release_published_step(
                        train_dir, int(step), e["artifact"]
                    )
                except (OSError, ValueError):
                    logger.exception(
                        "registry gc: could not release published step "
                        "%s of %s", step, train_dir,
                    )
            if delete_artifacts:
                import shutil

                shutil.rmtree(e["artifact"], ignore_errors=True)
        get_telemetry().emit(
            "registry_gc",
            retired=[e["version"] for e in retired],
            kept=[e["version"] for e in doc["entries"]],
            keep_last=keep_last, registry=self.root,
        )
        return {"retired": [e["version"] for e in retired],
                "kept": [e["version"] for e in doc["entries"]]}

    # -- watch mode --------------------------------------------------------

    def scan_dir(self, export_dir: str,
                 labels: Sequence[str] = ()) -> List[dict]:
        """Publish every not-yet-registered artifact under ``export_dir``
        (direct children carrying an ``artifact.json``) — the NFS-poll
        loop the reference evaluator ran, pointed at exports. Returns the
        newly published entries, publish-time order by artifact mtime.
        Unreadable/torn candidates are skipped with a warning, not fatal:
        a half-written export shows up intact on the next poll."""
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            MANIFEST_NAME,
        )

        known = {e["artifact"] for e in self.entries()}
        found = []
        try:
            children = sorted(os.listdir(export_dir))
        except OSError:
            return []
        for name in children:
            d = os.path.abspath(os.path.join(export_dir, name))
            if d in known or not os.path.isfile(
                os.path.join(d, MANIFEST_NAME)
            ):
                continue
            found.append(d)
        found.sort(key=lambda d: os.path.getmtime(
            os.path.join(d, MANIFEST_NAME)
        ))
        new = []
        for d in found:
            try:
                new.append(self.publish(d, labels=labels))
            except (RegistryError, OSError, ValueError) as e:
                logger.warning("registry watch: skipping %s (%s)", d, e)
        return new


def render_entries(doc: dict) -> str:
    """Human-readable ``cli registry list`` table."""
    by_version: Dict[str, List[str]] = {}
    for label, v in doc.get("labels", {}).items():
        by_version.setdefault(v, []).append(label)
    lines = [f"  {'version':<40} {'labels':<16} artifact"]
    for e in doc.get("entries", []):
        labels = ",".join(sorted(by_version.get(e["version"], []))) or "-"
        lines.append(
            f"  {e['version']:<40} {labels:<16} {e['artifact']}"
        )
    if not doc.get("entries"):
        lines.append("  (empty)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Selftest (cli registry --selftest): pure host-side — the artifacts are
# fabricated bytes, no torch, <2 s
# ---------------------------------------------------------------------------


def _fake_artifact(root: str, name: str, step: int,
                   train_dir: Optional[str] = None,
                   payload: bytes = b"weights") -> str:
    """A structurally valid artifact dir with arbitrary payload bytes —
    everything the registry checks (manifest + CRC), nothing the engine
    needs (no real params)."""
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        ARTIFACT_FORMAT,
        MANIFEST_NAME,
        PARAMS_NAME,
    )

    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    blob = b"PDAR" + payload
    with open(os.path.join(d, PARAMS_NAME), "wb") as f:
        f.write(blob)
    manifest = {
        "format": ARTIFACT_FORMAT,
        "network": "LeNet", "num_classes": 10, "model_kw": {},
        "input": {"kind": "image", "spec": [28, 28, 1]},
        "quantize": "none", "quantize_stats": None,
        "source": {
            "train_dir": train_dir or os.path.join(root, "td"),
            "step": step,
            "checkpoint": os.path.join(root, "td", f"model_step_{step}"),
        },
        "param_count": 1, "param_bytes": len(payload),
        "bytes": len(blob),
        "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
        "created": time.time(),
    }
    with open(os.path.join(d, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f)
    return d


def selftest() -> int:
    """Registry invariants: publish idempotency + immutability, torn-
    artifact refusal, label atomicity, rollback history, watch pickup,
    and the gc protection-release closure. Chaos-style PASS/FAIL lines;
    exit 0 only when every invariant held."""
    import shutil
    import sys
    import tempfile

    from pytorch_distributed_nn_tpu_torch.serving.artifact import PARAMS_NAME
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    root = tempfile.mkdtemp(prefix="pdtn_registry_selftest_")
    checks = []

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), detail))

    try:
        reg = Registry(os.path.join(root, "registry"))
        td = os.path.join(root, "td")
        os.makedirs(td)
        a1 = _fake_artifact(root, "a1", 1, train_dir=td, payload=b"one")
        a2 = _fake_artifact(root, "a2", 2, train_dir=td, payload=b"two")
        a3 = _fake_artifact(root, "a3", 3, train_dir=td, payload=b"three")
        for step, art in ((1, a1), (2, a2), (3, a3)):
            ckpt.record_published_step(td, step, art)

        e1 = reg.publish(a1, labels=("stable",))
        check("publish derives the immutable version id",
              e1["version"] == "td@1:none", e1["version"])
        check("publish is idempotent",
              reg.publish(a1)["version"] == e1["version"]
              and len(reg.entries()) == 1)
        conflict = _fake_artifact(root, "a1b", 1, train_dir=td,
                                  payload=b"different")
        try:
            reg.publish(conflict)
            check("immutable version ids reject a conflicting publish",
                  False, "conflicting publish accepted")
        except RegistryError:
            check("immutable version ids reject a conflicting publish",
                  True)
        torn = _fake_artifact(root, "torn", 9, train_dir=td)
        with open(os.path.join(torn, PARAMS_NAME), "ab") as f:
            f.write(b"x")  # tear AFTER the manifest recorded its CRC
        try:
            reg.publish(torn)
            check("torn artifact refused at publish", False)
        except RegistryError:
            check("torn artifact refused at publish", True)

        reg.publish(a2)
        reg.publish(a3, labels=("canary",))
        check("resolve follows labels and versions",
              reg.resolve("stable")["artifact"] == a1
              and reg.resolve("canary")["artifact"] == a3
              and reg.resolve("td@2:none")["artifact"] == a2)
        ok, reason = reg.verify("td@2:none")
        check("verify passes an intact entry", ok, reason)
        with open(os.path.join(a2, PARAMS_NAME), "ab") as f:
            f.write(b"!")
        ok, reason = reg.verify("td@2:none")
        check("verify convicts a post-publish tear", not ok, reason)

        reg.set_labels({"stable": "td@3:none", "canary": None})
        check("atomic multi-label move (promote shape)",
              reg.labels() == {"stable": "td@3:none"})
        frm, to = reg.rollback("stable")
        check("rollback restores the previous stable",
              (frm, to) == ("td@3:none", "td@1:none")
              and reg.labels()["stable"] == "td@1:none",
              f"{frm} -> {to}")

        # watch: a new export appears in the scanned dir -> published
        exports = os.path.join(root, "exports")
        os.makedirs(exports)
        shutil.copytree(a3, os.path.join(exports, "seen"))
        reg2 = Registry(os.path.join(root, "registry2"))
        reg2.scan_dir(exports)
        a4 = _fake_artifact(exports, "new", 4, train_dir=td,
                            payload=b"four")
        new = reg2.scan_dir(exports)
        check("watch picks up exactly the new export",
              [e["artifact"] for e in new] == [a4]
              and len(reg2.entries()) == 2,
              f"new={[e['version'] for e in new]}")

        # gc closure: unlabeled + outside keep-last -> retired AND its
        # published.json protection released
        check("published steps protected before gc",
              ckpt.published_steps(td) == {1, 2, 3})
        res = reg.gc(keep_last=1)
        check("gc retires exactly the unlabeled old entry",
              res["retired"] == ["td@2:none"]
              and set(res["kept"]) == {"td@1:none", "td@3:none"},
              str(res))
        check("gc released the retired step's checkpoint protection",
              ckpt.published_steps(td) == {1, 3},
              f"published={sorted(ckpt.published_steps(td))}")
    except Exception as e:  # any crash is a failed selftest
        logger.exception("registry selftest crashed")
        check("selftest completed without exception", False, repr(e))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failed = [c for c in checks if not c[1]]
    for name, ok, detail in checks:
        mark = "PASS" if ok else "FAIL"
        print(f"  [{mark}] {name}"
              + (f" — {detail}" if detail and not ok else ""))
    print(f"registry selftest: {len(checks) - len(failed)}/{len(checks)} "
          "invariants held", file=sys.stderr)
    return 1 if failed else 0
