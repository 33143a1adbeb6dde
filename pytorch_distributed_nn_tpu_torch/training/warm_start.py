"""Vocabulary-curriculum warm start: a checkpoint's trained parameters
resized into a bigger model. The port of ``pytorch_distributed_nn_tpu/
training/warm_start.py``.

The two models share every trunk shape; only the vocabulary-sized leaves
(``token_embed``, ``mlm_bias``/``lm_bias``, an untied ``mlm_out``) and
the positional table may differ. :func:`merge_resized` walks the TARGET
params tree (flax layout, numpy leaves) and, per leaf: the same shape in
the source copies the trained value; the same rank with some axes
different copies the overlapping hyperslab (the first ``min(src, tgt)``
indices per axis: token ids are allocated specials-first) and keeps the
target's fresh values elsewhere; missing from the source keeps the
target's. A shape mismatch on any other leaf, or a rank mismatch, raises.
The report counts ``copied``, ``sliced`` (with ``sliced_paths``),
``fresh`` and the source leaves the walk never consumed (``unused``,
``unused_paths``). The optimizer state is not carried: the target's
optimizer starts from scratch.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np

log = logging.getLogger(__name__)

#: leaves that may differ in shape between curriculum stages
RESIZABLE_LEAF_NAMES = ("token_embed", "pos_embed", "mlm_bias", "mlm_out")


def _flatten(tree, prefix=()) -> dict:
    """Nested-dict tree -> {("a", "b", "c"): leaf}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
    else:
        out[prefix] = tree
    return out


def _resizable(key: tuple) -> bool:
    return any(name in key for name in RESIZABLE_LEAF_NAMES)


def merge_resized(src_params, target_params) -> Tuple[dict, dict]:
    """Merge trained ``src_params`` into ``target_params`` (host-side):
    ``(merged, report)``, ``merged`` with ``target_params``'s structure and
    numpy leaves (module docstring)."""
    src = _flatten(src_params)
    consumed = set()
    report = {"copied": 0, "sliced": 0, "fresh": 0, "sliced_paths": []}

    def merge_leaf(key, tgt):
        tgt = np.asarray(tgt)
        s = src.get(key)
        if s is None:
            report["fresh"] += 1
            return tgt
        consumed.add(key)
        s = np.asarray(s)
        if s.shape == tgt.shape:
            report["copied"] += 1
            return s.astype(tgt.dtype)
        if s.ndim != tgt.ndim:
            raise ValueError(
                f"{'/'.join(key)}: rank mismatch {s.shape} vs {tgt.shape} "
                "— source checkpoint is not a resized variant of this model")
        if not _resizable(key):
            raise ValueError(
                f"{'/'.join(key)}: shape {s.shape} vs {tgt.shape} — only "
                f"vocabulary/positional leaves "
                f"({'/'.join(RESIZABLE_LEAF_NAMES)}) may differ between "
                "curriculum stages; a mismatched trunk leaf means the "
                "checkpoint's d_model/d_ff/num_heads differ from this "
                "config's")
        out = tgt.copy()
        sl = tuple(slice(0, min(a, b)) for a, b in zip(s.shape, tgt.shape))
        out[sl] = s[sl].astype(tgt.dtype)
        report["sliced"] += 1
        report["sliced_paths"].append("/".join(key))
        return out

    def walk(tree, prefix=()):  # in key order, as jax.tree_util walks
        if isinstance(tree, dict):
            return {k: walk(tree[k], prefix + (str(k),))
                    for k in sorted(tree)}
        return merge_leaf(prefix, tree)

    merged = walk(target_params)
    unused = sorted("/".join(k) for k in src if k not in consumed)
    report["unused"] = len(unused)
    report["unused_paths"] = unused
    return merged, report


def warm_start_params(ckpt_path: str, target_params) -> Tuple[dict, dict]:
    """Load a FILE checkpoint and merge its params into ``target_params``:
    ``(merged, report)`` (:func:`merge_resized`), logged."""
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    raw = ckpt.load_raw(ckpt_path)
    merged, report = merge_resized(raw["params"], target_params)
    log.info("Warm start from %s: %d leaves copied, %d resized (%s), %d "
             "fresh", ckpt_path, report["copied"], report["sliced"],
             ", ".join(report["sliced_paths"]) or "-", report["fresh"])
    if report["unused"]:
        log.warning("Warm start from %s: %d source leaves unused: %s",
                    ckpt_path, report["unused"],
                    ", ".join(report["unused_paths"]))
    return merged, report
