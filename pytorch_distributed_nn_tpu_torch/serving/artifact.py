"""Serving artifacts in the JAX package's ``pdtn-artifact-v1`` format:
checkpoint -> self-describing serving bundle, and back.

An artifact is a directory::

    <artifact>/
      artifact.json     # manifest: network, num_classes, model_kw, input
                        # kind and spec, quantize mode, source step,
                        # param count/bytes, CRC32
      params.msgpack    # 4-byte magic + flax-msgpack {"params",
                        # "batch_stats"}: PDAR raw, PDAZ compressed with
                        # the native host codec

:func:`export_artifact` freezes one checkpoint of a train_dir (either
package's ``model_step_<N>`` files, read through the port's
:mod:`..training.checkpoint`): the newest step that passes
``verify_checkpoint`` unless a step is named, never a torn or quarantined
one; optionally per-tensor int8 (``{"__int8__": q, "scale", "dtype"}``
leaves, round-to-nearest, :func:`..ops.compression.quantize_int8_host`).
The network comes from the run's manifest-headed ``telemetry.jsonl``
(:func:`sniff_train_config`) unless given. The exported step is recorded
in the train_dir's published-step registry, so ``--keep-last`` GC never
deletes it. For the same checkpoint, ``params.msgpack`` is byte for byte
the JAX exporter's, and the manifest is its but for ``created`` and the
absolute paths.

The reader covers what either exporter writes: both magics, the CRC32
check against the manifest, int8 leaves dequantized on load, and flax's
msgpack ndarray extension, decoded without flax
(:mod:`..utils.flax_msgpack`, which the checkpoints share).
:func:`save_artifact` writes a port ``CausalLM`` state_dict in the same
format (PDAR, no quantization), so the port can make a decoder artifact
with no checkpoint and no JAX installed.

Everything here is host-side numpy: export and load need no card.
"""

from __future__ import annotations

import json
import logging
import os
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.observability.core import (
    STREAM_BASENAME,
)
from pytorch_distributed_nn_tpu_torch.ops.compression import (
    dequantize_int8_host,
    quantize_int8_host,
)
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.utils import flax_msgpack

logger = logging.getLogger(__name__)

ARTIFACT_FORMAT = "pdtn-artifact-v1"
MANIFEST_NAME = "artifact.json"
PARAMS_NAME = "params.msgpack"

_MAGIC_RAW = b"PDAR"
_MAGIC_LZ = b"PDAZ"

#: leaves below this element count stay fp32 under ``quantize="int8"``:
#: biases and norm scales are tiny and disproportionately sensitive
_QUANT_MIN_SIZE = 16


def _codec():
    from pytorch_distributed_nn_tpu_torch.ops import host_codec

    return host_codec if host_codec.available() else None


def _walk(tree, fn):
    """``fn`` over the leaves of a nested-dict tree, keys in sorted order
    (the order flax's serializer writes a tree in: it maps over the tree
    as a pytree, whose dicts flatten by sorted key)."""
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn) for k in sorted(tree)}
    return fn(tree)


def _quantize_tree(params):
    """fp tree -> (tree with int8 leaves and their scales, counts).

    Each quantized leaf becomes ``{"__int8__": q, "dtype", "scale"}``; the
    scale is a 0-d float32 array (msgpack writes arrays, not numpy
    scalars). Integer leaves and leaves under :data:`_QUANT_MIN_SIZE`
    elements pass through."""
    stats = {"quantized": 0, "kept": 0}

    def one(leaf):
        a = np.asarray(leaf)
        if not np.issubdtype(a.dtype, np.floating) \
                or a.size < _QUANT_MIN_SIZE:
            stats["kept"] += 1
            return a
        q, scale = quantize_int8_host(a)
        stats["quantized"] += 1
        return {"__int8__": q, "dtype": str(a.dtype),
                "scale": np.asarray(scale, np.float32)}

    return _walk(params, one), stats


def _tree_count_bytes(tree) -> Tuple[int, int]:
    """(elements, bytes) over the tree's array leaves."""
    count = nbytes = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            a = np.asarray(node)
            count += a.size
            nbytes += a.nbytes
    return count, nbytes


def sniff_train_config(train_dir: str) -> dict:
    """The run's TrainConfig from the manifest that heads its
    ``telemetry.jsonl`` ({} when the stream is absent, unreadable or not
    manifest-headed: the caller must then name the network)."""
    path = os.path.join(train_dir, STREAM_BASENAME)
    try:
        with open(path) as f:
            first = json.loads(f.readline())
    except (OSError, ValueError):
        return {}
    if first.get("kind") != "manifest":
        return {}
    return first.get("config") or {}


def resolve_export_step(train_dir: str, step: Optional[int] = None) -> int:
    """The step to freeze: ``step`` when given (it must verify), else the
    newest checkpoint that passes ``verify_checkpoint``. Quarantined steps
    are out of the scan's sight; export never quarantines."""
    if step is not None:
        path = ckpt.checkpoint_path(train_dir, step)
        ok, reason = ckpt.verify_checkpoint(path)
        if not ok:
            raise ValueError(
                f"refusing to export step {step}: checkpoint {path} failed "
                f"validation ({reason}) — export only freezes steps that "
                "prove intact")
        return int(step)
    for s in ckpt.all_steps(train_dir)[::-1]:
        ok, reason = ckpt.verify_checkpoint(ckpt.checkpoint_path(train_dir, s))
        if ok:
            return int(s)
        logger.warning("serve export: skipping step %d (%s) — falling back "
                       "to an older step", s, reason)
    raise FileNotFoundError(f"no valid model_step_<N> checkpoint in "
                            f"{train_dir}")


def _publish(path: str, data, mode: str) -> None:
    with open(path + ".tmp", mode) as f:
        if mode == "w":
            json.dump(data, f, indent=2, sort_keys=True)
        else:
            f.write(data)
    os.replace(path + ".tmp", path)


def export_artifact(train_dir: str, out_dir: str, step: Optional[int] = None,
                    quantize: Optional[str] = None,
                    network: Optional[str] = None,
                    num_classes: Optional[int] = None,
                    model_kw: Optional[dict] = None) -> dict:
    """Freeze one validated checkpoint of ``train_dir`` into the artifact
    directory ``out_dir``; returns the manifest. ``network``,
    ``num_classes`` and ``model_kw`` default from the run's telemetry
    manifest (``vocab_size`` and ``seq_len`` -> ``max_len``); without one
    ``network`` is required. ``quantize``: None/"none" or "int8" (the
    params only; BatchNorm statistics stay fp)."""
    from pytorch_distributed_nn_tpu_torch.models import (
        input_spec,
        is_text_model,
    )

    if quantize not in (None, "none", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}; "
                         "expected none|int8")
    quantize = None if quantize in (None, "none") else quantize
    cfg = sniff_train_config(train_dir)
    network = network or cfg.get("network")
    if not network:
        raise ValueError(
            f"model architecture unknown: {train_dir} has no telemetry "
            "manifest to sniff it from — pass network explicitly "
            "(cli: --network)")
    if num_classes is None:
        num_classes = 100 if cfg.get("dataset") == "Cifar100" else 10
    model_kw = dict(model_kw or {})
    for src_key, kw_key in (("vocab_size", "vocab_size"),
                            ("seq_len", "max_len")):
        if kw_key not in model_kw and cfg.get(src_key) is not None:
            model_kw[kw_key] = cfg[src_key]

    src_step = resolve_export_step(train_dir, step)
    src_path = ckpt.checkpoint_path(train_dir, src_step)
    raw = ckpt.load_raw(src_path)  # refuses sharded directories
    params = raw["params"]
    batch_stats = raw.get("batch_stats") or {}
    if quantize == "int8":
        stored, qstats = _quantize_tree(params)
    else:
        stored, qstats = _walk(params, np.asarray), None
    payload = flax_msgpack.pack_array(
        {"batch_stats": _walk(batch_stats, np.asarray), "params": stored})
    codec = _codec()
    blob = (_MAGIC_LZ + codec.compress(payload) if codec is not None
            else _MAGIC_RAW + payload.tobytes())

    os.makedirs(out_dir, exist_ok=True)
    _publish(os.path.join(out_dir, PARAMS_NAME), blob, "wb")
    param_count, param_bytes = _tree_count_bytes(params)
    manifest = {
        "format": ARTIFACT_FORMAT,
        "network": network,
        "num_classes": int(num_classes),
        "model_kw": model_kw,
        "input": {"kind": "tokens" if is_text_model(network) else "image",
                  "spec": list(input_spec(network))},
        "quantize": quantize or "none",
        "quantize_stats": qstats,
        "source": {"train_dir": os.path.abspath(train_dir),
                   "step": src_step,
                   "checkpoint": os.path.abspath(src_path)},
        "param_count": param_count,
        "param_bytes": param_bytes,
        "bytes": len(blob),
        "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
        "created": time.time(),
    }
    _publish(os.path.join(out_dir, MANIFEST_NAME), manifest, "w")
    # the source step is production provenance now: GC must keep it
    ckpt.record_published_step(train_dir, src_step, out_dir)
    logger.info("Exported step %d of %s -> %s (%s, %d params, %.1f KB on "
                "disk)", src_step, train_dir, out_dir, manifest["quantize"],
                param_count, len(blob) / 1e3)
    return manifest


def _dequantize_tree(tree):
    if isinstance(tree, dict):
        if "__int8__" in tree:
            return dequantize_int8_host(
                tree["__int8__"], tree["scale"],
                dtype=np.dtype(str(tree.get("dtype", "float32"))),
            )
        return {k: _dequantize_tree(v) for k, v in tree.items()}
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


def artifact_version(manifest: dict) -> str:
    """``<train_dir basename>@<step>:<quantize>``, as the JAX package
    names an artifact."""
    src = manifest.get("source") or {}
    base = os.path.basename(str(src.get("train_dir", "?")).rstrip("/")) or "?"
    return f"{base}@{src.get('step', '?')}:{manifest.get('quantize', 'none')}"


def load_manifest(artifact_dir: str) -> dict:
    path = os.path.join(artifact_dir, MANIFEST_NAME)
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format") != ARTIFACT_FORMAT:
        raise ValueError(
            f"{path}: unknown artifact format {manifest.get('format')!r}"
        )
    return manifest


def load_artifact(artifact_dir: str):
    """``(manifest, params, batch_stats)``: the CRC32-checked, int8-
    dequantized flax trees as nested dicts of numpy arrays."""
    manifest = load_manifest(artifact_dir)
    params_path = os.path.join(artifact_dir, PARAMS_NAME)
    with open(params_path, "rb") as f:
        blob = f.read()
    want = manifest.get("crc32")
    if want is not None and (zlib.crc32(blob) & 0xFFFFFFFF) != want:
        raise ValueError(
            f"{params_path}: CRC32 mismatch against {MANIFEST_NAME} — "
            "torn or corrupt artifact; re-export from the source checkpoint"
        )
    magic, payload = blob[:4], blob[4:]
    if magic == _MAGIC_LZ:
        from pytorch_distributed_nn_tpu_torch.ops import host_codec

        payload = host_codec.decompress(payload)
    elif magic != _MAGIC_RAW:
        raise ValueError(f"{params_path}: not a pdtn serving artifact")
    tree = flax_msgpack.unpackb(payload)
    params = _dequantize_tree(tree["params"])
    return manifest, params, tree.get("batch_stats", {}) or {}


def save_artifact(out_dir: str, state_dict: Dict[str, torch.Tensor],
                  network: str, model_kw: Optional[dict] = None,
                  source: Optional[dict] = None) -> dict:
    """Write a port ``CausalLM`` state_dict as a ``pdtn-artifact-v1``
    directory (PDAR, unquantized). ``source`` is the provenance block
    (``train_dir``, ``step``) that names the artifact's version. Returns
    the manifest."""
    from pytorch_distributed_nn_tpu_torch.models import (
        build_model,
        input_spec,
    )
    from pytorch_distributed_nn_tpu_torch.models.convert import (
        state_dict_to_flax,
    )

    model_kw = dict(model_kw or {})
    num_heads = build_model(network, **model_kw).config.num_heads
    params = state_dict_to_flax(state_dict, num_heads)
    payload = flax_msgpack.packb({"params": params, "batch_stats": {}})
    blob = _MAGIC_RAW + payload
    os.makedirs(out_dir, exist_ok=True)
    params_path = os.path.join(out_dir, PARAMS_NAME)
    with open(params_path + ".tmp", "wb") as f:
        f.write(blob)
    os.replace(params_path + ".tmp", params_path)
    leaves = list(_leaves(params))
    manifest = {
        "format": ARTIFACT_FORMAT,
        "network": network,
        "num_classes": 0,
        "model_kw": model_kw,
        "input": {"kind": "tokens", "spec": list(input_spec(network))},
        "quantize": "none",
        "quantize_stats": None,
        "source": dict(source or {"train_dir": "port", "step": 0,
                                  "checkpoint": None}),
        "param_count": int(sum(a.size for a in leaves)),
        "param_bytes": int(sum(a.nbytes for a in leaves)),
        "bytes": len(blob),
        "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
        "created": time.time(),
    }
    mpath = os.path.join(out_dir, MANIFEST_NAME)
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(mpath + ".tmp", mpath)
    return manifest
