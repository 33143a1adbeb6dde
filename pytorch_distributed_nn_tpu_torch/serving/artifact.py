"""Serving artifacts in the JAX package's ``pdtn-artifact-v1`` format.

An artifact is a directory::

    <artifact>/
      artifact.json     # manifest: network, model_kw, quantize mode,
                        # source step, param count/bytes, CRC32
      params.msgpack    # 4-byte magic + flax-msgpack {"params",
                        # "batch_stats"}: PDAR raw, PDAZ compressed with
                        # the native host codec

The reader covers what the JAX exporter writes: both magics, the CRC32
check against the manifest, int8 leaves (``{"__int8__": q, "scale",
"dtype"}``) dequantized on load, and flax's msgpack ndarray extension
(type 1: a msgpack ``(shape, dtype name, C-order bytes)`` triple),
decoded here without flax. The
writer, :func:`save_artifact`, emits the same format (PDAR, no
quantization) from a port state_dict, so the JAX package's
``load_artifact`` reads it and the port can make an artifact with no
JAX installed.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Dict, Optional

import msgpack
import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.ops.compression import (
    dequantize_int8_host,
)

ARTIFACT_FORMAT = "pdtn-artifact-v1"
MANIFEST_NAME = "artifact.json"
PARAMS_NAME = "params.msgpack"

_MAGIC_RAW = b"PDAR"
_MAGIC_LZ = b"PDAZ"
_EXT_NDARRAY = 1  # flax.serialization's msgpack ext type for ndarrays


def _ext_unpack(code: int, data: bytes):
    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code} in artifact")
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(
        shape, order="C"
    )


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
            (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))
    raise TypeError(f"cannot serialize {type(x).__name__} into an artifact")


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
    tree = msgpack.unpackb(payload, ext_hook=_ext_unpack, raw=False)
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
    payload = msgpack.packb({"params": params, "batch_stats": {}},
                            default=_ext_pack, strict_types=True)
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
