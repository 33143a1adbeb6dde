"""The port's artifact reader and writer against the JAX package's, on
the CPU: the port reads what the JAX exporter writes (PDAR, PDAZ, int8)
into exactly the same params, and the JAX reader reads what the port's
``save_artifact`` writes."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.serving import artifact as jax_artifact
from pytorch_distributed_nn_tpu.serving.loadgen import (
    make_tiny_decoder_artifact,
)
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    flax_to_state_dict,
)
from pytorch_distributed_nn_tpu_torch.serving import artifact


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """One JAX checkpoint exported three ways: PDAZ (the native codec
    builds here), PDAR (codec withheld) and int8."""
    root = str(tmp_path_factory.mktemp("torch_artifact"))
    lz = make_tiny_decoder_artifact(root)
    train_dir = os.path.join(root, "train_dir")
    raw = os.path.join(root, "raw")
    codec = jax_artifact._codec
    jax_artifact._codec = lambda: None
    try:
        jax_artifact.export_artifact(train_dir, raw, step=1,
                                     network="GptTiny", num_classes=0)
    finally:
        jax_artifact._codec = codec
    q8 = os.path.join(root, "int8")
    jax_artifact.export_artifact(train_dir, q8, step=1, network="GptTiny",
                                 num_classes=0, quantize="int8")
    return {"PDAZ": lz, "PDAR": raw, "int8": q8}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for key in fa:
        assert fa[key].dtype == fb[key].dtype, key
        assert fa[key].shape == fb[key].shape, key
        assert np.array_equal(fa[key], fb[key]), key


@pytest.mark.parametrize("kind", ["PDAR", "PDAZ", "int8"])
def test_load_artifact_equals_jax_exactly(exported, kind):
    path = exported[kind]
    with open(os.path.join(path, artifact.PARAMS_NAME), "rb") as f:
        magic = f.read(4)
    if kind != "PDAR" and jax_artifact._codec() is None:
        pytest.skip("the native host codec does not build here")
    assert magic == (b"PDAR" if kind == "PDAR" else b"PDAZ")
    manifest, params, stats = artifact.load_artifact(path)
    jm, jparams, jstats = jax_artifact.load_artifact(path)
    assert manifest == jm and stats == jstats == {}
    assert manifest["quantize"] == ("int8" if kind == "int8" else "none")
    _assert_trees_equal(params, jparams)
    assert artifact.artifact_version(manifest) == \
        jax_artifact.artifact_version(jm)


def test_crc_mismatch_refused(exported, tmp_path):
    bad = str(tmp_path / "bad")
    shutil.copytree(exported["PDAR"], bad)
    path = os.path.join(bad, artifact.PARAMS_NAME)
    with open(path, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="CRC32"):
        artifact.load_artifact(bad)
    manifest_path = os.path.join(bad, artifact.MANIFEST_NAME)
    with open(manifest_path) as f:
        doc = json.load(f)
    doc["format"] = "something-else"
    with open(manifest_path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="unknown artifact format"):
        artifact.load_manifest(bad)


def test_save_artifact_round_trips_through_jax(exported, tmp_path):
    _, params, _ = artifact.load_artifact(exported["PDAR"])
    sd = flax_to_state_dict(params)
    out = str(tmp_path / "saved")
    manifest = artifact.save_artifact(
        out, sd, "GptTiny", model_kw={"fused_ln": True},
        source={"train_dir": "/x/run7", "step": 3, "checkpoint": None})
    jm, jparams, _ = jax_artifact.load_artifact(out)
    assert jm == manifest and jm["model_kw"] == {"fused_ln": True}
    assert jax_artifact.artifact_version(jm) == "run7@3:none"
    _assert_trees_equal(jparams, params)
    assert jm["param_count"] == sum(v.numel() for v in sd.values())
    # and the port reads its own artifact back into a loadable model
    _, again, _ = artifact.load_artifact(out)
    model = build_model("GptTiny", **jm["model_kw"])
    model.load_state_dict(flax_to_state_dict(again))
    assert torch.equal(model.state_dict()["lm_bias"], sd["lm_bias"])
