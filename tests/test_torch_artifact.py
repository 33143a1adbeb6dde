"""The port's artifact reader, writer and exporter against the JAX
package's, on the CPU: the port reads what the JAX exporter writes (PDAR,
PDAZ, int8) into exactly the same params, the JAX reader reads what the
port's ``save_artifact`` writes, and the port's ``export_artifact`` gives
the JAX exporter's bytes for the same checkpoint (image and token models,
with and without int8), with its refusals and its GC registration."""

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

import torch_cpu  # noqa: F401  (one intra-op thread)


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


# -- export: checkpoints -> artifacts, against the JAX exporter -------------

from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt  # noqa: E402


def _jax_checkpoint(train_dir, network, step=1, seed=0):
    """A random-init JAX TrainState of ``network`` written by the JAX
    package's ``save_checkpoint``."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_nn_tpu.models import build_model as jax_build
    from pytorch_distributed_nn_tpu.models import input_spec
    from pytorch_distributed_nn_tpu.optim import build_optimizer
    from pytorch_distributed_nn_tpu.parallel import make_grad_sync
    from pytorch_distributed_nn_tpu.training import checkpoint as jax_ckpt
    from pytorch_distributed_nn_tpu.training.train_step import (
        create_train_state,
    )

    text = network == "BertTiny"
    state = create_train_state(
        jax_build(network, 0 if text else 10), build_optimizer("sgd", 0.1),
        make_grad_sync("local"), jax.random.PRNGKey(seed),
        input_spec(network), **({"input_dtype": jnp.int32} if text else {}))
    jax_ckpt.save_checkpoint(str(train_dir), jax.device_get(state),
                             step=step)


def _port_checkpoint(train_dir, network, step=1, seed=0):
    """A random-init port TrainState of ``network`` written by the port's
    ``save_checkpoint``."""
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        create_train_state,
    )

    model = build_model(network, 0 if network == "BertTiny" else 10)
    model.init_weights(torch.Generator().manual_seed(seed))
    state = create_train_state(
        model, lambda p: build_optimizer("sgd", p, 0.1), "cpu", seed=seed)
    state.step = step
    ckpt.save_checkpoint(str(train_dir), state, step=step)


@pytest.fixture(scope="module")
def train_dirs(tmp_path_factory):
    """One checkpoint from each package: LeNet from the JAX package,
    ResNet-20 and BertTiny (a token model) from the port."""
    root = tmp_path_factory.mktemp("torch_export")
    dirs = {"LeNet": root / "jax_lenet", "ResNet20": root / "port_resnet20",
            "BertTiny": root / "port_bert_tiny"}
    _jax_checkpoint(dirs["LeNet"], "LeNet")
    _port_checkpoint(dirs["ResNet20"], "ResNet20")
    _port_checkpoint(dirs["BertTiny"], "BertTiny")
    return {k: str(v) for k, v in dirs.items()}


def _strip(manifest):
    """A manifest less ``created``, the export's own time (the absolute
    source paths are equal: both exports read one train_dir)."""
    return {k: v for k, v in manifest.items() if k != "created"}


@pytest.mark.parametrize("network", ["LeNet", "ResNet20", "BertTiny"])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_export_is_byte_equal_to_the_jax_exporter(train_dirs, network,
                                                  quantize, tmp_path):
    td = train_dirs[network]
    classes = 0 if network == "BertTiny" else 10
    want = jax_artifact.export_artifact(
        td, str(tmp_path / "jax"), network=network, num_classes=classes,
        quantize=quantize)
    got = artifact.export_artifact(
        td, str(tmp_path / "port"), network=network, num_classes=classes,
        quantize=quantize)
    with open(tmp_path / "jax" / artifact.PARAMS_NAME, "rb") as f:
        jax_blob = f.read()
    with open(tmp_path / "port" / artifact.PARAMS_NAME, "rb") as f:
        port_blob = f.read()
    assert port_blob == jax_blob
    if jax_artifact._codec() is not None:
        assert port_blob[:4] == b"PDAZ"
    assert _strip(got) == _strip(want)
    assert got["input"]["kind"] == ("tokens" if network == "BertTiny"
                                    else "image")
    assert (got["quantize_stats"] is None) == (quantize == "none")
    # each package reads the other's export into the same trees
    jm, jparams, jstats = jax_artifact.load_artifact(str(tmp_path / "port"))
    pm, pparams, pstats = artifact.load_artifact(str(tmp_path / "jax"))
    assert jm == got and pm == want
    _assert_trees_equal(pparams, jparams)
    _assert_trees_equal(pstats, jstats)


def test_int8_export_dequantizes_to_the_jax_values_bit_for_bit(train_dirs,
                                                                tmp_path):
    from pytorch_distributed_nn_tpu.ops.compression import (
        quantize_int8_host as jax_quantize,
    )
    from pytorch_distributed_nn_tpu_torch.ops.compression import (
        quantize_int8_host,
    )

    rng = np.random.RandomState(0)
    for a in (rng.randn(37, 5).astype(np.float32) * 3,
              np.zeros((4, 4), np.float32), np.float32([0.5, -127.0, 1e-9])):
        q, s = quantize_int8_host(a)
        jq, js = jax_quantize(a)
        assert q.dtype == np.int8 and q.tobytes() == jq.tobytes()
        assert np.float32(s).tobytes() == np.float32(js).tobytes()
    artifact.export_artifact(train_dirs["ResNet20"], str(tmp_path / "q"),
                             network="ResNet20", quantize="int8")
    _, params, _ = artifact.load_artifact(str(tmp_path / "q"))
    _, jparams, _ = jax_artifact.load_artifact(str(tmp_path / "q"))
    _assert_trees_equal(params, jparams)


def _lenet_dir(tmp_path, steps=(1,)):
    td = tmp_path / "td"
    for s in steps:
        _jax_checkpoint(td, "LeNet", step=s, seed=s)
    return str(td)


def test_export_refuses_a_torn_step_and_falls_back(tmp_path):
    td = _lenet_dir(tmp_path, (1, 2))
    path2 = ckpt.checkpoint_path(td, 2)
    with open(path2, "r+b") as f:
        f.truncate(64)
    with pytest.raises(ValueError, match="refusing to export"):
        artifact.export_artifact(td, str(tmp_path / "x"), network="LeNet",
                                 step=2)
    manifest = artifact.export_artifact(td, str(tmp_path / "art"),
                                        network="LeNet")
    assert manifest["source"]["step"] == 1
    assert os.path.exists(path2)  # export never quarantines


def test_export_cannot_see_a_quarantined_step(tmp_path):
    td = _lenet_dir(tmp_path, (1, 2))
    ckpt.quarantine_checkpoint(ckpt.checkpoint_path(td, 2))
    assert artifact.resolve_export_step(td) == 1
    with pytest.raises(ValueError, match="refusing to export"):
        artifact.export_artifact(td, str(tmp_path / "x"), network="LeNet",
                                 step=2)
    with pytest.raises(FileNotFoundError, match="no valid"):
        artifact.resolve_export_step(str(tmp_path / "empty"))


def test_export_registers_its_step_and_gc_protects_it(tmp_path):
    td = _lenet_dir(tmp_path, (1, 2, 3))
    artifact.export_artifact(td, str(tmp_path / "art"), network="LeNet",
                             step=1)
    assert ckpt.published_steps(td) == {1}
    res = ckpt.gc_checkpoints(td, keep_last=1)
    assert res["deleted"] == [2]
    assert ckpt.all_steps(td) == [1, 3]


def test_export_sniffs_the_network_or_requires_it(tmp_path):
    import dataclasses

    from pytorch_distributed_nn_tpu_torch.observability import core as obs
    from pytorch_distributed_nn_tpu_torch.training.config import (
        TrainConfig,
    )

    td = _lenet_dir(tmp_path)
    with pytest.raises(ValueError, match="architecture unknown"):
        artifact.export_artifact(td, str(tmp_path / "x"))
    # the manifest that heads a port trainer's stream names the network
    t = obs.Telemetry.for_run(
        os.path.join(td, obs.STREAM_BASENAME),
        obs.run_manifest(config=dataclasses.asdict(
            TrainConfig(network="LeNet", dataset="MNIST"))))
    t.close()
    manifest = artifact.export_artifact(td, str(tmp_path / "art"))
    assert manifest["network"] == "LeNet" and manifest["num_classes"] == 10
    assert artifact.sniff_train_config(td)["dataset"] == "MNIST"
    assert artifact.sniff_train_config(str(tmp_path / "none")) == {}
