"""The port's model registry (pytorch_distributed_nn_tpu_torch/serving/
registry.py) against the JAX package's, on the CPU.

Both packages keep ``registry.json`` as ``pdtn-registry-v1``: the same
publish, label, rollback and gc sequence gives the same index (canonical
bytes, with ``created`` fixed and the root prefix taken out), and either
package reads and verifies the index the other wrote. Artifacts are the
registry's fabricated ones (a manifest and a CRC-stamped blob: the
registry checks nothing more), plus one real port export for the gc
closure over a port checkpoint directory.
"""

import json
import os

import pytest

from pytorch_distributed_nn_tpu.serving import registry as jax_registry
from pytorch_distributed_nn_tpu.training import checkpoint as jax_ckpt
from pytorch_distributed_nn_tpu_torch import cli
from pytorch_distributed_nn_tpu_torch.serving import registry
from pytorch_distributed_nn_tpu_torch.serving.registry import (
    Registry,
    RegistryError,
)
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

import torch_cpu  # noqa: F401  (one intra-op thread)


def _artifacts(root, steps=(1, 2, 3)):
    """Fabricated artifacts of steps ``steps`` from ``<root>/td``, each
    recorded as published from it (the port's record)."""
    td = os.path.join(root, "td")
    os.makedirs(td, exist_ok=True)
    out = {}
    for s in steps:
        out[s] = registry._fake_artifact(root, f"a{s}", s, train_dir=td,
                                         payload=f"w{s}".encode())
        ckpt.record_published_step(td, s, out[s])
    return td, out


def _lifecycle(reg, arts):
    """The operator sequence both packages run: publish, label, a
    promote-shaped move, a rollback, gc."""
    reg.publish(arts[1], labels=("stable",))
    reg.publish(arts[2])
    reg.publish(arts[3], labels=("canary",))
    reg.set_labels({"stable": "td@3:none", "canary": None})
    reg.rollback("stable")
    return reg.gc(keep_last=1)


def _canonical(doc, root):
    """The index as canonical bytes with ``created`` fixed and ``root``
    taken out of every path."""
    doc = json.loads(json.dumps(doc))
    for e in doc["entries"]:
        e["created"] = 0.0
        e["manifest"]["created"] = 0.0
        e["manifest_crc32"] = 0
    text = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return text.replace(str(root), "<root>").encode()


def _published(td, root):
    with open(os.path.join(td, "published.json")) as f:
        doc = json.load(f)
    for e in doc["artifacts"]:
        e.pop("time")
        e["artifact"] = e["artifact"].replace(str(root), "<root>")
    return doc


def test_lifecycle_index_and_published_equal_jax(tmp_path):
    """publish, label, rollback, gc and verify: equal outcomes, equal
    ``registry.json``, equal ``published.json`` after gc's release."""
    rp, rj = tmp_path / "port", tmp_path / "jax"
    td_p, arts_p = _artifacts(str(rp))
    os.makedirs(rj / "td")
    td_j = str(rj / "td")
    arts_j = {}
    for s in (1, 2, 3):
        arts_j[s] = jax_registry._fake_artifact(
            str(rj), f"a{s}", s, train_dir=td_j, payload=f"w{s}".encode())
        jax_ckpt.record_published_step(td_j, s, arts_j[s])
    # the same manifests on both sides, so the CRC fields agree too
    for s in (1, 2, 3):
        with open(os.path.join(arts_p[s], "artifact.json")) as f:
            m = json.load(f)
        m["source"]["train_dir"] = td_j
        m["source"]["checkpoint"] = m["source"]["checkpoint"].replace(
            str(rp), str(rj))
        with open(os.path.join(arts_j[s], "artifact.json"), "w") as f:
            json.dump(m, f)
    got = _lifecycle(Registry(str(rp / "reg")), arts_p)
    want = _lifecycle(jax_registry.Registry(str(rj / "reg")), arts_j)
    assert got == want == {"retired": ["td@2:none"],
                           "kept": ["td@1:none", "td@3:none"]}
    doc_p = Registry(str(rp / "reg")).load()
    doc_j = jax_registry.Registry(str(rj / "reg")).load()
    assert doc_p["labels"] == doc_j["labels"] == {"stable": "td@1:none"}
    assert _canonical(doc_p, rp) == _canonical(doc_j, rj)
    # gc released step 2's protection in both train dirs, alike
    assert ckpt.published_steps(td_p) == {1, 3}
    assert _published(td_p, rp) == _published(td_j, rj)
    for reg in (Registry(str(rp / "reg")),
                jax_registry.Registry(str(rj / "reg"))):
        assert reg.verify("td@1:none") == (True, "ok")
        assert reg.verify("td@2:none")[0] is False  # retired


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_index(tmp_path, writer):
    td, arts = _artifacts(str(tmp_path))
    root = str(tmp_path / "reg")
    W, R = ((Registry, jax_registry.Registry) if writer == "port"
            else (jax_registry.Registry, Registry))
    w = W(root)
    w.publish(arts[1], labels=("stable",))
    w.publish(arts[2], labels=("canary",))
    r = R(root)
    assert r.labels() == {"stable": "td@1:none", "canary": "td@2:none"}
    assert r.resolve("canary")["artifact"] == arts[2]
    assert r.verify("td@2:none") == (True, "ok")
    # a write by the reader is read back by the writer
    r.set_labels({"stable": "td@2:none", "canary": None})
    assert w.labels() == {"stable": "td@2:none"}
    assert w.rollback("stable") == ("td@2:none", "td@1:none")
    assert r.resolve("stable")["version"] == "td@1:none"


def test_torn_artifact_and_contract_refusals(tmp_path):
    td, arts = _artifacts(str(tmp_path), steps=(1,))
    reg = Registry(str(tmp_path / "reg"))
    torn = registry._fake_artifact(str(tmp_path), "torn", 9, train_dir=td)
    with open(os.path.join(torn, "params.msgpack"), "ab") as f:
        f.write(b"x")  # torn after the manifest recorded its CRC
    with pytest.raises(RegistryError, match="torn or corrupt"):
        reg.publish(torn)
    with pytest.raises(jax_registry.RegistryError, match="torn or corrupt"):
        jax_registry.Registry(str(tmp_path / "jreg")).publish(torn)
    assert reg.entries() == []
    reg.publish(arts[1])
    assert reg.publish(arts[1])["version"] == "td@1:none"  # idempotent
    other = registry._fake_artifact(str(tmp_path), "other", 1,
                                    train_dir=td, payload=b"different")
    with pytest.raises(RegistryError, match="immutable"):
        reg.publish(other)
    with pytest.raises(RegistryError, match="unknown label"):
        reg.label("prod", "td@1:none")
    with pytest.raises(RegistryError, match="no history"):
        reg.rollback("stable")
    with open(os.path.join(arts[1], "params.msgpack"), "ab") as f:
        f.write(b"!")
    ok, reason = reg.verify("td@1:none")
    assert not ok and "torn or replaced" in reason


def test_gc_releases_a_port_export(tmp_path):
    """The closure over a real port checkpoint directory: registry gc
    retires the unlabeled export and releases its step, which checkpoint
    GC then reclaims."""
    import torch

    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        export_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        create_train_state,
    )

    model = build_model("LeNet", 10).init_weights(
        torch.Generator().manual_seed(0))
    state = create_train_state(
        model, lambda p: build_optimizer("sgd", p, 0.1), "cpu", seed=0)
    td = str(tmp_path / "td")
    reg = Registry(str(tmp_path / "reg"))
    for step in (1, 2):
        state.step = step
        ckpt.save_checkpoint(td, state, step=step)
        out = str(tmp_path / f"art{step}")
        export_artifact(td, out, step=step, network="LeNet",
                        num_classes=10)
        reg.publish(out, labels=("stable",) if step == 2 else ())
    assert ckpt.published_steps(td) == {1, 2}
    assert 1 in ckpt.gc_checkpoints(td, keep_last=1)["kept"]
    assert reg.gc(keep_last=1)["retired"] == ["td@1:none"]
    assert ckpt.published_steps(td) == {2}
    assert 1 in ckpt.gc_checkpoints(td, keep_last=1)["deleted"]


def test_cli_registry_commands(tmp_path, capsys):
    td, arts = _artifacts(str(tmp_path))
    r = ["--registry", str(tmp_path / "reg")]
    assert cli.main(["registry", "publish", *r, "--artifact", arts[1],
                     "--label", "stable"]) == 0
    assert cli.main(["registry", "publish", *r, "--artifact", arts[2]]) == 0
    assert cli.main(["registry", "label", *r, "stable", "td@2:none"]) == 0
    assert cli.main(["registry", "rollback", *r]) == 0
    assert cli.main(["registry", "verify", *r, "td@1:none"]) == 0
    assert cli.main(["registry", "list", *r, "--json"]) == 0
    out = capsys.readouterr().out
    assert "rolled back stable: td@2:none -> td@1:none" in out
    doc = json.loads(out[out.index("{\n"):])
    assert doc["labels"] == {"stable": "td@1:none"}
    assert cli.main(["registry", "gc", *r, "--keep-last", "1",
                     "--json"]) == 0
    assert cli.main(["registry", "label", *r, "stable", "td@9:none"]) == 2
    exports = tmp_path / "exports"
    exports.mkdir()
    registry._fake_artifact(str(exports), "new", 4, train_dir=td)
    assert cli.main(["registry", "watch", *r, "--dir", str(exports),
                     "--max-polls", "1"]) == 0
    assert "picked up td@4:none" in capsys.readouterr().out
    assert cli.main(["registry", "--selftest"]) == 0
