"""The port's stream reader and ``obs`` tools against the JAX package's,
on the CPU.

The reader is host code over JSONL streams, so the port's summaries must
equal the JAX reader's on the same streams: the JAX package's synthetic
training, serving and frontend runs (numpy-seeded), and a
``serving.jsonl`` the port's own batcher wrote, with two artifact
versions (a hot swap halfway). ``obs summary``, ``obs compare
--by-version``, ``obs slo check`` and ``obs export`` print the same text
from either package.
"""

import json
import os

import pytest

from pytorch_distributed_nn_tpu.observability import reader as jax_reader
from pytorch_distributed_nn_tpu.observability.obs_cli import (
    main_obs as jax_obs,
)
from pytorch_distributed_nn_tpu_torch import cli
from pytorch_distributed_nn_tpu_torch.observability import reader

import torch_cpu  # noqa: F401  (one intra-op thread)


def _port_stream(root, name, seed):
    """A port-written serving.jsonl: LeNet step 1, swapped to step 2
    halfway, a bounded queue that sheds."""
    from pytorch_distributed_nn_tpu_torch.serving import loadgen
    from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )

    a1 = loadgen.make_tiny_artifact(os.path.join(root, "a1"), seed=0,
                                    step=1)
    a2 = loadgen.make_tiny_artifact(os.path.join(root, "a2"), seed=1,
                                    step=2)
    engine = InferenceEngine(a1, batch_buckets=(1, 2, 4), device="cpu")
    engine.warmup()
    serve = os.path.join(root, name)
    os.makedirs(serve)
    tel = loadgen.serving_telemetry(serve, engine)
    b = Batcher(engine, telemetry=tel, max_queue=16)
    xs = loadgen.sample_inputs(engine, 16, seed=seed)
    loadgen.run_load(b, xs, 400.0, 0.25, timeout_s=5.0)
    engine.swap(a2)
    loadgen.run_load(b, xs, 400.0, 0.25, timeout_s=5.0)
    b.close()
    tel.close()
    return serve


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_reader")
    out = {k: str(root / k) for k in ("train", "serving", "frontend")}
    jax_reader.write_synthetic_run(out["train"], steps=80, seed=1)
    jax_reader.write_synthetic_serving_run(out["serving"], requests=300,
                                           dropped=4, seed=1)
    jax_reader.write_synthetic_frontend_run(out["frontend"])
    out["port"] = _port_stream(str(root), "port", 0)
    out["port_b"] = _port_stream(str(root / "b"), "port_b", 1)
    return out


@pytest.mark.parametrize("kind", ["train", "serving", "frontend", "port"])
def test_summaries_equal_jax(streams, kind):
    rs, jrs = (reader.read_stream(streams[kind]),
               jax_reader.read_stream(streams[kind]))
    got, want = reader.summarize_run(rs), jax_reader.summarize_run(jrs)
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(
        want, sort_keys=True, default=str)
    assert reader.render_summary(got, rs.manifest) == \
        jax_reader.render_summary(want, jrs.manifest)
    assert reader.summarize_by_version(rs) == \
        jax_reader.summarize_by_version(jrs)
    if kind == "port":
        versions = set(reader.summarize_by_version(rs))
        assert versions == {"train_dir@1:none", "train_dir@2:none"}
        assert got["serving"]["requests"] == len(rs.steps) > 0


def _obs(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["summary", "{train}"],
    ["summary", "{serving}", "--json"],
    ["summary", "{frontend}"],
    ["summary", "{port}"],
    ["compare", "{port}", "{port_b}", "--by-version", "--threshold", "5"],
    ["compare", "{train}", "{train}"],
    ["slo", "check", "{port}", "--slo", "lat_p99<1ms@60s,avail>90%@60s"],
    ["slo", "status", "{serving}", "--slo", "lat_p99<50ms@60s", "--json"],
    ["export", "{port}"],
    ["incidents", "{train}"],
])
def test_obs_prints_what_jax_obs_prints(streams, argv, capsys):
    argv = [a.format(**streams) for a in argv]
    got = _obs(lambda a: cli.main(["obs", *a]), argv, capsys)
    want = _obs(jax_obs, argv, capsys)
    assert got == want
    assert got[1].strip()


def test_obs_selftests_pass(capsys):
    for argv in (["summary", "--selftest"], ["trace", "--selftest"],
                 ["slo", "--selftest"]):
        assert cli.main(["obs", *argv]) == 0
    capsys.readouterr()
