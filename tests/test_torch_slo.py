"""The port's SLO engine, Prometheus exporter and the supervisor's
``metrics.prom`` against the JAX package's, on the CPU.

The modules are host code, so the port must agree exactly: the same
spec parses to the same objectives (or the same error), the same request
records (latencies drawn with numpy from a seed, on a fixed clock) give
the same burn rates, status, breaches and ``slo_breach`` events, and the
same stream replays into byte-equal exposition text.
"""

import json
import os

import numpy as np
import pytest

from pytorch_distributed_nn_tpu.observability import core as jax_core
from pytorch_distributed_nn_tpu.observability import promexport as jax_prom
from pytorch_distributed_nn_tpu.observability import reader as jax_reader
from pytorch_distributed_nn_tpu.observability import slo as jax_slo
from pytorch_distributed_nn_tpu.resilience import supervisor as jax_sup
from pytorch_distributed_nn_tpu_torch.observability import (
    core,
    promexport,
    reader,
    slo,
)
from pytorch_distributed_nn_tpu_torch.resilience import supervisor

import torch_cpu  # noqa: F401  (one intra-op thread)

T0 = 1_700_000_000.0


@pytest.mark.parametrize("spec", [
    "lat_p99<25ms@60s,avail>99.5%@300s", "lat_p50<1.5s@30s",
    "lat_p95<9ms@12s", "lat_p99.9<5ms@60s", "lat_p98<25ms@60s",
    "avail>101%@60s", "avail>0%@60s", "lat_p99<25@60s", "lat_p99<0ms@60s",
    "qps>100@60s", "", "lat_p99<25ms@60s,lat_p99<25ms@60s", "lat_p99<25ms"])
def test_parse_slos_equals_jax(spec):
    try:
        want = jax_slo.parse_slos(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            slo.parse_slos(spec)
        assert str(got.value) == str(e)
        return
    got = slo.parse_slos(spec)
    assert [s.__dict__ for s in got] == [s.__dict__ for s in want]
    assert slo.describe(got) == jax_slo.describe(want) == spec


def _records(seed, n=1500, rate=20.0):
    """Request records and drop events on a fixed clock: a healthy
    stretch, a burst of slow requests and drops, a healthy tail."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t = T0 + i / rate
        burst = n // 3 <= i < n // 2
        if burst and rng.rand() < 0.1:
            out.append({"kind": "event", "type": "request_dropped",
                        "time": t, "request": i})
            continue
        lat = float(rng.lognormal(np.log(60.0 if burst else 8.0), 0.3))
        out.append({"kind": "step", "step": i, "time": t,
                    "latency_ms": round(lat, 3)})
    return out


def _run(mod_core, mod_slo, records, spec):
    tel = mod_core.Telemetry()
    events = []
    tel.subscribe(lambda r: events.append(r)
                  if r.get("type") == "slo_breach" else None)
    eng = mod_slo.SLOEngine(spec, telemetry=tel, min_events=20,
                            eval_every_s=0.5)
    for rec in records:
        eng.observe_record(rec)
    end = records[-1]["time"]
    status = eng.status(now=end)
    breached = eng.breached()
    gauges = {m.name + json.dumps(m.labels, sort_keys=True): m.value
              for m in tel.registry.collect() if m.kind == "gauge"}
    eng.close()
    return ([{k: v for k, v in e.items() if k not in ("time", "mono")}
             for e in events], status, breached, gauges,
            mod_slo.render_status(status, breached))


@pytest.mark.parametrize("seed", [0, 1])
def test_burn_windows_status_and_events_equal_jax(seed):
    spec = "lat_p99<25ms@60s,avail>99.5%@30s,lat_p50<20ms@10s"
    records = _records(seed)
    got = _run(core, slo, records, spec)
    want = _run(jax_core, jax_slo, records, spec)
    assert got == want
    events, status, breached, _, _ = got
    assert len(events) >= 2 and {b["slo"] for b in breached} >= {
        "lat_p99<25ms@60s", "avail>99.5%@30s"}


def test_evaluate_stream_equals_jax(tmp_path):
    jax_reader.write_synthetic_serving_run(str(tmp_path), requests=400,
                                           dropped=6, seed=3)
    spec = "lat_p99<6ms@60s,avail>99%@60s"
    eng, status = slo.evaluate_stream(reader.read_stream(str(tmp_path)),
                                      spec)
    jeng, jstatus = jax_slo.evaluate_stream(
        jax_reader.read_stream(str(tmp_path)), spec)
    assert status == jstatus and eng.breached() == jeng.breached()
    assert slo.render_status(status, eng.breached()) == \
        jax_slo.render_status(jstatus, jeng.breached())
    assert slo.selftest() == 0


def _port_serving_stream(tmp_path):
    """A serving.jsonl written by the port's batcher (LeNet on the CPU),
    with drops and sheds."""
    from pytorch_distributed_nn_tpu_torch.serving import loadgen
    from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )

    art = loadgen.make_tiny_artifact(str(tmp_path / "art"))
    engine = InferenceEngine(art, batch_buckets=(1, 2, 4), device="cpu")
    engine.warmup()
    serve = str(tmp_path / "serve")
    os.makedirs(serve)
    tel = loadgen.serving_telemetry(serve, engine)
    b = Batcher(engine, telemetry=tel, max_queue=8)
    loadgen.run_load(b, loadgen.sample_inputs(engine, 16), 500.0, 0.2,
                     timeout_s=5.0)
    b.close()
    tel.close()
    return serve


@pytest.mark.parametrize("kind", ["train", "serving", "port"])
def test_promexport_render_of_a_replayed_stream_equals_jax(tmp_path, kind):
    if kind == "train":
        jax_reader.write_synthetic_run(str(tmp_path), steps=40, seed=2)
        target = str(tmp_path)
    elif kind == "serving":
        jax_reader.write_synthetic_serving_run(str(tmp_path), seed=2)
        target = str(tmp_path)
    else:
        target = _port_serving_stream(tmp_path)
    got = promexport.render(reader.replay_registry(
        reader.read_stream(target)))
    want = jax_prom.render(jax_reader.replay_registry(
        jax_reader.read_stream(target)))
    assert got == want
    assert promexport.validate_exposition(got) == []
    assert jax_prom.validate_exposition(got) == []
    assert "pdtn_" in got
    bad = got.replace("# TYPE", "# TYPO", 1)
    assert promexport.validate_exposition(bad) == \
        jax_prom.validate_exposition(bad) != []


def test_supervisor_writes_metrics_prom_like_jax(tmp_path):
    """Each beat publishes the run's registry to ``metrics.prom``; the
    same metric updates give the JAX supervisor's file."""
    files = {}
    for name, mod_core, mod_sup in (("port", core, supervisor),
                                    ("jax", jax_core, jax_sup)):
        run_dir = tmp_path / name
        run_dir.mkdir()
        tel = mod_core.Telemetry()
        for step in range(3):
            tel.log_step({"step": step, "loss": 2.0 - step,
                          "step_time": 0.1 + 0.01 * step})
        tel.emit("checkpoint_write", step=2, path="x", ms=3.0)
        sup = mod_sup.RunSupervisor(str(run_dir), telemetry=tel,
                                    signals=())
        with sup:
            sup.beat(2)
        with open(run_dir / "metrics.prom") as f:
            files[name] = f.read()
        assert json.load(open(run_dir / "heartbeat.json"))["step"] == 2
    assert files["port"] == files["jax"]
    assert promexport.validate_exposition(files["port"]) == []
    assert "pdtn_steps_total 3" in files["port"]
    # without a telemetry the beat writes the heartbeat only
    quiet = tmp_path / "quiet"
    quiet.mkdir()
    with supervisor.RunSupervisor(str(quiet), signals=()) as sup:
        sup.beat(1)
    assert not (quiet / "metrics.prom").exists()
