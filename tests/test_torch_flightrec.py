"""The port's flight recorder (``observability/detect.py``,
``flightrec.py`` and the incident report of ``xplane.py``), held against
the JAX package's: the same spec grammar and errors, the same triggers
from one seeded record stream through both detector engines, and the
recorder's bundle layout, rate limit, cap and stall hook with a fake
tracer (as ``tests/test_flightrec.py`` drives the JAX recorder); then a
LeNet run under an injected delay that opens one bundle holding a real
``torch.profiler`` trace."""

import json
import os

import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one intra-op thread)
from pytorch_distributed_nn_tpu.observability import detect as jdetect
from pytorch_distributed_nn_tpu_torch.observability import (
    core,
    detect,
    flightrec,
    xplane,
)

SPECS = [
    "default",
    "step_regression:factor=2.5:warmup=5,stall,cooldown=100,max_bundles=2,"
    "capture_steps=8,ring=64",
    "ckpt_stall:factor=4,cooldown=10",
    "nonfinite:count=2:window=10,straggler_burst:count=2:window=5",
    "slo_breach,stall",
]
BAD = ["bogus", "step_regression:nope=1", "step_regression:factor",
       "cooldown=abc", "cooldown=5:x=1", "unknown_option=3", "cooldown=10"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parse_describe_and_round_trip_equal_jax(spec):
    ours, want = detect.DetectorSpec.parse(spec), jdetect.DetectorSpec.parse(
        spec)
    assert ours.describe() == want.describe()
    assert ours.detectors == want.detectors
    assert (ours.cooldown, ours.max_bundles, ours.capture_steps,
            ours.ring) == (want.cooldown, want.max_bundles,
                           want.capture_steps, want.ring)
    assert detect.DetectorSpec.parse(ours.describe()) == ours


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_raise_the_jax_error(spec):
    with pytest.raises(ValueError) as want:
        jdetect.DetectorSpec.parse(spec)
    with pytest.raises(ValueError) as got:
        detect.DetectorSpec.parse(spec)
    assert str(got.value) == str(want.value)


def _stream(seed, n=400):
    """A seeded record stream: step records (log-normal step times with
    spikes), restarts, and the events every detector watches."""
    rng = np.random.RandomState(seed)
    recs = [{"kind": "manifest", "run_id": "r"}]
    for step in range(1, n + 1):
        st = float(rng.lognormal(np.log(0.08), 0.1))
        if rng.rand() < 0.03:
            st *= float(rng.uniform(3.0, 8.0))
        recs.append({"kind": "step", "step": step, "step_time": st})
        u = rng.rand()
        if u < 0.04:
            recs.append({"kind": "event", "type": "nonfinite_skip",
                         "step": step})
        elif u < 0.08:
            recs.append({"kind": "event", "type": "straggler_drop",
                         "step": step})
        elif u < 0.12:
            stall = float(rng.choice([5.0, 20.0, 400.0], p=[.5, .4, .1]))
            recs.append({"kind": "event", "type": "checkpoint_write",
                         "step": step, "stall_ms": stall})
        elif u < 0.13:
            recs.append({"kind": "event", "type": "stall", "step": step,
                         "age_seconds": 31.0, "grace": 30.0})
        elif u < 0.135:
            recs.append({"kind": "manifest", "run_id": "r2"})
    return recs


def _triggers(module, spec, records):
    out = []
    engine = module.DetectorEngine(module.DetectorSpec.parse(spec),
                                   out.append)
    for rec in records:
        engine.observe(rec)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spec", SPECS)
def test_detector_engines_trigger_alike_on_a_seeded_stream(seed, spec):
    records = _stream(seed)
    want = [(t.kind, t.step, t.reason)
            for t in _triggers(jdetect, spec, records)]
    got = [(t.kind, t.step, t.reason)
           for t in _triggers(detect, spec, records)]
    assert got == want
    # the port's own step records carry step_ms: the same triggers
    port_records = [
        {k: v for k, v in r.items() if k != "step_time"}
        | {"step_ms": r["step_time"] * 1000.0}
        if r["kind"] == "step" else r for r in records]
    assert [(t.kind, t.step) for t in _triggers(detect, spec,
                                                port_records)] \
        == [(k, s) for k, s, _ in want]
    if spec == "default" and seed == 0:
        assert {k for k, _, _ in want} >= {"step_regression", "nonfinite",
                                           "stall", "ckpt_stall"}


# -- the recorder with a fake tracer ------------------------------------------


def _step(i, st=0.01):
    return {"step": i, "step_time": st}


SPEC = ("step_regression:factor=3:warmup=3:min_ms=10,"
        "cooldown=10,capture_steps=2,max_bundles=2,ring=32")


def _recorder(tmp_path, spec_str, tracer=None, calls=None):
    calls = calls if calls is not None else []
    tracer = tracer or (lambda d: calls.append(("start", d)),
                        lambda: calls.append(("stop",)))
    tel = core.Telemetry.for_run(
        os.path.join(str(tmp_path), "telemetry.jsonl"),
        core.run_manifest(config={"network": "X"}))
    fr = flightrec.FlightRecorder(str(tmp_path), tel,
                                  detect.DetectorSpec.parse(spec_str),
                                  tracer=tracer)
    return tel, fr, calls


def _drive(tel, fr, n, spike_at=(), start=1):
    for i in range(start, start + n):
        tel.log_step(_step(i, st=0.5 if i in spike_at else 0.01))
        fr.tick(i)


def test_bundle_layout_rate_limit_and_report(tmp_path):
    tel, fr, calls = _recorder(tmp_path, SPEC)
    try:
        # spike at 8 -> capture 9..10; the spike at 12 is inside the
        # cooldown -> suppressed
        _drive(tel, fr, 14, spike_at={8, 12})
        assert len(fr.bundles) == 1 and fr.suppressed >= 1
        bundle = fr.bundles[0]
        assert os.path.basename(bundle) == "8-step_regression"
        for name in ("incident.json", "events.jsonl", "manifest.json",
                     "env.json"):
            assert os.path.isfile(os.path.join(bundle, name)), name
        with open(os.path.join(bundle, "incident.json")) as f:
            meta = json.load(f)
        assert meta["kind"] == "step_regression" and meta["step"] == 8
        assert meta["capture_until_step"] == 10
        with open(os.path.join(bundle, "events.jsonl")) as f:
            ring = [json.loads(line) for line in f]
        assert ring[0]["kind"] == "manifest" and ring[-1]["step"] == 8
        assert calls == [("start", os.path.join(bundle, "trace")),
                         ("stop",)]
        with open(os.path.join(bundle, "env.json")) as f:
            env = json.load(f)
        assert "torch_version" in env and "env" in env
    finally:
        fr.close()
        tel.close()
    with open(os.path.join(fr.bundles[0], "report.md")) as f:
        report = f.read()
    assert "step_regression" in report and "Event ring" in report
    with open(os.path.join(str(tmp_path), "telemetry.jsonl")) as f:
        incidents = [r for r in map(json.loads, f)
                     if r.get("type") == "incident"]
    assert [(r["incident"], r["step"]) for r in incidents] == [
        ("step_regression", 8)]
    assert incidents[0]["bundle"].startswith("incidents/")
    assert tel.registry.counter(
        "incidents_total", labels={"kind": "step_regression"}).value == 1


def test_max_bundles_hard_cap(tmp_path):
    tel, fr, _ = _recorder(
        tmp_path, "step_regression:factor=3:warmup=3:min_ms=10,"
        "cooldown=1,capture_steps=1,max_bundles=2")
    try:
        _drive(tel, fr, 40, spike_at={8, 15, 22, 29})
        assert len(fr.bundles) == 2 and fr.suppressed >= 2
        assert tel.registry.gauge("detector_armed").value == 0.0
    finally:
        fr.close()
        tel.close()


def test_armed_gauge_and_due(tmp_path):
    tel, fr, _ = _recorder(tmp_path, SPEC)
    try:
        g = tel.registry.gauge("detector_armed")
        assert g.value == 1.0
        _drive(tel, fr, 7)
        tel.log_step(_step(8, st=0.5))
        assert fr.due(8)  # a pending trigger opens at this tick
        fr.tick(8)
        assert g.value == 0.0 and not fr.due(9) and fr.due(10)
        _drive(tel, fr, 13, start=9)  # past the capture and the cooldown
        assert g.value == 1.0
    finally:
        fr.close()
        tel.close()


def test_trace_failure_still_writes_bundle(tmp_path):
    def boom(_):
        raise RuntimeError("profiler busy")

    tel, fr, _ = _recorder(tmp_path, SPEC, tracer=(boom, lambda: None))
    try:
        _drive(tel, fr, 12, spike_at={8})
    finally:
        fr.close()
        tel.close()
    assert len(fr.bundles) == 1
    with open(os.path.join(fr.bundles[0], "report.md")) as f:
        assert "trace not captured" in f.read()


def test_notify_stall_direct_hook_and_lookup(tmp_path):
    tel, fr, _ = _recorder(tmp_path, "stall,cooldown=5")
    try:
        fr.notify_stall(12.0)  # the supervisor watchdog's hook
        fr.tick(1)
        assert fr._capture is not None
    finally:
        fr.close()
        tel.close()
    assert len(fr.bundles) == 1 and "stall" in os.path.basename(
        fr.bundles[0])
    (entry,) = flightrec.list_incidents(str(tmp_path))
    assert entry["kind"] == "stall" and entry["has_report"]
    assert flightrec.find_incident(str(tmp_path), entry["name"]) == entry
    assert flightrec.find_incident(str(tmp_path), "nope") is None


def test_report_degrades_without_device_events(tmp_path, monkeypatch):
    monkeypatch.setattr(xplane, "summarize_trace", lambda *a, **k: {})
    bundle = os.path.join(str(tmp_path), "7-stall")
    os.makedirs(os.path.join(bundle, "trace"))
    with open(os.path.join(bundle, "trace", "h.1.pt.trace.json"), "w") as f:
        f.write("{}")
    with open(os.path.join(bundle, "incident.json"), "w") as f:
        json.dump({"kind": "stall", "step": 7, "reason": "r",
                   "triggered_time": 1.0, "spec": "s"}, f)
    with open(os.path.join(bundle, "events.jsonl"), "w") as f:
        f.write(json.dumps({"kind": "step", "step": 7,
                            "step_time": 0.5}) + "\n")
    with open(xplane.write_incident_report(bundle)) as f:
        report = f.read()
    assert "# Incident: stall @ step 7" in report
    assert "no device planes" in report and "step=7" in report


# -- the trainer --------------------------------------------------------------


def test_delay_under_flightrec_opens_one_bundle_with_a_trace(tmp_path):
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    d = str(tmp_path)
    cfg = TrainConfig(
        network="LeNet", dataset="MNIST", batch_size=16, synthetic_size=32,
        max_steps=10, test_batch_size=16, train_dir=d,
        metrics_path=os.path.join(d, "telemetry.jsonl"),
        faults="delay@7:1.0s",
        flightrec=("step_regression:factor=2.5:warmup=4:min_ms=400,"
                   "cooldown=50,capture_steps=2"))
    trainer = Trainer(cfg, device="cpu")
    try:
        history = trainer.train()
    finally:
        trainer.close()
    assert len(history) == 10 and history[6]["step_ms"] >= 1000.0
    (inc,) = flightrec.list_incidents(d)
    assert inc["kind"] == "step_regression" and inc["step"] == 7
    assert inc["has_trace"] and inc["has_report"]
    with open(os.path.join(inc["path"], "events.jsonl")) as f:
        ring = [json.loads(line) for line in f if line.strip()]
    assert any(r.get("type") == "fault_injected" and r.get("step") == 7
               for r in ring)
    with open(os.path.join(inc["path"], "report.md")) as f:
        assert "no device planes" in f.read()  # a CPU trace


def test_bad_spec_fails_before_the_model_is_built(tmp_path, monkeypatch):
    from pytorch_distributed_nn_tpu_torch.training import trainer as tr

    monkeypatch.setattr(tr, "build_train_model", lambda c: 1 / 0)
    with pytest.raises(ValueError, match="unknown detector"):
        tr.Trainer(tr.TrainConfig(
            network="LeNet", dataset="MNIST", batch_size=16,
            synthetic_size=32, max_steps=2, train_dir=str(tmp_path),
            flightrec="bogus_detector"), device="cpu")
