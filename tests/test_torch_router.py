"""The port's deployment lifecycle on the CPU: engine hot swap and shadow
engines, the canary router, the admin endpoint and the ``serve run``
lifecycle flags, against the JAX package's.

- ``split_bucket`` and ``CanaryPolicy.parse`` equal the JAX router's.
- One record stream (latencies and non-finite flags drawn with numpy
  from a seed) fed to the JAX ``CanaryRouter`` and to the port's, over
  stub batchers, gives the same ``canary``, ``promote`` and ``rollback``
  events: the gate is pure host code, so the decisions are equal, not
  close.
- ``swap`` and ``shadow`` on LeNet and BertTiny: logits bit for bit a
  fresh engine's on the new artifact (the same CPU kernels on the same
  weights), ``retraces() == 0`` across both engines.
- The admin endpoint answers as the JAX server does (status codes, error
  texts, the router's state on ``/stats``).
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pytorch_distributed_nn_tpu.observability import core as jax_core
from pytorch_distributed_nn_tpu.serving import router as jax_router
from pytorch_distributed_nn_tpu.serving.batcher import Batcher as JaxBatcher
from pytorch_distributed_nn_tpu.serving.engine import (
    InferenceEngine as JaxEngine,
)
from pytorch_distributed_nn_tpu.serving.server import (
    ServingServer as JaxServer,
)
from pytorch_distributed_nn_tpu_torch import cli
from pytorch_distributed_nn_tpu_torch.observability import core, reader
from pytorch_distributed_nn_tpu_torch.serving import loadgen, router
from pytorch_distributed_nn_tpu_torch.serving.artifact import export_artifact
from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
from pytorch_distributed_nn_tpu_torch.serving.engine import InferenceEngine
from pytorch_distributed_nn_tpu_torch.serving.router import (
    CanaryPolicy,
    CanaryRouter,
)
from pytorch_distributed_nn_tpu_torch.serving.server import ServingServer

import torch_cpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (1, 2, 4)
LOGITS_TOL = 1e-4  # tests/test_torch_cnn.py


def _checkpoint_artifact(root, network, step, seed, **model_kw):
    """A random-init port checkpoint of ``network`` at ``step`` in
    ``<root>/train_dir``, exported to ``<root>/art<step>``; its version is
    ``train_dir@<step>:none``."""
    import torch

    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        create_train_state,
    )

    text = network.startswith("Bert")
    model = build_model(network, 0 if text else 10, **model_kw)
    model.init_weights(torch.Generator().manual_seed(seed))
    state = create_train_state(
        model, lambda p: build_optimizer("sgd", p, 0.1), "cpu", seed=seed)
    state.step = step
    td = os.path.join(root, "train_dir")
    ckpt.save_checkpoint(td, state, step=step)
    out = os.path.join(root, f"art{step}")
    export_artifact(td, out, step=step, network=network,
                    num_classes=0 if text else 10, model_kw=model_kw)
    return out


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """LeNet at steps 1, 2 and a NaN-poisoned 9; BertTiny at 1 and 2;
    ResNet20 at 1 (another architecture)."""
    root = tmp_path_factory.mktemp("torch_router")
    out = {}
    for step, seed in ((1, 0), (2, 1)):
        out[f"lenet{step}"] = _checkpoint_artifact(
            str(root / "lenet"), "LeNet", step, seed)
        out[f"bert{step}"] = _checkpoint_artifact(
            str(root / "bert"), "BertTiny", step, seed, dtype="float32")
    out["nan"] = loadgen.make_tiny_artifact(str(root / "nan"), seed=3,
                                            step=9, poison_nan=True)
    out["resnet"] = _checkpoint_artifact(str(root / "resnet"), "ResNet20",
                                         1, 0)
    return out


def _engine(art, **kw):
    e = InferenceEngine(art, batch_buckets=BUCKETS, device="cpu", **kw)
    e.warmup()
    return e


# -- pure routing code ---------------------------------------------------


def test_split_bucket_equals_jax_over_ten_thousand_ids():
    rng = np.random.RandomState(0)
    ids = [f"req-{i}" for i in range(5000)] + [
        "%032x" % rng.randint(0, 2 ** 62) for _ in range(5000)]
    got = [CanaryRouter.split_bucket(i) for i in ids]
    assert got == [jax_router.CanaryRouter.split_bucket(i) for i in ids]
    assert 0.2 < sum(b < 2500 for b in got) / len(got) < 0.3


@pytest.mark.parametrize("spec", [
    None, "", "ramp=5:25:50,stage=200,threshold=0.5,window=400,min=50,"
    "nonfinite=0", "ramp=100,stage=1", " ramp=10:20 , min=3 ",
    "nonfinite=0.25,window=2", "ramp=50:25", "ramp=0", "ramp=101",
    "stage=0", "threshold=0", "threshold=-1", "window=1", "min=0",
    "nonfinite=1.5", "bogus=1", "ramp", "stage=abc", "ramp=a:b"])
def test_canary_policy_parse_equals_jax(spec):
    try:
        want = jax_router.CanaryPolicy.parse(spec, slo="lat_p99<5ms@60s")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            CanaryPolicy.parse(spec, slo="lat_p99<5ms@60s")
        assert str(got.value) == str(e)
        return
    got = CanaryPolicy.parse(spec, slo="lat_p99<5ms@60s")
    assert got.__dict__ == want.__dict__


class _StubEngine:
    """A stand-in engine whose version is its artifact path; swap
    installs one, shadow makes another."""

    max_batch = 4

    def __init__(self, artifact):
        self.artifact_dir = artifact
        self.swaps = 0

    @property
    def version(self):
        return self.artifact_dir

    def swap(self, artifact):
        self.artifact_dir = artifact
        self.swaps += 1
        return artifact

    def shadow(self, artifact):
        return _StubEngine(artifact)

    def adopt(self, shadow):
        return self.swap(shadow.artifact_dir)


class _StubBatcher:
    """The stable side's scheduler surface, without a thread."""

    served = dropped = shed = 0
    max_queue = None
    draining = False
    default_timeout_s = 1.0
    batch_window_s = 0.002
    canary_share = 0.5

    def __init__(self, engine):
        self.engine = engine

    def begin_drain(self):
        self.draining = True

    def close(self):
        pass


def _stream(scenario, n=400, seed=0):
    """(version side, record) pairs: stable and canary interleaved, the
    latencies from a seed; ``slow`` and ``slo`` make the canary 3x
    slower, ``nan`` flags some of its rows non-finite."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        side = "canary" if rng.rand() < 0.5 else "stable"
        lat = float(rng.lognormal(np.log(4.0), 0.1))
        # record times 10 ms apart: the SLO engine's windows and its
        # evaluation throttle read them, so both routers see one clock
        rec = {"step": i, "request_id": f"r{i}", "queue_ms": 0.1,
               "infer_ms": round(lat * 0.8, 3), "time": 1.7e9 + i * 0.01}
        if side == "canary" and scenario in ("slow", "slo"):
            lat *= 3.0
        rec["latency_ms"] = round(lat, 3)
        if side == "canary" and scenario == "nan" and rng.rand() < 0.2:
            rec["nonfinite"] = True
        out.append((side, rec))
    return out


def _drive(mod_router, mod_batcher, telemetry, scenario):
    events = []
    telemetry.subscribe(lambda r: events.append(r)
                        if r.get("kind") == "event" else None)
    stable = _StubBatcher(_StubEngine("stable@1:none"))
    # under "slo" only the SLO burn can convict (the latency rows'
    # threshold is out of reach)
    policy = mod_router.CanaryPolicy.parse(
        "ramp=25:50,stage=60,window=80,min=20,threshold="
        + ("5" if scenario == "slo" else "0.5"),
        slo="lat_p99<8ms@60s" if scenario == "slo" else None)
    r = mod_router.CanaryRouter(stable, telemetry=telemetry, policy=policy,
                                decide_every_s=0.0)
    r.start_canary("canary@2:none")
    for side, rec in _stream(scenario):
        version = r.engine.version if side == "stable" or (
            r.state()["canary"] is None) else "canary@2:none"
        telemetry.log_step({**rec, "version": version})
    state = r.state()
    r.close()
    keep = ("type", "phase", "version", "stable", "fraction",
            "from_version", "reasons", "stage", "source", "stages",
            "canary_served")
    return ([{k: e[k] for k in keep if k in e} for e in events],
            {k: state[k] for k in ("promotes", "rollbacks", "swaps")},
            state["stable"]["version"])


@pytest.mark.parametrize("scenario", ["healthy", "slow", "nan", "slo"])
def test_router_events_equal_jax_on_one_stream(scenario):
    got = _drive(router, Batcher, core.Telemetry(), scenario)
    want = _drive(jax_router, JaxBatcher, jax_core.Telemetry(), scenario)
    assert got == want
    events, counters, stable = got
    kinds = [e["type"] for e in events]
    if scenario == "healthy":
        assert kinds == ["canary", "canary", "promote"]
        assert counters == {"promotes": 1, "rollbacks": 0, "swaps": 1}
        assert stable == "canary@2:none"
    else:
        assert kinds == ["canary", "rollback"]
        assert counters == {"promotes": 0, "rollbacks": 1, "swaps": 0}


# -- engines: swap and shadow ----------------------------------------------


def _rows(engine, n, seed):
    return loadgen.sample_inputs(engine, n, seed=seed)


@pytest.mark.parametrize("net", ["lenet", "bert"])
def test_swap_and_shadow_equal_a_fresh_engine(arts, net):
    kw = {"seq_buckets": (8, 32, 128)} if net == "bert" else {}
    stable = _engine(arts[f"{net}1"], **kw)
    fresh = _engine(arts[f"{net}2"], **kw)
    xs = _rows(stable, 4, seed=5)
    want, want_stats = fresh.infer(xs)
    shadow = stable.shadow(arts[f"{net}2"])
    got, stats = shadow.infer(xs)
    assert stats["version"] == fresh.version != stable.version
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    before, _ = stable.infer(xs)  # the stable side is untouched
    assert not all(np.array_equal(a, b) for a, b in zip(before, want))
    assert stable.swap(arts[f"{net}2"]) == fresh.version
    got, stats = stable.infer(xs)
    assert stats["version"] == fresh.version and stable.swaps == 1
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    # one warm set: the shadow ran no shape warmup did not
    assert stable.retraces() == shadow.retraces() == 0
    shadow._warm.shapes.discard((4, *shadow._bucket_shapes()[-1][1:]))
    try:
        shadow.infer(xs)
        assert stable.retraces() == shadow.retraces() == 1
    finally:
        shadow._warm.shapes.add((4, *shadow._bucket_shapes()[-1][1:]))
        shadow._warm.cold = 0


def test_check_swappable_refusals_equal_jax(arts):
    lenet = _engine(arts["lenet1"])
    jax_lenet = JaxEngine(arts["lenet1"], batch_buckets=(1,))
    for other in ("resnet", "bert1"):
        with pytest.raises(ValueError) as got:
            lenet.swap(arts[other])
        with pytest.raises(ValueError) as want:
            jax_lenet.swap(arts[other])
        assert str(got.value) == str(want.value)
        assert "hot swap replaces WEIGHTS" in str(got.value)
        with pytest.raises(ValueError, match="refusing swap"):
            lenet.shadow(arts[other])
    assert lenet.swaps == 0 and lenet.version == "train_dir@1:none"


# -- the router over real engines ------------------------------------------


def test_nan_canary_rolled_back_exactly_once(arts, tmp_path):
    from pytorch_distributed_nn_tpu_torch.serving.registry import Registry

    engine = _engine(arts["lenet1"])
    reg = Registry(str(tmp_path / "reg"))
    reg.publish(arts["lenet1"], labels=("stable",))
    reg.publish(arts["nan"], labels=("canary",))
    serve_dir = str(tmp_path / "serve")
    os.makedirs(serve_dir)
    tel = loadgen.serving_telemetry(serve_dir, engine)
    batcher = Batcher(engine, telemetry=tel)
    r = CanaryRouter(batcher, telemetry=tel, registry=reg,
                     policy=CanaryPolicy(ramp=(50.0,), stage_requests=500,
                                         window=60, min_samples=10),
                     decide_every_s=0.01)
    xs = _rows(engine, 32, seed=0)
    try:
        r.start_canary(arts["nan"])
        deadline = time.monotonic() + 20.0
        while r.rollbacks == 0 and time.monotonic() < deadline:
            loadgen.run_load(r, xs, 400.0, 0.15, timeout_s=10.0)
        assert r.rollbacks == 1
        assert any("non-finite" in s for s in r.last_rollback["reasons"])
        loadgen.run_load(r, xs, 400.0, 0.2, timeout_s=10.0)
        r.rollback("again")  # no canary in flight: a no-op
        assert r.rollbacks == 1
        # labels restored in one write: canary cleared, stable kept
        assert reg.labels() == {"stable": "train_dir@1:none"}
        assert engine.retraces() == 0
    finally:
        r.close()
        batcher.close()
        tel.close()
    rs = reader.read_stream(serve_dir)
    assert [e["type"] for e in rs.events
            if e.get("type") in ("canary", "rollback")] == [
        "canary", "rollback"]
    assert any(s.get("nonfinite") for s in rs.steps)


def test_watcher_never_swaps_back_across_a_promote(arts, tmp_path):
    """A promote that lands between the watcher's reads of the router's
    state and of the labels: the port reads the state first and moves the
    labels under the router's lock, so the poll sees a canary in flight
    and does nothing (read the other way round, the stale ``stable``
    label looked like a swap back to the old version)."""
    from pytorch_distributed_nn_tpu_torch.serving.registry import Registry
    from pytorch_distributed_nn_tpu_torch.serving.router import (
        RegistryWatcher,
    )

    engine = _engine(arts["lenet1"])
    reg = Registry(str(tmp_path / "reg"))
    reg.publish(arts["lenet1"], labels=("stable",))
    reg.publish(arts["lenet2"], labels=("canary",))
    tel = core.Telemetry()
    batcher = Batcher(engine, telemetry=tel)
    r = CanaryRouter(batcher, telemetry=tel, registry=reg)
    w = RegistryWatcher(reg, r, poll_s=60.0)
    labels = reg.labels

    def racing():  # the labels as they stood just before the promote
        before = labels()
        r._promote()
        return before

    try:
        assert w.poll_once() == "canary train_dir@2:none"
        reg.labels = racing
        assert w.poll_once() is None
        reg.labels = labels
        assert w.poll_once() is None
        assert engine.version == "train_dir@2:none" and engine.swaps == 1
        assert reg.labels() == {"stable": "train_dir@2:none"}
    finally:
        r.close()
        batcher.close()


# -- HTTP: the admin endpoint ----------------------------------------------


def _post(url, doc, headers=None, timeout=30.0):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30.0) as resp:
        return json.loads(resp.read())


class _Rig:
    """engine + batcher + router + server of one package over ``art``."""

    def __init__(self, pkg, art, serve_dir, token="t"):
        os.makedirs(serve_dir)
        if pkg == "port":
            self.engine = _engine(art)
            Tel, B, R, S = (core.Telemetry, Batcher, CanaryRouter,
                            ServingServer)
        else:
            self.engine = JaxEngine(art, batch_buckets=(1, 2))
            self.engine.warmup()
            Tel, B, R, S = (jax_core.Telemetry, JaxBatcher,
                            jax_router.CanaryRouter, JaxServer)
        self.tel = Tel.for_run(os.path.join(serve_dir, "serving.jsonl"),
                               {"kind": "manifest", "schema": 2})
        self.batcher = B(self.engine, telemetry=self.tel)
        self.router = R(self.batcher, telemetry=self.tel)
        self.server = S(self.engine, self.router, port=0,
                        router=self.router, admin_token=token)
        self.server.start()
        self.base = f"http://{self.server.host}:{self.server.port}"

    def close(self):
        self.server.close()
        self.router.close()
        self.batcher.close()
        self.tel.close()


def _admin_sequence(rig, arts, tmp_path):
    url = f"{rig.base}/v1/admin/swap"
    out = [
        _post(url, {"artifact": arts["lenet2"]}),
        _post(url, {"artifact": arts["lenet2"]},
              headers={"X-Admin-Token": "wrong"}),
        _post(url, {}, headers={"X-Admin-Token": "t"}),
        _post(url, {"rollback": True}, headers={"X-Admin-Token": "t"}),
        _post(url, {"artifact": arts["lenet2"]},
              headers={"X-Admin-Token": "t"}),
        _post(url, {"artifact": arts["lenet2"], "canary": True},
              headers={"X-Admin-Token": "t"}),
    ]
    code, _ = _post(url, {"artifact": str(tmp_path / "nope")},
                    headers={"X-Admin-Token": "t"})
    out.append((code, None))
    stats = _get(f"{rig.base}/stats")
    return out, stats["router"]


def test_admin_swap_and_stats_equal_jax(arts, tmp_path):
    rigs = {pkg: _Rig(pkg, arts["lenet1"], str(tmp_path / pkg))
            for pkg in ("port", "jax")}
    try:
        got = _admin_sequence(rigs["port"], arts, tmp_path)
        want = _admin_sequence(rigs["jax"], arts, tmp_path)
    finally:
        for rig in rigs.values():
            rig.close()
    assert got == want
    codes = [c for c, _ in got[0]]
    assert codes == [403, 403, 400, 200, 200, 400, 400]
    assert got[0][4][1] == {"status": "swapped",
                            "version": "train_dir@2:none"}
    assert got[1]["swaps"] == 1 and got[1]["canary"] is None
    assert got[1]["traffic_split"] == {"stable": 1.0, "canary": 0.0}


def test_swap_under_load_atomicity(arts, tmp_path):
    """Four clients hammer /v1/infer while the stable side swaps 20
    times: every response's version was live during its request, every
    response's logits are that version's (within LOGITS_TOL: a coalesced
    batch's CPU convolution rounds differently from one row's), no 5xx,
    no retrace."""
    rig = _Rig("port", arts["lenet1"], str(tmp_path / "serve"))
    engine = rig.engine
    xs = _rows(engine, 1, seed=0)
    row = xs[0].tolist()
    logits = {}
    for art in (arts["lenet1"], arts["lenet2"]):
        ref = _engine(art)
        logits[ref.version] = ref.infer(xs)[0][0]
    swap_log = [(0.0, 0.0, engine.version)]
    results, failures = [], []
    lock, stop = threading.Lock(), threading.Event()

    def hammer():
        while not stop.is_set():
            t_admit = time.time()
            try:
                code, body = _post(f"{rig.base}/v1/infer",
                                   {"inputs": [row], "timeout_s": 10.0})
            except Exception as e:  # pragma: no cover - fail loudly
                failures.append(repr(e))
                return
            with lock:
                results.append((t_admit, time.time(), code,
                                body.get("versions", [None])[0],
                                body.get("outputs", [None])[0]))

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for i in range(20):
            time.sleep(0.02)
            t_before = time.time()
            v = rig.router.swap(arts["lenet2"] if i % 2 == 0
                                else arts["lenet1"])
            swap_log.append((t_before, time.time(), v))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        rig.close()
    assert not failures, failures
    assert engine.swaps == 20 and engine.retraces() == 0
    assert len(results) > 20
    for t_admit, t_done, code, version, out in results:
        assert code == 200
        live = {v for i, (t_early, _, v) in enumerate(swap_log)
                if t_early <= t_done and (i + 1 >= len(swap_log)
                                          or swap_log[i + 1][1] >= t_admit)}
        assert version in live, (version, live)
        # the row's logits are its version's (batch-size rounding of the
        # CPU convolutions aside: LOGITS_TOL), never the other weights'
        out = np.asarray(out, np.float32)
        for v, want in logits.items():
            err = float(np.max(np.abs(out - want)))
            assert err <= LOGITS_TOL if v == version else err > 1e-2


def test_generative_direct_swap_over_admin(tmp_path):
    from pytorch_distributed_nn_tpu_torch.serving.generate import (
        GenerateScheduler,
        GenerativeEngine,
    )

    a1 = loadgen.make_tiny_decoder_artifact(str(tmp_path / "g1"), step=1)
    a2 = loadgen.make_tiny_decoder_artifact(str(tmp_path / "g2"), seed=1,
                                            step=2)
    kw = dict(batch_buckets=(1, 2), seq_buckets=(32,), pool_slots=4,
              device="cpu")
    engine = GenerativeEngine(a1, **kw)
    engine.warmup()
    ref = GenerativeEngine(a2, **kw)
    ref.warmup()
    tel = core.Telemetry()
    sched = GenerateScheduler(engine, telemetry=tel)
    ref_sched = GenerateScheduler(ref, telemetry=core.Telemetry())
    server = ServingServer(engine, None, port=0, generator=sched,
                           admin_token="t")
    server.start()
    base = f"http://{server.host}:{server.port}"
    prompts = loadgen.sample_prompts(engine, 6, reserve=10)
    try:
        results = []
        burst = [threading.Thread(target=lambda p=p: results.append(_post(
            f"{base}/v1/generate",
            {"inputs": [p.tolist()], "max_new_tokens": 8})))
            for p in prompts]
        for t in burst:
            t.start()
        time.sleep(0.05)
        code, body = _post(f"{base}/v1/admin/swap", {"artifact": a2},
                           headers={"X-Admin-Token": "t"})
        assert (code, body) == (200, {"status": "swapped",
                                      "version": "train_dir@2:none"})
        for t in burst:
            t.join(timeout=60.0)
        assert [c for c, _ in results] == [200] * 6
        assert engine.fence_violations == 0 and engine.swaps == 1
        # after the swap a request's tokens are the new artifact's
        code, body = _post(f"{base}/v1/generate",
                           {"inputs": [prompts[0].tolist()],
                            "max_new_tokens": 8})
        want = ref_sched.submit(prompts[0], max_new_tokens=8,
                                timeout_s=30.0).wait(timeout=60.0)
        assert code == 200 and body["outputs"][0] == [int(t) for t in want]
        assert body["versions"] == ["train_dir@2:none"]
        for doc in ({"artifact": a2, "canary": True}, {"rollback": True}):
            code, body = _post(f"{base}/v1/admin/swap", doc,
                               headers={"X-Admin-Token": "t"})
            assert code == 400 and "hot-swap only" in body["error"]
        assert engine.retraces() == 0
    finally:
        server.close()
        sched.close()
        ref_sched.close()


# -- the serve run lifecycle flags -----------------------------------------


def test_cli_serve_run_refusals(arts, tmp_path, capsys):
    gen = loadgen.make_tiny_decoder_artifact(str(tmp_path / "g"))
    for argv, msg in (
            (["--artifact", arts["lenet1"], "--reload-poll", "1"],
             "--reload-poll needs --registry"),
            (["--artifact", arts["lenet1"], "--canary", "ramp=200"],
             "bad canary spec value"),
            (["--artifact", arts["lenet1"], "--slo", "nonsense"], "bad SLO"),
            (["--artifact", gen, "--canary", "ramp=50"],
             "not wired for generative"),
            ([], "--artifact is required without --registry"),
            (["--registry", str(tmp_path / "empty")], "no entry or label")):
        assert cli.main(["serve", "run", "--device", "cpu", *argv]) == 2
        assert msg in capsys.readouterr().err


def test_cli_serve_run_follows_registry_labels(arts, tmp_path):
    """``serve run --registry --reload-poll --canary --slo --admin-token``
    in a subprocess: the canary label ramps a canary to promotion under
    load; /stats reports the router and the SLO status, no retrace."""
    from pytorch_distributed_nn_tpu_torch.serving.registry import Registry

    reg = Registry(str(tmp_path / "reg"))
    reg.publish(arts["lenet1"], labels=("stable",))
    reg.publish(arts["lenet2"])
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "serve",
         "run", "--registry", str(tmp_path / "reg"), "--reload-poll", "0.1",
         "--canary", "ramp=50,stage=20,window=40,min=10,threshold=5",
         "--slo", "lat_p99<2000ms@60s", "--admin-token", "t",
         "--device", "cpu", "--buckets", "1,2,4", "--port", "0",
         "--port-file", str(port_file),
         "--serve-dir", str(tmp_path / "serve")],
        cwd=REPO, env=torch_cpu.SUBPROCESS_ENV, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists():
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        port = int(port_file.read_text())
        base = f"http://127.0.0.1:{port}"
        reg.label("canary", "train_dir@2:none")
        rows = [x.tolist() for x in _rows(_engine(arts["lenet1"]), 8, 0)]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            r = loadgen.run_http_load("127.0.0.1", port, rows, 200.0, 0.2,
                                      workers=4)
            assert r["failed"] == 0, r
            st = _get(f"{base}/stats")
            if st["router"]["promotes"]:
                break
        assert st["router"]["promotes"] == 1, st["router"]
        assert st["router"]["stable"]["version"] == "train_dir@2:none"
        assert st["retraces"] == 0
        assert st["slo"][0]["slo"] == "lat_p99<2000ms@60s"
        assert reg.labels() == {"stable": "train_dir@2:none"}
        code, body = _post(f"{base}/v1/admin/swap",
                           {"artifact": "train_dir@1:none"},
                           headers={"X-Admin-Token": "t"})
        assert (code, body["version"]) == (200, "train_dir@1:none")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stderr.close()
    assert proc.returncode == 0
    rs = reader.read_stream(str(tmp_path / "serve"))
    kinds = [e["type"] for e in rs.events
             if e["type"] in ("canary", "promote", "swap")]
    assert kinds == ["canary", "promote", "swap"]
