"""The port's replicated frontend (pytorch_distributed_nn_tpu_torch/serving/
frontend.py) and HTTP load functions on the CPU.

- ``CircuitBreaker``: one call sequence gives the JAX breaker's states
  and edges.
- The frontend over stub replica servers: retry on the other replica,
  one ``breaker_open`` and one ``breaker_close`` after the half-open
  probe, hedged requests deduplicated, lease down and rejoin, 429 with
  ``Retry-After`` past ``max_inflight``, the canary share, an unknown
  traffic class answered 400.
- Two spawned ``serve run --device cpu`` replicas: one SIGKILLed under
  load and respawned, the other drained, and no client sees a failure.
- Importing the frontend and ``serve frontend --help`` import no torch.
- ``run_http_load`` and ``generate_sweep`` against the port's server.

Every assertion is a count, an edge or an equality, never a latency
percentile; every spawned process has a deadline and is killed in a
``finally``.
"""

import http.client
import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from pytorch_distributed_nn_tpu.serving import frontend as jax_frontend
from pytorch_distributed_nn_tpu_torch.observability import core, reader
from pytorch_distributed_nn_tpu_torch.serving import loadgen
from pytorch_distributed_nn_tpu_torch.serving.frontend import (
    CircuitBreaker,
    Frontend,
    FrontendShed,
    frontend_telemetry,
)

import torch_cpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _breaker_trace(cls):
    """One call sequence through a breaker: every return value and
    state, in order."""
    out = []
    br = cls(threshold=2, cooldown_s=0.3)

    def note(name, value):
        out.append((name, value, br.state, br.opens))

    note("failure", br.record_failure())
    note("success", br.record_success())
    note("failure", br.record_failure())
    note("failure", br.record_failure())  # the open edge
    note("allow", br.allow())  # cooling down
    note("stale success", br.record_success())  # ignored while open
    note("failure", br.record_failure())  # same outage
    time.sleep(0.35)
    note("allow", br.allow())  # the half-open probe slot
    note("allow", br.allow())  # one probe at a time
    note("release", br.release_probe())
    note("allow", br.allow())
    note("failure", br.record_failure())  # probe failed: reopen, no edge
    time.sleep(0.35)
    note("allow", br.allow())
    note("success", br.record_success())  # the close edge
    note("force_open", br.force_open())
    note("force_open", br.force_open())
    note("reset", br.reset())
    note("reset", br.reset())
    snap = br.snapshot()
    out.append(("snapshot", sorted(snap)))
    return out


def test_circuit_breaker_edges_equal_jax():
    assert _breaker_trace(CircuitBreaker) == _breaker_trace(
        jax_frontend.CircuitBreaker)


class _StubReplica:
    """A controllable replica server: ``ok`` answers 200, ``fail`` 500,
    ``slow`` sleeps first, ``reset`` drops the connection, ``draining``
    refuses as a SIGTERMed replica does (readiness too)."""

    def __init__(self, version="v1"):
        self.mode = "ok"
        self.slow_s = 0.5
        self.served = 0
        self.on_post = None  # called as each request arrives
        outer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if outer.mode == "draining":
                    self._reply(503, {"status": "draining",
                                      "draining": True})
                else:
                    self._reply(200, {"status": "ready"})

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                outer.served += 1
                if outer.on_post is not None:
                    outer.on_post()
                mode = outer.mode
                if mode == "reset":
                    self.close_connection = True
                    self.connection.close()
                    return
                if mode == "fail":
                    self._reply(500, {"error": "stub failure"})
                    return
                if mode == "draining":
                    self._reply(503, {"error": "draining",
                                      "draining": True})
                    return
                if mode == "slow":
                    time.sleep(outer.slow_s)
                self._reply(200, {
                    "outputs": [[0.0]], "versions": [version],
                    "klass": self.headers.get("X-Traffic-Class"),
                    "request_ids": [self.headers.get("X-Request-Id")]})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def stub_pool(tmp_path):
    stubs = [_StubReplica(version=f"v{i}") for i in range(2)]
    tel = frontend_telemetry(str(tmp_path / "serve"))
    fe = Frontend(str(tmp_path / "fe"), telemetry=tel, timeout_s=2.0,
                  max_inflight=64, retries=2, poll_s=0.05, lease_s=0.5,
                  breaker_threshold=2, breaker_cooldown_s=0.2,
                  hedge_ms=5000.0)
    for i, s in enumerate(stubs):
        fe.attach_replica(f"r{i}", "127.0.0.1", s.port)
    fe.start()
    fe.wait_ready(timeout=10.0)
    try:
        yield fe, stubs, tel, str(tmp_path / "serve")
    finally:
        fe.close(stop_replicas=False)
        tel.close()
        for s in stubs:
            s.close()


def _events(tel, serve_dir):
    tel.flush()
    out = {}
    for e in reader.read_stream(serve_dir).events:
        out.setdefault(e.get("type", "?"), []).append(e)
    return out


def test_retry_breaker_and_probe(stub_pool):
    fe, stubs, tel, serve_dir = stub_pool
    stubs[0].mode = "reset"
    for _ in range(6):
        status, payload = fe.forward({"inputs": [[1.0]]})
        assert status == 200 and payload["replica"] == "r1"
    assert fe.retried > 0
    r0 = fe._find("r0")
    assert r0.breaker.state == CircuitBreaker.OPEN
    stubs[0].mode = "ok"
    time.sleep(0.3)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline \
            and r0.breaker.state != CircuitBreaker.CLOSED:
        fe.forward({"inputs": [[1.0]]})
        time.sleep(0.02)
    assert r0.breaker.state == CircuitBreaker.CLOSED
    ev = _events(tel, serve_dir)
    assert [e["replica"] for e in ev["breaker_open"]] == ["r0"]
    assert [e["replica"] for e in ev["breaker_close"]] == ["r0"]
    assert fe.failed == 0


def test_hedge_first_response_wins_once(stub_pool):
    fe, stubs, tel, serve_dir = stub_pool
    fe.hedge_ms = 30.0
    stubs[0].mode = "slow"
    stubs[0].slow_s = 0.4
    for i in range(20):
        status, payload = fe.forward({"inputs": [[1.0]]},
                                     request_id=f"h-{i}")
        assert status == 200 and payload["request_ids"] == [f"h-{i}"]
        if fe.hedges:
            break
    assert fe.hedges >= 1 and fe.hedge_wins >= 1
    ev = _events(tel, serve_dir)
    assert len(ev["hedge"]) == fe.hedges
    # one record per request: the losing attempt is discarded
    steps = reader.read_stream(serve_dir).steps
    ids = [s["request_id"] for s in steps]
    assert len(ids) == len(set(ids)) == fe.forwarded


def test_lease_down_and_rejoin(stub_pool):
    fe, stubs, tel, serve_dir = stub_pool
    stubs[0].mode = "draining"  # /readyz 503 past the lease
    deadline = time.monotonic() + 10.0
    while fe.state()["ready"] != 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    status, payload = fe.forward({"inputs": [[1.0]]})
    assert status == 200 and payload["replica"] == "r1"
    stubs[0].mode = "ok"
    while fe.state()["ready"] != 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert fe.state()["ready"] == 2
    ev = _events(tel, serve_dir)
    assert [e["replica"] for e in ev["replica_down"]] == ["r0"]
    rejoins = [e for e in ev["replica_up"] if e.get("rejoin")]
    assert [e["replica"] for e in rejoins] == ["r0"]


class _SlowExit:
    """A replica process that answers SIGTERM as ``serve run`` does, but
    slowly: its stub refuses as draining at once and the process exits 0
    ``after_s`` later."""

    def __init__(self, stub, after_s):
        self.stub, self.after_s = stub, after_s
        self.returncode, self._term = None, None

    def send_signal(self, sig):
        self.stub.mode = "draining"
        self._term = time.monotonic()

    def poll(self):
        if self._term is not None \
                and time.monotonic() - self._term >= self.after_s:
            self.returncode = 0
        return self.returncode


def test_a_drain_outlasting_the_lease_is_no_outage(stub_pool):
    fe, stubs, tel, serve_dir = stub_pool
    r0 = fe._find("r0")
    r0.proc = _SlowExit(stubs[0], after_s=4 * fe.lease_s)
    assert fe.drain_replica("r0", timeout=10.0) is True
    status, payload = fe.forward({"inputs": [[1.0]]})
    assert status == 200 and payload["replica"] == "r1"
    ev = _events(tel, serve_dir)
    assert [e["phase"] for e in ev["drain"]] == ["start", "done"]
    assert "replica_down" not in ev and "breaker_open" not in ev
    assert r0.failures == 0 and fe.failed == 0


@pytest.mark.parametrize("move", ["draining", "respawned"])
def test_an_attempt_whose_replica_moved_under_it_reroutes(stub_pool, move):
    fe, stubs, tel, serve_dir = stub_pool
    r0 = fe._find("r0")

    def moved():
        # what drain_replica or restart_replica does between the pick and
        # the attempt's error: the replica then drops the connection
        if move == "draining":
            r0.draining = True
        else:
            r0.proc = _SlowExit(stubs[0], after_s=60.0)
        stubs[0].on_post = None

    stubs[0].mode = "reset"
    stubs[0].on_post = moved
    penalties = []
    record = r0.breaker.record_failure
    r0.breaker.record_failure = lambda: penalties.append(1) or record()
    for i in range(20):
        status, payload = fe.forward({"inputs": [[1.0]]})
        assert status == 200 and payload["replica"] == "r1"
        if stubs[0].served:
            break
    assert stubs[0].served == 1
    assert penalties == [] and r0.failures == 0 and fe.failed == 0
    assert "breaker_open" not in _events(tel, serve_dir)


def test_admission_shed_canary_share_and_class(stub_pool):
    fe, stubs, tel, serve_dir = stub_pool
    fe.max_inflight = 4
    fe.canary_share = 0.5  # canary cap 2
    fe._admit("canary")
    fe._admit("canary")
    with pytest.raises(FrontendShed):
        fe._admit("canary")
    fe._admit("stable")
    fe._admit("stable")  # the bound is full
    fe._admit("probe")  # probes bypass it
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=10)
    try:
        conn.request("POST", "/v1/infer", json.dumps({"inputs": [[1.0]]}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        doc = json.loads(resp.read())
        assert resp.status == 429 and doc["retry_after_s"] > 0
        assert int(resp.getheader("Retry-After")) >= 1
        conn.request("POST", "/v1/infer", json.dumps({"inputs": [[1.0]]}),
                     {"Content-Type": "application/json",
                      "X-Traffic-Class": "vip"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 400
    finally:
        conn.close()
    assert fe.shed == 2
    ev = _events(tel, serve_dir)
    # shed events are rate-limited (one a second, each with its count)
    assert [(e["klass"], e["layer"], e["count"])
            for e in ev["request_shed"]] == [("canary", "frontend", 1)]


def test_spawned_cpu_replicas_survive_kill_and_drain(tmp_path):
    """Two ``serve run --device cpu`` replicas behind the frontend: one
    SIGKILLed under 8 clients (no client-visible failure) and respawned,
    the other drained."""
    artifact = loadgen.make_tiny_artifact(str(tmp_path))
    tel = frontend_telemetry(str(tmp_path / "serve"))
    fe = Frontend(str(tmp_path / "fe"), telemetry=tel, timeout_s=10.0,
                  poll_s=0.1, lease_s=2.0, breaker_cooldown_s=1.0,
                  device="cpu")
    try:
        for i in range(2):
            r = fe.spawn_replica(f"r{i}", artifact,
                                 serve_args=["--buckets", "1,2,4"],
                                 env={"OMP_NUM_THREADS": "1"})
            assert r.spawn_cmd[-4:-2] == ["--device", "cpu"]
        fe.start()
        fe.wait_ready(timeout=120.0)
        rows = [x.tolist() for x in loadgen.sample_inputs(
            _Engine28(), 4)]
        holder = {}

        def _load():
            holder["res"] = loadgen.run_http_load(
                fe.host, fe.port, rows, offered_rps=40.0, duration_s=3.0,
                timeout_s=10.0, workers=8)

        t = threading.Thread(target=_load)
        t.start()
        time.sleep(1.0)
        fe.kill_replica("r0")
        t.join(timeout=60.0)
        assert not t.is_alive()
        res = holder["res"]
        assert res["failed"] == 0 and res["ok"] == res["submitted"], res
        fe.restart_replica("r0")
        assert fe.state()["ready"] == 2
        assert fe.drain_replica("r1") is True  # SIGTERM: exits 0
    finally:
        fe.close()
        tel.close()
    ev = _events(tel, str(tmp_path / "serve"))
    assert [e["replica"] for e in ev["replica_down"]][:1] == ["r0"]
    assert "r0" in [e["replica"] for e in ev["breaker_open"]]
    assert any(e["replica"] == "r0" and e.get("rejoin")
               for e in ev["replica_up"])


class _Engine28:
    """What ``sample_inputs`` reads of a LeNet engine."""

    kind = "image"
    input_spec = (28, 28, 1)


def test_frontend_imports_no_torch():
    code = ("import sys\n"
            "import pytorch_distributed_nn_tpu_torch.serving.frontend\n"
            "from pytorch_distributed_nn_tpu_torch import cli\n"
            "try:\n"
            "    cli.main(['serve', 'frontend', '--help'])\n"
            "except SystemExit:\n"
            "    pass\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "print('no torch')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=torch_cpu.SUBPROCESS_ENV, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("no torch")
    assert "--replicas" in out.stdout


def test_http_load_and_generate_sweep_against_the_port(tmp_path):
    from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )
    from pytorch_distributed_nn_tpu_torch.serving.server import (
        ServingServer,
    )

    art = loadgen.make_tiny_artifact(str(tmp_path / "lenet"))
    engine = InferenceEngine(art, batch_buckets=(1, 2, 4), device="cpu")
    engine.warmup()
    batcher = Batcher(engine, telemetry=core.Telemetry(), max_queue=2)
    server = ServingServer(engine, batcher, port=0)
    server.start()
    rows = [x.tolist() for x in loadgen.sample_inputs(engine, 4)]
    try:
        r = loadgen.run_http_load(server.host, server.port, rows, 50.0,
                                  0.5, timeout_s=5.0, workers=4)
        assert r["submitted"] == 25 and r["failed"] == 0
        assert r["ok"] + r["shed"] == 25 and r["ok"] > 0
        assert set(r["statuses"]) <= {"200", "429"}
        r = loadgen.run_http_load(server.host, server.port, rows, 50.0,
                                  0.2, klass="vip", workers=2)
        assert r["statuses"] == {"400": 10}
    finally:
        server.close()
        batcher.close()
    gen = loadgen.make_tiny_decoder_artifact(str(tmp_path / "gen"))
    rec = loadgen.generate_sweep(gen, offered=(20.0,), duration_s=0.3,
                                 max_new_tokens=4, batch_buckets=(1, 2),
                                 seq_buckets=(32,), pool_slots=4,
                                 out_dir=str(tmp_path / "gen_serve"),
                                 device="cpu", log=lambda m: None)
    sweep = rec["sweep"][0]
    assert rec["retraces_after_warmup"] == 0
    assert rec["fence_violations"] == 0 and rec["device"] == "cpu"
    assert sweep["submitted"] == 6 and sweep["served"] == 6
    assert sweep["tokens"] == 24 and sweep["dropped"] == 0
    steps = reader.read_stream(str(tmp_path / "gen_serve")).steps
    assert sum(s["new_tokens"] for s in steps) == 24
