"""The port's single-pass serving path (pytorch_distributed_nn_tpu_torch/
serving: engine, batcher, server, loadgen, the ``serve`` CLI) against
the JAX package's, on the CPU.

Artifacts are exported once per module from random-init checkpoints
(LeNet f32 and int8, ResNet-20, BertTiny in f32 with seq buckets up to
128), and both packages' ``InferenceEngine`` serve the same directory.
Tolerances: CNN logits at ``LOGITS_TOL`` (1e-4, ``test_torch_cnn.py``)
with top-1 equal; BertTiny logits at 1e-5 (``test_torch_model.py``'s
f32 atol); int8 artifacts dequantize bit for bit
(``test_torch_artifact.py``), so they take the f32 tolerance too.

Output dtype: the port's engine returns float32 arrays. The JAX engine
returns float32 as well for every network of the zoo (each model casts
its logits to f32, bf16 configurations included), so the two compare
as arrays of one dtype; a bf16 head would reach the port's caller as
float32 holding the same values, since numpy has no bf16.
"""

import http.client
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from pytorch_distributed_nn_tpu.observability import reader as jax_reader
from pytorch_distributed_nn_tpu.serving.batcher import Batcher as JaxBatcher
from pytorch_distributed_nn_tpu.serving.engine import (
    InferenceEngine as JaxEngine,
)
from pytorch_distributed_nn_tpu.serving.server import (
    ServingServer as JaxServer,
)
from pytorch_distributed_nn_tpu_torch.observability import core as obs
from pytorch_distributed_nn_tpu_torch.observability import tracing
from pytorch_distributed_nn_tpu_torch.serving import artifact, loadgen
from pytorch_distributed_nn_tpu_torch.serving.batcher import (
    TRAFFIC_CLASSES,
    Batcher,
    DeadlineExceeded,
    QueueShed,
)
from pytorch_distributed_nn_tpu_torch.serving.engine import (
    DEFAULT_BATCH_BUCKETS,
    InferenceEngine,
    length_buckets,
)
from pytorch_distributed_nn_tpu_torch.serving.server import ServingServer

import torch_cpu  # one intra-op thread here and in subprocesses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_TOL = 1e-4  # tests/test_torch_cnn.py
TOKENS_TOL = 1e-5  # tests/test_torch_model.py, f32
IMAGE_BUCKETS = (1, 2, 4)
SEQ_BUCKETS = (8, 32, 128)


def _port_checkpoint(train_dir, network, seed=0, **model_kw):
    """A random-init port TrainState of ``network`` in ``train_dir``."""
    import torch

    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        create_train_state,
    )

    model = build_model(network, 0 if network == "BertTiny" else 10,
                        **model_kw)
    model.init_weights(torch.Generator().manual_seed(seed))
    state = create_train_state(
        model, lambda p: build_optimizer("sgd", p, 0.1), "cpu", seed=seed)
    state.step = 1
    ckpt.save_checkpoint(str(train_dir), state, step=1)
    return str(train_dir)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """name -> artifact dir: LeNet (f32, int8), ResNet-20, BertTiny f32."""
    root = tmp_path_factory.mktemp("torch_serving")
    out = {"LeNet": loadgen.make_tiny_artifact(str(root / "lenet"))}
    out["LeNet-int8"] = str(root / "lenet" / "artifact-int8")
    artifact.export_artifact(str(root / "lenet" / "train_dir"),
                             out["LeNet-int8"], network="LeNet",
                             quantize="int8")
    out["ResNet20"] = str(root / "resnet20_art")
    artifact.export_artifact(_port_checkpoint(root / "resnet20", "ResNet20"),
                             out["ResNet20"], network="ResNet20")
    kw = {"dtype": "float32"}
    out["BertTiny"] = str(root / "bert_art")
    artifact.export_artifact(
        _port_checkpoint(root / "bert", "BertTiny", **kw), out["BertTiny"],
        network="BertTiny", num_classes=0, model_kw=kw)
    return out


def _engine(art, **kw):
    e = InferenceEngine(art, batch_buckets=IMAGE_BUCKETS, device="cpu",
                        **kw)
    e.warmup()
    return e


@pytest.fixture(scope="module")
def engines(arts):
    """Warm port engines, one per artifact (the JAX ones compile on
    demand, one bucket each)."""
    return {name: _engine(a, **({"seq_buckets": SEQ_BUCKETS}
                                if name == "BertTiny" else {}))
            for name, a in arts.items()}


@pytest.fixture(scope="module")
def lenet(engines):
    return engines["LeNet"]


def _inputs(engine, n, seed, length=None):
    rng = np.random.RandomState(seed)
    if engine.kind == "tokens":
        return [rng.randint(1, 1024, size=length or rng.randint(4, 30))
                .astype(np.int32) for _ in range(n)]
    return [rng.rand(*engine.input_spec).astype(np.float32)
            for _ in range(n)]


# -- the engine ------------------------------------------------------------


@pytest.mark.parametrize("name", ["LeNet", "LeNet-int8", "ResNet20",
                                  "BertTiny"])
def test_engine_matches_the_jax_engine(arts, engines, name):
    port = engines[name]
    jax_engine = JaxEngine(arts[name], batch_buckets=IMAGE_BUCKETS,
                           **({"seq_buckets": SEQ_BUCKETS}
                              if name == "BertTiny" else {}))
    xs = _inputs(port, 3, seed=1, length=20)
    got, stats = port.infer(xs)
    want, jstats = jax_engine.infer(xs)
    assert set(stats) == set(jstats)
    for k in ("bucket", "batch", "version", "nonfinite"):
        assert stats[k] == jstats[k], k
    assert stats["bucket"] == 4 and stats["flops"] > 0
    tol = TOKENS_TOL if name == "BertTiny" else LOGITS_TOL
    for g, w in zip(got, want):
        # both float32: the zoo's models all end in f32 (module doc)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        assert np.argmax(g) == np.argmax(w)
    if name == "BertTiny":
        assert got[0].shape == (32, 1024)  # the length bucket of 20


def test_bf16_configurations_are_served_as_float32(arts, tmp_path):
    """The stated output-dtype rule: a bf16 configuration's logits come
    back float32 from both engines."""
    art = str(tmp_path / "a")
    artifact.export_artifact(
        os.path.join(os.path.dirname(arts["LeNet"]), "train_dir"), art,
        network="LeNet", model_kw={"dtype": "bfloat16"})
    port = InferenceEngine(art, batch_buckets=(1,), device="cpu")
    xs = _inputs(port, 1, seed=0)
    got, _ = port.infer(xs)
    want, _ = JaxEngine(art, batch_buckets=(1,)).infer(xs)
    assert got[0].dtype == want[0].dtype == np.float32
    assert port.precision == {"tf32": False, "dtype": "torch.bfloat16"}
    # bf16 convolutions on both sides, summed in other orders
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=0.05)


def test_bucket_and_length_bucket_selection(lenet, engines):
    assert [lenet.select_bucket(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    with pytest.raises(ValueError, match="largest bucket"):
        lenet.select_bucket(5)
    with pytest.raises(ValueError, match="strictly increasing"):
        InferenceEngine(lenet.artifact_dir, batch_buckets=(4, 2),
                        device="cpu")
    assert length_buckets(128) == (1, 2, 4, 8, 16, 32, 64, 128)
    assert length_buckets(48) == (1, 2, 4, 8, 16, 32, 48)
    bert = engines["BertTiny"]
    assert [bert.select_seq_bucket(n) for n in (1, 8, 9, 33, 128)] == \
        [8, 8, 32, 128, 128]
    with pytest.raises(ValueError, match="max_len"):
        bert.select_seq_bucket(129)
    with pytest.raises(ValueError, match="must end at the model max_len"):
        InferenceEngine(bert.artifact_dir, seq_buckets=(8, 32),
                        device="cpu")
    assert DEFAULT_BATCH_BUCKETS == (1, 2, 4, 8, 16, 32)
    assert lenet._bucket_shapes() == [(b, 28, 28, 1) for b in IMAGE_BUCKETS]


@pytest.mark.parametrize("name", ["ResNet20", "BertTiny"])
def test_a_row_alone_equals_the_row_in_a_padded_batch(engines, name):
    engine = engines[name]
    xs = _inputs(engine, 3, seed=2, length=12)
    batch, stats = engine.infer(xs)
    assert stats["bucket"] == 4 and stats["batch"] == 3
    for x, row in zip(xs, batch):
        alone, s1 = engine.infer([x])
        assert s1["bucket"] == 1
        np.testing.assert_allclose(alone[0], row, rtol=0, atol=1e-5)


def test_no_retrace_across_mixed_shapes(engines):
    for name in ("LeNet", "BertTiny"):
        engine = engines[name]
        rng = np.random.RandomState(3)
        for n in (3, 1, 4, 2, 1, 4):
            xs = _inputs(engine, n, seed=int(rng.randint(1 << 30)),
                         length=int(rng.randint(1, 129)))
            outs, stats = engine.infer(xs)
            assert len(outs) == n and stats["nonfinite"] == 0
        assert engine.retraces() == 0
    # a shape warmup did not run counts as a retrace
    engine = engines["LeNet"]
    engine._warm_shapes.discard((4, 28, 28, 1))
    try:
        engine.infer(_inputs(engine, 3, seed=0))
        assert engine.retraces() == 1
    finally:
        engine._warm_shapes.add((4, 28, 28, 1))
        engine._cold_shapes = 0


def test_engine_needs_a_card_unless_asked_for_the_cpu(arts):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(arts["LeNet"])
    for fn in ("swap", "shadow"):
        with pytest.raises(NotImplementedError, match="item 6"):
            getattr(InferenceEngine(arts["LeNet"], batch_buckets=(1,),
                                    device="cpu"), fn)(arts["LeNet"])


# -- the batcher -----------------------------------------------------------


def _telemetry(path):
    return obs.Telemetry.for_run(str(path), obs.run_manifest(
        config={"mode": "serving", "network": "LeNet"}))


def _jax_telemetry(path):
    from pytorch_distributed_nn_tpu.observability.core import (
        Telemetry,
        run_manifest,
    )

    return Telemetry.for_run(str(path), run_manifest(
        config={"mode": "serving", "network": "LeNet"}))


def _serve(batcher, xs, request_ids):
    reqs = [batcher.submit(x, timeout_s=30.0, request_id=rid)
            for x, rid in zip(xs, request_ids)]
    return [r.wait(timeout=60.0) for r in reqs]


def test_one_record_per_request_with_the_jax_fields(lenet, arts, tmp_path):
    xs = _inputs(lenet, 10, seed=4)
    rids = [f"req-{i}" for i in range(10)]
    t = _telemetry(tmp_path / "port" / "serving.jsonl")
    b = Batcher(lenet, telemetry=t)
    outs = _serve(b, xs, rids)
    b.close()
    t.close()
    assert b.served == 10 and b.dropped == 0
    assert all(np.shape(o) == (10,) for o in outs)
    jax_engine = JaxEngine(arts["LeNet"], batch_buckets=IMAGE_BUCKETS)
    jax_engine.warmup()
    jt = _jax_telemetry(tmp_path / "jax" / "serving.jsonl")
    jb = JaxBatcher(jax_engine, telemetry=jt)
    _serve(jb, xs, rids)
    jb.close()
    jt.close()
    port = jax_reader.read_stream(str(tmp_path / "port")).steps
    want = jax_reader.read_stream(str(tmp_path / "jax")).steps
    assert len(port) == len(want) == 10
    assert {r["request_id"] for r in port} == set(rids)
    for rec in port:
        # the same field names; flops is present where a cost is known,
        # on both sides (the port counts every bucket's FLOPs)
        assert set(rec) - {"flops"} == set(want[0]) - {"flops"}
        assert tuple(rec["spans"]) == tracing.SPANS
        assert rec["version"] == lenet.version
        assert rec["latency_ms"] >= rec["queue_ms"]
        assert rec["flops"] > 0
    hist = t.registry.histogram("serving_latency_seconds")
    assert sum(hist.counts) == 10


def test_deadline_drop_emits_its_typed_event(lenet, tmp_path):
    t = _telemetry(tmp_path / "serving.jsonl")
    b = Batcher(lenet, telemetry=t, start=False)
    x = np.zeros((28, 28, 1), np.float32)
    dead = b.submit(x, timeout_s=-0.01)
    live = b.submit(x, timeout_s=30.0)
    b.start()
    assert np.shape(live.wait(timeout=30.0)) == (10,)
    with pytest.raises(DeadlineExceeded):
        dead.wait(timeout=30.0)
    b.close()
    t.close()
    assert b.dropped == 1 and b.served == 1
    events = jax_reader.read_stream(str(tmp_path)).events
    drops = [e for e in events if e.get("type") == "request_dropped"]
    assert len(drops) == 1 and drops[0]["request"] == dead.id
    assert t.registry.counter("serving_dropped_total").value == 1


def test_close_rejects_unscheduled_requests(lenet):
    b = Batcher(lenet, start=False)
    req = b.submit(np.zeros((28, 28, 1), np.float32))
    b.close(drain=False)
    with pytest.raises(RuntimeError, match="shut down"):
        req.wait(timeout=1.0)
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit(np.zeros((28, 28, 1), np.float32))


def test_submits_past_max_queue_shed(lenet, tmp_path):
    t = _telemetry(tmp_path / "serving.jsonl")
    b = Batcher(lenet, telemetry=t, start=False, max_queue=2)
    x = np.zeros((28, 28, 1), np.float32)
    held = [b.submit(x, timeout_s=30.0) for _ in range(2)]
    with pytest.raises(QueueShed) as e:
        b.submit(x)
    assert e.value.retry_after_s == 1.0  # no service rate observed yet
    probe = b.submit(x, timeout_s=30.0, klass="probe")  # always admits
    with pytest.raises(ValueError, match="traffic class"):
        b.submit(x, klass="bulk")
    assert TRAFFIC_CLASSES == ("stable", "canary", "probe")
    assert b.shed == 1
    # canaries cap at CANARY_SHARE of the bound, stable traffic does not
    c = Batcher(lenet, start=False, max_queue=4)
    queued = [c.submit(x, klass="canary") for _ in range(2)]
    with pytest.raises(QueueShed):
        c.submit(x, klass="canary")
    queued += [c.submit(x) for _ in range(2)]
    assert c.shed == 1 and len(queued) == 4
    c.close(drain=False)
    b.start()
    for r in held + [probe]:
        assert np.shape(r.wait(timeout=30.0)) == (10,)
    b.begin_drain()
    from pytorch_distributed_nn_tpu_torch.serving.batcher import Draining

    with pytest.raises(Draining):
        b.submit(x)
    b.close()
    t.close()
    events = jax_reader.read_stream(str(tmp_path)).events
    assert [e["count"] for e in events
            if e.get("type") == "request_shed"] == [1]
    assert [e["phase"] for e in events if e.get("type") == "drain"] == \
        ["start"]


# -- the HTTP server -------------------------------------------------------


def _post(conn, path, doc, headers=None):
    conn.request("POST", path, json.dumps(doc),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read() or b"{}"), resp


def _get(conn, path):
    conn.request("GET", path)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_infer_over_http_gives_the_jax_servers_response(lenet, arts):
    xs = _inputs(lenet, 3, seed=5)
    body = {"inputs": [x.tolist() for x in xs], "timeout_s": 10.0}
    docs = []
    jax_engine = JaxEngine(arts["LeNet"], batch_buckets=IMAGE_BUCKETS)
    jax_engine.warmup()
    for engine, batcher_cls, server_cls in (
            (lenet, Batcher, ServingServer),
            (jax_engine, JaxBatcher, JaxServer)):
        b = batcher_cls(engine)
        server = server_cls(engine, b, port=0)
        server.start()
        try:
            conn = http.client.HTTPConnection(server.host, server.port,
                                              timeout=60)
            status, doc, resp = _post(conn, "/v1/infer", body,
                                      {"X-Request-Id": "client-7"})
            assert status == 200
            assert resp.getheader("X-Request-Id") == "client-7"
            docs.append(doc)
            health = _get(conn, "/healthz")
            stats = _get(conn, "/stats")
            conn.close()
        finally:
            server.close()
            b.close()
        assert health == (200, {"status": "ok", "network": "LeNet",
                                "source_step": 1, "quantize": "none"})
        assert stats[1]["served"] == 3 and stats[1]["retraces"] == 0
    got, want = docs
    assert set(got) == set(want) == {
        "outputs", "top1", "latency_ms", "queue_ms", "infer_ms",
        "request_ids", "versions"}
    assert got["request_ids"] == want["request_ids"] == [
        "client-7", "client-7.1", "client-7.2"]
    assert got["top1"] == want["top1"]
    assert got["versions"] == want["versions"] == [lenet.version] * 3
    np.testing.assert_allclose(got["outputs"], want["outputs"], rtol=0,
                               atol=LOGITS_TOL)


def test_http_errors_shed_and_drain(lenet):
    b = Batcher(lenet, start=False, max_queue=1)
    held = b.submit(np.zeros((28, 28, 1), np.float32), timeout_s=30.0)
    server = ServingServer(lenet, b, port=0)
    server.start()
    body = {"inputs": [np.zeros((28, 28, 1)).tolist()], "timeout_s": 5.0}
    try:
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=30)
        assert _get(conn, "/readyz") == (200, {"status": "ready"})
        status, doc, resp = _post(conn, "/v1/infer", body)
        assert status == 429 and int(resp.getheader("Retry-After")) >= 1
        assert doc["retry_after_s"] > 0 and b.shed == 1
        for bad in ({}, {"inputs": []}, {"inputs": "x"}):
            assert _post(conn, "/v1/infer", bad)[0] == 400
        assert _post(conn, "/v1/infer", body,
                     {"X-Request-Id": "bad id"})[0] == 400
        assert _post(conn, "/v1/generate", {"inputs": [[1]]})[0] == 400
        assert _post(conn, "/v1/nothing", {})[0] == 404
        server.begin_drain()
        assert server.draining and b.draining
        assert _get(conn, "/readyz") == (503, {"status": "draining",
                                               "draining": True})
        assert _get(conn, "/healthz")[0] == 200  # liveness never flips
        status, doc, _ = _post(conn, "/v1/infer", body)
        assert status == 503 and doc["draining"] is True
        status, stats = _get(conn, "/stats")
        assert stats["draining"] and stats["shed"] == 1
        assert stats["max_queue"] == 1 and stats["generate"] is None
        assert stats["precision"] == {"tf32": False,
                                      "dtype": "torch.float32"}
        conn.close()
        b.start()
        assert np.shape(held.wait(timeout=30.0)) == (10,)
    finally:
        server.close()
        b.close()


# rows each refused at admission: (artifact, what, row maker given the
# engine). An id outside [0, vocab) would be a device-side assert on the
# card; a mis-shaped image would broadcast into the batch or fail it.
BAD_ROWS = [
    ("BertTiny", "an id at vocab_size", lambda e: [1, 2, e.vocab_size]),
    ("BertTiny", "a negative id", lambda e: [1, -1, 2]),
    ("BertTiny", "a row over max_len",
     lambda e: [1] * (e.input_spec[0] + 1)),
    ("BertTiny", "an empty row", lambda e: []),
    ("BertTiny", "a 2-D row", lambda e: [[1, 2], [3, 4]]),
    ("BertTiny", "float ids", lambda e: [1.5, 2.0]),
    ("LeNet", "a scalar image", lambda e: 0.5),
    ("LeNet", "an image without its channel axis",
     lambda e: np.zeros(e.input_spec[:-1]).tolist()),
    ("LeNet", "a transposed image",
     lambda e: np.zeros(e.input_spec[::-1]).tolist()),
]


@pytest.mark.parametrize("name,what,make", BAD_ROWS,
                         ids=[w for _, w, _ in BAD_ROWS])
def test_http_refuses_a_bad_row_and_serves_on(engines, name, what, make):
    """A body with a bad row is a 400 and none of its rows is queued;
    the next good request is a 200."""
    engine = engines[name]
    good = _inputs(engine, 1, seed=3)[0].tolist()
    b = Batcher(engine)
    server = ServingServer(engine, b, port=0)
    server.start()
    try:
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=30)
        status, doc, _ = _post(conn, "/v1/infer",
                               {"inputs": [good, make(engine)]})
        assert status == 400 and doc["error"].startswith("bad request")
        with pytest.raises(ValueError):
            engine.infer([np.asarray(good), make(engine)])
        status, doc, _ = _post(conn, "/v1/infer", {"inputs": [good]})
        assert status == 200 and len(doc["outputs"]) == 1
        assert _get(conn, "/stats")[1]["served"] == 1
        conn.close()
    finally:
        server.close()
        b.close()


def test_batcher_warms_its_own_thread_before_it_starts(lenet, monkeypatch):
    """The scheduler thread runs the engine's warm pass before ``start``
    returns (its own cuBLAS/cuDNN handles and plans on the card); a
    failure there is raised by ``start``."""
    import threading

    seen = []
    warm = lenet.warm_thread
    monkeypatch.setattr(lenet, "warm_thread", lambda: seen.append(
        (threading.current_thread().name, warm())))
    b = Batcher(lenet)
    assert seen == [("pdtn-serve-scheduler", None)]
    assert np.shape(b.submit(_inputs(lenet, 1, 0)[0]).wait(30.0)) == (10,)
    b.close()

    def broken():
        raise RuntimeError("no card")

    monkeypatch.setattr(lenet, "warm_thread", broken)
    with pytest.raises(RuntimeError, match="no card"):
        Batcher(lenet)


def test_engine_forwards_hold_tf32_off_and_give_it_back():
    """The TF32 switches are process-wide: off while any engine forward
    runs (nested or on two threads), back as they were after the last."""
    import torch

    from pytorch_distributed_nn_tpu_torch.serving.engine import _no_tf32

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    try:
        matmul.allow_tf32, cudnn.allow_tf32 = True, True
        with _no_tf32():
            assert (matmul.allow_tf32, cudnn.allow_tf32) == (False, False)
            with _no_tf32():
                pass
            assert (matmul.allow_tf32, cudnn.allow_tf32) == (False, False)
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def test_one_server_answers_infer_and_generate(lenet, tmp_path):
    """/v1/generate is unchanged beside /v1/infer (the generative tests
    hold its contract; here both paths answer on one server)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.serving.generate import (
        GenerateScheduler,
        GenerativeEngine,
    )

    model = build_model("GptTiny").init_weights(
        torch.Generator().manual_seed(0))
    art = str(tmp_path / "gen")
    artifact.save_artifact(art, model.state_dict(), "GptTiny")
    gen = GenerativeEngine(art, batch_buckets=(1,), seq_buckets=(32,),
                           pool_slots=2, device="cpu")
    gen.warmup()
    sched = GenerateScheduler(gen)
    b = Batcher(lenet)
    server = ServingServer(lenet, b, port=0, generator=sched)
    server.start()
    try:
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=60)
        status, doc, _ = _post(conn, "/v1/generate",
                               {"inputs": [[3, 1, 4]], "max_new_tokens": 3})
        assert status == 200 and doc["new_tokens"] == [3]
        status, doc, _ = _post(conn, "/v1/infer", {"inputs": [
            np.zeros((28, 28, 1)).tolist()]})
        assert status == 200 and len(doc["outputs"][0]) == 10
        conn.close()
        assert server.drain_and_close(timeout=10.0)
    finally:
        sched.close()
        b.close()
    with pytest.raises(ValueError, match="batcher, a generator"):
        ServingServer(lenet, None, port=0)


# -- the stream contract and the load generator ----------------------------


def test_jax_reader_summarizes_the_port_serving_stream(lenet, tmp_path):
    t = loadgen.serving_telemetry(str(tmp_path), lenet)
    b = Batcher(lenet, telemetry=t)
    _serve(b, _inputs(lenet, 20, seed=6), [f"s{i}" for i in range(20)])
    b.close()
    t.close()
    rs = jax_reader.read_stream(str(tmp_path))
    assert rs.manifest["config"]["mode"] == "serving"
    assert rs.manifest["artifact_identity"]["version"] == lenet.version
    summary = jax_reader.summarize_run(rs)
    sv = summary["serving"]
    assert sv["requests"] == 20
    assert 0 < sv["latency_ms"]["p50"] <= sv["latency_ms"]["p99"]


def test_run_load_is_open_loop_and_counts(lenet):
    b = Batcher(lenet, max_queue=1024)
    try:
        r = loadgen.run_load(b, loadgen.sample_inputs(lenet, 8), 200.0, 0.25)
    finally:
        b.close()
    assert r["submitted"] == 50 and r["served"] + r["dropped"] == 50
    assert r["shed"] == 0 and r["sustained_rps"] > 0
    assert r["achieved_gflops_per_s"] > 0
    assert set(r["spans"]) == set(tracing.SPANS)
    assert r["latency_ms"]["p50"] <= r["latency_ms"]["p99"]
    assert loadgen._pctl([], 50) != loadgen._pctl([], 50)  # nan
    assert loadgen._pctl([3, 1, 2, 4], 50) == 2


# -- the CLI ---------------------------------------------------------------


def _cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", *args],
        cwd=REPO, env=torch_cpu.SUBPROCESS_ENV, capture_output=True,
        text=True, timeout=timeout)


def test_cli_serve_smoke_on_the_cpu():
    proc = _cli("serve", "smoke", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[FAIL]" not in proc.stdout and "13/13" in proc.stderr


def test_cli_serve_export_then_bench_on_the_cpu(arts, tmp_path):
    td = os.path.join(os.path.dirname(arts["LeNet"]), "train_dir")
    out = str(tmp_path / "art")
    proc = _cli("serve", "export", "--train-dir", td, "--out", out,
                "--network", "LeNet", "--quantize", "int8")
    assert proc.returncode == 0, proc.stderr
    assert "exported step 1" in proc.stdout
    assert artifact.load_manifest(out)["quantize"] == "int8"
    proc = _cli("serve", "bench", "--artifact", out, "--device", "cpu",
                "--offered", "50", "--duration", "0.5", "--buckets", "1,2,4",
                "--json")
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["retraces_after_warmup"] == 0 and rec["device"] == "cpu"
    (r,) = rec["sweep"]
    assert r["offered_rps"] == 50.0 and r["served"] == r["submitted"] == 25
    assert os.path.exists(rec["stream"])


def test_cli_serve_flags_of_later_items_raise(arts):
    from pytorch_distributed_nn_tpu_torch import cli

    for args, item in ((("--slo", "lat_p99<25ms@60s"), "item 6"),
                       (("--registry", "r"), "item 6"),
                       (("--flightrec", "default"), "item 6")):
        with pytest.raises(NotImplementedError, match=item):
            cli.main(["serve", "run", "--artifact", arts["LeNet"],
                      "--device", "cpu", *args])
    with pytest.raises(NotImplementedError, match="item 6"):
        cli.main(["serve", "frontend"])


def test_cli_serve_run_answers_infer_and_drains_on_sigterm(arts, tmp_path):
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "serve",
         "run", "--artifact", arts["LeNet"], "--device", "cpu", "--port",
         "0", "--port-file", str(port_file), "--buckets", "1,2",
         "--serve-dir", str(tmp_path / "serve")],
        cwd=REPO, env=torch_cpu.SUBPROCESS_ENV, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists():
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        conn = http.client.HTTPConnection("127.0.0.1",
                                          int(port_file.read_text()),
                                          timeout=60)
        status, doc, _ = _post(conn, "/v1/infer", {"inputs": [
            np.zeros((28, 28, 1)).tolist()] * 2})
        conn.close()
        assert status == 200 and len(doc["top1"]) == 2
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:  # never leave a server behind
            proc.kill()
            proc.wait(timeout=30)
    assert b"drain complete" in proc.stderr.read()
    with open(tmp_path / "serve" / "serving.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records[0]["kind"] == "manifest"
    assert sum(r.get("kind") == "step" for r in records) == 2


# -- injected serving faults (serve run --faults) -----------------------------

FAULT_SPECS = ["slow_infer@1:0.2s:x8,conn_reset@12,http_503@15:x3",
               "conn_reset@2:x3,http_503@3:x4,slow_infer@5:0.01s",
               "http_503@40,slow_infer@10:0.5s:x2,slow_infer@11:0.25s:x5"]


class _FakeEngine:
    """``infer`` of one batch: stats as the engines give them."""

    def infer(self, xs):
        return list(xs), {"batch": len(xs), "infer_ms": 1.0}


def _fault_sequence(injector_cls, plan_cls, telemetry, spec, monkeypatch,
                    module):
    slept = []
    monkeypatch.setattr(module.time, "sleep", slept.append)
    inj = injector_cls(plan_cls.parse(spec), telemetry=telemetry)
    engine = _FakeEngine()
    inj.attach_engine(engine)
    actions = [inj.http_action() for _ in range(40)]
    batches = [engine.infer([0] * n)[1]["infer_ms"]
               for n in (1, 1, 3, 2, 1, 5, 1, 1, 4, 1, 2, 1)]
    return actions, batches, slept, inj.fired


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_serving_fault_sequence_equals_jax(spec, monkeypatch):
    from pytorch_distributed_nn_tpu.observability import core as jcore
    from pytorch_distributed_nn_tpu.resilience.faults import (
        FaultPlan as JaxPlan,
    )
    from pytorch_distributed_nn_tpu.serving import faultinject as jfi
    from pytorch_distributed_nn_tpu_torch.resilience.faults import FaultPlan
    from pytorch_distributed_nn_tpu_torch.serving import faultinject as fi

    jtel, tel = jcore.Telemetry(), obs.Telemetry()
    jseen, seen = [], []
    jtel.subscribe(jseen.append)
    tel.subscribe(seen.append)
    want = _fault_sequence(jfi.ServingFaultInjector, JaxPlan, jtel, spec,
                           monkeypatch, jfi)
    got = _fault_sequence(fi.ServingFaultInjector, FaultPlan, tel, spec,
                          monkeypatch, fi)
    assert got == want
    strip = ("time", "mono")
    assert [{k: v for k, v in r.items() if k not in strip} for r in seen] \
        == [{k: v for k, v in r.items() if k not in strip} for r in jseen]
    assert len(seen) == len(FaultPlan.parse(spec).entries)


def test_server_applies_injected_faults(lenet):
    """One sequential client: slow_infer bills its requests' infer_ms,
    conn_reset closes request 3's connection with no response, http_503
    answers requests 4 and 5; every entry fires once."""
    from pytorch_distributed_nn_tpu_torch.resilience.faults import FaultPlan
    from pytorch_distributed_nn_tpu_torch.serving.faultinject import (
        ServingFaultInjector,
    )

    tel = obs.Telemetry()
    seen = []
    tel.subscribe(seen.append)
    inj = ServingFaultInjector(FaultPlan.parse(
        "slow_infer@1:0.05s:x2,conn_reset@3,http_503@4:x2"), telemetry=tel)

    class Wrapped:  # the module's warm engine stays unwrapped
        def __getattr__(self, name):
            return getattr(lenet, name)

    engine = Wrapped()
    engine.infer = lenet.infer
    inj.attach_engine(engine)
    batcher = Batcher(engine, batch_window_s=0.0)
    server = ServingServer(lenet, batcher, port=0, faults=inj)
    server.start()
    row = np.zeros((28, 28, 1)).tolist()
    out = []
    try:
        for _ in range(7):
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=30)
            try:
                status, doc, _ = _post(conn, "/v1/infer", {"inputs": [row]})
                out.append((status, doc.get("infer_ms")))
            except (http.client.RemoteDisconnected, ConnectionError):
                out.append(("reset", None))
            finally:
                conn.close()
    finally:
        server.close()
        batcher.close()
    assert [s for s, _ in out] == [200, 200, "reset", 503, 503, 200, 200]
    assert all(ms[0] >= 50.0 for _, ms in out[:2])
    assert all(ms[0] < 50.0 for _, ms in out[5:])
    assert [(r["fault"], r["request"], r["layer"]) for r in seen] == [
        ("slow_infer", 1, "engine"), ("conn_reset", 3, "http"),
        ("http_503", 4, "http")]


def test_cli_serve_run_refuses_faults_without_a_serving_kind(arts, capsys):
    from pytorch_distributed_nn_tpu_torch import cli

    assert cli.main(["serve", "run", "--artifact", arts["LeNet"],
                     "--device", "cpu", "--faults", "crash@3"]) == 2
    assert "no serving-side entries" in capsys.readouterr().err
    assert cli.main(["serve", "run", "--artifact", arts["LeNet"],
                     "--device", "cpu", "--faults", "boom@3"]) == 2
