"""The port's generative serving path (pytorch_distributed_nn_tpu_torch/
serving) on the CPU: engine logits against the JAX package's engine on
the same artifact, the slot ledger, swap fencing, continuous batching,
and one HTTP round trip.

The JAX engine runs ``decode_attn="pallas"`` (interpret mode) over an
artifact exported with ``model_kw={"fused_ln": true}``, the slice's TPU
kernel configuration; the port runs ``device="cpu"`` (its kernels' plain
versions). Tolerance: f32 logits at atol 1e-5 for prefill and every
teacher-forced decode step.
"""

import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.serving.generate import (
    GenerativeEngine as JaxEngine,
)
from pytorch_distributed_nn_tpu.serving.loadgen import (
    make_tiny_decoder_artifact,
)
from pytorch_distributed_nn_tpu_torch.serving.generate import (
    GenerateScheduler,
    GenerativeEngine,
    KVCachePool,
    PoolExhausted,
    StaleKVPage,
)
from pytorch_distributed_nn_tpu_torch.serving.generate.engine import (
    StaleBatchEpoch,
)

import torch_cpu  # noqa: F401  (one intra-op thread)

BUCKETS = dict(batch_buckets=(1, 2, 4), seq_buckets=(16, 32), pool_slots=6)


def _fused_ln_copy(src: str, dst: str) -> str:
    """The same weights under ``model_kw={"fused_ln": true}`` (the
    manifest is outside the params CRC)."""
    shutil.copytree(src, dst)
    path = os.path.join(dst, "artifact.json")
    with open(path) as f:
        doc = json.load(f)
    doc["model_kw"] = {"fused_ln": True}
    with open(path, "w") as f:
        json.dump(doc, f)
    return dst


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_generate")
    a = make_tiny_decoder_artifact(str(root / "a"))
    b = make_tiny_decoder_artifact(str(root / "b"), seed=3, step=9)
    return (_fused_ln_copy(a, str(root / "a_ln")),
            _fused_ln_copy(b, str(root / "b_ln")))


@pytest.fixture(scope="module")
def engine(artifacts):
    eng = GenerativeEngine(artifacts[0], device="cpu", **BUCKETS)
    eng.warmup()
    return eng


def test_engine_logits_match_jax_engine(artifacts, engine):
    jax_engine = JaxEngine(artifacts[0], decode_attn="pallas", **BUCKETS)
    prompts = [np.asarray([3, 1, 4, 1, 5], np.int32),
               np.asarray([9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3], np.int32)]
    lp, kvp, stats = engine.prefill(prompts[0])
    lj, kvj, _ = jax_engine.prefill(prompts[0])
    assert stats["prompt_bucket"] == 16
    np.testing.assert_allclose(lp, lj, atol=1e-5)
    bucket = 32
    sp = [engine.pools[bucket].alloc(0) for _ in prompts]
    sj = [jax_engine.pools[bucket].alloc(0) for _ in prompts]
    try:
        for i, prompt in enumerate(prompts):
            _, kvp, _ = engine.prefill(prompt)
            _, kvj, _ = jax_engine.prefill(prompt)
            engine.insert(bucket, sp[i], kvp)
            jax_engine.insert(bucket, sj[i], kvj)
        rng = np.random.RandomState(0)
        positions = [len(p) for p in prompts]
        for _ in range(5):
            toks = rng.randint(1, 256, size=2).tolist()
            got, st = engine.decode(bucket, sp, toks, positions)
            want, _ = jax_engine.decode(bucket, sj, toks, positions)
            assert got.shape == (2, 256) and st["batch_bucket"] == 2
            np.testing.assert_allclose(got, want, atol=1e-5)
            positions = [p + 1 for p in positions]
    finally:
        for s in sp:
            engine.pools[bucket].free(s)
    assert engine.retraces() == 0


def test_engine_decode_equals_full_recompute(engine):
    """Greedy generation through the scheduler reproduces a full-
    recompute greedy loop token for token."""
    sched = GenerateScheduler(engine)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    try:
        got = sched.submit(prompt, max_new_tokens=6, timeout_s=30.0).wait(60)
    finally:
        sched.close()
    seq = list(prompt)
    model = engine.model
    with torch.no_grad():
        for _ in range(6):
            logits = model(torch.as_tensor([seq]))
            seq.append(int(logits[0, -1].argmax()))
    assert got == seq[len(prompt):]


def test_engine_needs_a_card_unless_asked_for_the_cpu(artifacts):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerativeEngine(artifacts[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerativeEngine(artifacts[0], device="cuda")


def test_decode_attn_option_selects_the_plain_version(artifacts, engine):
    """``decode_attn="plain"`` swaps the decode attention alone; on the
    CPU both choices compute the same logits."""
    plain = GenerativeEngine(artifacts[0], device="cpu",
                             decode_attn="plain", **BUCKETS)
    assert engine.decode_attn == "kernel"
    prompt = np.asarray([4, 8, 15, 16, 23, 42], np.int32)
    bucket = 16
    slots = []
    try:
        for eng in (engine, plain):
            _, kvs, _ = eng.prefill(prompt)
            slots.append(eng.pools[bucket].alloc(eng.epoch))
            eng.insert(bucket, slots[-1], kvs)
        got, _ = engine.decode(bucket, [slots[0]], [7], [len(prompt)])
        want, _ = plain.decode(bucket, [slots[1]], [7], [len(prompt)])
    finally:
        engine.pools[bucket].free(slots[0])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown decode_attn"):
        GenerativeEngine(artifacts[0], device="cpu", decode_attn="pallas")


def test_kernel_failure_fails_requests_instead_of_retrying(engine,
                                                           monkeypatch):
    """A decode step that raises (a kernel launch refused) is no swap
    fence: the scheduler fails the request with the cause, it does not
    retry forever."""
    def refused(*args, **kwargs):
        raise RuntimeError("decode_attention kernel launch failed")

    monkeypatch.setattr(engine, "_decode_padded", refused)
    sched = GenerateScheduler(engine)
    try:
        req = sched.submit([1, 2, 3], max_new_tokens=4, timeout_s=30.0)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            req.wait(30.0)
    finally:
        sched.close()
    assert engine.fence_violations == 0
    assert all(p.live == 0 for p in engine.pools.values())


def test_engine_rejects_bad_configuration(artifacts):
    with pytest.raises(ValueError, match="needs >= 1 slot"):
        GenerativeEngine(artifacts[0], device="cpu", pool_slots=-1)
    with pytest.raises(ValueError, match="strictly increasing"):
        GenerativeEngine(artifacts[0], device="cpu", batch_buckets=(2, 1))
    with pytest.raises(ValueError, match="max_len"):
        GenerativeEngine(artifacts[0], device="cpu", seq_buckets=(128,))


def test_pool_alloc_exhaust_free_reuse():
    pool = KVCachePool(bucket=32, slots=2)
    a, b = pool.alloc(epoch=0), pool.alloc(epoch=0)
    assert {a, b} == {0, 1} and pool.free_slots == 0
    with pytest.raises(PoolExhausted):
        pool.alloc(epoch=0)
    pool.free(a)
    assert pool.alloc(epoch=0) == a and pool.live == 2
    assert pool.scratch == 2
    with pytest.raises(KeyError):
        pool.free(pool.scratch)


def test_pool_epoch_fence():
    pool = KVCachePool(bucket=32, slots=2)
    s = pool.alloc(epoch=0)
    assert pool.checkout(s, 0) == s
    with pytest.raises(StaleKVPage, match="swap fence"):
        pool.checkout(s, 1)
    assert pool.stale_slots(1) == [s]
    pool.rebind(s, 1)
    assert pool.checkout(s, 1) == s and pool.stale_slots(1) == []
    pool.evict(s)
    assert pool.evictions == 1 and pool.free_slots == 2


def test_mid_round_swap_refused_without_fence_violation(engine):
    bucket = min(engine.pools)
    pool = engine.pools[bucket]
    before, e0 = engine.fence_violations, engine.epoch
    slot = pool.alloc(e0)
    try:
        with engine._weights_lock:
            engine.epoch = e0 + 1
        with pytest.raises(StaleBatchEpoch):
            engine.decode(bucket, [slot], [0], [0], expected_epoch=e0)
        assert engine.fence_violations == before
        with pytest.raises(StaleKVPage, match="swap fence"):
            engine.decode(bucket, [slot], [0], [0],
                          expected_epoch=engine.epoch)
        assert engine.fence_violations == before + 1
    finally:
        pool.free(slot)
        with engine._weights_lock:
            engine.epoch = e0
        engine.fence_violations = before


def test_swap_fences_and_restamps(engine, artifacts):
    sched = GenerateScheduler(engine)
    try:
        reqs = [sched.submit([1 + i, 2, 3], max_new_tokens=28, timeout_s=30.0)
                for i in range(3)]
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if any(len(r.tokens) >= 2 for r in reqs):
                break
            time.sleep(0.001)
        assert not any(r.done.is_set() for r in reqs)
        new_v = sched.swap(artifacts[1])
        outs = [r.wait(60.0) for r in reqs]
    finally:
        sched.close()
        engine.swap(artifacts[0])
    assert all(len(o) == 28 for o in outs)
    assert engine.fence_violations == 0 and engine.retraces() == 0
    fenced = [r for r in reqs if r.refences]
    assert sched.refenced_total >= 1 and fenced
    assert all(r.version == new_v for r in fenced)


def test_swap_refuses_a_different_architecture(engine, tmp_path):
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        save_artifact,
    )

    other = build_model("GptMini").init_weights(
        torch.Generator().manual_seed(0))
    path = save_artifact(str(tmp_path / "mini"), other.state_dict(),
                         "GptMini", model_kw={"fused_ln": True})
    assert path["network"] == "GptMini"
    with pytest.raises(ValueError, match="refusing swap"):
        engine.swap(str(tmp_path / "mini"))


def test_shadow_has_its_own_weights_and_pools(engine, artifacts):
    shadow = engine.shadow(artifacts[1])
    assert shadow.version != engine.version
    assert shadow.pools is not engine.pools
    sched = GenerateScheduler(shadow)
    try:
        out = sched.submit([9, 8, 7], max_new_tokens=4,
                           timeout_s=30.0).wait(60.0)
    finally:
        sched.close()
    assert len(out) == 4
    assert all(p.live == 0 for p in engine.pools.values())
    assert engine.retraces() == 0


def test_continuous_batch_join_leave(engine):
    sched = GenerateScheduler(engine)
    rng = np.random.RandomState(7)
    steps_before = engine.decode_steps
    try:
        waves = []
        for _ in range(3):
            waves.extend(
                sched.submit(rng.randint(1, 256, size=rng.randint(2, 20)),
                             max_new_tokens=8, timeout_s=30.0)
                for _ in range(4)
            )
            time.sleep(0.01)
        outs = [r.wait(60.0) for r in waves]
    finally:
        sched.close()
    assert all(len(o) == 8 for o in outs)
    assert sched.served == 12 and sched.dropped == 0
    assert engine.retraces() == 0 and engine.fence_violations == 0
    # sequences shared decode steps: fewer than one step per token
    assert engine.decode_steps - steps_before < 12 * 7


def test_stop_token_and_deadline_drop(artifacts):
    eng = GenerativeEngine(artifacts[0], device="cpu", batch_buckets=(1,),
                           seq_buckets=(16,), pool_slots=1)
    eng.warmup()
    sched = GenerateScheduler(eng)
    try:
        r = sched.submit([5, 6, 7], max_new_tokens=10,
                         stop_tokens=list(range(256)), timeout_s=30.0)
        assert len(r.wait(60.0)) == 1 and r.finish_reason == "stop"
        hog = sched.submit([1, 2], max_new_tokens=12, timeout_s=30.0)
        late = sched.submit([3, 4], max_new_tokens=12, timeout_s=0.0)
        from pytorch_distributed_nn_tpu_torch.serving.batcher import (
            DeadlineExceeded,
        )

        with pytest.raises(DeadlineExceeded):
            late.wait(60.0)
        assert len(hog.wait(60.0)) == 12
    finally:
        sched.close()
    assert sched.dropped == 1


def _post(url, doc, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def test_http_generate_round_trip(engine, tmp_path):
    from pytorch_distributed_nn_tpu_torch.observability import tracing
    from pytorch_distributed_nn_tpu_torch.observability.core import (
        Telemetry,
    )
    from pytorch_distributed_nn_tpu_torch.serving.server import ServingServer

    stream = str(tmp_path / "serving.jsonl")
    telemetry = Telemetry.for_run(stream)
    sched = GenerateScheduler(engine, telemetry=telemetry)
    server = ServingServer(engine, None, port=0, generator=sched)
    server.start()
    base = f"http://{server.host}:{server.port}"
    trace_id, caller_span = "ab" * 16, "cd" * 8
    try:
        status, doc, headers = _post(
            f"{base}/v1/generate",
            {"inputs": [[5, 3, 1], [2, 4, 6, 8]], "max_new_tokens": 4},
            headers={"X-Request-Id": "gen-e2e",
                     tracing.TRACE_HEADER: f"00-{trace_id}-{caller_span}-01"},
        )
        assert status == 200
        assert [len(o) for o in doc["outputs"]] == [4, 4]
        assert doc["new_tokens"] == [4, 4]
        assert doc["request_ids"] == ["gen-e2e", "gen-e2e.1"]
        assert doc["versions"] == [engine.version] * 2
        assert doc["finish"] == ["length", "length"]
        assert headers.get("X-Request-Id") == "gen-e2e"
        status, doc, _ = _post(f"{base}/v1/infer", {"inputs": [[1, 2]]})
        assert status == 400 and "generate" in doc["error"]
        status, _, _ = _post(f"{base}/v1/generate", {"inputs": []})
        assert status == 400
        status, doc, _ = _post(f"{base}/v1/generate", {"inputs": [[1]]},
                               headers={tracing.TRACE_HEADER: "00-bad"})
        assert status == 400 and "trace context" in doc["error"]
        with urllib.request.urlopen(f"{base}/readyz", timeout=30) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["served"] >= 2 and stats["retraces"] == 0
        assert stats["generate"]["fence_violations"] == 0
    finally:
        server.close()
        sched.close()
        telemetry.close()
    assert engine.retraces() == 0
    with open(stream) as f:
        records = [json.loads(line) for line in f]
    served = [r for r in records if r.get("request_id", "").startswith("gen-")]
    assert len(served) == 2 and all(r["new_tokens"] == 4 for r in served)
    assert tuple(served[0]["spans"]) == tracing.GENERATE_SPANS
    # each row is its own child span of the caller's
    assert {r["trace"] for r in served} == {trace_id}
    assert {r["parent"] for r in served} == {caller_span}
    assert len({r["span"] for r in served}) == 2
