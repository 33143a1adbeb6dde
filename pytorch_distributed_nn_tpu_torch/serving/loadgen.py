"""Load generators, and the bodies of ``serve bench`` and ``serve
smoke``: the port of ``pytorch_distributed_nn_tpu/serving/loadgen.py``.

The generator is OPEN-LOOP: arrival times follow the offered rate on the
wall clock, not the responses, so a slow server shows its latency instead
of throttling its own load. Submission goes straight to the batcher (no
HTTP): the numbers are the serving core's (admission, coalescing,
padding, the forward on the device).

:func:`sweep` warms an engine and drives increasing offered rates; per
rate it reports sustained req/s, served/dropped/shed counts, p50/p95/p99
latency, the per-span p50/p99 and the achieved FLOP/s, and it fails when
a kernel was built or an unwarmed shape ran after warmup. :func:`smoke`
is the few-second serving gate: export a random-init LeNet, serve 100
requests, check the invariants by reading the ``serving.jsonl`` stream
itself and through ``observability.reader``, shut down cleanly; then the
same for a tiny causal decoder over the generative scheduler.

:func:`run_generate_load` and :func:`generate_sweep` do the same for the
generative scheduler in token rates; :func:`run_http_load` offers single
rows over real HTTP (a server or the frontend) and tallies every outcome
by status, the client-visible ground truth of the availability checks.
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

from pytorch_distributed_nn_tpu_torch.observability import tracing

logger = logging.getLogger(__name__)


def sample_inputs(engine, n: int, seed: int = 0) -> List[np.ndarray]:
    """Deterministic request payloads of the artifact's input kind:
    uniform [0, 1) images, or token rows of 4 to max_len ids."""
    rng = np.random.RandomState(seed)
    if engine.kind == "tokens":
        max_len = int(engine.input_spec[0])
        vocab = int(engine.manifest.get("model_kw", {}).get("vocab_size",
                                                            1024))
        return [rng.randint(1, max(2, vocab),
                            size=rng.randint(4, max_len + 1)).astype(np.int32)
                for _ in range(n)]
    return [rng.rand(*engine.input_spec).astype(np.float32)
            for _ in range(n)]


def sample_prompts(engine, n: int, seed: int = 0,
                   reserve: int = 8) -> List[np.ndarray]:
    """Deterministic prompts for a generative engine, leaving ``reserve``
    cache positions free in its largest cache bucket."""
    rng = np.random.RandomState(seed)
    max_prompt = max(4, int(engine.seq_buckets[-1]) - int(reserve))
    return [rng.randint(1, int(engine.vocab_size),
                        size=rng.randint(2, max_prompt + 1)).astype(np.int32)
            for _ in range(n)]


def _pctl(vals, q):
    """Nearest-rank percentile (nan of nothing)."""
    vals = sorted(vals)
    if not vals:
        return float("nan")
    return vals[min(max(1, math.ceil(q / 100 * len(vals))), len(vals)) - 1]


def run_load(batcher, inputs: List[np.ndarray], offered_rps: float,
             duration_s: float, timeout_s: float = 2.0) -> dict:
    """Offer ``offered_rps`` for ``duration_s``; returns the measured dict.

    Every ~1 ms tick submits each request whose arrival time has passed,
    so the offered process holds past the sleep granularity. A submit the
    bounded batcher sheds counts as ``shed``, apart from deadline drops.
    """
    from pytorch_distributed_nn_tpu_torch.serving.batcher import QueueShed

    reqs = []
    total = max(1, int(offered_rps * duration_s))
    flops0 = batcher.engine.flops_total
    shed = submitted = 0
    t0 = time.monotonic()
    while submitted < total:
        due = min(total, int((time.monotonic() - t0) * offered_rps) + 1)
        while submitted < due:
            try:
                reqs.append(batcher.submit(inputs[submitted % len(inputs)],
                                           timeout_s=timeout_s))
            except QueueShed:
                shed += 1
            submitted += 1
        time.sleep(0.001)
    # the tail: everything completes or is deadline-dropped
    deadline = time.monotonic() + timeout_s + 10.0
    for r in reqs:
        r.done.wait(timeout=max(0.0, deadline - time.monotonic()))
    wall = max(time.monotonic() - t0, 1e-9)
    served = [r for r in reqs if r.error is None and r.done.is_set()]
    dropped = sum(1 for r in reqs if r.error is not None)
    lat = [r.latency_ms for r in served]
    flops = batcher.engine.flops_total - flops0
    span_samples: dict = {}
    for r in served:
        for name, ms in r.spans.items():
            span_samples.setdefault(name, []).append(ms)
    spans = {name: {"p50": round(_pctl(v, 50), 3),
                    "p99": round(_pctl(v, 99), 3)}
             for name, v in span_samples.items()}
    return {
        "spans": spans,
        "offered_rps": offered_rps,
        "duration_s": round(duration_s, 3),
        "submitted": submitted,
        "served": len(served),
        "dropped": dropped,
        "shed": shed,
        "shed_fraction": round(shed / max(1, submitted), 4),
        "sustained_rps": round(len(served) / wall, 1),
        "achieved_gflops_per_s": (round(flops / wall / 1e9, 3)
                                  if flops > 0 else None),
        "latency_ms": {"p50": round(_pctl(lat, 50), 3),
                       "p95": round(_pctl(lat, 95), 3),
                       "p99": round(_pctl(lat, 99), 3)},
    }


def serving_telemetry(out_dir: str, engine, extra: Optional[dict] = None):
    """A manifest-headed ``serving.jsonl`` in ``out_dir``; the manifest
    carries the run's configuration and the artifact identity, whose
    ``version`` every request record repeats."""
    from pytorch_distributed_nn_tpu_torch.observability import core as obs

    m = engine.manifest
    manifest = obs.run_manifest(
        config={
            "mode": "serving",
            "network": m["network"],
            "artifact": engine.artifact_dir,
            "source_step": (m.get("source") or {}).get("step"),
            "quantize": m.get("quantize", "none"),
            "batch_buckets": list(engine.batch_buckets),
            "device": str(engine.device),
            **(extra or {}),
        },
        param_count=m.get("param_count"),
        param_bytes=m.get("param_bytes"),
        artifact_identity=engine.identity,
    )
    return obs.Telemetry.for_run(os.path.join(out_dir, obs.SERVING_BASENAME),
                                 manifest)


def make_tiny_artifact(root: str, quantize: Optional[str] = None,
                       seed: int = 0, step: int = 1,
                       poison_nan: bool = False) -> str:
    """A random-init LeNet checkpoint in ``<root>/train_dir``, exported to
    ``<root>/artifact`` (bench and smoke fixture: serving speed does not
    depend on trained weights). ``step`` names the artifact's version, so
    one helper mints distinct registry versions. ``poison_nan`` NaNs every
    float parameter first: a CRC-intact artifact that passes every load
    check and emits NaN, the deploy only an output-quality gate can
    convict."""
    import torch

    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        export_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        create_train_state,
    )

    model = build_model("LeNet", 10).init_weights(
        torch.Generator().manual_seed(seed))
    if poison_nan:
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(float("nan"))
    state = create_train_state(
        model, lambda p: build_optimizer("sgd", p, 0.1), "cpu", seed=seed)
    state.step = step
    train_dir = os.path.join(root, "train_dir")
    ckpt.save_checkpoint(train_dir, state, step=step)
    out = os.path.join(root, "artifact")
    export_artifact(train_dir, out, step=step, network="LeNet",
                    num_classes=10, quantize=quantize)
    return out


def make_tiny_decoder_artifact(root: str, seed: int = 0, step: int = 1,
                               network: str = "GptTiny") -> str:
    """A random-init causal decoder saved as ``<root>/artifact``, its
    version ``train_dir@<step>:none`` as the JAX helper's (the generative
    twin of :func:`make_tiny_artifact`)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        save_artifact,
    )

    model = build_model(network).init_weights(
        torch.Generator().manual_seed(seed))
    out = os.path.join(root, "artifact")
    save_artifact(out, model.state_dict(), network,
                  source={"train_dir": os.path.join(root, "train_dir"),
                          "step": step, "checkpoint": None})
    return out


def sweep(artifact_dir: str,
          offered: Sequence[float] = (500.0, 1000.0, 2000.0),
          duration_s: float = 2.0, out_dir: Optional[str] = None,
          batch_buckets=None, batch_window_s: float = 0.002,
          timeout_s: float = 2.0, max_queue: Optional[int] = None,
          device=None, log=print) -> dict:
    """The ``serve bench`` body: warm an engine on ``device``, offer each
    rate in turn, check the no-retrace invariant; with ``out_dir``, stream
    every request's record into ``<out_dir>/serving.jsonl``."""
    from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        DEFAULT_BATCH_BUCKETS,
        InferenceEngine,
    )

    engine = InferenceEngine(
        artifact_dir, batch_buckets=batch_buckets or DEFAULT_BATCH_BUCKETS,
        device=device)
    warm_s = engine.warmup()
    telemetry = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        telemetry = serving_telemetry(out_dir, engine,
                                      extra={"offered": list(offered)})
    batcher = Batcher(engine, telemetry=telemetry,
                      batch_window_s=batch_window_s,
                      default_timeout_s=timeout_s, max_queue=max_queue)
    inputs = sample_inputs(engine, 256)
    results = []
    try:
        for rate in offered:
            r = run_load(batcher, inputs, rate, duration_s,
                         timeout_s=timeout_s)
            results.append(r)
            ach = r["achieved_gflops_per_s"]
            log(f"serve bench: offered {rate:g} req/s -> sustained "
                f"{r['sustained_rps']:g} req/s, p50 "
                f"{r['latency_ms']['p50']:.2f} ms, p99 "
                f"{r['latency_ms']['p99']:.2f} ms, dropped {r['dropped']}"
                + (f", {ach:.2f} GFLOP/s achieved" if ach else ""))
            spans = r["spans"]
            if spans:
                log("  spans p50/p99 (ms): " + " · ".join(
                    f"{n} {spans[n]['p50']:.2f}/{spans[n]['p99']:.2f}"
                    for n in tracing.SPANS[1:] if n in spans))
    finally:
        batcher.close()
        if telemetry is not None:
            telemetry.close()
    retraces = engine.retraces()
    if retraces != 0:
        raise AssertionError(
            f"no-retrace invariant violated: {retraces} kernel build(s) or "
            "unwarmed shape(s) after warmup — a request shape escaped the "
            "bucket padding")
    return {
        "artifact": artifact_dir,
        "device": str(engine.device),
        "warmup_s": round(warm_s, 3),
        "buckets": list(engine.batch_buckets),
        "retraces_after_warmup": retraces,
        "sweep": results,
        "stream": (os.path.join(out_dir, "serving.jsonl")
                   if out_dir else None),
    }


def run_generate_load(
    scheduler,
    prompts: List[np.ndarray],
    offered_rps: float,
    duration_s: float,
    max_new_tokens: int = 8,
    timeout_s: float = 30.0,
) -> dict:
    """Open-loop generation load: offer ``offered_rps`` REQUESTS/s of
    mixed-length prompts for ``duration_s``; returns the measured dict.

    Same pacing discipline as :func:`run_load`; the reported rates are
    TOKEN rates (the decoder's unit of work), with per-request TTFT and
    inter-token percentiles pooled across the window."""
    reqs = []
    total = max(1, int(offered_rps * duration_s))
    t0 = time.monotonic()
    submitted = 0
    while submitted < total:
        due = min(total, int((time.monotonic() - t0) * offered_rps) + 1)
        while submitted < due:
            reqs.append(scheduler.submit(
                prompts[submitted % len(prompts)],
                max_new_tokens=max_new_tokens, timeout_s=timeout_s,
            ))
            submitted += 1
        time.sleep(0.001)
    deadline = time.monotonic() + timeout_s + 30.0
    for r in reqs:
        r.done.wait(timeout=max(0.0, deadline - time.monotonic()))
    t_end = time.monotonic()
    served = [r for r in reqs if r.error is None and r.done.is_set()]
    dropped = sum(1 for r in reqs if r.error is not None)
    wall = max(t_end - t0, 1e-9)
    tokens = sum(len(r.tokens) for r in served)
    ttft = [r.ttft_ms for r in served if r.ttft_ms is not None]
    itl = [s for r in served for s in r.itl_samples]
    occ = [
        r.occ_sum / r.occ_steps for r in served if r.occ_steps
    ]
    return {
        "offered_rps": offered_rps,
        "duration_s": round(duration_s, 3),
        "submitted": len(reqs),
        "served": len(served),
        "dropped": dropped,
        "tokens": tokens,
        "sustained_tokens_per_s": round(tokens / wall, 1),
        "ttft_ms": {
            "p50": round(_pctl(ttft, 50), 3),
            "p99": round(_pctl(ttft, 99), 3),
        },
        # pooled per-TOKEN intervals across every served request — the
        "inter_token_ms": {
            "p50": round(_pctl(itl, 50), 3),
            "p99": round(_pctl(itl, 99), 3),
        },
        "decode_batch_mean": (
            round(sum(occ) / len(occ), 2) if occ else None
        ),
    }


def generate_sweep(
    artifact_dir: str,
    offered: Sequence[float] = (10.0, 25.0, 50.0),
    duration_s: float = 2.0,
    max_new_tokens: int = 8,
    out_dir: Optional[str] = None,
    batch_buckets=(1, 2, 4, 8),
    seq_buckets=None,
    pool_slots: Optional[int] = None,
    timeout_s: float = 30.0,
    device=None,
    log=print,
) -> dict:
    """Warm a generative engine on ``device``, sweep offered request rates
    of mixed prompt lengths, check the no-retrace invariant, optionally
    stream telemetry."""
    from pytorch_distributed_nn_tpu_torch.serving.generate import (
        GenerateScheduler,
        GenerativeEngine,
    )

    engine = GenerativeEngine(
        artifact_dir, batch_buckets=batch_buckets,
        seq_buckets=seq_buckets, pool_slots=pool_slots, device=device,
    )
    warm_s = engine.warmup()
    telemetry = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        telemetry = serving_telemetry(
            out_dir, engine,
            extra={"generative": True, "offered": list(offered)},
        )
    scheduler = GenerateScheduler(engine, telemetry=telemetry,
                                  default_timeout_s=timeout_s)
    prompts = sample_prompts(engine, 64, reserve=max_new_tokens + 2)
    results = []
    try:
        for rate in offered:
            r = run_generate_load(
                scheduler, prompts, rate, duration_s,
                max_new_tokens=max_new_tokens, timeout_s=timeout_s,
            )
            results.append(r)
            log(
                f"decode bench: offered {rate:g} req/s -> "
                f"{r['sustained_tokens_per_s']:g} tokens/s, TTFT p99 "
                f"{r['ttft_ms']['p99']:.2f} ms, ITL p99 "
                f"{r['inter_token_ms']['p99']:.2f} ms, mean decode "
                f"batch {r['decode_batch_mean']}, dropped {r['dropped']}"
            )
    finally:
        scheduler.close()
        if telemetry is not None:
            telemetry.close()
    retraces = engine.retraces()
    rec = {
        "artifact": artifact_dir,
        "device": str(engine.device),
        "warmup_s": round(warm_s, 3),
        "batch_buckets": list(engine.batch_buckets),
        "seq_buckets": list(engine.seq_buckets),
        "retraces_after_warmup": retraces,
        "fence_violations": engine.fence_violations,
        "sweep": results,
        "stream": (
            os.path.join(out_dir, "serving.jsonl") if out_dir else None
        ),
    }
    if retraces is not None and retraces != 0:
        raise AssertionError(
            f"no-retrace invariant violated on the decode path: "
            f"{retraces} kernel build(s) after warmup — a "
            "prompt/generation shape escaped the bucket families"
        )
    return rec


def run_http_load(
    host: str,
    port: int,
    rows: Sequence,
    offered_rps: float,
    duration_s: float,
    timeout_s: float = 5.0,
    workers: int = 32,
    klass: Optional[str] = None,
    stop_early=None,
) -> dict:
    """Open-loop load over real HTTP (the frontend and replica-loss path,
    where in-process submission cannot stand in).

    A worker pool paces single-row ``POST /v1/infer`` bodies against the
    wall-clock schedule; every outcome is tallied by status — the
    client-visible ground truth of "zero failed requests". ``workers`` bounds parallelism: keep
    it comfortably above offered_rps x typical latency or the offered
    process self-throttles (and the result dict says so via
    ``behind_schedule``).
    """
    import http.client
    import threading

    total = max(1, int(offered_rps * duration_s))
    lock = threading.Lock()
    taken = 0
    statuses: dict = {}
    latencies: List[float] = []
    t0 = time.monotonic()

    def worker():
        nonlocal taken
        conn = None  # per-worker keep-alive connection
        while True:
            if stop_early is not None and stop_early.is_set():
                break  # no new request once set, on schedule or behind it
            with lock:
                if taken >= total:
                    break
                i = taken
                due = t0 + i / offered_rps
                now = time.monotonic()
                if now >= due:
                    taken += 1
                    claimed = True
                else:
                    claimed = False
                    wait = due - now
            if not claimed:
                time.sleep(min(wait, 0.002))
                continue
            body = json.dumps({"inputs": [rows[i % len(rows)]],
                                "timeout_s": timeout_s})
            headers = {"Content-Type": "application/json"}
            if klass:
                headers["X-Traffic-Class"] = klass
            sent = time.monotonic()
            status = -1
            # one fresh-connection retry: a keep-alive socket the server
            # closed while idle is a client-side race, not a served-
            # request failure (requests are idempotent by contract)
            for fresh in (False, True):
                if conn is None or fresh:
                    if conn is not None:
                        try:
                            conn.close()
                        except OSError:
                            pass
                    conn = http.client.HTTPConnection(
                        host, port, timeout=timeout_s + 10.0
                    )
                    try:
                        conn.connect()
                        _set_nodelay(conn.sock)
                    except OSError:
                        pass  # surfaces on the request below
                try:
                    conn.request("POST", "/v1/infer", body=body,
                                 headers=headers)
                    resp = conn.getresponse()
                    resp.read()
                    status = resp.status
                    if resp.will_close:
                        conn.close()
                        conn = None
                    break
                except (OSError, http.client.HTTPException):
                    try:
                        conn.close()
                    except OSError:
                        pass
                    conn = None
            lat = (time.monotonic() - sent) * 1000.0
            with lock:
                statuses[status] = statuses.get(status, 0) + 1
                if status == 200:
                    latencies.append(lat)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    threads = [
        threading.Thread(target=worker, name=f"pdtn-httpload-{i}",
                         daemon=True)
        for i in range(workers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = max(time.monotonic() - t0, 1e-9)
    ok = statuses.get(200, 0)
    shed = statuses.get(429, 0)
    failed = sum(
        n for s, n in statuses.items()
        if s == -1 or (s is not None and s >= 500)
    )
    return {
        "offered_rps": offered_rps,
        "submitted": taken,
        "ok": ok,
        "shed": shed,
        "failed": failed,
        "statuses": {str(k): v for k, v in sorted(statuses.items())},
        "sustained_rps": round(ok / wall, 1),
        # the schedule slipped: the pool was too small for the offered
        # rate — the numbers are then closed-loop-ish, flag it
        "behind_schedule": wall > duration_s * 1.5,
        "latency_ms": {
            "p50": round(_pctl(latencies, 50), 3),
            "p95": round(_pctl(latencies, 95), 3),
            "p99": round(_pctl(latencies, 99), 3),
        },
    }


def _set_nodelay(sock) -> None:
    import socket

    if sock is not None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass


def smoke(keep_dir: Optional[str] = None, device=None) -> int:
    """The few-second serving gate. Prints one PASS/FAIL line per
    invariant; returns 0 only when every invariant holds."""
    import shutil
    import tempfile

    from pytorch_distributed_nn_tpu_torch.observability import reader
    from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )
    from pytorch_distributed_nn_tpu_torch.serving.generate import (
        GenerateScheduler,
        GenerativeEngine,
    )

    root = keep_dir or tempfile.mkdtemp(prefix="pdtn_serve_smoke_")
    checks = []

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), detail))

    try:
        artifact = make_tiny_artifact(root, quantize="int8")
        engine = InferenceEngine(artifact, batch_buckets=(1, 2, 4, 8),
                                 device=device)
        engine.warmup()
        serve_dir = os.path.join(root, "serve")
        os.makedirs(serve_dir)
        telemetry = serving_telemetry(serve_dir, engine)
        batcher = Batcher(engine, telemetry=telemetry)
        reqs = [batcher.submit(x, timeout_s=10.0)
                for x in sample_inputs(engine, 100)]
        outs = [r.wait(timeout=30.0) for r in reqs]
        batcher.close()
        telemetry.close()
        check("all 100 requests served",
              len(outs) == 100 and batcher.served == 100
              and batcher.dropped == 0,
              f"served={batcher.served} dropped={batcher.dropped}")
        check("outputs have the class-logit shape",
              all(np.shape(o) == (10,) for o in outs))
        retr = engine.retraces()
        check("zero retraces after warmup", retr == 0, f"retraces={retr}")
        rs = reader.read_stream(serve_dir)
        manifest, steps = rs.manifest, rs.steps
        check("serving stream is manifest-headed",
              manifest is not None
              and manifest.get("config", {}).get("mode") == "serving")
        check("stream carries one record per request", len(steps) == 100,
              f"records={len(steps)}")
        sv = reader.summarize_run(rs).get("serving") or {}
        check("obs summary exposes the serving percentiles",
              sv.get("requests") == 100
              and (sv.get("latency_ms") or {}).get("p99", 0) > 0,
              f"serving={sv}")
        check("records carry request ids, spans and the version stamp",
              all(rec.get("request_id")
                  and set(rec.get("spans") or {}) >= set(tracing.SPANS)
                  and rec.get("version") == engine.version
                  for rec in steps),
              f"first record={steps[0] if steps else None}")
        check("manifest carries the artifact identity",
              (manifest or {}).get("artifact_identity", {}).get("version")
              == engine.version,
              f"identity={(manifest or {}).get('artifact_identity')}")

        # the generative case: a tiny causal decoder, mixed prompt
        # lengths, per-token continuous batching
        gen_art = make_tiny_decoder_artifact(os.path.join(root, "gen"))
        gen_engine = GenerativeEngine(gen_art, batch_buckets=(1, 2),
                                      seq_buckets=(32,), pool_slots=4,
                                      device=device)
        gen_engine.warmup()
        gen_dir = os.path.join(root, "gen_serve")
        os.makedirs(gen_dir)
        gen_tel = serving_telemetry(gen_dir, gen_engine,
                                    extra={"generative": True})
        sched = GenerateScheduler(gen_engine, telemetry=gen_tel)
        greqs = [sched.submit(p, max_new_tokens=4, timeout_s=20.0)
                 for p in sample_prompts(gen_engine, 10, reserve=8)]
        gouts = [r.wait(timeout=30.0) for r in greqs]
        sched.close()
        gen_tel.close()
        check("generate: all 10 requests served, none dropped",
              len(gouts) == 10 and sched.served == 10
              and sched.dropped == 0,
              f"served={sched.served} dropped={sched.dropped}")
        check("generate: every request produced max_new_tokens ids",
              all(len(o) == 4 for o in gouts),
              f"lens={[len(o) for o in gouts]}")
        gretr = gen_engine.retraces()
        check("generate: zero retraces across prefill and decode",
              gretr == 0, f"retraces={gretr}")
        grs = reader.read_stream(gen_dir)
        gsteps = grs.steps
        check("generate: records carry prefill/decode spans, token counts "
              "and the version stamp",
              len(gsteps) == 10 and all(
                  rec.get("request_id")
                  and set(rec.get("spans") or {}) >= {
                      "admit", "queue", "prefill", "decode", "respond"}
                  and rec.get("new_tokens") == 4
                  and rec.get("version") == gen_engine.version
                  for rec in gsteps),
              f"first={gsteps[0] if gsteps else None}")
        gen_block = (reader.summarize_run(grs).get("serving")
                     or {}).get("generate") or {}
        check("obs summary exposes the generation block",
              gen_block.get("tokens") == 40
              and (gen_block.get("tokens_per_s") or 0) > 0,
              f"generate={gen_block}")
    except Exception as e:  # a crash is a failed smoke, with its trace
        logger.exception("serving smoke crashed")
        check("smoke completed without exception", False, repr(e))
    finally:
        if keep_dir is None:
            shutil.rmtree(root, ignore_errors=True)
    failed = [c for c in checks if not c[1]]
    for name, ok, detail in checks:
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}"
              + (f" — {detail}" if detail and not ok else ""))
    print(f"serve smoke: {len(checks) - len(failed)}/{len(checks)} "
          "invariants held", file=sys.stderr)
    return 1 if failed else 0
