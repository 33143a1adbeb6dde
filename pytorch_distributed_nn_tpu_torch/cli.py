"""Command line of the port.

    python -m pytorch_distributed_nn_tpu_torch train --network ResNet18 \
        --dataset Cifar10 --batch-size 1024 --learning-rate 0.4 \
        --dtype bfloat16 --compress-grad int8 --max-steps N [--device cpu]

trains an image model of the CNN zoo, data-parallel over the torchrun
world (``torchrun --nproc-per-node N -m pytorch_distributed_nn_tpu_torch
train --num-workers N ...``; one rank without torchrun), with the JAX
package's gradient sync flags (``--sync-mode``, ``--num-aggregate``,
``--kill-ranks``, ``--compress-grad none|int8|topk``, ``--topk-ratio``,
``--bucket-kb``, ``--straggler-deadline``, ``--straggler-min-keep``,
``--bn-stats-sync``) and data flags (``--data-layout``, ``--data-dir``,
``--synthetic-size``, ``--loader-workers``: worker processes of the host
layout's loader, or the streaming loader's transform threads;
``--data-path DIR``: train from a shard directory of ``data export``,
``--stream-prefetch N`` batches ready). ``--multihost`` requires the
torchrun environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and retries the rendezvous store, as
the JAX CLI retries ``jax.distributed.initialize``; each node then reads
its own shards of ``--data-path``.

    python -m pytorch_distributed_nn_tpu_torch train --network BertBase \
        --dataset MLMSynth --optimizer adam --learning-rate 1e-4 \
        --attn-impl pallas --fused-ln --dtype bfloat16 --batch-size 16 \
        --max-steps N [--device cpu] [...]

trains a text model, data-parallel over the same world with the same
sync flags (the masked-LM loss over the global masked count). Both take
the JAX package's ``train``
flags (same names, defaults and meanings, so a command line moves across
unchanged) and run ``train()`` then ``evaluate()``. ``--attn-impl
pallas`` selects the hand-written flash kernel, ``full`` plain attention
in PyTorch; ``--fused-ln`` is accepted (the port has one LayerNorm, the
kernel). ``--eval-freq N`` checkpoints every N steps into
``--train-dir`` in the JAX package's format (``--no-async-ckpt`` writes
inline, ``--keep-last K`` keeps the newest K, ``--overlap-eval`` scores
each checkpoint on a thread); ``--resume`` continues from the newest
valid checkpoint (elastic across a changed world size;
``--strict-geometry`` raises instead); ``--supervise`` turns SIGTERM into
an emergency checkpoint and exit 0; ``--skip-nonfinite`` skips
non-finite updates; ``--faults SPEC`` injects the fault plan,
``--flightrec SPEC`` arms the flight recorder and ``--profile N`` traces
N steps with ``torch.profiler``. Training runs on the card unless
``--device cpu`` is given, and fails without one.

    python -m pytorch_distributed_nn_tpu_torch single [train flags]

is the single-machine baseline: ``train`` on one rank with no sync.

    python -m pytorch_distributed_nn_tpu_torch evaluator --model-dir DIR \
        --network BertBase --dataset MLMSynth --eval-freq N \
        [--max-evals K] [--timeout S] [--follow-latest] \
        [--attn-impl pallas --fused-ln --dtype bfloat16] [--device cpu]

polls ``DIR`` for ``model_step_<N>`` checkpoints (either package's) and
scores each on the test set, with the JAX ``evaluator``'s flags; the MLM
data flags (``--seed``, ``--seq-len``, ``--vocab-size``, ...) must match
the trainer's, and so must the model flags the port adds (``--attn-impl``,
``--fused-ln``, ``--dtype``). It prints one JSON line at the end: each
step's metrics and restore/eval times, and the kernel launch counts.

    python -m pytorch_distributed_nn_tpu_torch data export --out DIR \
        [--kind image|tokens] [--shards 8] [--dataset Cifar10] [...]
    python -m pytorch_distributed_nn_tpu_torch data info DIR

writes a shard directory (``dataset.json`` and ``shard-*.pdsr``, the JAX
package's bytes for the same flags) from an image dataset or the
synthetic token corpus, and prints a directory's manifest, with the JAX
``data`` command's flags and output. Host-side only: no card.

    python -m pytorch_distributed_nn_tpu_torch serve export --train-dir D \
        --out A [--step N] [--quantize int8] [--network NAME]

freezes the newest checkpoint of ``D`` that verifies (or step ``N``) into
the serving artifact ``A``, in the JAX package's format (its
``params.msgpack`` byte for byte), and records the step as published so
``--keep-last`` never deletes it.

    python -m pytorch_distributed_nn_tpu_torch serve run --artifact A \
        [--host 127.0.0.1] [--port 8000] [--buckets 1,2,4,8,16,32] \
        [--batch-window-ms 2] [--timeout 2] [--max-queue 1024] \
        [--serve-dir DIR] [--port-file PATH] [--device cpu]

serves a classifier or masked-LM artifact over ``POST /v1/infer`` (the
bucket-padded engine and the continuous batcher), or a causal decoder
over ``POST /v1/generate`` (``--batch-buckets`` or ``--buckets``: its
decode batch buckets), as the JAX package's ``serve run`` does. Each
served request writes one record to ``<serve-dir>/serving.jsonl``
(default ``<artifact>/serve``). SIGTERM drains: admissions stop,
in-flight requests finish, then the process exits 0.

    python -m pytorch_distributed_nn_tpu_torch serve bench --artifact A \
        [--offered 500,1000,2000] [--duration 2] [--json] [--device cpu]
    python -m pytorch_distributed_nn_tpu_torch serve smoke [--device cpu]

``bench`` is the open-loop load sweep against the engine (no HTTP):
sustained req/s, latency percentiles, achieved FLOP/s, and a failure if
anything was built after warmup; ``smoke`` is the few-second serving
gate. The serving commands run on the card unless ``--device cpu`` is
given, and fail without one. ``serve run --faults SPEC`` injects the
fault plan's serving kinds (``slow_infer``, ``conn_reset``, ``http_503``,
keyed by request count; a spec without one is refused).

The deployment lifecycle, with the JAX package's flags and refusals:
``serve run --registry R`` resolves ``--artifact`` as a version or a
label (``stable`` when omitted); ``--reload-poll S`` follows the
registry's labels (a moved ``stable`` hot-swaps, a set ``canary`` starts
a ramp; it needs ``--registry``); ``--canary SPEC`` is the ramp and gate
policy (``ramp=5:25:50,stage=200,threshold=0.5,window=400,min=50,
nonfinite=0``); ``--admin-token T`` opens ``POST /v1/admin/swap``;
``--slo SPEC`` runs the live SLO engine (status on ``GET /stats``,
``slo_breach`` events); ``--flightrec SPEC`` arms the flight recorder over
the serving stream. A generative artifact refuses ``--canary`` and
``--reload-poll`` (its admin swap is the KV-fenced direct swap).

    python -m pytorch_distributed_nn_tpu_torch serve frontend --artifact A \
        [--replicas 2] [--attach H:P,...] [--max-inflight 256] [--device D]

spawns N ``serve run`` replicas (each with ``--device D``) and routes
over them with admission control, per-replica circuit breakers, hedged
retries and zero-downtime drain; the frontend process imports no torch.

    python -m pytorch_distributed_nn_tpu_torch registry \
        {publish|list|label|rollback|gc|watch|verify} --registry R ...
    python -m pytorch_distributed_nn_tpu_torch obs \
        {summary|tail|compare|trace|bench-trend|slo|export|incidents} ...

are the registry of serving artifacts (``registry.json`` in the JAX
package's ``pdtn-registry-v1`` format; ``--selftest`` checks its
invariants) and the stream tools over ``telemetry.jsonl`` and
``serving.jsonl`` (host-side: no card).

    python -m pytorch_distributed_nn_tpu_torch sweep run --sweep-dir S \
        [--spec 'lr=0.4,0.05,0.00625'] [--scheduler grid|asha] \
        [--steps 100] [--ckpt-every N] [--concurrency 2] [--retries 1] \
        [base config flags] [--device cpu]
    python -m pytorch_distributed_nn_tpu_torch sweep \
        {status|report|resume} --sweep-dir S
    python -m pytorch_distributed_nn_tpu_torch sweep --selftest
    python -m pytorch_distributed_nn_tpu_torch tune [train flags] \
        [--candidates 0.1,0.01] [--tune-steps 100] [--device cpu]

are the JAX package's sweep orchestrator and lr grid search, with its
flags, journal (``S/sweep.jsonl``), trial directories and exit codes (0;
1 trials failed; 2 bad input or journal; 3 SIGTERM, continued by
``sweep resume``). Each trial attempt is a spawned process training the
port's ``Trainer`` on ``--device`` (default: the card); the orchestrating
process imports no torch. ``sweep run`` adds ``--compress-grad`` to the
JAX base flags; ``--plan-mesh N`` plans each network's mesh for N
devices in a spawned subprocess (the roofline planner, ``analyze
--plan``).

    python -m pytorch_distributed_nn_tpu_torch fleet agent \
        [--listen HOST:PORT] [--devices N] [--device cuda|cpu] ...
    python -m pytorch_distributed_nn_tpu_torch fleet run --sweep-dir S \
        [--agents 3] [--agent-devices 4,2,2] [--lease 10] \
        [sweep flags] [--device cpu] [--resume]
    python -m pytorch_distributed_nn_tpu_torch fleet \
        {status --sweep-dir S|agents --hosts H:P,...|drain --hosts ...}
    python -m pytorch_distributed_nn_tpu_torch fleet --selftest

are the JAX package's fleet: the same sweep over host agents that take
trials over JSON lines on TCP, with its flags, journal events and exit
codes (3: interrupted, or every host dead, with the resume recipe). An
agent of ``--device cuda --devices N`` runs its trials on N cards of
its own (a trial of several ranks is that many rank processes, rank r
on the r-th card); ``--device cpu`` on gloo rank processes. The
orchestrator and the agents import no torch; ``--plan-hosts`` plans
each host's mesh in a spawned subprocess and caches the plan.

    python -m pytorch_distributed_nn_tpu_torch analyze [--model M] \
        [--mesh 4x2] [--cost] [--json] [--device cpu]
    python -m pytorch_distributed_nn_tpu_torch analyze --plan \
        --model M --devices N [--validate] [--calibration F] [--device cpu]
    python -m pytorch_distributed_nn_tpu_torch analyze --calibrate \
        [--trace DIR --trace-steps K] [--microbench] [--out F]

is the JAX ``analyze`` by a walk of the step's dispatched operations on
the meta device (:mod:`.analysis.costmodel`; no card for the walk):
the collective inventory and step cost of a mesh, the mesh planner and
the roofline calibration. ``--validate`` and ``--microbench`` run on the
card unless ``--device cpu``; the HLO auditor's flags exit 2.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
from typing import Optional, Sequence



def _buckets(text: Optional[str]):
    return tuple(int(b) for b in text.split(",")) if text else None


def _serve_loop(server, port_file: Optional[str] = None) -> None:
    """Run ``server`` until SIGTERM or SIGINT. SIGTERM drains: /readyz
    flips 503, admissions stop, in-flight requests finish (30 s at most),
    then the listener closes. With ``port_file`` the bound port is
    written there first."""
    if port_file:
        with open(port_file + ".tmp", "w") as f:
            f.write(str(server.port))
        os.replace(port_file + ".tmp", port_file)
    stop, drain = threading.Event(), threading.Event()

    def _on_term(signum, frame):
        drain.set()
        stop.set()

    prev_term = signal.signal(signal.SIGTERM, _on_term)
    prev_int = signal.signal(signal.SIGINT, lambda s, f: stop.set())
    server.start()
    try:
        while not stop.wait(0.2):
            pass
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)
    if drain.is_set():
        print("SIGTERM: draining — admissions stopped, finishing in-flight "
              "requests", file=sys.stderr)
        clean = server.drain_and_close(timeout=30.0)
        print(f"drain {'complete' if clean else 'TIMED OUT'}; exiting",
              file=sys.stderr)
    else:
        server.close()


def _fault_injector(plan, telemetry, engine):
    """The serving fault injector of ``plan`` (None without one), its
    ``slow_infer`` wrapped around the engine's single-pass ``infer``
    (a generative engine has none)."""
    if plan is None:
        return None
    from pytorch_distributed_nn_tpu_torch.serving.faultinject import (
        ServingFaultInjector,
    )

    injector = ServingFaultInjector(plan, telemetry=telemetry)
    if hasattr(engine, "infer"):
        injector.attach_engine(engine)
    return injector


def _serve_run(args) -> int:
    from pytorch_distributed_nn_tpu_torch.models import is_generative_model
    from pytorch_distributed_nn_tpu_torch.observability.detect import (
        DetectorSpec,
    )
    from pytorch_distributed_nn_tpu_torch.observability.slo import (
        SLOEngine,
        parse_slos,
    )
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        load_manifest,
    )
    from pytorch_distributed_nn_tpu_torch.serving.loadgen import (
        serving_telemetry,
    )
    from pytorch_distributed_nn_tpu_torch.serving.router import CanaryPolicy
    from pytorch_distributed_nn_tpu_torch.serving.server import ServingServer

    # every spec is parsed before the engine pays its warmup
    try:
        slos = parse_slos(args.slo) if args.slo else None
        frspec = (DetectorSpec.parse(args.flightrec) if args.flightrec
                  else None)
        policy = CanaryPolicy.parse(args.canary, slo=args.slo)
    except ValueError as e:
        print(f"serve run: {e}", file=sys.stderr)
        return 2
    fault_plan = None
    if args.faults:
        from pytorch_distributed_nn_tpu_torch.resilience.faults import (
            FaultPlan,
        )

        try:
            fault_plan = FaultPlan.parse(args.faults)
            if not fault_plan.has_serving_faults():
                raise ValueError(
                    f"--faults {args.faults!r} has no serving-side "
                    "entries (slow_infer/conn_reset/http_503) — nothing "
                    "would ever fire on the request path")
        except ValueError as e:
            print(f"serve run: {e}", file=sys.stderr)
            return 2
    registry, artifact = None, args.artifact
    if args.registry:
        from pytorch_distributed_nn_tpu_torch.serving.registry import (
            Registry,
            RegistryError,
        )

        registry = Registry(args.registry)
        try:
            # a version id or a label; omitted: the stable label
            if artifact is None:
                artifact = registry.resolve("stable")["artifact"]
            elif not os.path.isdir(artifact):
                artifact = registry.resolve(artifact)["artifact"]
        except RegistryError as e:
            print(f"serve run: {e}", file=sys.stderr)
            return 2
    elif artifact is None:
        print("serve run: --artifact is required without --registry",
              file=sys.stderr)
        return 2
    if args.reload_poll is not None and registry is None:
        print("serve run: --reload-poll needs --registry", file=sys.stderr)
        return 2
    generative = is_generative_model(
        load_manifest(artifact).get("network", ""))
    if generative and (args.canary or args.reload_poll is not None):
        print("serve run: canary/label-follow is not wired for generative "
              "artifacts — use /v1/admin/swap (KV-fenced hot swap)",
              file=sys.stderr)
        return 2
    max_queue = args.max_queue if args.max_queue > 0 else None
    serve_dir = args.serve_dir or os.path.join(artifact, "serve")
    os.makedirs(serve_dir, exist_ok=True)
    buckets = _buckets(args.buckets or args.batch_buckets)
    kw = {"batch_buckets": buckets} if buckets else {}
    extra = {"slo": args.slo} if args.slo else {}
    closers = []  # closed in reverse order after the serve loop
    if generative:
        from pytorch_distributed_nn_tpu_torch.serving.generate import (
            GenerateScheduler,
            GenerativeEngine,
        )

        engine = GenerativeEngine(artifact, device=args.device, **kw)
        engine.warmup()
        telemetry = serving_telemetry(serve_dir, engine,
                                      extra={"generative": True, **extra})
        closers.append(telemetry)
        slo_engine = (SLOEngine(slos, telemetry=telemetry)
                      if slos is not None else None)
        closers.append(slo_engine)
        faults = _fault_injector(fault_plan, telemetry, engine)
        sched = GenerateScheduler(engine, telemetry=telemetry,
                                  default_timeout_s=args.timeout,
                                  max_queue=max_queue)
        closers.append(sched)
        server = ServingServer(engine, None, host=args.host, port=args.port,
                               slo=slo_engine, admin_token=args.admin_token,
                               generator=sched, faults=faults)
        what = "GENERATIVE "
    else:
        from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
        from pytorch_distributed_nn_tpu_torch.serving.engine import (
            InferenceEngine,
        )
        from pytorch_distributed_nn_tpu_torch.serving.router import (
            CanaryRouter,
            RegistryWatcher,
        )

        engine = InferenceEngine(artifact, device=args.device, **kw)
        engine.warmup()
        telemetry = serving_telemetry(serve_dir, engine, extra=extra)
        closers.append(telemetry)
        slo_engine = (SLOEngine(slos, telemetry=telemetry)
                      if slos is not None else None)
        closers.append(slo_engine)
        recorder = None
        if frspec is not None:
            from pytorch_distributed_nn_tpu_torch.observability.flightrec \
                import FlightRecorder

            recorder = FlightRecorder(serve_dir, telemetry, frspec)
            closers.append(recorder)
        faults = _fault_injector(fault_plan, telemetry, engine)
        batcher = Batcher(
            engine, telemetry=telemetry,
            batch_window_s=args.batch_window_ms / 1000.0,
            default_timeout_s=args.timeout, max_queue=max_queue,
            # the flight recorder opens and closes captures at batch
            # boundaries (request ids as its steps)
            on_batch=recorder.tick if recorder is not None else None)
        closers.append(batcher)
        router = CanaryRouter(batcher, telemetry=telemetry,
                              registry=registry, policy=policy)
        closers.append(router)
        if args.reload_poll is not None:
            watcher = RegistryWatcher(registry, router,
                                      poll_s=args.reload_poll)
            watcher.start()
            closers.append(watcher)
        server = ServingServer(engine, router, host=args.host,
                               port=args.port, slo=slo_engine,
                               router=router, admin_token=args.admin_token,
                               faults=faults)
        what = ""
    print(f"serving {what}{artifact} on "
          f"http://{server.host}:{server.port} ({engine.device}; stream: "
          f"{serve_dir})", file=sys.stderr)
    if registry is not None:
        print(f"registry: {args.registry}"
              + (f" (label follow every {args.reload_poll:g}s)"
                 if args.reload_poll is not None else ""), file=sys.stderr)
    try:
        _serve_loop(server, port_file=args.port_file)
    finally:
        for obj in reversed(closers):
            if obj is not None:
                obj.close()
    return 0


def _serve_frontend(args) -> int:
    """``serve frontend``: the replicated frontend over spawned ``serve
    run`` replicas (or attached ones). SIGTERM drains every replica before
    exiting; SIGINT stops at once. Imports no torch."""
    from pytorch_distributed_nn_tpu_torch.serving.frontend import (
        Frontend,
        frontend_telemetry,
    )

    workdir = args.workdir or os.path.join(args.artifact, "frontend")
    serve_dir = args.serve_dir or os.path.join(workdir, "serve")
    telemetry = frontend_telemetry(serve_dir, extra={
        "artifact": args.artifact,
        "replicas": args.replicas if not args.attach else None,
        "attach": args.attach,
        "max_inflight": args.max_inflight,
        "device": args.device,
    })
    fe = Frontend(
        workdir, telemetry=telemetry, host=args.host, port=args.port,
        timeout_s=args.timeout,
        max_inflight=args.max_inflight if args.max_inflight > 0 else None,
        retries=args.retries, hedge_ms=args.hedge_ms,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown,
        lease_s=args.lease, poll_s=args.poll,
        replica_max_queue=(args.replica_max_queue
                           if args.replica_max_queue > 0 else None),
        device=args.device)
    try:
        if args.attach:
            for i, hp in enumerate(args.attach.split(",")):
                host, port = hp.rsplit(":", 1)
                fe.attach_replica(f"r{i}", host, int(port))
        else:
            for i in range(args.replicas):
                fe.spawn_replica(f"r{i}", args.artifact)
        fe.start()
        fe.wait_ready()
    except Exception as e:
        print(f"serve frontend: {e}", file=sys.stderr)
        fe.close()
        telemetry.close()
        return 1
    print(f"frontend on http://{fe.host}:{fe.port} — {len(fe.replicas)} "
          f"replica(s) ready (stream: {serve_dir})", file=sys.stderr)
    if args.port_file:
        with open(args.port_file + ".tmp", "w") as f:
            f.write(str(fe.port))
        os.replace(args.port_file + ".tmp", args.port_file)
    stop, drain = threading.Event(), threading.Event()

    def _on_term(signum, frame):
        drain.set()
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, lambda s, f: stop.set())
    try:
        while not stop.wait(0.2):
            pass
    finally:
        if drain.is_set():
            print("SIGTERM: draining replicas", file=sys.stderr)
        fe.close(stop_replicas=not args.attach, drain=drain.is_set())
        telemetry.close()
    return 0


def _serve(args) -> int:
    if args.serve_cmd == "frontend":
        return _serve_frontend(args)
    if args.serve_cmd == "smoke":
        from pytorch_distributed_nn_tpu_torch.serving.loadgen import smoke

        return smoke(keep_dir=args.keep, device=args.device)
    if args.serve_cmd == "export":
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            export_artifact,
        )

        m = export_artifact(args.train_dir, args.out, step=args.step,
                            quantize=args.quantize, network=args.network,
                            num_classes=args.num_classes)
        print(f"exported step {m['source']['step']} of {args.train_dir} -> "
              f"{args.out} ({m['quantize']}, {m['param_count']} params, "
              f"{m['bytes'] / 1e3:.1f} KB)")
        return 0
    if args.serve_cmd == "bench":
        import json

        from pytorch_distributed_nn_tpu_torch.serving.loadgen import sweep

        rec = sweep(
            args.artifact,
            offered=tuple(float(r) for r in args.offered.split(",")),
            duration_s=args.duration,
            out_dir=args.out or os.path.join(args.artifact, "bench"),
            batch_buckets=_buckets(args.buckets),
            batch_window_s=args.batch_window_ms / 1000.0,
            timeout_s=args.timeout,
            max_queue=args.max_queue if args.max_queue > 0 else None,
            device=args.device,
            log=lambda msg: print(msg, file=sys.stderr))
        if args.json:
            print(json.dumps(rec))
        else:
            print(f"retraces after warmup: {rec['retraces_after_warmup']} "
                  f"(stream: {rec['stream']})")
        return 0
    return _serve_run(args)


def _add_serve_flags(serve: argparse.ArgumentParser) -> None:
    """``serve export | run | bench | smoke | frontend`` with the JAX
    package's flags and defaults, and the port's ``--device``."""
    ssub = serve.add_subparsers(dest="serve_cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs "
                             "the kernels' plain versions)")

    pe = ssub.add_parser("export", help="freeze a checkpoint into an "
                                        "inference artifact")
    pe.add_argument("--train-dir", required=True)
    pe.add_argument("--out", required=True, metavar="DIR")
    pe.add_argument("--step", type=int, default=None,
                    help="checkpoint step to freeze (default: the newest "
                         "step that verifies)")
    pe.add_argument("--quantize", choices=["none", "int8"], default="none")
    pe.add_argument("--network", default=None,
                    help="model architecture (default: sniffed from the "
                         "run's telemetry manifest)")
    pe.add_argument("--num-classes", type=int, default=None)

    def engine_flags(sp, artifact_required=True):
        sp.add_argument("--artifact", required=artifact_required,
                        metavar="DIR",
                        help="artifact directory (serve run with "
                             "--registry: also a version id or label)")
        sp.add_argument("--buckets", default=None, metavar="B1,B2,...",
                        help="batch buckets requests are padded up to "
                             "(default 1,2,4,8,16,32; a decoder's: its "
                             "decode batch buckets), all run at startup")
        sp.add_argument("--batch-window-ms", type=float, default=2.0)
        sp.add_argument("--timeout", type=float, default=2.0,
                        help="default request deadline, seconds")
        sp.add_argument("--max-queue", type=int, default=1024,
                        help="admission bound (429 past it); 0 = unbounded")
        device(sp)

    run = ssub.add_parser("run", help="serve an artifact over HTTP")
    engine_flags(run, artifact_required=False)
    run.add_argument("--host", default="127.0.0.1")
    run.add_argument("--port", type=int, default=8000)
    run.add_argument("--batch-buckets", default=None,
                     help="a decoder's decode batch buckets (--buckets)")
    run.add_argument("--serve-dir", default=None, metavar="DIR",
                     help="serving.jsonl goes here (default "
                          "<artifact>/serve)")
    run.add_argument("--port-file", default=None, metavar="FILE",
                     help="write the bound port here (use with --port 0)")
    run.add_argument("--faults", default=None, metavar="SPEC",
                     help="inject serving faults (slow_infer, conn_reset, "
                          "http_503; keyed by request count)")
    run.add_argument("--registry", default=None, metavar="DIR",
                     help="model registry: resolves --artifact by version "
                          "or label (default: the 'stable' label) and "
                          "takes the router's label moves")
    run.add_argument("--reload-poll", type=float, default=None,
                     metavar="SECS",
                     help="with --registry: follow its labels (a moved "
                          "'stable' hot-swaps, a set 'canary' starts a "
                          "ramp)")
    run.add_argument("--canary", default=None, metavar="SPEC",
                     help="canary policy, e.g. 'ramp=5:25:50,stage=200,"
                          "threshold=0.5,window=400,min=50,nonfinite=0'")
    run.add_argument("--admin-token", default=None, metavar="TOKEN",
                     help="enable POST /v1/admin/swap (X-Admin-Token); "
                          "without it the endpoint always answers 403")
    run.add_argument("--slo", default=None, metavar="SPEC",
                     help="live SLO objectives, e.g. "
                          "'lat_p99<25ms@60s,avail>99.5%%@300s'")
    run.add_argument("--flightrec", default=None, metavar="SPEC",
                     help="arm the flight recorder over the serving "
                          "stream ('default' arms every detector)")

    pb = ssub.add_parser("bench", help="open-loop load sweep against an "
                                       "artifact (no HTTP)")
    engine_flags(pb)
    pb.add_argument("--offered", default="500,1000,2000",
                    metavar="R1,R2,...")
    pb.add_argument("--duration", type=float, default=2.0,
                    help="seconds per offered rate")
    pb.add_argument("--out", default=None, metavar="DIR",
                    help="serving.jsonl goes here (default "
                         "<artifact>/bench)")
    pb.add_argument("--json", action="store_true",
                    help="print the result record as JSON on stdout")

    psm = ssub.add_parser("smoke", help="the few-second serving gate")
    psm.add_argument("--keep", default=None, metavar="DIR",
                     help="run under this dir and keep what it writes")
    device(psm)

    pfe = ssub.add_parser(
        "frontend", help="replicated frontend over N serve run replicas: "
                         "admission control, circuit breakers, hedged "
                         "retries, zero-downtime drain (imports no torch)")
    a = pfe.add_argument
    a("--artifact", required=True, metavar="DIR")
    a("--replicas", type=int, default=2,
      help="local replica servers to spawn")
    a("--attach", default=None, metavar="H:P,H:P",
      help="attach to running replica servers instead of spawning")
    a("--host", default="127.0.0.1")
    a("--port", type=int, default=8000)
    a("--workdir", default=None, metavar="DIR",
      help="replica workdirs and logs (default <artifact>/frontend)")
    a("--serve-dir", default=None, metavar="DIR",
      help="the frontend's serving.jsonl (default <workdir>/serve)")
    a("--timeout", type=float, default=5.0,
      help="default request deadline, seconds")
    a("--max-inflight", type=int, default=256,
      help="forwards in flight past it are shed with 429; 0 = unbounded")
    a("--retries", type=int, default=2,
      help="extra attempts (hedge included) on other replicas")
    a("--hedge-ms", type=float, default=None,
      help="fixed hedge delay; default: observed p95, floored at 25 ms")
    a("--breaker-threshold", type=int, default=3)
    a("--breaker-cooldown", type=float, default=2.0)
    a("--lease", type=float, default=2.0,
      help="readiness lease: a replica unreachable past it is down")
    a("--poll", type=float, default=0.2,
      help="readiness poll interval, seconds")
    a("--replica-max-queue", type=int, default=256,
      help="--max-queue of each spawned replica")
    a("--port-file", default=None, metavar="FILE",
      help="write the bound port here once the pool is ready")
    device(pfe)


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    """The JAX package's ``train`` flags (``cli.py``), every one of them:
    the trainer runs a subset and raises on the rest."""
    a = p.add_argument
    a("--batch-size", type=int, default=128)
    a("--test-batch-size", type=int, default=1000)
    a("--learning-rate", "--lr", dest="lr", type=float, default=0.01)
    a("--lr-decay-steps", type=int, default=None)
    a("--lr-decay-factor", type=float, default=0.1)
    a("--warmup-steps", type=int, default=0)
    a("--momentum", type=float, default=0.9)
    a("--optimizer", choices=["sgd", "adam"], default="sgd")
    a("--weight-decay", type=float, default=0.0)
    a("--nesterov", action="store_true")
    a("--max-steps", type=int, default=None)
    a("--epochs", type=int, default=1)
    a("--network", default="ResNet18")
    a("--dataset", default="Cifar10",
      choices=["MNIST", "Cifar10", "Cifar100", "SVHN", "MLMSynth"])
    a("--seq-len", type=int, default=None)
    a("--vocab-size", type=int, default=None)
    a("--mask-prob", type=float, default=0.15)
    a("--corpus-branching", type=int, default=8)
    a("--eval-batches", type=int, default=64)
    a("--attn-impl", choices=["full", "pallas"], default="full",
      help="pallas = the hand-written flash-attention kernel")
    a("--remat", action="store_true")
    a("--fused-ln", action="store_true",
      help="accepted: the port's one LayerNorm is the kernel")
    a("--eval-freq", type=int, default=0)
    a("--async-ckpt", action=argparse.BooleanOptionalAction, default=True)
    a("--keep-last", type=int, default=None)
    a("--overlap-eval", action="store_true")
    a("--train-dir", default="./train_dir")
    a("--resume", action="store_true")
    a("--strict-geometry", action="store_true")
    a("--warm-start", default=None)
    a("--seed", type=int, default=0)
    a("--dtype", choices=["float32", "bfloat16"], default="float32")
    a("--data-dir", default="./data")
    a("--data-layout", choices=["auto", "device", "host"], default="auto")
    a("--loader-workers", type=int, default=0)
    a("--data-path", default=None)
    a("--stream-prefetch", type=int, default=2)
    a("--synthetic-size", type=int, default=None)
    a("--metrics-path", default=None,
      help="append one JSON record per step (and the eval) here")
    a("--log-every", type=int, default=1)
    a("--bn-stats-sync", choices=["mean", "rank0"], default="mean")
    a("--grad-accum", type=int, default=1)
    a("--profile", type=int, default=0)
    a("--profile-dir", default=None)
    a("--faults", default=None)
    a("--skip-nonfinite", action="store_true")
    a("--supervise", action="store_true")
    a("--heartbeat-grace", type=float, default=None)
    a("--flightrec", default=None)
    a("--num-workers", type=int, default=None)
    a("--tensor-parallel", type=int, default=1)
    a("--seq-parallel", type=int, default=1)
    a("--seq-attn", choices=["ring", "ulysses"], default="ring")
    a("--sync-mode", choices=["allreduce", "ps"], default="allreduce")
    a("--num-aggregate", type=int, default=None)
    a("--kill-ranks", default=None)
    a("--straggler-deadline", type=float, default=None)
    a("--straggler-min-keep", type=int, default=1)
    a("--compress-grad", choices=["none", "int8", "topk"], default="none")
    a("--topk-ratio", type=float, default=0.01)
    a("--bucket-kb", type=int, default=None)
    a("--multihost", action="store_true")
    a("--device", default=None,
      help="torch device (default: the card; 'cpu' runs the kernels' "
           "plain versions)")


def train_config(args):
    """The ``TrainConfig`` of parsed ``train`` flags, as the JAX CLI
    builds it."""
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    return TrainConfig(
        network=args.network, dataset=args.dataset,
        batch_size=args.batch_size, test_batch_size=args.test_batch_size,
        lr=args.lr, lr_decay_steps=args.lr_decay_steps,
        lr_decay_factor=args.lr_decay_factor,
        warmup_steps=args.warmup_steps, momentum=args.momentum,
        optimizer=args.optimizer, weight_decay=args.weight_decay,
        nesterov=args.nesterov, max_steps=args.max_steps,
        epochs=args.epochs, num_workers=args.num_workers,
        sync_mode=args.sync_mode, num_aggregate=args.num_aggregate,
        kill_ranks=tuple(int(r) for r in args.kill_ranks.split(","))
        if args.kill_ranks else (),
        compression=args.compress_grad, grad_accum=args.grad_accum,
        topk_ratio=args.topk_ratio,
        bucket_bytes=args.bucket_kb * 1024 if args.bucket_kb else None,
        eval_freq=args.eval_freq, train_dir=args.train_dir,
        async_ckpt=args.async_ckpt, keep_last=args.keep_last,
        overlap_eval=args.overlap_eval, resume=args.resume,
        strict_geometry=args.strict_geometry, warm_start=args.warm_start,
        seed=args.seed, bn_stats_sync=args.bn_stats_sync, dtype=args.dtype,
        data_layout=args.data_layout, loader_workers=args.loader_workers,
        data_path=args.data_path, stream_prefetch=args.stream_prefetch,
        data_dir=args.data_dir, synthetic_size=args.synthetic_size,
        metrics_path=args.metrics_path, log_every=args.log_every,
        profile_steps=args.profile, profile_dir=args.profile_dir,
        seq_len=args.seq_len, vocab_size=args.vocab_size,
        mask_prob=args.mask_prob, corpus_branching=args.corpus_branching,
        eval_batches=args.eval_batches, attn_impl=args.attn_impl,
        remat=args.remat, fused_ln=args.fused_ln,
        tensor_parallel=args.tensor_parallel,
        seq_parallel=args.seq_parallel, seq_attn=args.seq_attn,
        faults=args.faults, skip_nonfinite=args.skip_nonfinite,
        straggler_deadline=args.straggler_deadline,
        straggler_min_keep=args.straggler_min_keep,
        supervise=args.supervise, heartbeat_grace=args.heartbeat_grace,
        flightrec=args.flightrec,
    )


def _train(args) -> int:
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    if args.cmd == "single":  # the JAX main_single: one rank, no sync
        args.sync_mode, args.num_workers = "local", 1
    trainer = Trainer(train_config(args), device=args.device,
                      multihost=args.multihost)
    try:
        trainer.train()
        trainer.evaluate()
    finally:
        trainer.close()
    return 0


def _add_evaluator_flags(p: argparse.ArgumentParser) -> None:
    """The JAX ``evaluator``'s flags, and the model flags of the port's
    forward (``--attn-impl``, ``--fused-ln``, ``--dtype``, ``--device``)."""
    a = p.add_argument
    a("--model-dir", required=True)
    a("--network", default="ResNet18")
    a("--dataset", default="Cifar10",
      choices=["MNIST", "Cifar10", "Cifar100", "SVHN", "MLMSynth"])
    a("--eval-freq", type=int, default=100)
    a("--eval-interval", type=float, default=10.0,
      help="poll period in seconds")
    a("--test-batch-size", type=int, default=1000)
    a("--max-evals", type=int, default=None)
    a("--timeout", type=float, default=None)
    a("--follow-latest", action="store_true")
    a("--data-dir", default="./data")
    a("--data-layout", choices=["auto", "device", "host"], default="auto")
    a("--synthetic-size", type=int, default=None)
    a("--seed", type=int, default=0,
      help="MLM: must match the trainer's --seed (same corpus)")
    a("--seq-len", type=int, default=None)
    a("--vocab-size", type=int, default=None)
    a("--mask-prob", type=float, default=0.15)
    a("--corpus-branching", type=int, default=8)
    a("--eval-batches", type=int, default=64)
    a("--attn-impl", choices=["full", "pallas"], default="full",
      help="text models: the trainer's --attn-impl")
    a("--fused-ln", action="store_true")
    a("--dtype", choices=["float32", "bfloat16"], default="float32")
    a("--device", default=None,
      help="torch device (default: the card; 'cpu' runs the kernels' "
           "plain versions)")


def _evaluator(args) -> int:
    import json

    from pytorch_distributed_nn_tpu_torch.data.datasets import load_dataset
    from pytorch_distributed_nn_tpu_torch.data.loader import (
        DataLoader,
        DeviceDataLoader,
    )
    from pytorch_distributed_nn_tpu_torch.data.text import (
        MLMBatches,
        MLMLoader,
    )
    from pytorch_distributed_nn_tpu_torch.models import (
        input_spec,
        is_text_model,
    )
    from pytorch_distributed_nn_tpu_torch.ops import kernels
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
    from pytorch_distributed_nn_tpu_torch.training.evaluator import Evaluator
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        create_train_state,
    )
    from pytorch_distributed_nn_tpu_torch.training.trainer import (
        build_train_model,
    )
    from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    device = resolve_device(args.device)
    text = is_text_model(args.network)
    cfg = TrainConfig(network=args.network, dataset=args.dataset,
                      seed=args.seed, seq_len=args.seq_len,
                      vocab_size=args.vocab_size, dtype=args.dtype,
                      attn_impl=args.attn_impl if text else "full",
                      fused_ln=args.fused_ln and text)
    # the trainer's model of these flags, on an SGD template (the
    # evaluator restores parameters and statistics only)
    model = build_train_model(cfg)
    state = create_train_state(
        model, lambda p: build_optimizer("sgd", p, 0.1), device)
    bs = args.test_batch_size
    if text:
        seq_len = args.seq_len or input_spec(args.network)[0]
        loader = MLMLoader(
            MLMBatches(vocab_size=model.config.vocab_size, seq_len=seq_len,
                       batch_size=bs, seed=args.seed + 10_000,
                       corpus_seed=args.seed, mask_prob=args.mask_prob,
                       branching=args.corpus_branching),
            device, eval_batches=args.eval_batches)
    else:
        test_ds = load_dataset(args.dataset, train=False,
                               data_dir=args.data_dir,
                               synthetic_size=args.synthetic_size)
        bs = min(bs, len(test_ds))
        on_device = args.data_layout == "device" or (
            args.data_layout == "auto"
            and test_ds.raw_images.nbytes < 2 << 30)
        loader = (DeviceDataLoader(test_ds, bs, device, shuffle=False)
                  if on_device else
                  DataLoader(test_ds, bs, shuffle=False, prefetch=0,
                             device=device))
    evaluator = Evaluator(state, loader, args.model_dir,
                          eval_freq=args.eval_freq,
                          eval_interval=args.eval_interval,
                          follow_latest=args.follow_latest)
    results = {}
    kernels.reset_launch_counts()
    try:
        evaluator.run(max_evals=args.max_evals, timeout=args.timeout,
                      on_metrics=lambda step, m: results.__setitem__(
                          step, {**m, **evaluator.timings[step]}))
    finally:
        loader.close()
    print(json.dumps({"evaluated": {str(k): v for k, v in results.items()},
                      "eval_batches": args.eval_batches if text else None,
                      "launches": kernels.launch_counts()}), flush=True)
    return 0


def _add_data_flags(p: argparse.ArgumentParser) -> None:
    """The JAX ``data`` command's subcommands and flags."""
    sub = p.add_subparsers(dest="data_cmd", required=True)
    pe = sub.add_parser(
        "export", help="write a shard directory from an in-memory dataset")
    a = pe.add_argument
    a("--out", required=True, metavar="DIR",
      help="shard directory to write (dataset.json + shard-*.pdsr)")
    a("--kind", choices=["image", "tokens"], default="image")
    a("--shards", type=int, default=8,
      help="number of shard files (>= the host count the training run "
           "will use)")
    a("--dataset", default="Cifar10",
      choices=["MNIST", "Cifar10", "Cifar100", "SVHN"],
      help="image kind: which dataset to export")
    a("--data-dir", default="./data")
    a("--synthetic-size", type=int, default=None,
      help="image kind: force synthetic data of this size")
    a("--split", choices=["train", "test"], default="train")
    a("--sequences", type=int, default=4096,
      help="tokens kind: number of sequences to draw")
    a("--vocab-size", type=int, default=1024)
    a("--corpus-branching", type=int, default=8)
    a("--min-len", type=int, default=16)
    a("--max-len", type=int, default=128)
    a("--seed", type=int, default=0)
    pi = sub.add_parser("info", help="print a shard directory's manifest")
    pi.add_argument("path")


def _data(args) -> int:
    """``data export`` and ``data info``: host-side numpy, no card."""
    import json

    from pytorch_distributed_nn_tpu_torch.data.streaming import (
        export_image_dataset,
        export_text_corpus,
        load_meta,
    )

    if args.data_cmd == "info":
        print(json.dumps(load_meta(args.path), indent=2, sort_keys=True))
        return 0
    if args.kind == "image":
        from pytorch_distributed_nn_tpu_torch.data.datasets import (
            load_dataset,
        )

        ds = load_dataset(args.dataset, train=args.split == "train",
                          data_dir=args.data_dir,
                          synthetic_size=args.synthetic_size)
        meta = export_image_dataset(ds, args.out, shards=args.shards)
    else:
        meta = export_text_corpus(
            args.out, shards=args.shards, sequences=args.sequences,
            vocab_size=args.vocab_size, branching=args.corpus_branching,
            min_len=args.min_len, max_len=args.max_len, seed=args.seed)
    print(f"wrote {len(meta['shards'])} shard(s), "
          f"{meta['num_records']} records to {args.out}")
    return 0


def main_registry(argv: Optional[Sequence[str]] = None) -> int:
    """Model registry (serving/registry.py): versioned serving artifacts
    with labels and rollback, in the JAX package's ``registry.json``.

    - ``publish``  — register an exported artifact (CRC-verified; torn
      artifacts are refused) under its immutable version id
      ``<train_dir>@<step>:<quantize>``, optionally labeling it.
    - ``list``     — entries with their labels.
    - ``label``    — atomically point ``stable``/``canary`` at a version
      (``-`` clears the label).
    - ``rollback`` — restore a label's previous holder (the operator
      undo; the canary router calls the same primitive automatically).
    - ``gc``       — retire entries that are neither labeled nor among
      the newest K and RELEASE their checkpoint protection in the source
      train_dir's ``published.json``.
    - ``watch``    — poll a directory for new exports and publish them
      (the reference evaluator's NFS loop, pointed at exports).
    - ``verify``   — CRC-check one entry end to end.
    - ``--selftest`` — the registry's invariants in about a second.

    Host-side json/os: no card.
    """
    argv = list(argv) if argv is not None else sys.argv[1:]
    if "--selftest" in argv:
        from pytorch_distributed_nn_tpu_torch.serving.registry import selftest

        return selftest()

    import json as _json

    from pytorch_distributed_nn_tpu_torch.serving.registry import (
        Registry,
        RegistryError,
        render_entries,
    )

    p = argparse.ArgumentParser(
        "pdtn-registry", description=main_registry.__doc__
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def _add(name, help):
        sp = sub.add_parser(name, help=help)
        sp.add_argument("--registry", required=True, metavar="DIR",
                        help="registry root (registry.json lives here)")
        return sp

    pp = _add("publish", "register an exported artifact")
    pp.add_argument("--artifact", required=True, metavar="DIR")
    pp.add_argument("--label", default=None, metavar="L1,L2",
                    help="also point these labels (stable,canary) at it")
    pl = _add("list", "entries + labels")
    pl.add_argument("--json", action="store_true")
    pla = _add("label", "atomically move a label")
    pla.add_argument("name", choices=["stable", "canary"])
    pla.add_argument("version",
                     help="version id to point the label at ('-' clears)")
    prb = _add("rollback", "restore a label's previous holder")
    prb.add_argument("--label", default="stable",
                     choices=["stable", "canary"])
    pg = _add("gc", "retire unlabeled old entries + release their "
                    "checkpoint protection")
    pg.add_argument("--keep-last", type=int, required=True, metavar="K")
    pg.add_argument("--delete-artifacts", action="store_true",
                    help="also remove the retired artifact directories")
    pg.add_argument("--json", action="store_true")
    pw = _add("watch", "poll a directory for new exports")
    pw.add_argument("--dir", required=True, metavar="DIR",
                    help="directory whose child artifact dirs are "
                         "published as they appear")
    pw.add_argument("--label", default=None, metavar="L1,L2",
                    help="labels for every picked-up export (e.g. "
                         "'stable' to make publishing deploy)")
    pw.add_argument("--interval", type=float, default=5.0, metavar="SECS")
    pw.add_argument("--max-polls", type=int, default=None,
                    help="stop after N polls (default: forever)")
    pv = _add("verify", "CRC-check one entry")
    pv.add_argument("version")
    args = p.parse_args(argv)

    reg = Registry(args.registry)
    labels = tuple(
        s for s in (getattr(args, "label", None) or "").split(",") if s
    ) if getattr(args, "label", None) else ()
    try:
        if args.cmd == "publish":
            entry = reg.publish(args.artifact, labels=labels)
            print(f"published {entry['version']} -> {entry['artifact']}"
                  + (f" labels={list(labels)}" if labels else ""))
        elif args.cmd == "list":
            doc = reg.load()
            print(_json.dumps(doc, indent=2, sort_keys=True)
                  if args.json else render_entries(doc))
        elif args.cmd == "label":
            version = None if args.version == "-" else args.version
            print(reg.label(args.name, version))
        elif args.cmd == "rollback":
            frm, to = reg.rollback(args.label)
            print(f"rolled back {args.label}: {frm} -> {to}")
        elif args.cmd == "gc":
            res = reg.gc(args.keep_last,
                         delete_artifacts=args.delete_artifacts)
            print(_json.dumps(res) if args.json else
                  f"retired {len(res['retired'])} entr(ies) "
                  f"{res['retired']}; kept {res['kept']}")
        elif args.cmd == "watch":
            import time as _time

            polls = 0
            while args.max_polls is None or polls < args.max_polls:
                if polls:
                    _time.sleep(args.interval)
                polls += 1
                for entry in reg.scan_dir(args.dir, labels=labels):
                    print(f"picked up {entry['version']} "
                          f"({entry['artifact']})")
        elif args.cmd == "verify":
            ok, reason = reg.verify(args.version)
            print(f"{args.version}: {'OK' if ok else 'FAIL'} — {reason}")
            return 0 if ok else 1
    except RegistryError as e:
        print(f"registry: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        pass
    return 0


def main_tune(argv: Optional[Sequence[str]] = None) -> int:
    """LR grid search (reference: src/tune.sh + src/tiny_tuning_parser.py),
    a shim over the sweep runner: candidates run as spawned subprocesses
    under a bounded pool on ``--device`` (default: the card), every trial
    writes a telemetry stream, and the sweep is journaled under
    ``<train-dir>/lr_sweep`` — a killed tune continues where it stopped.
    ``sweep`` is the full surface (ASHA scheduler, arbitrary fields).
    """
    p = argparse.ArgumentParser("pdtn-tune", description=main_tune.__doc__)
    _add_train_flags(p)
    p.add_argument("--candidates", default=None,
                   help="comma-separated lr candidates "
                        "(default: the reference's tune.sh grid)")
    p.add_argument("--tune-steps", type=int, default=100,
                   help="steps per candidate (reference: tune.sh "
                        "--max-steps=100)")
    p.add_argument("--concurrency", type=int, default=2,
                   help="concurrent candidate subprocesses (keep 1 on a "
                        "card: trials share it)")
    p.add_argument("--sweep-dir", default=None,
                   help="journal + per-trial dirs (default: "
                        "<train-dir>/lr_sweep)")
    args = p.parse_args(argv)

    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
    from pytorch_distributed_nn_tpu_torch.tuning import (
        DEFAULT_CANDIDATES,
        lr_sweep,
    )

    # the fields the JAX tune sets, and no others
    cfg = TrainConfig(
        network=args.network, dataset=args.dataset,
        batch_size=args.batch_size, test_batch_size=args.test_batch_size,
        momentum=args.momentum, optimizer=args.optimizer,
        num_workers=args.num_workers, sync_mode=args.sync_mode,
        num_aggregate=args.num_aggregate, compression=args.compress_grad,
        seed=args.seed, dtype=args.dtype, data_dir=args.data_dir,
        train_dir=args.train_dir,
        synthetic_size=args.synthetic_size, log_every=10**9,
        seq_len=args.seq_len, vocab_size=args.vocab_size,
        mask_prob=args.mask_prob, corpus_branching=args.corpus_branching,
        attn_impl=args.attn_impl,
    )
    candidates = (
        tuple(float(c) for c in args.candidates.split(","))
        if args.candidates else DEFAULT_CANDIDATES
    )
    try:
        results = lr_sweep(cfg, candidates, steps=args.tune_steps,
                           sweep_dir=args.sweep_dir,
                           concurrency=args.concurrency,
                           trial_device=args.device)
    except ValueError as e:
        # e.g. an interrupted tune's journal records a different grid
        print(f"tune: {e}", file=sys.stderr)
        return 2
    for r in results:
        print(f"lr {r.lr:g}: final loss {r.final_loss:.4f}")
    print(f"best lr: {results[0].lr:g}")
    return 0


def _add_pool_flags(sp) -> None:
    """The trial-pool knobs of ``sweep run`` and ``sweep resume``."""
    sp.add_argument("--concurrency", type=int, default=None,
                    help="concurrent trial subprocesses (default 2; "
                         "keep 1 on a card)")
    sp.add_argument("--trial-timeout", type=float, default=None,
                    metavar="SECS",
                    help="per-attempt wall budget; a trial past it is "
                         "terminated (SIGTERM -> emergency checkpoint) "
                         "and retried")
    sp.add_argument("--retries", type=int, default=None,
                    help="extra attempts per trial after a "
                         "crash/timeout (default 1); retried attempts "
                         "resume from the trial's last checkpoint")
    sp.add_argument("--heartbeat-grace", type=float, default=None,
                    metavar="SECS",
                    help="convict a RUNNING trial whose heartbeat "
                         "goes quiet past this many seconds: it is "
                         "terminated and re-queued immediately instead "
                         "of waiting out --trial-timeout")
    sp.add_argument("--json", action="store_true",
                    help="emit the result record as JSON on stdout")
    sp.add_argument("--device", default=None,
                    help="the trials' torch device (default: the card; "
                         "'cpu' trains on the CPU)")


def _sweep_finish(result: dict, as_json: bool) -> int:
    """Shared tail of ``sweep run``/``resume``: print + exit code."""
    import json

    from pytorch_distributed_nn_tpu_torch.experiments import (
        render_leaderboard,
    )

    if as_json:
        print(json.dumps(result, default=str))
    else:
        print(
            f"sweep {result['scheduler']}: {result['trials']} trial(s), "
            f"{len(result['rungs'])} rung(s), "
            f"{result['executed_steps']} step(s) executed of "
            f"{result['planned_steps']} planned, "
            f"{result['wall_s']:.1f}s wall"
        )
        print(render_leaderboard(result["leaderboard"]))
        if result["best"] is not None:
            best = result["best"]
            cfg_s = " ".join(
                f"{k}={v}" for k, v in best["overrides"].items()
            )
            print(f"best: trial {best['trial']} ({cfg_s}) "
                  f"loss {best['loss']:.4f}")
        if result["failed"]:
            print(f"{len(result['failed'])} trial(s) failed after "
                  f"retries: {result['failed']}", file=sys.stderr)
    return 1 if result["failed"] else 0


def _sweep_interrupted(e, sweep_dir: str) -> int:
    print(f"sweep interrupted: {e} — continue with "
          f"'sweep resume --sweep-dir {sweep_dir}'", file=sys.stderr)
    return 3


def main_sweep(argv: Optional[Sequence[str]] = None) -> int:
    """Sweep orchestrator (``experiments/``), with the JAX ``sweep``'s
    flags and exit codes (0; 1 trials failed; 2 bad input or journal; 3
    interrupted), plus ``--device`` on ``run`` and ``resume``.

    - ``run``     — execute a sweep spec: N trials as supervised
      spawned subprocesses (bounded concurrency, per-trial timeout +
      retry with backoff), full-grid or ASHA-style successive-halving
      scheduling, everything journaled in ``<sweep-dir>/sweep.jsonl``.
    - ``resume``  — continue an interrupted sweep from its journal:
      completed trials are skipped (results reused byte-identically),
      dead trials re-queued, in-flight trials resume from their last
      valid checkpoint.
    - ``status``  — per-trial state straight off the journal.
    - ``report``  — ranked leaderboard with trailing-loss, step-rate and
      MFU columns sourced from the trial telemetry streams.
    - ``--selftest`` — <15 s scheduler/journal invariant gate.

    The orchestrating process imports no torch; only the trials do.
    """
    argv = list(argv) if argv is not None else sys.argv[1:]
    if "--selftest" in argv:
        from pytorch_distributed_nn_tpu_torch.experiments.selftest import (
            run_selftest,
        )

        return run_selftest()

    p = argparse.ArgumentParser("pdtn-sweep", description=main_sweep.__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="execute a sweep spec")
    pr.add_argument("--sweep-dir", required=True,
                    help="journal + trials/<id>/ live here")
    pr.add_argument("--spec", default=None,
                    help="sweep spec, e.g. 'lr=0.1,0.01;batch_size=32,64' "
                         "or 'lr=log:1e-4..1e-1' with --samples "
                         "(default: the reference tune.sh lr grid)")
    pr.add_argument("--samples", type=int, default=None,
                    help="random search: number of trials drawn from the "
                         "spec's ranges/lists")
    pr.add_argument("--sweep-seed", type=int, default=0,
                    help="seeds trial enumeration AND per-trial seeds "
                         "(SeedSequence((sweep_seed, trial_index)))")
    pr.add_argument("--steps", type=int, default=100,
                    help="full per-trial step budget (tune.sh: 100)")
    pr.add_argument("--tail", type=int, default=10,
                    help="trailing-loss ranking window")
    pr.add_argument("--scheduler", choices=["grid", "asha"], default="grid",
                    help="asha: successive-halving rungs — the top 1/eta "
                         "per rung continue (via checkpoint resume) to "
                         "eta x the budget")
    pr.add_argument("--eta", type=int, default=3,
                    help="asha reduction factor")
    pr.add_argument("--min-steps", type=int, default=None,
                    help="asha: first-rung budget (default: derived from "
                         "the trial count)")
    pr.add_argument("--ckpt-every", type=int, default=None,
                    help="per-trial checkpoint cadence (default: one "
                         "checkpoint at the rung budget); set it so a "
                         "killed sweep resumes trials mid-rung")
    pr.add_argument("--resume", action="store_true",
                    help="continue this sweep-dir's journal")
    pr.add_argument("--plan-mesh", type=int, default=0, metavar="DEVICES",
                    help="plan each network's mesh for this many devices "
                         "with the roofline planner (in a subprocess); 0 "
                         "keeps the base mesh")
    # base config: every trial starts from these and applies its overrides
    pr.add_argument("--network", default="LeNet")
    pr.add_argument("--dataset", default="MNIST",
                    choices=["MNIST", "Cifar10", "Cifar100", "SVHN",
                             "MLMSynth"])
    pr.add_argument("--batch-size", type=int, default=32)
    pr.add_argument("--test-batch-size", type=int, default=32)
    pr.add_argument("--optimizer", choices=["sgd", "adam"], default="sgd")
    pr.add_argument("--momentum", type=float, default=0.9)
    pr.add_argument("--num-workers", type=int, default=None)
    pr.add_argument("--synthetic-size", type=int, default=None)
    pr.add_argument("--data-dir", default="./data")
    pr.add_argument("--data-path", default=None, metavar="DIR",
                    help="sharded streaming input for every trial: the "
                         "loader whose checkpointed iterator state makes "
                         "interrupted trials resume bit for bit (the "
                         "in-memory image loaders restart their epoch)")
    pr.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    pr.add_argument("--seq-len", type=int, default=None)
    pr.add_argument("--vocab-size", type=int, default=None)
    pr.add_argument("--faults", default=None, metavar="SPEC",
                    help="per-trial deterministic fault injection: every "
                         "trial trains under this plan")
    # a base-config flag the JAX sweep lacks (its train and tune have it)
    pr.add_argument("--compress-grad", choices=["none", "int8", "topk"],
                    default="none")
    _add_pool_flags(pr)

    pres = sub.add_parser(
        "resume", help="continue an interrupted sweep from its journal "
                       "(spec, config and scheduler are read back from "
                       "the manifest)")
    pres.add_argument("--sweep-dir", required=True)
    _add_pool_flags(pres)

    ps = sub.add_parser("status", help="per-trial state off the journal")
    ps.add_argument("--sweep-dir", required=True)

    prep = sub.add_parser("report", help="ranked leaderboard from the "
                                         "journal + trial streams")
    prep.add_argument("--sweep-dir", required=True)
    prep.add_argument("--tail", type=int, default=10)
    prep.add_argument("--json", action="store_true")

    args = p.parse_args(argv)

    from pytorch_distributed_nn_tpu_torch.experiments import (
        RunnerConfig,
        SweepInterrupted,
        SweepRunner,
        SweepSpec,
        leaderboard,
        load_journal,
        render_leaderboard,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.report import (
        render_status,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.spec import (
        DEFAULT_SPEC,
    )

    if args.cmd in ("status", "report", "resume"):
        jstate = load_journal(args.sweep_dir)
        if jstate is None:
            print(f"no sweep journal under {args.sweep_dir}",
                  file=sys.stderr)
            return 2
    if args.cmd == "status":
        print(render_status(jstate))
        return 0
    if args.cmd == "report":
        import json

        rows = leaderboard(args.sweep_dir, jstate, tail=args.tail)
        print(json.dumps(rows, default=str) if args.json
              else render_leaderboard(rows))
        return 0

    if args.cmd == "resume":
        meta = jstate.sweep_meta
        sched = meta.get("scheduler") or {}
        runner_meta = meta.get("runner") or {}
        try:
            spec = SweepSpec.parse(
                meta.get("spec") or DEFAULT_SPEC,
                samples=meta.get("samples"),
                sweep_seed=int(meta.get("sweep_seed") or 0),
            )
            rcfg = RunnerConfig(
                sweep_dir=args.sweep_dir,
                max_steps=int(sched.get("max_steps") or 100),
                tail=int(runner_meta.get("tail") or 10),
                concurrency=int(
                    args.concurrency
                    or runner_meta.get("concurrency") or 2
                ),
                trial_timeout=(
                    args.trial_timeout
                    if args.trial_timeout is not None
                    else runner_meta.get("trial_timeout")
                ),
                retries=int(
                    args.retries if args.retries is not None
                    else runner_meta.get("retries", 1)
                ),
                ckpt_every=runner_meta.get("ckpt_every"),
                scheduler=sched.get("kind") or "grid",
                eta=int(sched.get("eta") or 3),
                min_steps=sched.get("min_steps"),
                plan_mesh=int(runner_meta.get("plan_mesh") or 0),
                heartbeat_grace=(
                    args.heartbeat_grace
                    if args.heartbeat_grace is not None
                    else runner_meta.get("heartbeat_grace")
                ),
                resume=True,
                device=args.device,
            )
        except ValueError as e:
            print(f"sweep resume: {e}", file=sys.stderr)
            return 2
        runner = SweepRunner(spec, dict(jstate.base_config or {}), rcfg)
        try:
            return _sweep_finish(runner.run(), args.json)
        except SweepInterrupted as e:
            return _sweep_interrupted(e, args.sweep_dir)

    # run
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    base = TrainConfig(
        network=args.network, dataset=args.dataset,
        batch_size=args.batch_size, test_batch_size=args.test_batch_size,
        optimizer=args.optimizer, momentum=args.momentum,
        num_workers=args.num_workers,
        synthetic_size=args.synthetic_size, data_dir=args.data_dir,
        data_path=args.data_path,
        dtype=args.dtype, seq_len=args.seq_len, vocab_size=args.vocab_size,
        seed=args.sweep_seed, faults=args.faults,
        compression=args.compress_grad,
    )
    try:
        spec = SweepSpec.parse(
            args.spec or DEFAULT_SPEC,
            samples=args.samples, sweep_seed=args.sweep_seed,
        )
        runner = SweepRunner(
            spec, base,
            RunnerConfig(
                sweep_dir=args.sweep_dir, max_steps=args.steps,
                tail=args.tail,
                concurrency=args.concurrency or 2,
                trial_timeout=args.trial_timeout,
                retries=args.retries if args.retries is not None else 1,
                ckpt_every=args.ckpt_every,
                scheduler=args.scheduler, eta=args.eta,
                min_steps=args.min_steps, resume=args.resume,
                plan_mesh=args.plan_mesh,
                heartbeat_grace=args.heartbeat_grace,
                device=args.device,
            ),
        )
    except ValueError as e:
        print(f"sweep: {e}", file=sys.stderr)
        return 2
    try:
        return _sweep_finish(runner.run(), args.json)
    except ValueError as e:
        print(f"sweep: {e}", file=sys.stderr)
        return 2
    except SweepInterrupted as e:
        return _sweep_interrupted(e, args.sweep_dir)


def main_fleet(argv: Optional[Sequence[str]] = None) -> int:
    """Multi-host experiment fleet (experiments/fleet/), with the JAX
    ``fleet``'s subcommands, flags, defaults and exit codes (0; 1 trials
    failed or an agent unreachable; 2 bad input; 3 interrupted, or every
    host dead, with the resume recipe). ``agent --device {cuda,cpu}``
    takes the place of ``--platform``, and ``run`` takes ``--device`` and
    ``--compress-grad`` as ``sweep run`` does.

    - ``agent``  — run a host agent: registers capacity (device count,
      labels, planner profile) over a JSON-line TCP protocol and runs
      assigned trials as supervised subprocesses (a trial of several
      ranks as that many rank processes); SIGTERM forwards to the trials
      (emergency checkpoints) before the agent exits.
    - ``run``    — the sweep orchestrator over a fleet: trials placed by
      host capacity, meshes capped to each host, dead hosts'
      in-flight trials migrated to survivors and elastically resumed
      from their last valid checkpoint. ``--plan-hosts`` plans each
      host's mesh (in a subprocess, cached). ``--resume`` continues an interrupted fleet sweep from its
      journal — including after the ORCHESTRATOR died.
    - ``status`` — journal-reconstructed fleet + trial state.
    - ``agents`` — probe ``--hosts`` agents live (hello each).
    - ``drain``  — stop new assignments on the named agents; running
      trials finish.
    - ``--selftest`` — <15 s transport/placement/migration invariant
      gate over local agents; asserts the orchestrator process and an
      agent process never import torch.
    """
    argv = list(argv) if argv is not None else sys.argv[1:]
    if "--selftest" in argv:
        from pytorch_distributed_nn_tpu_torch.experiments.fleet.selftest import (
            run_selftest,
        )

        return run_selftest()

    p = argparse.ArgumentParser("pdtn-fleet", description=main_fleet.__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("agent", help="run a host agent")
    pa.add_argument("--listen", default="127.0.0.1:0", metavar="HOST:PORT",
                    help="bind address (port 0 = ephemeral; pair with "
                         "--register so the orchestrator can find it)")
    pa.add_argument("--agent-id", default=None,
                    help="stable identity in the journal (default: "
                         "host-pid)")
    pa.add_argument("--devices", type=int, default=1,
                    help="device count advertised to the scheduler: on "
                         "the card the agent's cards (it refuses to start "
                         "with fewer), on the CPU the most gloo rank "
                         "processes a trial of its takes")
    pa.add_argument("--capacity", type=int, default=1,
                    help="concurrent trials this host accepts (keep 1 on "
                         "an accelerator host)")
    pa.add_argument("--label", action="append", default=None,
                    metavar="K=V", help="placement label (repeatable)")
    pa.add_argument("--register", default=None, metavar="FILE",
                    help="write a registration file (agent id, bound "
                         "address, pid, capacity) once listening")
    pa.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the agent's trials train: cuda (the "
                         "card, default; rank r on the r-th card "
                         "CUDA_VISIBLE_DEVICES shows) or cpu (gloo "
                         "ranks)")
    pa.add_argument("--idle-timeout", type=float, default=0.0,
                    metavar="SECS",
                    help="exit (terminating trials into emergency "
                         "checkpoints) after this much orchestrator "
                         "silence; 0 = never (the local transport "
                         "always sets it for its agents)")

    def _add_fleet_flags(sp):
        sp.add_argument("--transport", choices=["local", "tcp"],
                        default="local")
        sp.add_argument("--agents", type=int, default=3,
                        help="local transport: agent subprocesses to "
                             "spawn")
        sp.add_argument("--agent-devices", default=None, metavar="N,N,...",
                        help="local transport: per-agent device counts "
                             "(cycled; default 1 each)")
        sp.add_argument("--agent-capacity", type=int, default=1,
                        help="local transport: trials per agent")
        sp.add_argument("--hosts", default=None, metavar="H:P,H:P,...",
                        help="tcp transport: running agents to attach to "
                             "(sweep dir must be on shared storage)")
        sp.add_argument("--lease", type=float, default=10.0,
                        help="seconds of silence before a host is "
                             "declared dead and its trials migrate")
        sp.add_argument("--call-timeout", type=float, default=2.0,
                        help="per-RPC socket timeout")
        sp.add_argument("--plan-hosts", action="store_true",
                        help="planner-assigned mesh per host profile "
                             "(the roofline planner, in a subprocess, "
                             "cached in the fleet cache)")

    pr = sub.add_parser("run", help="run a sweep over the fleet")
    pr.add_argument("--sweep-dir", required=True)
    pr.add_argument("--spec", default=None)
    pr.add_argument("--samples", type=int, default=None)
    pr.add_argument("--sweep-seed", type=int, default=0)
    pr.add_argument("--steps", type=int, default=100)
    pr.add_argument("--tail", type=int, default=10)
    pr.add_argument("--scheduler", choices=["grid", "asha"],
                    default="grid")
    pr.add_argument("--eta", type=int, default=3)
    pr.add_argument("--min-steps", type=int, default=None)
    pr.add_argument("--ckpt-every", type=int, default=None)
    pr.add_argument("--resume", action="store_true",
                    help="continue this sweep-dir's journal (fresh fleet; "
                         "completed trials reused byte-identically, "
                         "in-flight ones re-dispatched with resume)")
    # base config (every trial starts from these, like `sweep run`)
    pr.add_argument("--network", default="LeNet")
    pr.add_argument("--dataset", default="MNIST",
                    choices=["MNIST", "Cifar10", "Cifar100", "SVHN",
                             "MLMSynth"])
    pr.add_argument("--batch-size", type=int, default=32)
    pr.add_argument("--test-batch-size", type=int, default=32)
    pr.add_argument("--optimizer", choices=["sgd", "adam"], default="sgd")
    pr.add_argument("--momentum", type=float, default=0.9)
    pr.add_argument("--num-workers", type=int, default=None)
    pr.add_argument("--synthetic-size", type=int, default=None)
    pr.add_argument("--data-dir", default="./data")
    pr.add_argument("--data-path", default=None, metavar="DIR")
    pr.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    pr.add_argument("--seq-len", type=int, default=None)
    pr.add_argument("--vocab-size", type=int, default=None)
    pr.add_argument("--faults", default=None, metavar="SPEC")
    pr.add_argument("--synthetic-trials", action="store_true",
                    help="run the torch-free synthetic trial main instead "
                         "of real training — the orchestration surface "
                         "without the training cost (tests/CI); its "
                         "agents need no card")
    pr.add_argument("--step-sleep", type=float, default=0.0,
                    metavar="SECS",
                    help="synthetic trials: uniform per-step pacing")
    # a base-config flag the JAX fleet lacks (its train and tune have it)
    pr.add_argument("--compress-grad", choices=["none", "int8", "topk"],
                    default="none")
    _add_fleet_flags(pr)
    _add_pool_flags(pr)

    ps = sub.add_parser("status", help="journal-reconstructed fleet + "
                                       "trial state")
    ps.add_argument("--sweep-dir", required=True)

    pag = sub.add_parser("agents", help="probe running agents (hello)")
    pag.add_argument("--hosts", required=True, metavar="H:P,H:P,...")
    pag.add_argument("--call-timeout", type=float, default=2.0)

    pd = sub.add_parser("drain", help="stop new assignments on agents")
    pd.add_argument("--hosts", required=True, metavar="H:P,H:P,...")
    pd.add_argument("--call-timeout", type=float, default=2.0)

    args = p.parse_args(argv)

    if args.cmd == "agent":
        from pytorch_distributed_nn_tpu_torch.experiments.fleet.agent import (
            agent_main,
        )

        if args.agent_id is None:
            import platform as _plat

            args.agent_id = f"{_plat.node()}-{os.getpid()}"
        try:
            return agent_main(args)
        except (ValueError, OSError) as e:
            print(f"fleet agent: {e}", file=sys.stderr)
            return 2

    if args.cmd == "status":
        from pytorch_distributed_nn_tpu_torch.experiments import load_journal
        from pytorch_distributed_nn_tpu_torch.experiments.report import (
            render_fleet,
            render_status,
        )

        jstate = load_journal(args.sweep_dir)
        if jstate is None:
            print(f"no sweep journal under {args.sweep_dir}",
                  file=sys.stderr)
            return 2
        print(render_fleet(jstate))
        print(render_status(jstate))
        return 0

    if args.cmd in ("agents", "drain"):
        from pytorch_distributed_nn_tpu_torch.experiments.fleet.transport import (
            call_once,
            probe_hosts,
        )

        addrs = [a for a in args.hosts.split(",") if a]
        rows = probe_hosts(addrs, timeout=args.call_timeout)
        rc = 0
        for addr, info, err in rows:
            if info is None:
                print(f"{addr}: UNREACHABLE ({err})")
                rc = 1
                continue
            if args.cmd == "drain":
                host, _, port = addr.rpartition(":")
                resp = call_once((host, int(port)), {"op": "drain"},
                                 timeout=args.call_timeout)
                print(f"{addr}: {info.agent_id} draining "
                      f"(running: {resp.get('running')})")
            else:
                print(f"{addr}: {info.agent_id} devices={info.devices} "
                      f"capacity={info.capacity} "
                      f"draining={info.draining} labels={info.labels}")
        return rc

    # run
    from pytorch_distributed_nn_tpu_torch.experiments import (
        SweepInterrupted,
        SweepSpec,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.fleet import (
        FleetConfig,
        FleetScheduler,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.fleet.transport import (
        FleetError,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.spec import DEFAULT_SPEC
    # the torch-free config module: the fleet orchestrator never imports
    # torch — trials do, in their own processes on their hosts
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    if args.synthetic_trials:
        base = {
            "network": "SynthNet", "lr": 0.1, "faults": args.faults,
            "batch_size": args.batch_size, "step_sleep": args.step_sleep,
        }
    else:
        base = TrainConfig(
            network=args.network, dataset=args.dataset,
            batch_size=args.batch_size,
            test_batch_size=args.test_batch_size,
            optimizer=args.optimizer, momentum=args.momentum,
            num_workers=args.num_workers,
            synthetic_size=args.synthetic_size, data_dir=args.data_dir,
            data_path=args.data_path,
            dtype=args.dtype, seq_len=args.seq_len,
            vocab_size=args.vocab_size,
            seed=args.sweep_seed, faults=args.faults,
            compression=args.compress_grad,
        )
    try:
        if args.transport == "tcp" and not args.hosts:
            raise ValueError("--transport tcp needs --hosts")
        spec = SweepSpec.parse(
            args.spec or DEFAULT_SPEC,
            samples=args.samples, sweep_seed=args.sweep_seed,
        )
        runner = FleetScheduler(
            spec, base,
            FleetConfig(
                sweep_dir=args.sweep_dir, max_steps=args.steps,
                tail=args.tail,
                trial_timeout=args.trial_timeout,
                retries=args.retries if args.retries is not None else 1,
                ckpt_every=args.ckpt_every,
                scheduler=args.scheduler, eta=args.eta,
                min_steps=args.min_steps, resume=args.resume,
                heartbeat_grace=args.heartbeat_grace,
                device=args.device,
                transport=args.transport, agents=args.agents,
                agent_devices=tuple(
                    int(d) for d in args.agent_devices.split(",") if d
                ) if args.agent_devices else (),
                agent_capacity=args.agent_capacity,
                hosts=tuple(
                    a for a in (args.hosts or "").split(",") if a
                ),
                lease=args.lease, call_timeout=args.call_timeout,
                plan_hosts=args.plan_hosts,
                trial_main_name=(
                    "synthetic" if args.synthetic_trials else "default"
                ),
            ),
        )
    except ValueError as e:
        print(f"fleet: {e}", file=sys.stderr)
        return 2
    try:
        return _sweep_finish(runner.run(), args.json)
    except ValueError as e:
        print(f"fleet: {e}", file=sys.stderr)
        return 2
    except SweepInterrupted as e:
        print(f"fleet sweep interrupted: {e} — continue with "
              f"'fleet run --resume --sweep-dir {args.sweep_dir}'",
              file=sys.stderr)
        return 3
    except FleetError as e:
        # every host dead (or the fleet failed to start): the journal
        # holds all completed work — resumable, like an interruption
        print(f"fleet: {e}", file=sys.stderr)
        return 3


def main_chaos(argv: Optional[Sequence[str]] = None) -> int:
    """Chaos suite: canned fault scenarios with CI-gateable invariants
    (resilience/chaos.py), with the JAX ``chaos``'s flags and exit codes
    plus ``--device``.

    Each scenario trains tiny models with injected faults and asserts the
    resilience contract — crash+resume bitwise equivalence, straggler
    K-of-N drop + renormalization, torn-checkpoint conviction/quarantine,
    NaN-update skipping, SIGTERM clean exit. Exits nonzero when any
    invariant is violated, so CI can gate fault handling exactly like a
    unit test. A data-parallel scenario runs one rank process per worker,
    one card each on the card: one that needs more cards than there are
    exits 2 before it trains.
    """
    p = argparse.ArgumentParser("pdtn-chaos", description=main_chaos.__doc__)
    p.add_argument("--scenario", default="smoke",
                   help="scenario name, or 'list' to enumerate with the "
                        "cards each needs (smoke is the fast composite)")
    p.add_argument("--workdir", default=None,
                   help="run under this directory and keep the artifacts "
                        "(default: a temp dir, removed unless --keep)")
    p.add_argument("--keep", action="store_true",
                   help="keep the default temp workdir for inspection")
    p.add_argument("--cases", default=None, metavar="C1,C2,...",
                   help="for scenarios with sub-cases (elastic_resume: "
                        "shrink,regrow,corrupt; live_reload: swap,canary; "
                        "replica_loss: kill,drain; fleet_preempt: "
                        "synthetic,elastic): run only these")
    p.add_argument("--device", default="cuda",
                   help="where every rank, engine and replica runs: cuda "
                        "(the card, default; one card per rank) or cpu "
                        "(gloo ranks)")
    args = p.parse_args(argv)

    from pytorch_distributed_nn_tpu_torch.resilience import chaos

    if args.scenario == "list":
        for name, fn in chaos.SCENARIOS.items():
            doc = (fn.__doc__ or "").strip().splitlines()
            print(f"{name}: {doc[0] if doc else ''} "
                  f"[{chaos.describe_ranks(name)}]")
        return 0
    cases = (
        tuple(c for c in args.cases.split(",") if c) if args.cases else None
    )
    return chaos.run_scenario(args.scenario, args.device,
                              workdir=args.workdir, keep=args.keep,
                              cases=cases)


#: the HLO auditor's flags of the JAX ``analyze``: the port has no HLO
_AUDITOR_FLAGS = ("--fail-on", "--suppress", "--check-recompile",
                  "--check-donation")

_MODEL_ALIASES = {"bert_tiny": "BertTiny", "bert_base": "BertBase",
                  "lenet": "LeNet", "gpt_tiny": "GptTiny",
                  "gpt_mini": "GptMini"}


def _parse_mesh_arg(mesh_arg: str):
    """'4x2' -> (data=4, model=2, seq=1); '2x2x2' -> (data, model, seq)."""
    try:
        parts = [int(p) for p in mesh_arg.lower().split("x")]
    except ValueError:
        raise SystemExit(f"--mesh must look like '8', '4x2' or '2x2x2', "
                         f"got {mesh_arg!r}")
    if not 1 <= len(parts) <= 3 or any(p < 1 for p in parts):
        raise SystemExit(f"--mesh must have 1-3 positive extents, "
                         f"got {mesh_arg!r}")
    parts += [1] * (3 - len(parts))
    return tuple(parts)  # (data, model, seq)


def _analyze_model_kw(args) -> dict:
    return {k: v for k, v in {
        "vocab_size": args.vocab_size,
        "max_len": args.seq_len,
        "d_model": args.d_model,
        "num_layers": args.num_layers,
        "num_heads": args.num_heads,
        "d_ff": args.d_ff,
        "dtype": args.dtype,
    }.items() if v is not None}


def _analyze_dtype(args) -> str:
    """``--dtype``, else the model's own compute dtype (the CNN zoo's:
    float32)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.models import (
        build_model,
        is_text_model,
    )

    model_name = _MODEL_ALIASES.get(args.model, args.model)
    if args.dtype or not is_text_model(model_name):
        return args.dtype or "float32"
    with torch.device("meta"):
        cfg = build_model(model_name, **_analyze_model_kw(args)).config
    return str(cfg.dtype).split(".")[-1]


def _decode_cost_block(args, model_name):
    """The decode-phase roofline of ``analyze --cost`` for causal
    decoders (the JAX CLI's block): per-token FLOPs and KV-cache bytes
    from the closed form, and the predicted tokens/s under the
    ``--device`` backend's profile; None for other models."""
    import torch

    from pytorch_distributed_nn_tpu_torch.analysis.calibration import (
        default_profile,
    )
    from pytorch_distributed_nn_tpu_torch.analysis.costmodel import (
        decode_phase_cost,
    )
    from pytorch_distributed_nn_tpu_torch.models import (
        build_model,
        is_generative_model,
    )

    if not is_generative_model(model_name):
        return None
    with torch.device("meta"):
        cfg = build_model(model_name, **_analyze_model_kw(args)).config
    cache_len = args.seq_len or cfg.max_len
    batch = args.batch_size or 8
    dc = decode_phase_cost(
        num_layers=cfg.num_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
        vocab_size=cfg.vocab_size, cache_len=cache_len, batch=batch,
        weight_bytes_per_param=4,
        kv_bytes_per_elem=torch.empty((), dtype=cfg.dtype).element_size(),
    )
    prof = default_profile(args.device, _analyze_dtype(args))
    pred = dc.predicted_tokens_per_s(
        prof.peak_flops_per_s, prof.hbm_peak_bytes_per_s
    )
    out = dc.to_dict()
    out["predicted_tokens_per_s"] = round(pred, 1)
    out["calibration_backend"] = prof.backend
    out["text"] = (
        dc.to_text()
        + f"\n  roofline tokens/s (per sequence, {prof.name} "
        f"calibration): {pred:,.0f}"
    )
    return out


def _analyze_walk(args, num_data, num_model, num_seq):
    """The walk of rank 0's step of ``--model`` over the mesh
    (:func:`..analysis.costmodel.walk_step`): its
    :class:`..analysis.report.Report` (its cost included), or None after
    a message for a combination that cannot be built."""
    from pytorch_distributed_nn_tpu_torch.analysis import costmodel
    from pytorch_distributed_nn_tpu_torch.analysis.report import (
        Report,
        summarize_collectives,
    )
    from pytorch_distributed_nn_tpu_torch.models import is_text_model

    model_name = _MODEL_ALIASES.get(args.model, args.model)
    model_kw = (_analyze_model_kw(args) if is_text_model(model_name)
                else {"dtype": args.dtype or "float32"})
    try:
        cost, params = costmodel.walk_step(
            model_name, (num_data, num_model, num_seq),
            args.batch_size or 2 * num_data, args.optimizer, args.seq_len,
            model_kw, args.seq_attn, args.compress_grad, args.grad_accum)
    except ValueError as e:
        print(e, file=sys.stderr)
        return None
    return Report(
        mesh_shape={"data": num_data, "model": num_model, "seq": num_seq},
        collectives=summarize_collectives(cost.collectives),
        num_params=len(params),
        param_bytes=int(sum(p.numel() * p.element_size() for p in params)),
        cost=cost,
    )


def _analyze_plan(args) -> int:
    """``analyze --plan``: the ranked mesh table under the roofline."""
    import json as _json

    from pytorch_distributed_nn_tpu_torch.analysis import planner
    from pytorch_distributed_nn_tpu_torch.analysis.calibration import (
        CalibrationProfile,
    )

    profile = (CalibrationProfile.load(args.calibration)
               if args.calibration else None)
    try:
        result = planner.plan(
            args.model, args.devices, profile=profile,
            batch_size=args.batch_size, optimizer=args.optimizer,
            seq_len=args.seq_len, model_kw=_analyze_model_kw(args),
            validate=args.validate, seq_attn=args.seq_attn,
            device=args.device,
        )
    except ValueError as e:
        print(f"plan: {e}", file=sys.stderr)
        return 2
    payload = _json.dumps(result, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload if args.json else planner.render_plan(result))
    if args.check:
        live = [c for c in result["candidates"] if not c.get("skipped")]
        ok = (result.get("top") is not None and len(live) >= 2
              and all(c["predicted_ms"] > 0 for c in live))
        print(f"plan --check: {'PASS' if ok else 'FAIL'}", file=sys.stderr)
        return 0 if ok else 1
    return 0


def _analyze_calibrate(args, num_data, num_model, num_seq) -> int:
    """``analyze --calibrate``: fit and write a calibration.json."""
    from pytorch_distributed_nn_tpu_torch.analysis import calibration

    dtype = _analyze_dtype(args)
    prof = calibration.default_profile(args.device, dtype)
    if args.trace:
        report = _analyze_walk(args, num_data, num_model, num_seq)
        if report is None:
            return 2
        try:
            prof = calibration.fit_from_trace(
                args.trace, report.cost.to_dict(), args.trace_steps,
                base=prof)
        except (ValueError, FileNotFoundError) as e:
            print(f"calibrate: trace fit failed: {e}", file=sys.stderr)
            return 2
    if args.microbench:
        prof = calibration.fit_microbench(base=prof, device=args.device,
                                          dtype=dtype)
    out = args.out or calibration.CALIBRATION_BASENAME
    prof.save(out)
    print(f"wrote {out}: profile {prof.name} (source {prof.source}), "
          f"peak {prof.peak_flops_per_s / 1e12:.2f} TFLOP/s, "
          f"HBM {prof.hbm_bytes_per_s / 1e9:.1f} GB/s, "
          f"ICI {prof.ici_bytes_per_s / 1e9:.1f} GB/s")
    return 0


def main_analyze(argv: Optional[Sequence[str]] = None) -> int:
    """The step's static cost, its collectives and the mesh planner (the
    JAX ``analyze``, by a walk of the step's dispatched operations on the
    meta device: no card needed; ``--validate`` and ``--microbench`` run
    on ``--device``). Without ``--plan`` or ``--calibrate`` it prints the
    mesh's collective inventory and step cost. The JAX HLO auditor's
    flags exit 2: the port has no HLO to lint."""
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in _AUDITOR_FLAGS:
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            print(f"analyze: {flag} belongs to the JAX package's HLO "
                  "auditor (the SL rules), which has no counterpart in the "
                  "port (it has no HLO)", file=sys.stderr)
            return 2
    p = argparse.ArgumentParser("pdtn-analyze",
                                description=main_analyze.__doc__)
    p.add_argument("--model", default="bert_tiny",
                   help="model zoo name (bert_tiny/bert_base/lenet/"
                        "gpt_tiny/gpt_mini aliases or any registry name; "
                        "image models walk the data-parallel step)")
    p.add_argument("--mesh", default="4x2",
                   help="data[xmodel[xseq]] extents of the walked mesh, "
                        "e.g. 8, 4x2, 2x2x2 (a fake process group)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch (default: 2 per data-parallel rank)")
    p.add_argument("--seq-len", type=int, default=None,
                   help="text models: sequence length (default: model spec)")
    p.add_argument("--vocab-size", type=int, default=None)
    p.add_argument("--d-model", type=int, default=None)
    p.add_argument("--num-layers", type=int, default=None)
    p.add_argument("--num-heads", type=int, default=None)
    p.add_argument("--d-ff", type=int, default=None)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="the model's compute dtype (default: the model's); "
                        "it picks the MFU peak and the card profile")
    p.add_argument("--optimizer", choices=["sgd", "adam"], default="adam")
    p.add_argument("--seq-attn", choices=["ring", "ulysses"], default="ring",
                   help="attention impl when the seq mesh axis is > 1")
    p.add_argument("--compress-grad", choices=["none", "int8"],
                   default="none")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--cost", action="store_true",
                   help="print the step's static FLOPs/bytes "
                        "(analysis/costmodel.py), and for a decoder the "
                        "decode-phase roofline (always in --json)")
    p.add_argument("--plan", action="store_true",
                   help="rank mesh factorizations x rule overrides for "
                        "--model over --devices devices under the "
                        "calibrated roofline; --validate also measures")
    p.add_argument("--devices", type=int, default=8,
                   help="--plan: device count to plan for")
    p.add_argument("--validate", action="store_true",
                   help="--plan: train every candidate a few steps as rank "
                        "processes on --device and report measured ms")
    p.add_argument("--check", action="store_true",
                   help="--plan: the CPU smoke (LeNet over 2 devices, the "
                        "default calibration, no measurement) and the "
                        "table's invariants")
    p.add_argument("--calibrate", action="store_true",
                   help="fit per-family ceilings into a calibration.json "
                        "from a --profile run's trace (--trace, with "
                        "--model/--mesh for the step's cost) and/or the "
                        "microbenches (--microbench)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="--calibrate: a torch.profiler trace directory")
    p.add_argument("--trace-steps", type=int, default=1,
                   help="--calibrate: how many steps the trace covers")
    p.add_argument("--microbench", action="store_true",
                   help="--calibrate: time one matmul chain and one copy "
                        "on --device")
    p.add_argument("--calibration", default=None, metavar="FILE",
                   help="--plan: ceilings from this calibration.json")
    p.add_argument("--json", action="store_true",
                   help="emit the report (or plan) as JSON on stdout")
    p.add_argument("--out", default=None,
                   help="also write the JSON (--calibrate: the profile) "
                        "to this file")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where --validate and --microbench run, and the "
                        "default profile's backend (default: the card)")
    args = p.parse_args(argv)

    if args.check and not args.plan:
        print("--check only applies with --plan", file=sys.stderr)
        return 2
    if args.plan and args.check:
        # the CPU smoke: tiny model, 2 ranks, default calibration, no
        # measurement — seconds
        args.model, args.devices, args.validate = "lenet", 2, False
        args.device = "cpu"
    if args.plan:
        return _analyze_plan(args)
    num_data, num_model, num_seq = _parse_mesh_arg(args.mesh)
    if args.calibrate:
        return _analyze_calibrate(args, num_data, num_model, num_seq)
    report = _analyze_walk(args, num_data, num_model, num_seq)
    if report is None:
        return 2
    import json as _json

    doc = report.to_dict()
    decode_cost = (_decode_cost_block(
        args, _MODEL_ALIASES.get(args.model, args.model))
        if args.cost else None)
    if decode_cost is not None:
        doc["decode_cost"] = {k: v for k, v in decode_cost.items()
                              if k != "text"}
    payload = _json.dumps(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload if args.json else report.to_text())
    if args.cost and not args.json:
        print()
        print(report.cost.to_text())
        if decode_cost is not None:
            print()
            print(decode_cost["text"])
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pytorch_distributed_nn_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    _add_train_flags(sub.add_parser(
        "train", help="train an image or a text model, data-parallel"))
    _add_train_flags(sub.add_parser(
        "single", help="the single-machine baseline: train on one rank "
                       "with no sync"))
    _add_evaluator_flags(sub.add_parser(
        "evaluator", help="poll a train_dir's checkpoints and score each"))
    _add_serve_flags(sub.add_parser("serve", help="serving commands"))
    _add_data_flags(sub.add_parser(
        "data", help="streaming shard tooling: export, info (host-side)"))
    # parsed by their own entry points (main dispatches them first)
    sub.add_parser("registry", add_help=False,
                   help="model registry: publish, list, label, rollback, "
                        "gc, watch, verify (host-side)")
    sub.add_parser("obs", add_help=False,
                   help="stream tools: summary, tail, compare, trace, "
                        "bench-trend, slo, export, incidents (host-side)")
    sub.add_parser("tune", add_help=False,
                   help="lr grid search over the sweep runner (the "
                        "reference's tune.sh)")
    sub.add_parser("sweep", add_help=False,
                   help="sweep orchestrator: run, status, report, resume, "
                        "--selftest (the orchestrator imports no torch)")
    sub.add_parser("fleet", add_help=False,
                   help="the sweep over host agents: agent, run, status, "
                        "agents, drain, --selftest (the orchestrator and "
                        "the agents import no torch)")
    sub.add_parser("chaos", add_help=False,
                   help="canned fault scenarios with CI-gateable "
                        "invariants (--scenario list)")
    sub.add_parser("analyze", add_help=False,
                   help="the step's static cost, its collectives, "
                        "calibration and the mesh planner (a walk on the "
                        "meta device)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["obs"]:
        from pytorch_distributed_nn_tpu_torch.observability.obs_cli import (
            main_obs,
        )

        return main_obs(argv[1:])
    if argv[:1] == ["registry"]:
        return main_registry(argv[1:])
    if argv[:1] == ["sweep"]:
        return main_sweep(argv[1:])
    if argv[:1] == ["tune"]:
        return main_tune(argv[1:])
    if argv[:1] == ["fleet"]:
        return main_fleet(argv[1:])
    if argv[:1] == ["chaos"]:
        return main_chaos(argv[1:])
    if argv[:1] == ["analyze"]:
        return main_analyze(argv[1:])
    args = build_parser().parse_args(argv)
    if args.cmd in ("train", "single"):
        return _train(args)
    if args.cmd == "evaluator":
        return _evaluator(args)
    if args.cmd == "data":
        return _data(args)
    return _serve(args)
