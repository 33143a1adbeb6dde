"""Command line of the port.

    python -m pytorch_distributed_nn_tpu_torch train --network ResNet18 \
        --dataset Cifar10 --batch-size 1024 --learning-rate 0.4 \
        --dtype bfloat16 --compress-grad int8 --max-steps N [--device cpu]

trains an image model of the CNN zoo, data-parallel over the torchrun
world (``torchrun --nproc-per-node N -m pytorch_distributed_nn_tpu_torch
train --num-workers N ...``; one rank without torchrun), with the JAX
package's gradient sync flags (``--sync-mode``, ``--num-aggregate``,
``--kill-ranks``, ``--compress-grad none|int8``, ``--bn-stats-sync``)
and data flags (``--data-layout``, ``--data-dir``, ``--synthetic-size``).

    python -m pytorch_distributed_nn_tpu_torch train --network BertBase \
        --dataset MLMSynth --optimizer adam --learning-rate 1e-4 \
        --attn-impl pallas --fused-ln --dtype bfloat16 --batch-size 16 \
        --max-steps N [--device cpu] [...]

trains a text model on one device. Both take the JAX package's ``train``
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
N steps with ``torch.profiler``. A flag the port cannot honour yet
raises, naming the ROADMAP item that ports it. Training runs on the card
unless ``--device cpu`` is given, and fails without one.

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
keyed by request count; a spec without one is refused). Its flags that
belong to a later ROADMAP item (``--registry``, ``--reload-poll``,
``--canary``, ``--admin-token``, ``--slo``, ``--flightrec``, ``serve
frontend``) raise, naming the item.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
from typing import Optional, Sequence


_ITEM6 = "ROADMAP Queue 1 item 6 (router, frontend, registry, SLOs)"

#: ``serve run`` flags of later items: flag -> the item that ports it
_SERVE_LATER = {"registry": _ITEM6, "reload_poll": _ITEM6,
                "canary": _ITEM6, "admin_token": _ITEM6, "slo": _ITEM6,
                "flightrec": _ITEM6}


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
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        load_manifest,
    )
    from pytorch_distributed_nn_tpu_torch.serving.loadgen import (
        serving_telemetry,
    )
    from pytorch_distributed_nn_tpu_torch.serving.server import ServingServer

    later = [f for f in _SERVE_LATER if getattr(args, f) is not None]
    if later:
        raise NotImplementedError(
            f"serve run --{later[0].replace('_', '-')} is not ported yet: "
            f"{_SERVE_LATER[later[0]]}")
    fault_plan = None
    if args.faults:  # parsed before the engine pays its warmup
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
    max_queue = args.max_queue if args.max_queue > 0 else None
    serve_dir = args.serve_dir or os.path.join(args.artifact, "serve")
    os.makedirs(serve_dir, exist_ok=True)
    buckets = _buckets(args.buckets or args.batch_buckets)
    kw = {"batch_buckets": buckets} if buckets else {}
    if is_generative_model(load_manifest(args.artifact).get("network", "")):
        from pytorch_distributed_nn_tpu_torch.serving.generate import (
            GenerateScheduler,
            GenerativeEngine,
        )

        engine = GenerativeEngine(args.artifact, device=args.device, **kw)
        engine.warmup()
        telemetry = serving_telemetry(serve_dir, engine,
                                      extra={"generative": True})
        faults = _fault_injector(fault_plan, telemetry, engine)
        sched = GenerateScheduler(engine, telemetry=telemetry,
                                  default_timeout_s=args.timeout,
                                  max_queue=max_queue)
        server = ServingServer(engine, None, host=args.host, port=args.port,
                               generator=sched, faults=faults)
        what = "GENERATIVE "
    else:
        from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
        from pytorch_distributed_nn_tpu_torch.serving.engine import (
            InferenceEngine,
        )

        engine = InferenceEngine(args.artifact, device=args.device, **kw)
        engine.warmup()
        telemetry = serving_telemetry(serve_dir, engine)
        faults = _fault_injector(fault_plan, telemetry, engine)
        sched = Batcher(engine, telemetry=telemetry,
                        batch_window_s=args.batch_window_ms / 1000.0,
                        default_timeout_s=args.timeout, max_queue=max_queue)
        server = ServingServer(engine, sched, host=args.host,
                               port=args.port, faults=faults)
        what = ""
    print(f"serving {what}{args.artifact} on "
          f"http://{server.host}:{server.port} ({engine.device}; stream: "
          f"{serve_dir})", file=sys.stderr)
    try:
        _serve_loop(server, port_file=args.port_file)
    finally:
        sched.close()
        telemetry.close()
    return 0


def _serve(args) -> int:
    if args.serve_cmd == "frontend":
        raise NotImplementedError(
            f"serve frontend is not ported yet: {_ITEM6}")
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

    def engine_flags(sp):
        sp.add_argument("--artifact", required=True, metavar="DIR")
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
    engine_flags(run)
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
    for flag in _SERVE_LATER:
        run.add_argument("--" + flag.replace("_", "-"), default=None,
                         help=f"not ported yet: {_SERVE_LATER[flag]}")

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

    ssub.add_parser("frontend", help=f"not ported yet: {_ITEM6}")


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

    if args.multihost:
        raise NotImplementedError(
            "--multihost is not ported yet: ROADMAP Queue 1 item 2 "
            "(gradient sync over torch.distributed)")
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
    trainer = Trainer(train_config(args), device=args.device)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pytorch_distributed_nn_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    _add_train_flags(sub.add_parser(
        "train", help="train an image model (data-parallel) or a text "
                      "model (one device)"))
    _add_train_flags(sub.add_parser(
        "single", help="the single-machine baseline: train on one rank "
                       "with no sync"))
    _add_evaluator_flags(sub.add_parser(
        "evaluator", help="poll a train_dir's checkpoints and score each"))
    _add_serve_flags(sub.add_parser("serve", help="serving commands"))
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd in ("train", "single"):
        return _train(args)
    if args.cmd == "evaluator":
        return _evaluator(args)
    return _serve(args)
