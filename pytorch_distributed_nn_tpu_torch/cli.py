"""Command line of the port.

    python -m pytorch_distributed_nn_tpu_torch train --network BertBase \
        --dataset MLMSynth --optimizer adam --learning-rate 1e-4 \
        --attn-impl pallas --fused-ln --dtype bfloat16 --batch-size 16 \
        --max-steps N [--device cpu] [...]

trains a text model on one device with the JAX package's ``train`` flags
(same names, defaults and meanings, so a command line moves across
unchanged): ``train()`` then ``evaluate()``. ``--attn-impl pallas``
selects the hand-written flash kernel, ``full`` plain attention in
PyTorch; ``--fused-ln`` is accepted (the port has one LayerNorm, the
kernel). A flag the port cannot honour yet raises, naming the ROADMAP
item that ports it.

    python -m pytorch_distributed_nn_tpu_torch serve run --artifact DIR \
        [--host 127.0.0.1] [--port 8000] [--device cuda] \
        [--batch-buckets 1,2,4,8] [--timeout 30] [--max-queue N] \
        [--serve-dir DIR] [--port-file PATH]

serves a generative (causal decoder) artifact over ``POST /v1/generate``
as the JAX package's ``serve run`` does, with decode attention and
LayerNorm on the hand-written kernels. It runs on the card unless
``--device cpu`` is given, and fails without one. Each served request
writes one record to ``<serve-dir>/serving.jsonl`` (default
``<artifact>/serve``). SIGTERM drains: admissions stop, in-flight
requests finish, then the process exits.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
from typing import Optional, Sequence


def _serve_run(args) -> int:
    from pytorch_distributed_nn_tpu_torch.models import is_generative_model
    from pytorch_distributed_nn_tpu_torch.observability import core as obs
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        load_manifest,
    )
    from pytorch_distributed_nn_tpu_torch.serving.generate import (
        GenerateScheduler,
        GenerativeEngine,
    )
    from pytorch_distributed_nn_tpu_torch.serving.server import ServingServer

    network = load_manifest(args.artifact).get("network", "")
    if not is_generative_model(network):
        print(f"serve run: {network!r} is not a causal decoder; the port "
              "serves generative artifacts only", file=sys.stderr)
        return 2
    kw = {}
    if args.batch_buckets:
        kw["batch_buckets"] = tuple(
            int(b) for b in args.batch_buckets.split(",")
        )
    engine = GenerativeEngine(args.artifact, device=args.device, **kw)
    engine.warmup()
    serve_dir = args.serve_dir or os.path.join(args.artifact, "serve")
    telemetry = obs.Telemetry.for_run(
        os.path.join(serve_dir, "serving.jsonl"),
        obs.run_manifest(
            config={"mode": "serving", "network": network,
                    "artifact": args.artifact,
                    "batch_buckets": list(engine.batch_buckets),
                    "generative": True, "device": str(engine.device)},
            param_count=engine.manifest.get("param_count"),
            artifact_identity=engine.identity,
        ),
    )
    scheduler = GenerateScheduler(engine, telemetry=telemetry,
                                  default_timeout_s=args.timeout,
                                  max_queue=args.max_queue)
    server = ServingServer(scheduler, host=args.host, port=args.port)
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(server.port))

    def _drain(signum, frame):
        server.begin_drain()
        threading.Thread(target=lambda: (scheduler.drain(),
                                         server.close()),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    print(f"serving GENERATIVE {args.artifact} on "
          f"http://{server.host}:{server.port} ({engine.device}; "
          f"stream: {serve_dir})", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()
    finally:
        scheduler.close()
        telemetry.close()
    return 0


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
    trainer = Trainer(train_config(args), device=args.device)
    try:
        trainer.train()
        trainer.evaluate()
    finally:
        trainer.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pytorch_distributed_nn_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    _add_train_flags(sub.add_parser(
        "train", help="train a text model on one device"))
    serve = sub.add_parser("serve", help="serving commands")
    ssub = serve.add_subparsers(dest="serve_cmd", required=True)
    run = ssub.add_parser("run", help="serve a generative artifact")
    run.add_argument("--artifact", required=True)
    run.add_argument("--host", default="127.0.0.1")
    run.add_argument("--port", type=int, default=8000)
    run.add_argument("--device", default=None,
                     help="torch device (default: the card; 'cpu' runs "
                          "the kernels' plain versions)")
    run.add_argument("--batch-buckets", default=None,
                     help="comma-separated decode batch buckets")
    run.add_argument("--timeout", type=float, default=30.0,
                     help="default per-request deadline, seconds")
    run.add_argument("--max-queue", type=int, default=None)
    run.add_argument("--serve-dir", default=None)
    run.add_argument("--port-file", default=None,
                     help="write the bound port here (use with --port 0)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "train":
        return _train(args)
    return _serve_run(args)
