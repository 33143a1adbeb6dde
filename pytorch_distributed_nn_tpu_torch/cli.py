"""Command line of the port.

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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pytorch_distributed_nn_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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
    return _serve_run(args)
