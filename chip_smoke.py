#!/usr/bin/env python3
"""Drive the PyTorch port's generative serving path on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out report.json]

Phases, each printed on its own line:

1. the card's name and power limit (``nvidia-smi``) and the torch/CUDA
   versions;
2. build every hand-written kernel from ``pytorch_distributed_nn_tpu_torch/
   ops/csrc/`` (one ``nvcc`` per source, in parallel), timed;
3. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes — decode attention over every (batch bucket,
   cache bucket) pair of GptMini in float32 and bfloat16, LayerNorm at
   (N, 128) float32 and bfloat16-in/float32-out — and fail past the
   stated tolerance;
4. write a random-init GptMini artifact (``fused_ln: true``, weights from
   a seeded ``torch.Generator``) with ``save_artifact``, serve it with the
   port's server on an ephemeral port, and answer a burst of concurrent
   ``POST /v1/generate`` requests of mixed prompt lengths. The kernels'
   launch counts are set to 0 just before the burst and read just after;
   every kernel must have launched. Then check the responses, that no
   kernel was built after warmup (``retraces() == 0``), that no fenced
   page was decoded, and one request's served logits (prefill and
   teacher-forced decode steps) against a full-recompute plain forward
   on the card;
5. timings: each kernel, its plain version and the nearest single
   PyTorch call (CUDA events over 200 launches), a decode step at the
   largest batch and cache bucket, tokens/s and time to first token of
   the burst;
6. one JSON line listing the kernels (launches on the main path, error
   against the plain version, times, least possible time), then the
   result line ``{"ok": true, "device": {...}}``.

It needs one card and exits non-zero, printing no result, without one,
when any phase fails, or when run outside the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

#: NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth and the f32
#: rate outside the tensor cores, where both kernels do their arithmetic
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGITS_TOL = 1e-4
N_TIMED = 200


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def time_ms(fn, n: int = N_TIMED, graph: bool = True) -> float:
    """Mean ms per call of ``fn`` on the card, timed with CUDA events.

    ``graph=True`` captures ``n`` calls into one CUDA graph and times its
    replay: the device's own time per call, free of the host's launch
    cost. ``graph=False`` times ``n`` eager calls back to back, which at
    these sizes measures how fast the host can launch. The last output
    is checked finite either way."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(10):
            out = fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                out = fn()
        g.replay()
        torch.cuda.synchronize()
        reps = 5
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        n *= reps
    else:
        start.record()
        for _ in range(n):
            out = fn()
        end.record()
        torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail("timed call produced non-finite values")
    return start.elapsed_time(end) / n


def attn_inputs(B, S, H, D, dtype, positions, gen):
    import torch

    q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype)
               for shape in ((B, 1, H, D), (B, S, H, D), (B, S, H, D)))
    pos = torch.as_tensor(positions, dtype=torch.int32, device="cuda")
    return q, k, v, pos


def attn_cost(B, S, H, D, elem, positions):
    """Bytes and FLOPs decode attention must spend on these inputs: q,
    the live K/V rows (0..pos per row), positions, the output."""
    live = sum(min(int(p), S - 1) + 1 for p in positions)
    nbytes = 2 * B * H * D * elem + 2 * live * H * D * elem + 4 * B
    flops = live * H * (4 * D + 4)
    return nbytes, flops


def ln_cost(N, D, in_elem, out_elem):
    return N * D * (in_elem + out_elem) + 2 * D * 4, 8 * N * D


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sweep(kernels, reference, F, H, Dh, d_model, gen):
    """Device time (CUDA graph replay) of each kernel, its plain version
    and the library call at every shape the serving path gives it."""
    import torch

    rows = []
    for dtype, elem in ((torch.float32, 4), (torch.bfloat16, 2)):
        for S in (16, 32, 64, 128):
            for B in (1, 2, 4, 8):
                pos = [S - 1] * B
                q, k, v, p = attn_inputs(B, S, H, Dh, dtype, pos, gen)
                valid = torch.arange(S, device="cuda")[None] <= p[:, None]
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                rows.append({
                    "kernel": "decode_attention", "dtype": str(dtype),
                    "B": B, "S": S,
                    "ms": time_ms(lambda: kernels.decode_attention(q, k, v, p)),
                    "plain_ms": time_ms(
                        lambda: reference.decode_attention(q, k, v, p)),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=valid[:, None, None, :])),
                    "bound_ms": bound_ms(*attn_cost(B, S, H, Dh, elem, pos))[0],
                })
    for in_dt, elem in ((torch.float32, 4), (torch.bfloat16, 2)):
        for N in (1, 8, 16, 32, 64, 128):
            x = torch.randn((N, d_model), generator=gen).to("cuda", in_dt)
            g = torch.ones(d_model, device="cuda")
            b = torch.zeros(d_model, device="cuda")
            rows.append({
                "kernel": "layer_norm", "dtype": f"{in_dt}->torch.float32",
                "N": N,
                "ms": time_ms(lambda: kernels.layer_norm(
                    x, g, b, 1e-6, torch.float32)),
                "plain_ms": time_ms(lambda: reference.layer_norm(
                    x, g, b, 1e-6, torch.float32)),
                "library_ms": time_ms(lambda: F.layer_norm(
                    x.float(), (d_model,), g, b, 1e-6)),
                "bound_ms": bound_ms(*ln_cost(N, d_model, elem, 4))[0],
            })
    return rows


def profile_decode(engine, kvs, steps: int = 10):
    """torch.profiler over ``steps`` decode steps at the largest batch and
    cache bucket: wall time, device time by kernel, device busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    B, S = engine.batch_buckets[-1], engine.seq_buckets[-1]
    slots = [engine.pools[S].alloc(engine.epoch) for _ in range(B)]
    for s in slots:
        engine.insert(S, s, kvs)
    engine.decode(S, slots, [1] * B, [S - steps - 1] * B)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            engine.decode(S, slots, [1] * B, [S - steps + i] * B)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for s in slots:
        engine.pools[S].free(s)
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the host ops that
        # launched them report the same time again
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": e.key, "count": e.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    device_ms = sum(r["device_ms"] for r in rows)
    return {"B": B, "S": S, "steps": steps, "wall_ms": wall_ms,
            "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "top": rows[:15]}


def post(url, doc, timeout=120.0):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here, with a "
                         "per-shape kernel sweep and a profile of decode "
                         "steps")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card",
             code=2)
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "pytorch_distributed_nn_tpu_torch")):
        fail(f"the port's package is not beside {__file__}", code=2)
    sys.path.insert(0, repo)

    import numpy as np
    import torch.nn.functional as F

    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.ops import kernels, reference
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        save_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.serving.generate import (
        GenerateScheduler,
        GenerativeEngine,
    )
    from pytorch_distributed_nn_tpu_torch.serving.server import ServingServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"phases": {}}

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"phase 1 card: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    report["card"] = smi

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {sorted(kernels.KERNELS)} built and loaded in "
        f"{build_s:.3f} s")
    report["phases"]["build_s"] = build_s

    # -- 3. kernels vs plain versions at GptMini shapes -------------------
    gen = torch.Generator().manual_seed(args.seed)
    cfg = build_model("GptMini").config
    H, Dh, d_model = cfg.num_heads, cfg.d_model // cfg.num_heads, cfg.d_model
    errs = {"decode_attention": 0.0, "layer_norm": 0.0}
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for S in (16, 32, 64, 128):
            for B in (1, 2, 4, 8):
                rng = np.random.RandomState(S * 10 + B)
                pos = rng.randint(0, S, size=B)
                pos[0], pos[-1] = 0, S - 1
                q, k, v, p = attn_inputs(B, S, H, Dh, dtype, pos, gen)
                got = kernels.decode_attention(q, k, v, p)
                torch.cuda.synchronize()
                want = reference.decode_attention(q, k, v, p)
                err = (got.float() - want.float()).abs().max().item()
                checks.append(("decode_attention", str(dtype), B, S, err))
                errs["decode_attention"] = max(errs["decode_attention"], err)
                if not err <= tol:
                    fail(f"decode_attention B={B} S={S} {dtype}: max abs "
                         f"err {err} > {tol}")
    for in_dt, out_dt in ((torch.float32, torch.float32),
                          (torch.bfloat16, torch.float32)):
        for N, D in ((1, d_model), (8, d_model), (128, d_model),
                     (1000, d_model), (37, 200)):
            x = (torch.randn((N, D), generator=gen) * 3 + 1).to("cuda", in_dt)
            g = (1 + 0.1 * torch.randn((D,), generator=gen)).cuda()
            b = (0.1 * torch.randn((D,), generator=gen)).cuda()
            got = kernels.layer_norm(x, g, b, 1e-6, out_dt)
            torch.cuda.synchronize()
            want = reference.layer_norm(x, g, b, 1e-6, out_dt)
            err = (got.float() - want.float()).abs().max().item()
            checks.append(("layer_norm", f"{in_dt}->{out_dt}", N, D, err))
            errs["layer_norm"] = max(errs["layer_norm"], err)
            if not err <= TOL["float32"]:
                fail(f"layer_norm ({N},{D}) {in_dt}->{out_dt}: max abs err "
                     f"{err} > {TOL['float32']}")
    log(f"phase 3 kernels vs plain: {len(checks)} cases pass; max abs err "
        f"decode_attention {errs['decode_attention']:.3e} (tol f32 "
        f"{TOL['float32']}, bf16 {TOL['bfloat16']}), layer_norm "
        f"{errs['layer_norm']:.3e} (tol {TOL['float32']})")
    report["checks"] = checks

    # -- 4. the main path: serve a GptMini artifact -----------------------
    workdir = tempfile.mkdtemp(prefix="pdtn-chip-smoke-")
    model = build_model("GptMini", fused_ln=True).init_weights(
        torch.Generator().manual_seed(args.seed)
    )
    art = os.path.join(workdir, "artifact")
    save_artifact(art, model.state_dict(), "GptMini",
                  model_kw={"fused_ln": True},
                  source={"train_dir": f"random-init-seed{args.seed}",
                          "step": 0, "checkpoint": None})
    engine = GenerativeEngine(art)
    warm_s = engine.warmup()
    scheduler = GenerateScheduler(engine, default_timeout_s=120.0)
    server = ServingServer(scheduler, port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    rng = np.random.RandomState(args.seed)
    max_new = 16
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in (3, 9, 17, 30, 45, 60, 90, 110)]
    results = [None] * len(prompts)

    def one(i):
        results[i] = post(url, {"inputs": [prompts[i]],
                                "max_new_tokens": max_new})

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        kernels.reset_launch_counts()
        t_burst = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t_burst
        launches = kernels.launch_counts()
    finally:
        scheduler.close()
        server.close()
    for name in kernels.KERNELS:
        if launches[name] < 1:
            fail(f"the main path never launched kernel {name}: {launches}")
    for i, r in enumerate(results):
        if r is None or r[0] != 200:
            fail(f"request {i} failed: {r}")
        out = r[1]["outputs"][0]
        if len(out) != max_new or not all(0 <= t < cfg.vocab_size
                                          for t in out):
            fail(f"request {i}: bad tokens {out}")
    if engine.retraces() != 0:
        fail(f"retraces() = {engine.retraces()} after warmup")
    if engine.fence_violations != 0:
        fail(f"fence_violations = {engine.fence_violations}")

    # one request's served logits vs a full-recompute plain forward
    plain = build_model("GptMini", fused_ln=True, use_kernels=False)
    plain.load_state_dict(model.state_dict())
    plain = plain.cuda().eval()
    prompt, toks = prompts[3], results[3][1]["outputs"][0]
    seq = torch.as_tensor([prompt + toks], device="cuda")
    with torch.inference_mode():
        ref = plain(seq)[0].float().cpu().numpy()
    bucket = engine.select_seq_bucket(len(prompt) + max_new)
    logits, kvs, _ = engine.prefill(np.asarray(prompt, np.int32))
    logit_err = float(np.abs(logits - ref[len(prompt) - 1]).max())
    slot = engine.pools[bucket].alloc(engine.epoch)
    engine.insert(bucket, slot, kvs)
    for i, tok in enumerate(toks[:-1]):
        pos = len(prompt) + i
        step, _ = engine.decode(bucket, [slot], [tok], [pos])
        logit_err = max(logit_err, float(np.abs(step[0] - ref[pos]).max()))
    engine.pools[bucket].free(slot)
    if not logit_err <= LOGITS_TOL:
        fail(f"served logits vs full-recompute plain forward: max abs err "
             f"{logit_err} > {LOGITS_TOL}")
    new_tokens = sum(len(r[1]["outputs"][0]) for r in results)
    ttft = sorted(r[1]["ttft_ms"][0] for r in results)
    log(f"phase 4 serve: GptMini (fused_ln, seed {args.seed}) warmed in "
        f"{warm_s:.3f} s; {len(results)} concurrent requests -> 200; "
        f"launches {launches}; retraces {engine.retraces()}; "
        f"fence_violations {engine.fence_violations}; served logits vs "
        f"plain full recompute max abs err {logit_err:.3e} (tol {LOGITS_TOL})")

    # -- 5. timings -------------------------------------------------------
    B, S = engine.batch_buckets[-1], engine.seq_buckets[-1]
    slots = [engine.pools[S].alloc(engine.epoch) for _ in range(B)]
    for s in slots:
        engine.insert(S, s, kvs)
    steps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        engine.decode(S, slots, [1] * B, [S - steps + i] * B)
    decode_step_ms = (time.perf_counter() - t0) * 1e3 / steps
    for s in slots:
        engine.pools[S].free(s)

    entries = []
    pos = [S - 1] * B
    q, k, v, p = attn_inputs(B, S, H, Dh, torch.float32, pos, gen)
    valid = (torch.arange(S, device="cuda")[None] <= p[:, None].long())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes, flops = attn_cost(B, S, H, Dh, 4, pos)
    bms, by = bound_ms(nbytes, flops)
    run = lambda: kernels.decode_attention(q, k, v, p)  # noqa: E731
    entries.append({
        "name": "decode_attention", "route": "cuda",
        "source": kernels.KERNELS["decode_attention"]["source"],
        "replaces": kernels.KERNELS["decode_attention"]["replaces"],
        "launches": launches["decode_attention"],
        "max_abs_err": errs["decode_attention"],
        "ms": time_ms(run),
        "plain_ms": time_ms(lambda: reference.decode_attention(q, k, v, p)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=valid[:, None, None, :])),
        "eager_ms": time_ms(run, graph=False),
        "shape": f"B={B} S={S} H={H} D={Dh} float32, positions S-1",
    })
    N = B
    x = torch.randn((N, d_model), generator=gen).cuda()
    g = torch.ones(d_model, device="cuda")
    b = torch.zeros(d_model, device="cuda")
    nbytes, flops = ln_cost(N, d_model, 4, 4)
    bms, by = bound_ms(nbytes, flops)
    run = lambda: kernels.layer_norm(x, g, b, 1e-6)  # noqa: E731
    entries.append({
        "name": "layer_norm", "route": "cuda",
        "source": kernels.KERNELS["layer_norm"]["source"],
        "replaces": kernels.KERNELS["layer_norm"]["replaces"],
        "launches": launches["layer_norm"],
        "max_abs_err": errs["layer_norm"],
        "ms": time_ms(run),
        "plain_ms": time_ms(lambda: reference.layer_norm(x, g, b, 1e-6)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(
            lambda: F.layer_norm(x, (d_model,), g, b, 1e-6)),
        "eager_ms": time_ms(run, graph=False),
        "shape": f"N={N} D={d_model} float32 -> float32",
    })
    if args.out:
        report["sweep"] = sweep(kernels, reference, F, H, Dh, d_model, gen)
        report["decode_profile"] = profile_decode(engine, kvs)
    for e in entries:
        log(f"phase 5 kernel {e['name']} ({e['shape']}): {e['ms']:.6f} ms; "
            f"plain {e['plain_ms']:.6f} ms; library {e['library_ms']:.6f} "
            f"ms; bound {e['bound_ms']:.6f} ms ({e['bound_by']}); eager "
            f"back-to-back {e['eager_ms']:.6f} ms per call")
    tok_s = new_tokens / burst_s
    log(f"phase 5 serving: decode step (B={B}, S={S}) {decode_step_ms:.3f} "
        f"ms; burst of {len(results)} requests: {new_tokens} tokens in "
        f"{burst_s:.3f} s = {tok_s:.1f} tokens/s; TTFT p50 "
        f"{ttft[len(ttft) // 2]:.3f} ms, max {ttft[-1]:.3f} ms")
    report["phases"].update({
        "warmup_s": warm_s, "launches": launches, "logit_err": logit_err,
        "decode_step_ms": decode_step_ms, "burst_s": burst_s,
        "tokens_per_s": tok_s, "ttft_ms": ttft,
    })
    report["kernels"] = entries
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)

    # -- 6. result lines --------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
