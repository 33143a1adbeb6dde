#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card: generative serving
of GptMini and MLM training of BertBase (and GptMini).

    python3 chip_smoke.py [--seed 0] [--out report.json]

Phases, each printed on its own line:

1. the card's name and power limit (``nvidia-smi``) and the torch/CUDA
   versions;
2. build every hand-written kernel from ``pytorch_distributed_nn_tpu_torch/
   ops/csrc/`` (one ``nvcc`` per source, in parallel), timed;
3. hold each kernel against its plain PyTorch version on the card, with
   TF32 off for the f32 comparisons: decode attention over every (batch
   bucket, cache bucket) pair of GptMini and LayerNorm at (N, 128), as
   before; flash attention forward (out, lse), dq and dk/dv at BertBase
   shapes (B 1 and 16, L 128 and 512, 12 heads of 64) and GptMini's
   (8 x 128, 4 heads of 32, causal), f32 and bf16, with and without a pad
   mask, causal and not; LayerNorm forward (y, mu, rs) and backward at
   (16*512, 768) and (1000, 128), f32 and bf16-in/f32-out. Fails past the
   stated tolerance;
4. serving: write a random-init GptMini artifact, serve it with the
   port's server on an ephemeral port, answer a burst of concurrent
   ``POST /v1/generate`` requests; check the responses, that the serving
   kernels launched, that no kernel was built after warmup
   (``retraces() == 0``), and one request's served logits against a
   full-recompute plain forward on the card;
5. training: BertBase at full width (12 x 768, L 512, vocab 30522) through
   the port's ``Trainer`` (the object the ``train`` CLI builds) with
   ``--dtype bfloat16 --attn-impl pallas --fused-ln --optimizer adam``,
   B = 16, 10 steps, then ``evaluate()`` on 2 batches. Checks: every loss
   finite, the last below the first, the loss on the fixed eval set lower
   after the steps than before them, and the exact launch counts per step
   (flash fwd, dq and dk/dv 12 each, LayerNorm fwd and bwd 26 each) and
   per eval batch (12 and 26). Then one gradient check: at the same
   weights and batch, f32, B = 2, every parameter's gradient of the
   kernel model against the plain model on the card, relative to the
   size of the plain gradient (``leaf_grad_errors``). Then GptMini for 3
   steps the same way (causal flash kernels; finite losses and exact
   launch counts: 3 steps of a 1k vocabulary move its loss less than
   one batch differs from the next);
6. timings: each kernel, its plain version and the nearest single
   PyTorch call by CUDA-graph replay (the serving kernels at GptMini's
   decode shapes as before; the training kernels at BertBase's training
   shapes, bf16), beside the least time the card could take; the
   serving decode step, tokens/s and TTFT; the BertBase training step
   and tokens/s with ``--attn-impl pallas`` and, as a second line,
   ``--attn-impl full``. ``--out`` adds a per-shape sweep, a profile of
   decode steps and a ``torch.profiler`` breakdown of 5 training steps;
7. one JSON line listing the kernels (launches on the driven paths, error
   against the plain version, times, least possible time), then the
   result line ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before each driven path (the served
burst, the training steps, the eval pass) and read just after it.

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

#: NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth, the f32 rate
#: outside the tensor cores and the bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
PEAK_FLOPS = {"float32": F32_FLOPS_PER_S, "bfloat16": 989e12}

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGITS_TOL = 1e-4
#: flash attention vs its plain version, (atol, rtol): f32 sums of up to
#: L products (reduction order); bf16 outputs keep 8 bits, and the forward
#: rounds p against each 64-key tile's running max, the plain version
#: against the row's max
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
#: LayerNorm backward: dx at 1e-4 (two row means subtracted), dgamma and
#: dbeta (sums over up to 8192 rows) at 1e-4 relative
LN_BWD_TOL = (1e-4, 1e-4)
#: gradients of the whole BertBase (12 layers, f32), kernels vs plain:
#: per parameter, max |g - g_plain| / max |g_plain|
GRAD_TOL = 1e-4
N_TIMED = 200
#: graph-replayed calls per timing at the training shapes (ms-scale calls)
N_TIMED_TRAIN = 20
TRAIN_STEPS = 10


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
    """Least time for ``nbytes`` of memory traffic and ``flops``: a number
    (f32 on the CUDA cores) or a list of (flops, dtype) products, each at
    the card's peak for its type."""
    if not isinstance(flops, list):
        flops = [(flops, "float32")]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[t] for f, t in flops) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_costs(B, L, H, D, dtype, causal=False, mask=None):
    """Bytes and typed FLOPs each flash kernel must spend on these inputs
    (each input read once, each output written once; score pairs counted
    as this run's mask and causal flag need them). The products' types
    follow the TPU kernels' rounding points: the forward and dq multiply
    inputs of ``dtype``; dk/dv's p^T dO and ds^T Q are f32 by definition."""
    elem = 2 if dtype == "bfloat16" else 4
    n = B * L * H * D * elem
    rows = B * H * L * 4
    keys = [L] * B if mask is None else [int(m.sum()) for m in mask]
    if causal:
        pairs = H * sum(sum(min(i + 1, kb) for i in range(L)) for kb in keys)
    else:
        pairs = H * L * sum(keys)
    mask_b = 0 if mask is None else B * L * 4
    prod = 2 * pairs * D
    return {
        "flash_attention_fwd": (4 * n + rows + mask_b,
                                [(2 * prod, dtype)]),
        "flash_attention_dq": (5 * n + 2 * rows + mask_b,
                               [(3 * prod, dtype)]),
        "flash_attention_dkv": (6 * n + 2 * rows + mask_b,
                                [(2 * prod, dtype), (2 * prod, "float32")]),
    }


def ln_bwd_cost(N, D, x_elem, dy_elem):
    return (N * D * (2 * x_elem + dy_elem) + 8 * N + 3 * D * 4,
            10 * N * D)


def excess(got, want, atol, rtol=0.0):
    """(largest error past atol + rtol * |want| (<= 0 passes), max abs err)"""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    return (d - atol - rtol * want.abs()).max().item(), d.max().item()


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


def check_training_kernels(kernels, reference, gen):
    """Phase 3, training kernels: flash fwd / dq / dk-dv and LayerNorm
    fwd (y, mu, rs) / bwd against their plain versions on the card.
    Returns (cases, max abs err per kernel)."""
    import torch

    errs = {k: 0.0 for k in ("flash_attention_fwd", "flash_attention_dq",
                             "flash_attention_dkv", "layer_norm_bwd")}
    cases = []

    def record(name, what, exc_err, tol):
        over, err = exc_err
        errs[name] = max(errs[name], err)
        cases.append((name, what, err))
        if not over <= 0:
            fail(f"{name} {what}: max abs err {err} past tolerance {tol}")

    shapes = []  # (B, L, H, D, causal, pad)
    for L in (128, 512):
        for causal in (False, True):
            for pad in (0, 19):
                shapes.append((1, L, 12, 64, causal, pad))
        shapes.append((16, L, 12, 64, False, 0))
    shapes += [(16, 512, 12, 64, True, 37), (8, 128, 4, 32, True, 0)]
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        for B, L, H, D, causal, pad in shapes:
            q, k, v, do = (torch.randn((B, L, H, D), generator=gen)
                           .to("cuda", dtype) for _ in range(4))
            mask = None
            if pad:
                mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
                mask[-1, L - pad:] = 0
            what = f"B={B} L={L} H={H} D={D} {dtype} causal={causal} pad={pad}"
            out, lse = kernels.flash_attention_fwd(q, k, v, mask, causal)
            torch.cuda.synchronize()
            w_out, w_lse = reference.flash_attention_fwd(q, k, v, mask, causal)
            record("flash_attention_fwd", what + " out",
                   excess(out, w_out, *tol), tol)
            record("flash_attention_fwd", what + " lse",
                   excess(lse, w_lse, 1e-4, 1e-5), (1e-4, 1e-5))
            delta = reference.flash_attention_delta(w_out, do)
            dq = kernels.flash_attention_dq(q, k, v, mask, w_lse, delta, do,
                                            causal)
            dk, dv = kernels.flash_attention_dkv(q, k, v, mask, w_lse, delta,
                                                 do, causal)
            torch.cuda.synchronize()
            record("flash_attention_dq", what, excess(
                dq, reference.flash_attention_dq(q, k, v, mask, w_lse, delta,
                                                 do, causal), *tol), tol)
            w_dk, w_dv = reference.flash_attention_dkv(q, k, v, mask, w_lse,
                                                       delta, do, causal)
            record("flash_attention_dkv", what + " dk",
                   excess(dk, w_dk, *tol), tol)
            record("flash_attention_dkv", what + " dv",
                   excess(dv, w_dv, *tol), tol)
            del q, k, v, do, out, lse, w_out, w_lse, dq, dk, dv, w_dk, w_dv
    ln_fwd_err = 0.0
    for in_dt in (torch.float32, torch.bfloat16):
        for N, D in ((16 * 512, 768), (1000, 128)):
            x = (torch.randn((N, D), generator=gen) * 3 + 1).to("cuda", in_dt)
            g = (1 + 0.1 * torch.randn((D,), generator=gen)).cuda()
            b = (0.1 * torch.randn((D,), generator=gen)).cuda()
            dy = torch.randn((N, D), generator=gen).cuda()
            what = f"({N},{D}) {in_dt}->float32"
            y, mu, rs = kernels.layer_norm_fwd(x, g, b, 1e-6, torch.float32)
            torch.cuda.synchronize()
            w = reference.layer_norm_fwd(x, g, b, 1e-6, torch.float32)
            for got, want, name in zip((y, mu, rs), w, ("y", "mu", "rs")):
                over, err = excess(got, want, TOL["float32"],
                                   TOL["float32"] if name == "rs" else 0.0)
                ln_fwd_err = max(ln_fwd_err, err)
                cases.append(("layer_norm", f"{what} {name}", err))
                if not over <= 0:
                    fail(f"layer_norm {what} {name}: max abs err {err}")
            got = kernels.layer_norm_bwd(x, g, w[1], w[2], dy)
            torch.cuda.synchronize()
            want = reference.layer_norm_bwd(x, g, w[1], w[2], dy)
            dx_tol = LN_BWD_TOL if in_dt == torch.float32 else (2e-2, 1e-2)
            record("layer_norm_bwd", what + " dx",
                   excess(got[0], want[0], *dx_tol), dx_tol)
            for a, ww, name in zip(got[1:], want[1:], ("dgamma", "dbeta")):
                record("layer_norm_bwd", f"{what} {name}",
                       excess(a, ww, *LN_BWD_TOL), LN_BWD_TOL)
    errs["layer_norm_train"] = ln_fwd_err
    return cases, errs


def train_config(network, steps, attn_impl="pallas", **kw):
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    base = dict(network=network, dataset="MLMSynth", optimizer="adam",
                lr=1e-4, attn_impl=attn_impl, fused_ln=True,
                dtype="bfloat16", batch_size=16, max_steps=steps,
                eval_batches=2, test_batch_size=16)
    base.update(kw)
    return TrainConfig(**base)


def expect_launches(kernels, got, per, n, what):
    """Fail unless every training kernel launched exactly per[k] * n times
    (and decode attention not at all)."""
    want = {k: per.get(k, 0) * n for k in kernels.KERNELS}
    if got != want:
        fail(f"{what}: launch counts {got}, expected {want}")


def train_path(kernels, network, seed, steps, must_learn=True):
    """Train ``network`` through the Trainer for ``steps`` steps, then
    evaluate; launch counts read around each. With ``must_learn`` the
    last loss must be below the first and the fixed eval set's loss must
    fall. Returns the facts."""
    import math

    import torch

    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    trainer = Trainer(train_config(network, steps, seed=seed))
    cfg = trainer.model.config
    L = cfg.num_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_dq": L,
                "flash_attention_dkv": L, "layer_norm": 2 * L + 2,
                "layer_norm_bwd": 2 * L + 2}
    if network.startswith("Gpt"):
        per_step["layer_norm"] = per_step["layer_norm_bwd"] = 2 * L + 1
    per_eval = {"flash_attention_fwd": L,
                "layer_norm": per_step["layer_norm"]}
    try:
        ev0 = trainer.evaluate()  # the fixed eval set, before any step
        kernels.reset_launch_counts()
        history = trainer.train()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        kernels.reset_launch_counts()
        ev = trainer.evaluate()
        torch.cuda.synchronize()
        eval_launches = kernels.launch_counts()
    finally:
        trainer.close()
    losses = [r["loss"] for r in history]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"{network} training losses {losses}")
    if must_learn and not losses[-1] < losses[0]:
        fail(f"{network} training loss did not fall: {losses}")
    if not all(math.isfinite(v) for v in ev.values()) or not ev:
        fail(f"{network} eval {ev}")
    if must_learn and not ev["loss"] < ev0["loss"]:
        fail(f"{network} eval loss on the fixed eval set did not fall: "
             f"{ev0['loss']} -> {ev['loss']}")
    expect_launches(kernels, launches, per_step, steps, f"{network} train")
    expect_launches(kernels, eval_launches, per_eval,
                    trainer.config.eval_batches, f"{network} eval")
    step_ms = sorted(r["step_ms"] for r in history[1:])
    return {"trainer": trainer, "losses": losses, "eval": ev,
            "eval_before": ev0,
            "launches": launches, "eval_launches": eval_launches,
            "per_step": per_step, "step_ms": step_ms[len(step_ms) // 2],
            "tokens_per_s": trainer.config.batch_size * trainer.seq_len
            / (step_ms[len(step_ms) // 2] / 1e3),
            "params": sum(p.numel() for p in trainer.model.parameters())}


def leaf_grad_errors(got, want):
    """name -> (relative error, gradient size) of every parameter: max
    |g - g_plain| / max |g_plain|, and max |g_plain|. A missing or
    non-finite gradient reads inf. The key projection's bias has gradient
    zero in exact arithmetic (softmax does not change when one shift is
    added to every key of a row), so both sides read rounding there; it
    is held against the size of its weight's gradient instead."""
    import math

    out = {}
    for name, w in want.items():
        g = got.get(name)
        size = w.abs().max().item()
        scale = size
        if name.endswith("key.bias"):
            scale = want[name[:-len("bias")] + "weight"].abs().max().item()
        if g is None:
            out[name] = (math.inf, size)
            continue
        err = (g - w).abs().max().item()
        rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        out[name] = (rel if math.isfinite(rel) else math.inf, size)
    return out


def grad_check(kernels, reference, seed):
    """Gradients of BertBase (f32, B = 2, L = 512) on the kernels against
    the plain model at the same weights and batch. Returns every
    parameter's (relative error, gradient size) and the worst leaf."""
    import torch

    from pytorch_distributed_nn_tpu_torch.data.text import MLMBatches
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.ops.metrics import (
        masked_cross_entropy,
    )

    kw = dict(dtype="float32", dropout_rate=0.0)
    fast = build_model("BertBase", attn_fn=kernels.flash_attention, **kw)
    fast.init_weights(torch.Generator().manual_seed(seed))
    plain = build_model("BertBase", use_kernels=False,
                        attn_fn=reference.flash_attention, **kw)
    plain.load_state_dict(fast.state_dict())
    x, y = next(MLMBatches(vocab_size=30522, seq_len=512, batch_size=2,
                           seed=seed))
    x, y = (torch.from_numpy(a).long().cuda() for a in (x, y))
    grads = []
    for model in (fast, plain):
        model.cuda().train()
        masked_cross_entropy(model(x), y).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        model.cpu()
    errs = leaf_grad_errors(*grads)
    where = max(errs, key=lambda n: errs[n][0])
    if not errs[where][0] <= GRAD_TOL:
        fail(f"gradient check: relative error {errs[where][0]} at {where} "
             f"> {GRAD_TOL}")
    return errs, where


def train_step_ms(network, attn_impl, steps, seed):
    """Median step ms of a fresh Trainer over ``steps`` steps (the first,
    warming cuBLAS and the allocator, left out)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    trainer = Trainer(train_config(network, steps, attn_impl, seed=seed))
    try:
        history = trainer.train()
    finally:
        trainer.close()
    ms = sorted(r["step_ms"] for r in history[1:])
    del trainer
    torch.cuda.empty_cache()
    return ms[len(ms) // 2]


def profile_train(trainer, steps: int = 5):
    """torch.profiler over ``steps`` training steps: wall time, device
    time by kernel, device busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batches = [trainer.train_loader.next_batch() for _ in range(steps + 1)]
    trainer.train_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            trainer.train_step(trainer.state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernels and copies only: user annotations (the optimizer's
        # "Optimizer.step#..." range) span device time other rows count
        if not str(getattr(e, "device_type", "")).endswith("CUDA") \
                or getattr(e, "is_user_annotation", False) or "#" in e.key:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": e.key, "count": e.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    device_ms = sum(r["device_ms"] for r in rows)
    return {"steps": steps, "wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "top": rows[:20]}


def time_training_kernels(kernels, reference, F, gen, launches, errs):
    """Phase 6 entries of the training kernels at BertBase's training
    shapes (B 16, L 512, 12 heads of 64, bf16, no mask, not causal)."""
    import torch

    B, L, H, D, dt = 16, 512, 12, 64, torch.bfloat16
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen).to("cuda", dt)
                   for _ in range(4))
    out, lse = kernels.flash_attention_fwd(q, k, v)
    delta = reference.flash_attention_delta(out, do)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    costs = flash_costs(B, L, H, D, "bfloat16")
    shape = f"B={B} L={L} H={H} D={D} bfloat16, no mask, not causal"
    n = N_TIMED_TRAIN
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), n)
    # the library's flash attention as single aten calls on the (B, H, L,
    # D) views: its backward computes dq, dk and dv from q, k, v, out, lse
    # and dO in one call, the function of the dq and dk/dv kernels together
    lib_fwd = torch.ops.aten._scaled_dot_product_flash_attention
    lib_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    dot = do.transpose(1, 2)

    def library_backward(fwd):
        o, lse_l, cq, ck, mq, mk, seed, offset = fwd[:8]
        return lib_bwd(dot, qt, kt, vt, o, lse_l, cq, ck, mq, mk, 0.0, False,
                       seed, offset)

    fwd = lib_fwd(qt, kt, vt)
    lib_grads = [g.transpose(1, 2) for g in library_backward(fwd)]
    dq_k = kernels.flash_attention_dq(q, k, v, None, lse, delta, do)
    dk_k, dv_k = kernels.flash_attention_dkv(q, k, v, None, lse, delta, do)
    lib_diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip((dq_k, dk_k, dv_k), lib_grads))
    sdpa_bwd = time_ms(lambda: library_backward(fwd)[0], n)
    sdpa_both = time_ms(lambda: library_backward(lib_fwd(qt, kt, vt))[0], n)
    del fwd, lib_grads, dq_k, dk_k, dv_k
    calls = {
        "flash_attention_fwd": (
            lambda: kernels.flash_attention_fwd(q, k, v)[0],
            lambda: reference.flash_attention_fwd(q, k, v)[0], sdpa_fwd),
        "flash_attention_dq": (
            lambda: kernels.flash_attention_dq(q, k, v, None, lse, delta, do),
            lambda: reference.flash_attention_dq(q, k, v, None, lse, delta,
                                                 do), sdpa_bwd),
        "flash_attention_dkv": (
            lambda: kernels.flash_attention_dkv(q, k, v, None, lse, delta,
                                                do)[0],
            lambda: reference.flash_attention_dkv(q, k, v, None, lse, delta,
                                                  do)[0], sdpa_bwd),
    }
    entries = []
    for name, (run, plain, lib) in calls.items():
        bms, by = bound_ms(*costs[name])
        entries.append({
            "name": name, "route": "cuda",
            "source": kernels.KERNELS[name]["source"],
            "replaces": kernels.KERNELS[name]["replaces"],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": time_ms(run, n), "plain_ms": time_ms(plain, n),
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "sdpa_fwd_bwd_ms": sdpa_both, "library_vs_kernels": lib_diff,
            "shape": shape,
        })
    del q, k, v, do, out, lse, delta
    N, Dm = B * L, 768
    x = torch.randn((N, Dm), generator=gen).to("cuda", dt)
    g = (1 + 0.1 * torch.randn((Dm,), generator=gen)).cuda()
    b = torch.zeros(Dm, device="cuda")
    dy = torch.randn((N, Dm), generator=gen).cuda()
    _, mu, rs = kernels.layer_norm_fwd(x, g, b, 1e-6, torch.float32)
    xf = x.float()
    bms, by = bound_ms(*ln_bwd_cost(N, Dm, 2, 4))
    entries.append({
        "name": "layer_norm_bwd", "route": "cuda",
        "source": kernels.KERNELS["layer_norm_bwd"]["source"],
        "replaces": kernels.KERNELS["layer_norm_bwd"]["replaces"],
        "launches": launches["layer_norm_bwd"],
        "max_abs_err": errs["layer_norm_bwd"],
        "ms": time_ms(lambda: kernels.layer_norm_bwd(x, g, mu, rs, dy)[0], n),
        "plain_ms": time_ms(
            lambda: reference.layer_norm_bwd(x, g, mu, rs, dy)[0], n),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, xf, [Dm], mu[:, None], rs[:, None], g, b,
            [True, True, True])[0], n),
        "shape": f"N={N} D={Dm} x bfloat16, dy float32 (library call: x "
                 "float32)",
    })
    bms, by = bound_ms(*ln_cost(N, Dm, 2, 4))
    train_ln = {
        "train_shape": f"N={N} D={Dm} bfloat16 -> float32, with mu/rs",
        "train_ms": time_ms(lambda: kernels.layer_norm_fwd(
            x, g, b, 1e-6, torch.float32)[0], n),
        "train_plain_ms": time_ms(lambda: reference.layer_norm_fwd(
            x, g, b, 1e-6, torch.float32)[0], n),
        "train_library_ms": time_ms(lambda: F.layer_norm(
            xf, (Dm,), g, b, 1e-6), n),
        "train_bound_ms": bms,
    }
    return entries, train_ln


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
    train_cases, train_errs = check_training_kernels(kernels, reference, gen)
    log(f"phase 3 training kernels vs plain (TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}): {len(train_cases)} cases "
        f"pass; max abs err " + ", ".join(
            f"{k} {v:.3e}" for k, v in train_errs.items())
        + f" (flash tol {FLASH_TOL}, LN bwd tol {LN_BWD_TOL})")
    errs.update(train_errs)
    errs["layer_norm"] = max(errs["layer_norm"], train_errs["layer_norm_train"])
    report["checks"] = checks + train_cases

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
    for name in ("decode_attention", "layer_norm"):
        if launches[name] < 1:
            fail(f"the serving path never launched kernel {name}: {launches}")
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

    # -- 5. the training path: BertBase, then GptMini ---------------------
    serve_launches = launches
    bert = train_path(kernels, "BertBase", args.seed, TRAIN_STEPS)
    log(f"phase 5 train BertBase ({bert['params']} params, B=16, L=512, "
        f"bf16, adam, flash + fused LN): losses "
        f"{[round(x, 4) for x in bert['losses']]}; eval loss "
        f"{bert['eval_before']['loss']:.4f} -> {bert['eval']['loss']:.4f}; "
        f"launches per run of {TRAIN_STEPS} steps {bert['launches']} "
        f"(= {TRAIN_STEPS} x {bert['per_step']}); eval launches "
        f"{bert['eval_launches']}; step {bert['step_ms']:.3f} ms, "
        f"{bert['tokens_per_s']:.1f} tokens/s")
    train_profile = profile_train(bert["trainer"]) if args.out else None
    del bert["trainer"]
    torch.cuda.empty_cache()
    grad_errs, grad_where = grad_check(kernels, reference, args.seed)
    torch.cuda.empty_cache()
    sizes = sorted(size for _, size in grad_errs.values())
    log(f"phase 5 gradient check BertBase f32 B=2 L=512: kernels vs plain, "
        f"{len(grad_errs)} parameters, worst relative error "
        f"{grad_errs[grad_where][0]:.3e} at {grad_where} (tol {GRAD_TOL}); "
        f"gradient sizes max|g| from {sizes[0]:.3e} to {sizes[-1]:.3e}")
    log("phase 5 gradient check per parameter (relative error, max|g|): "
        + json.dumps({n: [float(f"{r:.3e}"), float(f"{g:.3e}")]
                      for n, (r, g) in grad_errs.items()}))
    gpt = train_path(kernels, "GptMini", args.seed, 3, must_learn=False)
    log(f"phase 5 train GptMini (causal flash, B=16, L=128, bf16): losses "
        f"{[round(x, 4) for x in gpt['losses']]}; launches "
        f"{gpt['launches']}; eval launches {gpt['eval_launches']}")
    path_launches = {name: serve_launches[name] + sum(
        run[key][name] for run in (bert, gpt)
        for key in ("launches", "eval_launches")) for name in kernels.KERNELS}
    report["training"] = {
        "bert": {k: v for k, v in bert.items()},
        "gpt": {k: v for k, v in gpt.items() if k != "trainer"},
        "grad_check": {"worst_relative_err": grad_errs[grad_where][0],
                       "at": grad_where, "tolerance": GRAD_TOL,
                       "per_parameter": grad_errs},
        "profile": train_profile,
    }
    report["training"]["gpt"].pop("trainer", None)

    # -- 6. timings -------------------------------------------------------
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
        "launches": path_launches["decode_attention"],
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
        "launches": path_launches["layer_norm"],
        "max_abs_err": errs["layer_norm"],
        "ms": time_ms(run),
        "plain_ms": time_ms(lambda: reference.layer_norm(x, g, b, 1e-6)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(
            lambda: F.layer_norm(x, (d_model,), g, b, 1e-6)),
        "eager_ms": time_ms(run, graph=False),
        "shape": f"N={N} D={d_model} float32 -> float32",
    })
    train_entries, train_ln = time_training_kernels(
        kernels, reference, F, gen, path_launches, errs)
    entries[1].update(train_ln)
    entries += train_entries
    full_ms = train_step_ms("BertBase", "full", 6, args.seed)
    if args.out:
        report["sweep"] = sweep(kernels, reference, F, H, Dh, d_model, gen)
        report["decode_profile"] = profile_decode(engine, kvs)
    for e in entries:
        lib = "n/a" if e["library_ms"] is None else f"{e['library_ms']:.6f} ms"
        extra = ""
        if "eager_ms" in e:
            extra += f"; eager back-to-back {e['eager_ms']:.6f} ms per call"
        if "sdpa_fwd_bwd_ms" in e:
            extra += (f"; library flash fwd+bwd {e['sdpa_fwd_bwd_ms']:.6f} "
                      f"ms; library backward (dq, dk, dv in one call) vs "
                      f"the kernels max abs diff "
                      f"{e['library_vs_kernels']:.3e}")
        if "train_ms" in e:
            extra += (f"; at {e['train_shape']}: {e['train_ms']:.6f} ms, "
                      f"plain {e['train_plain_ms']:.6f} ms, library "
                      f"{e['train_library_ms']:.6f} ms, bound "
                      f"{e['train_bound_ms']:.6f} ms")
        log(f"phase 6 kernel {e['name']} ({e['shape']}): {e['ms']:.6f} ms; "
            f"plain {e['plain_ms']:.6f} ms; library {lib}; bound "
            f"{e['bound_ms']:.6f} ms ({e['bound_by']}); launches "
            f"{e['launches']}{extra}")
    tok_s = new_tokens / burst_s
    log(f"phase 6 serving: decode step (B={B}, S={S}) {decode_step_ms:.3f} "
        f"ms; burst of {len(results)} requests: {new_tokens} tokens in "
        f"{burst_s:.3f} s = {tok_s:.1f} tokens/s; TTFT p50 "
        f"{ttft[len(ttft) // 2]:.3f} ms, max {ttft[-1]:.3f} ms")
    tokens = 16 * 512
    log(f"phase 6 training BertBase B=16 L=512 bf16: attn pallas "
        f"{bert['step_ms']:.3f} ms/step, {bert['tokens_per_s']:.1f} "
        f"tokens/s")
    log(f"phase 6 training BertBase B=16 L=512 bf16: attn full "
        f"{full_ms:.3f} ms/step, {tokens / full_ms * 1e3:.1f} tokens/s")
    if train_profile:
        log(f"phase 6 training profile (5 steps): wall "
            f"{train_profile['wall_ms']:.3f} ms, device "
            f"{train_profile['device_ms']:.3f} ms, busy "
            f"{train_profile['device_busy_share']:.4f}")
    report["phases"].update({
        "train_step_ms": bert["step_ms"], "train_full_step_ms": full_ms,
        "path_launches": path_launches,
        "warmup_s": warm_s, "launches": launches, "logit_err": logit_err,
        "decode_step_ms": decode_step_ms, "burst_s": burst_s,
        "tokens_per_s": tok_s, "ttft_ms": ttft,
    })
    report["kernels"] = entries
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)

    # -- 7. result lines --------------------------------------------------
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
