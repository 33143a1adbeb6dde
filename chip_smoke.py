#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card: generative serving
of GptMini, MLM training of BertBase (and GptMini), data-parallel
ResNet-18/CIFAR-10 training with the int8 gradient collective, the
checkpoints, resume, polling evaluator and SIGTERM path of the last two,
single-pass serving (``POST /v1/infer``) of their checkpoints, and the
training path's faults, flight recorder, profiler and elastic resume.

    python3 chip_smoke.py [--seed 0] [--out report.json]
    python3 chip_smoke.py --step-times BertBase,ResNet18,ResNet18-saves
    python3 chip_smoke.py --serve-bench 2
    python3 chip_smoke.py --ln-times
    python3 chip_smoke.py --flash-times

The second form only times the training steps of the checkout beside
the script (``step_times``), the third only runs that checkout's
``serve bench`` in fresh processes on a random-init ResNet-18 artifact
(``serve_bench_runs``), the fourth only times its LayerNorm forward
(``ln_times``) and the fifth its flash kernels at BertBase's f32 and
bf16 shapes (``flash_times``), each for comparing two commits in one
call.

Phases, each printed on its own line:

1. the card's name and power limit (``nvidia-smi``) and the torch/CUDA
   versions;
2. build every hand-written kernel from ``pytorch_distributed_nn_tpu_torch/
   ops/csrc/`` (one ``nvcc`` per source, in parallel), timed; print
   ``ptxas -v``'s registers, stack and spills of the flash kernels, the
   vectorised LayerNorm backward and forward, the grouped and the
   own-scale quantize and every decode attention instantiation, and fail
   if a flash kernel (bf16 or f32, 9 each) or any of the others spills or
   is missing;
3. hold each kernel against its plain PyTorch version on the card, with
   TF32 off for the f32 comparisons: decode attention over every (batch
   bucket, cache bucket) pair of GptMini, on misaligned caches (its scalar
   branch), on long caches (S 512 and 2048 at 12 heads of 64: the split
   path) and on 64 x 32 heads, f32 and bf16, each case launched twice and
   equal bit for bit, and the LayerNorm forward at ``LN_CHECK_SHAPES``
   (each vectorised width, a width of the general kernel and misaligned
   rows; f32 and bf16 in, f32 and bf16 out; each case twice, bit for bit
   equal, on the kernel the wrapper says); flash attention forward
   (out, lse), dq and dk/dv at BertBase shapes (B 1, 2 and 16, L 128 and
   512, 12 heads of 64) and GptMini's
   (8 x 128, 4 heads of 32, causal), f32 and bf16, with and without a pad
   mask, causal and not, and ragged L (77, 200, 333) at head dims 16, 32
   and 64 (200 also causal at 12 heads of 64); each flash kernel launched
   twice per case, bit for bit equal;
   the bf16 dq and dk/dv held to a tighter tolerance than the forward;
   LayerNorm forward (y, mu, rs) and backward at
   (16*512, 768) and (1000, 128), f32 and bf16-in/f32-out, and the
   backward with bf16 dy, at a width of the general kernel (200) and on a
   misaligned copy (the general kernel), each backward launched twice and
   equal bit for bit, one count per call, on the kernel the wrapper says;
   the int8 codec (quantize_int8_scaled at n from 1 to 2,359,296; the
   grouped quantize over ResNet-18's 18 kernel-sized leaves in one launch,
   over 70 leaves in two, with a misaligned leaf, and an empty group in
   none; quantize_int8 and dequantize_int8 at 2-D shapes, and
   quantize_int8 on both sides of the elements its grid holds in
   registers, at one element and all zero, aligned and not) bit for bit,
   then the largest leaf's mean rounding error within 4 standard errors
   of 0 and another seed giving another q. Fails past the stated
   tolerance;
4. serving: write a random-init GptMini artifact, serve it with the
   port's server on an ephemeral port, answer a burst of concurrent
   ``POST /v1/generate`` requests; check the responses, that the serving
   kernels launched (decode attention exactly once per layer per decode
   step), that no kernel was built after warmup
   (``retraces() == 0``), and one request's served logits against a
   full-recompute plain forward on the card;
5. training: BertBase at full width (12 x 768, L 512, vocab 30522) through
   the port's ``Trainer`` (the object the ``train`` CLI builds) with
   ``--dtype bfloat16 --attn-impl pallas --fused-ln --optimizer adam``,
   B = 16, 10 steps, then ``evaluate()`` on 2 batches. Checks: every loss
   finite, the last below the first, the loss on the fixed eval set lower
   after the steps than before them, and the exact launch counts per step
   (flash fwd, dq and dk/dv 12 each, LayerNorm fwd and bwd 26 each) and
   per eval batch (12 and 26). Then BertBase with the README's flash
   flags at the CLI's default dtype (``--dtype float32 --attn-impl pallas
   --optimizer adam``: the f32 flash kernels), B = 16, 5 steps: finite
   losses and exactly 12 forward, 12 dq and 12 dk/dv launches a step
   (and 26 LayerNorm forward and backward; 12 and 26 an eval batch). Then two gradient checks:
   at the same weights and batch, B = 2, f32 (the 3xTF32 flash kernels)
   and bf16, every parameter's gradient of the kernel model
   against the plain model on the card, relative to the size of the
   plain gradient (``leaf_grad_errors``); in bf16 the plain model runs
   the kernels' algorithm (``plain_flash_attention``), and the kernel
   model may be no further from the f32 gradient than a factor times the
   plain model's own bf16 error. Then GptMini for 3
   steps the same way (causal flash kernels; finite losses and exact
   launch counts: 3 steps of a 1k vocabulary move its loss less than
   one batch differs from the next). Then ResNet-18 at full width on a
   synthetic CIFAR-10 of 10240 images through the Trainer: B = 1024,
   bf16, SGD lr 0.05 momentum 0.9 decayed 10x every 20 steps,
   ``--compress-grad int8`` over a world-size-1 NCCL group, the data on
   the card, 60 steps and an eval pass: losses finite and falling, eval
   loss lower after than before, exactly one quantize_int8_scaled launch
   per step (one grouped launch over the 18 gradient leaves of 16384
   elements or more) and no other kernel; then one step's gradients
   synced through the kernel and through the plain grouped quantizer, bit
   for bit equal leaf by leaf;
6. timings: each kernel, its plain version and the nearest single
   PyTorch call by CUDA-graph replay (the serving kernels at GptMini's
   decode shapes as before, and decode attention off that path: long
   caches and heads enough to fill the card; the training kernels at
   BertBase's training shapes, bf16, with the achieved TFLOP/s of the
   flash kernels),
   beside the least time the card could take, the f32 flash kernels on
   the same values beside their bound (three TF32 products a product;
   the count at the CUDA cores' f32 rate printed too), their achieved
   f32 TFLOP/s, their plain versions and SDPA on the same f32 operands
   (forward, and the autograd backward: dq, dk and dv in one call); the
   serving decode step, tokens/s and TTFT; the BertBase training step
   and tokens/s, bf16 and f32, each with ``--attn-impl pallas`` and, as
   a second line, ``--attn-impl full``; ``mma.sync`` TF32's rate and the
   error of a sum chained in its accumulator (``tools/mma_tf32.py``); the LayerNorm backward at BertBase's shape also
   on its general kernel (a misaligned copy); the LayerNorm forward at
   GptMini's serving shapes (N 1-128 x 128, f32 and bf16 in) and at
   BertBase's training shape, each beside its general kernel (a
   misaligned copy) and with its eager host cost per call beside
   ``F.layer_norm``'s; the int8 kernels
   (quantize_int8_scaled over one ResNet-18 step's leaves in one grouped
   launch, and grouped per leaf size; the other two at the largest leaf)
   and the ResNet-18 step with int8 sync and without.
   ``--out`` adds a per-shape sweep, a profile of decode steps and
   ``torch.profiler`` breakdowns of 5 BertBase steps (bf16 and f32) and
   5 ResNet-18 steps,
   with the device time per launch of each of the port's CUDA kernels
   (a wrapper's kernels apart: the LayerNorm backward's rows and its
   partial-row sum);
7. checkpoints, in a temporary train_dir, each reading printed beside
   the card's name and power limit: the native codec built and every
   checkpoint is ``PDTZ``; ResNet-18 as in phase 5 for 20 steps at
   ``--eval-freq 10 --keep-last 1`` (async): ``model_step_20`` verifies,
   ``model_step_10`` was collected, the ``checkpoint_write`` events carry
   bytes, ``write_ms`` and ``stall_ms``, a sync save of the same state
   gives the same bytes, and ``--resume`` to step 25 restores parameters,
   momentum and BatchNorm statistics bit for bit, with one
   ``quantize_int8_scaled`` launch per resumed step; BertBase as in phase
   5 for 4 steps at ``--eval-freq 2 --keep-last 1``, then ``--resume`` to
   step 6 with exact launch counts per step, the losses of steps 5 and 6
   and the parameters after step 6 against an uninterrupted 6-step run
   (within ``BERT_RESUME_TOL`` and ``RESUME_PARAM_TOL``), and two faulty
   resumes (the data stream a batch on; the dropout generator seeded
   once) that must fall outside both; meanwhile the ``evaluator``
   subprocess polls the same train_dir (``--follow-latest --max-evals 2
   --timeout 300``): its loss, acc1 and acc5 against
   ``Trainer.evaluate()`` of the same state (within ``EVAL_TOL``, which
   must be below the eval loss's move from step 4 to 6) and its
   launch counts (12 flash forward and 26 LayerNorm forward a batch, no
   backward); then a supervised ``train`` subprocess gets SIGTERM after
   its first step, exits 0 and leaves an emergency checkpoint that
   verifies. Checkpoint bytes (raw and PDTZ), write, stall and restore
   ms, the evaluator's ms per checkpoint, and the step times of the 10
   steps after an async save against 9 steps without one;
8. single-pass serving of phase 7's checkpoints, each reading beside the
   card's name and power limit. ResNet-18 (11,173,962 parameters): exported
   with ``quantize`` none and int8, each served by the ``InferenceEngine``
   on the card (buckets 1-32): warmup time, logits against the same
   artifact on the CPU (``SERVE_RTOL``) with top-1 equal, ``infer_ms`` by
   bucket (median of ``SERVE_TIMED``) with the achieved FLOP/s,
   ``retraces() == 0``, a profile of bucket 32; two ``serve run``
   subprocesses on ephemeral ports: 8 concurrent clients of 1-4 rows whose
   top-1 equals the in-process engine's, a body with a scalar image row
   answered 400 and the next good row 200 with the engine's top-1, 8 rows
   against ``--max-queue 1`` answered 429 with Retry-After, each drained
   by SIGTERM to exit 0; ``serve bench``'s open-loop sweep at 500, 1000
   and 2000 req/s for 2 s each, from the CLI in a fresh process (with the
   ``infer_ms`` of its first ``FIRST_BATCHES`` batches) and then as
   ``loadgen.sweep`` in this one, counting Python's garbage collections:
   sustained req/s, p50/p95/p99, achieved FLOP/s, no retrace. BertBase (109,512,762
   parameters, bf16): exported and served at batch buckets 1-8 and every
   length bucket to 512; the LayerNorms' (in, out) dtypes read by hooks;
   exactly 26 LayerNorm forward launches a batch and no other kernel over 4
   engine batches and one short HTTP request, after a request with an id
   equal to the vocabulary size was answered 400 (on the card such an id
   would be a device-side assert); logits against the same
   weights with the plain LayerNorm on the card, in bf16 and in f32 (the
   kernels' model within ``BERT_SERVE_NOISE_FACTOR`` times the plain bf16
   model's own distance from f32); ``infer_ms`` at 1 x 512 and 8 x 512 and
   a profile of each; the LayerNorm forward kernel against its plain
   version at (1, 768) and (4096, 768) bf16 -> f32, timed beside its bound,
   its general kernel and ``F.layer_norm``, eager calls too;
9. faults and the flight recorder, each reading beside the card's name
   and power limit: ResNet-18 as in phase 5 (host layout, cuDNN's
   deterministic algorithms) under ``FAULT_SPEC`` with
   ``--skip-nonfinite --supervise --flightrec default --heartbeat-grace
   30 --eval-freq 2`` until its crash: each entry's ``fault_injected``
   once at its step, ``nonfinite_skip`` at step 3 with the state after it
   bit for bit the state after step 2, one ``retry`` of step 4's publish,
   step 6's file convicted by its manifest, one quantize launch a step;
   one ``14-step_regression`` bundle whose ``torch.profiler`` trace
   holds one ``quant_group_kernel`` a captured step, and a ``report.md``;
   ``--resume`` quarantines the torn emergency checkpoint (step 19),
   restores step 18 and runs to 26, its losses within
   ``FAULT_RESUME_TOL`` of an uninterrupted run of the same faults but
   the crash (its image loader restarted where the resume restarts it),
   steps 1-18 too; step ms inside the capture window beside before it;
10. the profiler: BertBase f32 (``--attn-impl pallas``) and bf16
   (``--fused-ln``) with ``--profile 2``: every flash and LayerNorm
   kernel in the trace's summary 2 x its per-step launches, the
   wrappers' counters exact, ``device_step_time_ms`` within
   ``PROFILE_AGREE`` of ``device_rows`` of the same profile; profiled
   step ms beside unprofiled and phase 5's; bf16 with ``--flightrec
   default`` armed and idle;
11. ``serve run --faults SERVE_FAULTS`` on phase 8's ResNet-18 artifact,
   one client in turn: request 12 reset with no response, 15-17 answered
   503, every other 200, the first 8 with ``infer_ms`` >= 200 and the
   rest below, one ``fault_injected`` an entry;
12. TF32: ``train`` (2 steps and its eval) and the ``evaluator`` of
   ResNet-20 at the CLI's default ``--dtype float32``, subprocesses on
   the card with TF32 at PyTorch's defaults, against ``--device cpu``:
   losses and metrics within ``TF32_RTOL``;
13. elastic resume: 2 gloo ranks on the CPU (``torch.distributed.run``)
   checkpoint ResNet-20 at step 2; ``--resume`` on the card at world size
   1 emits ``elastic_resume`` (dp 2 -> 1, the global batch kept) and
   continues with finite losses; ``--strict-geometry`` raises naming both
   geometries;
14. one JSON line listing the kernels (launches on the driven paths of
   phases 4, 5, 8, 9 and 10, error against the plain version, times,
   least possible time), then the result line ``{"ok": true, "device":
   {...}}``.

Launch counts are set to 0 just before each driven path (the served
burst, each model's training steps and eval pass (BertBase bf16 and
f32), the resumed steps of
phase 7, BertBase's served batches in phase 8, each training run of
phases 9 and 10) and read just after; the evaluator subprocess counts
its own.

It needs one card and exits non-zero, printing no result, without one,
when any phase fails, or when run outside the repository.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

#: NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth, the f32 rate
#: outside the tensor cores, and the bf16 and TF32 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
PEAK_FLOPS = {"float32": F32_FLOPS_PER_S, "bfloat16": 989e12,
              "tf32": 494.7e12}

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGITS_TOL = 1e-4
#: flash attention vs its plain version, (atol, rtol): f32 sums of up to
#: L products (reduction order); bf16 outputs keep 8 bits, and the forward
#: rounds p against each 64-key tile's running max, the plain version
#: against the row's max
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
#: the bf16 dq and dk/dv tensor-core kernels vs their plain versions,
#: (atol, rtol): both round f32 sums that differ by reduction order only to
#: bf16 (dk/dv after the same hi + lo split of p and ds), so they sit at
#: most one bf16 step apart (2^-7 relative). The absolute part is for dq:
#: it rounds each ds to bf16 before ds @ K, and a ds that lies within
#: reduction-order noise of a rounding boundary rounds to either side on
#: the two sides. Phase 3 prints the least atol its cases need at this
#: rtol (about 1e-3 on an H100); 2e-3 leaves a factor of 2
FLASH_BWD_TOL_BF16 = (2e-3, 2.0 ** -7)
#: LayerNorm forward vs its plain version, (atol, rtol): f32 out at
#: 1e-5 (reduction order only); bf16 out at 2e-2 plus 1e-2 relative, as
#: the card tests: f32 values a few ulps apart may round to neighbouring
#: bf16 values, 2^-7 relative apart
LN_FWD_TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 1e-2)}
#: its phase-3 shapes (N, D, x one element off its 16-byte boundary):
#: every vectorised width at N = 1 and at row counts no block's rows
#: divide, a width of the general kernel (200), and misaligned rows
LN_CHECK_SHAPES = ((1, 128, 0), (8, 128, 0), (128, 128, 0), (1000, 128, 0),
                   (1, 64, 0), (37, 64, 0), (1, 768, 0), (4097, 768, 0),
                   (37, 200, 0), (37, 768, 1), (1, 128, 1))
#: LayerNorm backward: dx at 1e-4 (two row means subtracted), dgamma and
#: dbeta (sums over up to 8192 rows) at 1e-4 relative
LN_BWD_TOL = (1e-4, 1e-4)
#: gradients of the whole BertBase (12 layers, f32), kernels vs plain:
#: per parameter, max |g - g_plain| / max |g_plain|
GRAD_TOL = 1e-4
#: the same in bf16 (the training path's dtype: the tensor-core kernels),
#: against a plain model that runs the kernels' algorithm at their
#: rounding points (``plain_flash_attention``). Activations keep 8 bits,
#: so the two differ where the forward rounds p (against each 64-key
#: tile's running max or the row's max) and by reduction order, and 12
#: layers carry that on. The query and key projections' gradients are
#: sums of ds = p (dp - delta), where dp and delta, the latter from the
#: bf16 output, nearly cancel at initialisation: there each model sits up
#: to about 0.15 of the gradient's size off the f32 gradient on an H100,
#: so two of them may differ by twice that
GRAD_TOL_BF16 = 0.5
#: ... so the finer check: the kernels add no error to their algorithm's
#: own in bf16. Per parameter, the kernel model's error against the f32
#: plain model is at most GRAD_NOISE_FACTOR times the bf16 plain model's,
#: plus GRAD_TOL_BF16_ABS
GRAD_NOISE_FACTOR = 2.0
GRAD_TOL_BF16_ABS = 1e-3
N_TIMED = 200
#: graph-replayed calls per timing at the training shapes (ms-scale calls)
N_TIMED_TRAIN = 20
TRAIN_STEPS = 10
#: BertBase with the README's flash command's flags at the CLI's default
#: dtype (``--dtype float32 --attn-impl pallas --optimizer adam``, no
#: ``--fused-ln``, which picks nothing in the port: its one LayerNorm is
#: the kernel): the f32 flash kernels' training path
F32_FLAGS = {"dtype": "float32", "fused_ln": False}
F32_TRAIN_STEPS = 5
#: the int8 kernels' element counts in phase 3: around the 16384 dispatch
#: threshold and the TPU kernel's 131072 chunk, up to ResNet-18's largest
#: gradient leaf
INT8_SIZES = (1, 1000, 16383, 16384, 131072, 131073, 2359296)
INT8_SHAPES = ((1, 1), (8, 125), (127, 129), (128, 128), (257, 510),
               (4608, 512))
#: decode attention off GptMini's path: long caches at BertBase's head
#: width (H = 12, D = 64; the split path, and at 16384 keys several
#: rounds of scores a warp), and (B, H) heads enough to fill the card
#: (2048 warps)
DECODE_LONG_S = (512, 2048, 16384)
DECODE_FILL = (64, 32)
#: a group of more leaves than one grouped launch takes (64): two launches
INT8_GROUP_CHUNKED = tuple(1 + 997 * i for i in range(70))
#: ResNet-18 on the synthetic CIFAR-10: 60 steps of SGD at lr 0.05,
#: momentum 0.9, the lr decayed 10x every 20 steps. The repo's recipe
#: (lr 0.4 at B 1024) diverges on this set within a few steps, with or
#: without a 20-step warmup (loss 2.4 -> 19-28), and so does lr 0.1; and
#: BatchNorm's running statistics (momentum 0.9) trail weights that move
#: fast, so the test split's eval-mode loss rises for 30 steps unless the
#: lr decays (``python -m pytorch_distributed_nn_tpu_torch.tools.
#: resnet_schedules`` measures both)
RESNET_STEPS = 60
RESNET_LR = 0.05
RESNET_DECAY_STEPS = 20
#: ResNet-18's global batch; the synthetic CIFAR-10 stand-in is cut to
#: this many images per split to bound the host's data generation
RESNET_B = 1024
RESNET_DATA = 10240


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
    these sizes measures how fast the host can launch; Python's garbage
    collector is held off in that window (a collection is a pause of the
    whole process, not a cost of the call, and landed on one shape's
    window in every run). The last output is checked finite either way."""
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
        gc.collect()
        gc.disable()
        try:
            start.record()
            for _ in range(n):
                out = fn()
            end.record()
            torch.cuda.synchronize()
        finally:
            gc.enable()
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


def misaligned(t):
    """A copy of ``t`` one element past a 16-byte boundary (same shape,
    contiguous): the decode kernel stages it with scalar loads."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def check_decode(kernels, reference, gen, H, Dh):
    """Phase 3, decode attention against its plain version on the card,
    f32 and bf16, each case launched twice and equal bit for bit: every
    (batch, cache) bucket of GptMini (one warp a head), the largest on
    misaligned caches (the scalar branch), the long caches of
    :data:`DECODE_LONG_S` at H = 12, D = 64 (the split path), and
    :data:`DECODE_FILL` heads. Returns the (name, dtype, B, S, err)
    cases."""
    import numpy as np
    import torch

    cases = [(B, S, H, Dh, False) for S in (16, 32, 64, 128)
             for B in (1, 2, 4, 8)]
    cases += [(8, 128, H, Dh, True), (3, 77, H, Dh, True)]
    cases += [(2, S, 12, 64, mis) for S in DECODE_LONG_S
              for mis in (False, True)]
    cases.append((DECODE_FILL[0], 128, DECODE_FILL[1], Dh, False))
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for B, S, nh, D, mis in cases:
            rng = np.random.RandomState(S * 10 + B)
            pos = rng.randint(0, S, size=B)
            pos[0], pos[-1] = 0, S - 1
            q, k, v, p = attn_inputs(B, S, nh, D, dtype, pos, gen)
            if mis:
                k, v = misaligned(k), misaligned(v)
            vec = kernels.decode_vector_loads(k, v)
            plan = kernels.decode_launch_plan(B, nh, S, D, q.element_size())
            if vec == mis or (plan["warps_per_head"] > 1) != (S > 128):
                fail(f"decode_attention B={B} S={S} H={nh} D={D}: vector "
                     f"loads {vec} on a {'mis' if mis else ''}aligned "
                     f"cache, plan {plan}")
            got = kernels.decode_attention(q, k, v, p)
            again = kernels.decode_attention(q, k, v, p)
            torch.cuda.synchronize()
            want = reference.decode_attention(q, k, v, p)
            err = (got.float() - want.float()).abs().max().item()
            what = (f"decode_attention B={B} S={S} H={nh} D={D} {dtype}"
                    + (" misaligned" if mis else ""))
            if not torch.equal(got, again):
                fail(f"{what}: two launches differ")
            if not err <= tol:
                fail(f"{what}: max abs err {err} > {tol}")
            checks.append(("decode_attention",
                           str(dtype) + (" misaligned" if mis else ""),
                           B, S if nh == H else f"{S} H={nh} D={D}", err))
    return checks


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
    inputs of ``dtype``; dk/dv's p^T dO and ds^T Q are f32 by definition.
    With bf16 operands the card's tensor cores multiply bf16 only, and the
    least work that keeps p and ds to 16 bits against exact bf16 dO and Q
    is two bf16 products each (hi and lo), so those count as 4 bf16
    products. An f32 product to f32 accuracy is three TF32 products on the
    tensor cores (the split operands' lo hi + hi lo + hi hi), so with f32
    operands every product counts three times at the TF32 rate;
    :func:`cuda_core_bound_ms` gives the count at the f32 rate outside
    them."""
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
    if dtype == "float32":
        return {
            "flash_attention_fwd": (4 * n + rows + mask_b,
                                    [(3 * 2 * prod, "tf32")]),
            "flash_attention_dq": (5 * n + 2 * rows + mask_b,
                                   [(3 * 3 * prod, "tf32")]),
            "flash_attention_dkv": (6 * n + 2 * rows + mask_b,
                                    [(3 * 4 * prod, "tf32")]),
        }
    return {
        "flash_attention_fwd": (4 * n + rows + mask_b, [(2 * prod, dtype)]),
        "flash_attention_dq": (5 * n + 2 * rows + mask_b,
                               [(3 * prod, dtype)]),
        "flash_attention_dkv": (6 * n + 2 * rows + mask_b,
                                [(2 * prod, dtype), (4 * prod, dtype)]),
    }


def cuda_core_bound_ms(cost):
    """The bound of an f32 :func:`flash_costs` entry with its products
    counted once each at the f32 rate outside the tensor cores (the count
    for kernels on the CUDA cores): (ms, what bounds it)."""
    nbytes, flops = cost
    return bound_ms(nbytes, [(f / 3, "float32") for f, _ in flops])


def ln_bwd_cost(N, D, x_elem, dy_elem):
    return (N * D * (2 * x_elem + dy_elem) + 8 * N + 3 * D * 4,
            10 * N * D)


def excess(got, want, atol, rtol=0.0):
    """(largest error past atol + rtol * |want| (<= 0 passes), max abs err)"""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    return (d - atol - rtol * want.abs()).max().item(), d.max().item()


def sweep(kernels, reference, F, H, Dh, d_model, gen):
    """Device time (CUDA graph replay) of decode attention, its plain
    version and SDPA at every shape the serving path gives it (the
    LayerNorm forward's: :func:`ln_sweep`)."""
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
    return rows


def ln_fwd_times(kernels, reference, F, x, g, b, stats=False, n=N_TIMED):
    """The LayerNorm forward on x, out f32, with mu/rs when ``stats``
    (training) or without (serving): by CUDA-graph replay the kernel the
    wrapper picks (``ms``), the general kernel on a copy of x one element
    off its 16-byte boundary (``general_ms``: the kernel every row took
    before the vectorised one), the plain version and ``F.layer_norm`` on
    x in f32; ``n`` eager calls of the wrapper and of ``F.layer_norm``
    back to back (``eager_ms``, ``library_eager_ms``: the host's cost per
    call); and the bound."""
    import torch

    N, D = x.shape
    xf, x_off = x.float(), misaligned(x)
    fwd = kernels.layer_norm_fwd if stats else (
        lambda *a: (kernels.layer_norm(*a),))
    plain = reference.layer_norm_fwd if stats else (
        lambda *a: (reference.layer_norm(*a),))

    def run(t):
        return fwd(t, g, b, 1e-6, torch.float32)[0]

    def lib():
        return F.layer_norm(xf, (D,), g, b, 1e-6)

    bms, by = bound_ms(*ln_cost(N, D, x.element_size(), 4))
    return {
        "ms": time_ms(lambda: run(x), n),
        "general_ms": time_ms(lambda: run(x_off), n),
        "plain_ms": time_ms(
            lambda: plain(x, g, b, 1e-6, torch.float32)[0], n),
        "library_ms": time_ms(lib, n),
        "eager_ms": time_ms(lambda: run(x), n, graph=False),
        "library_eager_ms": time_ms(lib, n, graph=False),
        "bound_ms": bms, "bound_by": by,
    }


#: the LayerNorm forward's rows in phase 6 and ``--ln-times``: GptMini's
#: serving shapes (D = 128, f32 and bf16 in) ...
LN_SWEEP_ROWS = (1, 8, 16, 32, 64, 128)
#: ... and BertBase's (D = 768, bf16 in; with mu/rs at the training shape)
LN_BERT_SHAPES = ((1, False), (4096, False), (8192, True))


def ln_sweep(kernels, reference, F, d_model, gen):
    """:func:`ln_fwd_times` at each of GptMini's serving shapes
    (:data:`LN_SWEEP_ROWS` x ``d_model``, f32 and bf16 in, f32 out)."""
    import torch

    rows = []
    for in_dt in (torch.float32, torch.bfloat16):
        for N in LN_SWEEP_ROWS:
            x = torch.randn((N, d_model), generator=gen).to("cuda", in_dt)
            g = torch.ones(d_model, device="cuda")
            b = torch.zeros(d_model, device="cuda")
            rows.append({"shape": f"N={N} D={d_model} {in_dt} -> float32",
                         **ln_fwd_times(kernels, reference, F, x, g, b)})
    return rows


def ln_row(r) -> str:
    """One LayerNorm forward row of :func:`ln_fwd_times`, as printed."""
    return (f"{r['ms']:.6f} ms (bound {r['bound_ms']:.6f} ms, "
            f"{r['bound_ms'] / r['ms']:.1%} of it); general kernel "
            f"{r['general_ms']:.6f} ms; plain {r['plain_ms']:.6f} ms; "
            f"library {r['library_ms']:.6f} ms (F.layer_norm, f32 in); eager "
            f"back to back {r['eager_ms']:.6f} ms per call (library "
            f"{r['library_eager_ms']:.6f})")


def ln_times(kernels, reference, F, seed):
    """``--ln-times``: the LayerNorm forward rows of the checkout beside
    the script (:func:`ln_fwd_times` at BertBase's shapes and
    :func:`ln_sweep`), nothing else built or checked."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    D = 768
    g = torch.randn(D, generator=gen).cuda()
    b = torch.randn(D, generator=gen).cuda()
    rows = []
    for N, stats in LN_BERT_SHAPES:
        x = torch.randn((N, D), generator=gen).cuda().to(torch.bfloat16)
        rows.append({"shape": f"N={N} D={D} bfloat16 -> float32"
                              + (", with mu/rs" if stats else ""),
                     **ln_fwd_times(kernels, reference, F, x, g, b, stats)})
    return rows + ln_sweep(kernels, reference, F, 128, gen)


def flash_times(kernels, reference, F, seed):
    """``--flash-times``: the flash kernels of the checkout beside the
    script at BertBase's training shapes (B 16, L 512, 12 heads of 64, no
    mask), f32 and bf16, each forward, dq and dk/dv by CUDA-graph replay
    beside its bound and achieved TFLOP/s, and SDPA's f32 forward and
    autograd backward on the same f32 operands; only
    ``flash_attention.cu`` is built, nothing checked but finite outputs."""
    import torch

    from pytorch_distributed_nn_tpu_torch.utils.native_build import (
        build_kernels,
    )

    build_kernels(["flash_attention"])
    gen = torch.Generator().manual_seed(seed)
    B, L, H, D = 16, 512, 12, 64
    n = N_TIMED_TRAIN
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn((B, L, H, D), generator=gen)
                       .to("cuda", dt) for _ in range(4))
        out, lse = kernels.flash_attention_fwd(q, k, v)
        delta = reference.flash_attention_delta(out, do)
        args = (q, k, v, None, lse, delta, do)
        name = str(dt).split(".")[1]
        costs = flash_costs(B, L, H, D, name)
        for kernel, run in (
                ("flash_attention_fwd",
                 lambda: kernels.flash_attention_fwd(q, k, v)[0]),
                ("flash_attention_dq",
                 lambda: kernels.flash_attention_dq(*args)),
                ("flash_attention_dkv",
                 lambda: kernels.flash_attention_dkv(*args)[0])):
            ms = time_ms(run, n)
            flops = sum(f for f, _ in costs[kernel][1])
            bms, by = bound_ms(*costs[kernel])
            rows.append({"kernel": kernel, "dtype": name, "ms": ms,
                         "bound_ms": bms, "bound_by": by,
                         "tflop_per_s": flops / (ms * 1e-3) / 1e12})
        if dt == torch.float32:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            rows.append({"kernel": "sdpa_fwd", "dtype": name,
                         "ms": time_ms(lambda: F.scaled_dot_product_attention(
                             qt, kt, vt), n)})
            leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            o = F.scaled_dot_product_attention(*leaves)
            dot = do.transpose(1, 2)
            rows.append({"kernel": "sdpa_autograd_bwd", "dtype": name,
                         "ms": time_ms(lambda: torch.autograd.grad(
                             o, leaves, dot, retain_graph=True)[0], n,
                             graph=False)})
        del q, k, v, do, out, lse, delta, args
    return rows


def time_decode_off_path(kernels, reference, F, gen):
    """Phase 6 rows of decode attention off GptMini's path: the long
    caches of :data:`DECODE_LONG_S` at B = 2, H = 12, D = 64 (the split
    path), f32 and bf16, and :data:`DECODE_FILL` heads at S = 128, f32;
    every key live."""
    import torch

    rows = []
    cases = [(2, S, 12, 64, dt) for dt in (torch.float32, torch.bfloat16)
             for S in DECODE_LONG_S]
    cases.append((DECODE_FILL[0], 128, DECODE_FILL[1], 32, torch.float32))
    for B, S, H, D, dtype in cases:
        elem = 4 if dtype == torch.float32 else 2
        pos = [S - 1] * B
        q, k, v, p = attn_inputs(B, S, H, D, dtype, pos, gen)
        valid = torch.arange(S, device="cuda")[None] <= p[:, None].long()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bms, by = bound_ms(*attn_cost(B, S, H, D, elem, pos))
        rows.append({
            "shape": f"B={B} S={S} H={H} D={D} {str(dtype).split('.')[1]}",
            "ms": time_ms(lambda: kernels.decode_attention(q, k, v, p)),
            "plain_ms": time_ms(
                lambda: reference.decode_attention(q, k, v, p)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=valid[:, None, None, :])),
            "bound_ms": bms, "bound_by": by,
            "plan": kernels.decode_launch_plan(B, H, S, D, elem),
        })
    return rows


def device_rows(prof):
    """A profile's device-side rows (kernels and copies), the largest
    first: the host ops that launched them would count the same time
    again, and user annotations (the optimizer's ``Optimizer.step#...``
    range) span device time other rows count. An annotation's key has a
    ``#`` and no parameter list; a kernel's may have a ``#`` inside its
    own (PyTorch's elementwise kernels name their lambdas
    ``{lambda()#3}``), and counts."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") \
                or getattr(e, "is_user_annotation", False) \
                or ("#" in e.key and "(" not in e.key):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": e.key, "count": e.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
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
    rows = device_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    return {"B": B, "S": S, "steps": steps, "wall_ms": wall_ms,
            "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "top": rows[:15]}


def check_training_kernels(kernels, reference, gen):
    """Phase 3, training kernels: flash fwd / dq / dk-dv and LayerNorm
    fwd (y, mu, rs) / bwd against their plain versions on the card, each
    flash kernel launched twice per case and held to equal bits. Returns
    (cases, max abs err per kernel)."""
    import torch

    errs = {k: 0.0 for k in ("flash_attention_fwd", "flash_attention_dq",
                             "flash_attention_dkv", "layer_norm_bwd")}
    cases = []

    def record(name, what, exc_err, tol):
        over, err = exc_err
        errs[name] = max(errs[name], err)
        if name.startswith("flash") and "float32 " in what:
            f32 = name + " float32"
            errs[f32] = max(errs.get(f32, 0.0), err)
        cases.append((name, what, err))
        if not over <= 0:
            fail(f"{name} {what}: max abs err {err} past tolerance {tol}")

    shapes = []  # (B, L, H, D, causal, pad)
    for L in (128, 512):
        for causal in (False, True):
            for pad in (0, 19):
                shapes.append((1, L, 12, 64, causal, pad))
        shapes.append((16, L, 12, 64, False, 0))
    # BertBase's training shape with a pad mask; GptMini's causal
    # training shape; ragged L with each head dim
    shapes += [(16, 512, 12, 64, True, 37), (8, 128, 4, 32, True, 0),
               (2, 200, 4, 16, False, 0), (2, 200, 4, 16, True, 13),
               (2, 77, 3, 32, False, 5), (2, 333, 2, 64, True, 0),
               (2, 512, 12, 64, False, 37), (2, 200, 12, 64, True, 0)]
    bwd_atol_needed = 0.0  # the least atol the bf16 backward needs at rtol

    def run_all(q, k, v, do, mask, causal, lse, delta):
        out, lse_k = kernels.flash_attention_fwd(q, k, v, mask, causal)
        dq = kernels.flash_attention_dq(q, k, v, mask, lse, delta, do, causal)
        dk, dv = kernels.flash_attention_dkv(q, k, v, mask, lse, delta, do,
                                             causal)
        torch.cuda.synchronize()
        return out, lse_k, dq, dk, dv

    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        bwd_tol = tol if dtype == torch.float32 else FLASH_BWD_TOL_BF16
        for B, L, H, D, causal, pad in shapes:
            q, k, v, do = (torch.randn((B, L, H, D), generator=gen)
                           .to("cuda", dtype) for _ in range(4))
            mask = None
            if pad:
                mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
                mask[-1, L - pad:] = 0
            what = f"B={B} L={L} H={H} D={D} {dtype} causal={causal} pad={pad}"
            w_out, w_lse = reference.flash_attention_fwd(q, k, v, mask, causal)
            delta = reference.flash_attention_delta(w_out, do)
            got = run_all(q, k, v, do, mask, causal, w_lse, delta)
            again = run_all(q, k, v, do, mask, causal, w_lse, delta)
            for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got,
                                  again):
                if not torch.equal(a, b):
                    fail(f"flash attention {what} {name}: two launches on "
                         f"the same inputs differ in {int((a != b).sum())} "
                         "elements")
            out, lse, dq, dk, dv = got
            record("flash_attention_fwd", what + " out",
                   excess(out, w_out, *tol), tol)
            record("flash_attention_fwd", what + " lse",
                   excess(lse, w_lse, 1e-4, 1e-5), (1e-4, 1e-5))
            w_dq = reference.flash_attention_dq(q, k, v, mask, w_lse, delta,
                                                do, causal)
            w_dk, w_dv = reference.flash_attention_dkv(q, k, v, mask, w_lse,
                                                       delta, do, causal)
            for name, g, w in (("flash_attention_dq", dq, w_dq),
                               ("flash_attention_dkv", dk, w_dk),
                               ("flash_attention_dkv", dv, w_dv)):
                record(name, what, excess(g, w, *bwd_tol), bwd_tol)
                if dtype == torch.bfloat16:
                    bwd_atol_needed = max(bwd_atol_needed, excess(
                        g, w, 0.0, bwd_tol[1])[0])
            del q, k, v, do, out, lse, w_out, w_lse, dq, dk, dv, w_dq, w_dk
            del w_dv, got, again
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
            check_ln_bwd(kernels, reference, record, x, g, w[1], w[2], dy,
                         what)
    # bf16 dy; a width the vectorised kernel is not built for; a copy of
    # x one element off a 16-byte boundary (both the general kernel)
    for N, D, dy_dt, shift in ((16 * 512, 768, torch.bfloat16, 0),
                               (1000, 200, torch.float32, 0),
                               (16 * 512, 768, torch.float32, 1),
                               (37, 128, torch.bfloat16, 1)):
        x = (torch.randn((N, D), generator=gen) * 3 + 1).to("cuda",
                                                             torch.bfloat16)
        if shift:
            flat = torch.empty(N * D + shift, dtype=x.dtype, device="cuda")
            x = flat[shift:].view(N, D).copy_(x)
        g = (1 + 0.1 * torch.randn((D,), generator=gen)).cuda()
        dy = torch.randn((N, D), generator=gen).to("cuda", dy_dt)
        _, mu, rs = reference.layer_norm_fwd(x, g, torch.zeros_like(g))
        check_ln_bwd(kernels, reference, record, x, g, mu, rs, dy,
                     f"({N},{D}) x bfloat16 offset {shift}, dy {dy_dt}")
    errs["layer_norm_train"] = ln_fwd_err
    errs["bf16_bwd_atol_needed"] = bwd_atol_needed
    return cases, errs


def check_ln_bwd(kernels, reference, record, x, g, mu, rs, dy, what):
    """The LayerNorm backward on (x, dy) against its plain version: dx at
    LN_BWD_TOL (bf16 dx at (2e-2, 1e-2)), dgamma and dbeta at LN_BWD_TOL;
    two launches equal bit for bit, one count per call, and the kernel
    the wrapper picks (vectorised for the widths it is built for on
    aligned rows, else general) named in the case."""
    import torch

    probe = torch.empty(x.shape, dtype=x.dtype, device="cuda")
    vec = kernels.layer_norm_bwd_vectorised(x, dy, probe)
    if vec != (x.shape[-1] in kernels.LN_WIDTHS
               and x.data_ptr() % 16 == 0):
        fail(f"layer_norm_bwd {what}: dispatch says vectorised={vec}")
    what += " vectorised" if vec else " general"
    before = kernels.launch_counts()["layer_norm_bwd"]
    got = kernels.layer_norm_bwd(x, g, mu, rs, dy)
    again = kernels.layer_norm_bwd(x, g, mu, rs, dy)
    torch.cuda.synchronize()
    if kernels.launch_counts()["layer_norm_bwd"] != before + 2:
        fail(f"layer_norm_bwd {what}: two calls counted "
             f"{kernels.launch_counts()['layer_norm_bwd'] - before}")
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, again):
        if not torch.equal(a, b):
            fail(f"layer_norm_bwd {what} {name}: two launches differ in "
                 f"{int((a != b).sum())} elements")
    want = reference.layer_norm_bwd(x, g, mu, rs, dy)
    dx_tol = LN_BWD_TOL if x.dtype == torch.float32 else (2e-2, 1e-2)
    record("layer_norm_bwd", what + " dx",
           excess(got[0], want[0], *dx_tol), dx_tol)
    for a, ww, name in zip(got[1:], want[1:], ("dgamma", "dbeta")):
        record("layer_norm_bwd", f"{what} {name}",
               excess(a, ww, *LN_BWD_TOL), LN_BWD_TOL)


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


def train_path(kernels, network, seed, steps, must_learn=True, **flags):
    """Train ``network`` through the Trainer for ``steps`` steps, then
    evaluate; launch counts read around each. With ``must_learn`` the
    last loss must be below the first and the fixed eval set's loss must
    fall. ``flags`` override :func:`train_config`'s. Returns the facts."""
    import math

    import torch

    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    trainer = Trainer(train_config(network, steps, seed=seed, **flags))
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


def plain_flash_attention(reference):
    """Attention by the flash kernels' plain versions, differentiable with
    the kernels' backward: delta from the rounded output, dq from ds
    rounded to the operands' dtype, dk/dv from p and ds split as the
    bf16 kernel splits them. (``reference.flash_attention`` differentiates
    the forward by autograd instead, at other rounding points.)"""
    import torch

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, causal):
            out, lse = reference.flash_attention_fwd(q, k, v, mask, causal)
            ctx.save_for_backward(q, k, v, mask, out, lse)
            ctx.causal = causal
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, mask, out, lse = ctx.saved_tensors
            args = (q, k, v, mask, lse,
                    reference.flash_attention_delta(out, dout), dout,
                    ctx.causal)
            return (reference.flash_attention_dq(*args),
                    *reference.flash_attention_dkv(*args), None, None)

    return lambda q, k, v, mask=None, causal=False: PlainFlash.apply(
        q, k, v, mask, causal)


def grad_check(kernels, reference, seed, dtype="float32"):
    """Gradients of BertBase (``dtype``: f32 reaches the 3xTF32 flash
    kernels, bf16 the bf16 ones; B = 2, L = 512) on the kernels
    against the plain model at the same weights and batch, per parameter
    (``leaf_grad_errors``): for f32 the plain model differentiates
    ``reference.flash_attention`` by autograd, for bf16 it runs
    :func:`plain_flash_attention`. For bf16 also both against the f32
    plain model. Returns (name -> (error vs plain, gradient size), worst
    name, name -> (kernels vs f32, plain vs f32) or None, failures)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.data.text import MLMBatches
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.ops.metrics import (
        masked_cross_entropy,
    )

    weights = build_model("BertBase").init_weights(
        torch.Generator().manual_seed(seed)).state_dict()

    def model(dt, fast):
        attn = (kernels.flash_attention if fast else
                plain_flash_attention(reference) if dt == "bfloat16" else
                reference.flash_attention)
        m = build_model("BertBase", dtype=dt, dropout_rate=0.0,
                        use_kernels=fast, attn_fn=attn)
        m.load_state_dict(weights)
        return m

    x, y = next(MLMBatches(vocab_size=30522, seq_len=512, batch_size=2,
                           seed=seed))
    x, y = (torch.from_numpy(a).long().cuda() for a in (x, y))

    def grads(m):
        m.cuda().train()
        masked_cross_entropy(m(x), y).backward()
        out = {n: p.grad for n, p in m.named_parameters()}
        m.cpu()
        return out

    fast, plain = grads(model(dtype, True)), grads(model(dtype, False))
    errs = leaf_grad_errors(fast, plain)
    where = max(errs, key=lambda n: errs[n][0])
    tol = GRAD_TOL if dtype == "float32" else GRAD_TOL_BF16
    failures = [f"{n}: {r:.3e} > {tol}" for n, (r, _) in errs.items()
                if not r <= tol]
    floor = None
    if dtype == "bfloat16":
        exact = grads(model("float32", False))
        k32, p32 = leaf_grad_errors(fast, exact), leaf_grad_errors(plain,
                                                                   exact)
        floor = {n: (k32[n][0], p32[n][0]) for n in errs}
        failures += [
            f"{n}: kernels {k:.3e} off the f32 gradient, plain bf16 {p:.3e}"
            for n, (k, p) in floor.items()
            if not k <= GRAD_NOISE_FACTOR * p + GRAD_TOL_BF16_ABS]
    return errs, where, floor, failures


def train_step_ms(network, attn_impl, steps, seed, **flags):
    """Median step ms of a fresh Trainer over ``steps`` steps (the first,
    warming cuBLAS and the allocator, left out)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    trainer = Trainer(train_config(network, steps, attn_impl, seed=seed,
                                   **flags))
    try:
        history = trainer.train()
    finally:
        trainer.close()
    ms = sorted(r["step_ms"] for r in history[1:])
    del trainer
    torch.cuda.empty_cache()
    return ms[len(ms) // 2]


def port_kernel_names():
    """The names of the port's CUDA kernels, read from its sources (each
    ``__global__`` function in ops/csrc/*.cu)."""
    from pytorch_distributed_nn_tpu_torch.ops import kernels

    fn = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(")
    repo, names = os.path.dirname(os.path.abspath(__file__)), set()
    for src in {k["source"] for k in kernels.KERNELS.values()}:
        with open(os.path.join(repo, src), encoding="utf-8") as f:
            names.update(fn.findall(f.read()))
    return names


def profile_train(trainer, steps: int = 5):
    """torch.profiler over ``steps`` training steps: wall time, device
    time by kernel, device busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batches = [trainer.train_loader.next_batch() for _ in range(steps + 1)]
    trainer.step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            trainer.step(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    # the port's own kernels: every CUDA kernel a wrapper launches, e.g.
    # the LayerNorm backward's rows and its partial-row sum
    ours = port_kernel_names()
    port = [r for r in rows if re.split(r"[<(]", r["name"].split(
        "::", 1)[-1], maxsplit=1)[0] in ours]
    return {"steps": steps, "wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "top": rows[:20], "port_kernels": port}


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
    # the f32 kernels (3xTF32: the f32 training path) on the same values
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    out32, lse32 = kernels.flash_attention_fwd(q32, k32, v32)
    delta32 = reference.flash_attention_delta(out32, do32)
    f32_args = (q32, k32, v32, None, lse32, delta32, do32)
    f32_calls = {
        "flash_attention_fwd": (
            lambda: kernels.flash_attention_fwd(q32, k32, v32)[0],
            lambda: reference.flash_attention_fwd(q32, k32, v32)[0]),
        "flash_attention_dq": (
            lambda: kernels.flash_attention_dq(*f32_args),
            lambda: reference.flash_attention_dq(*f32_args)),
        "flash_attention_dkv": (
            lambda: kernels.flash_attention_dkv(*f32_args)[0],
            lambda: reference.flash_attention_dkv(*f32_args)[0]),
    }
    costs32 = flash_costs(B, L, H, D, "float32")
    # the library on the same f32 operands: SDPA's forward, and its
    # backward (dq, dk and dv in one autograd call) replayed eagerly
    qt32, kt32, vt32 = (t.transpose(1, 2) for t in (q32, k32, v32))
    sdpa32_fwd = time_ms(
        lambda: F.scaled_dot_product_attention(qt32, kt32, vt32), n)
    leaves32 = [t.detach().requires_grad_() for t in (qt32, kt32, vt32)]
    o32 = F.scaled_dot_product_attention(*leaves32)
    dot32 = do32.transpose(1, 2)
    sdpa32_bwd = time_ms(lambda: torch.autograd.grad(
        o32, leaves32, dot32, retain_graph=True)[0], n, graph=False)
    entries = []
    for name, (run, plain, lib) in calls.items():
        bms, by = bound_ms(*costs[name])
        ms = time_ms(run, n)
        flops = sum(f for f, _ in costs[name][1])
        f32_ms = time_ms(f32_calls[name][0], n)
        f32_bms, f32_by = bound_ms(*costs32[name])
        # f32 work: each product once (the TF32 count is three times it)
        f32_flops = sum(f for f, _ in costs32[name][1]) / 3
        entries.append({
            "name": name, "route": "cuda",
            "source": kernels.KERNELS[name]["source"],
            "replaces": kernels.KERNELS[name]["replaces"],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": time_ms(plain, n),
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "sdpa_fwd_bwd_ms": sdpa_both, "library_vs_kernels": lib_diff,
            "gflop": flops / 1e9, "tflop_per_s": flops / (ms * 1e-3) / 1e12,
            "f32_ms": f32_ms, "f32_bound_ms": f32_bms, "f32_bound_by": f32_by,
            "f32_cuda_core_bound_ms": cuda_core_bound_ms(costs32[name])[0],
            "f32_plain_ms": time_ms(f32_calls[name][1], n),
            "f32_gflop": f32_flops / 1e9,
            "f32_tflop_per_s": f32_flops / (f32_ms * 1e-3) / 1e12,
            "f32_library_ms": sdpa32_fwd if name == "flash_attention_fwd"
            else sdpa32_bwd,
            "shape": shape,
        })
    del q, k, v, do, out, lse, delta, q32, k32, v32, do32, out32, lse32
    del delta32, f32_args, qt32, kt32, vt32, leaves32, o32, dot32
    N, Dm = B * L, 768
    x = torch.randn((N, Dm), generator=gen).to("cuda", dt)
    g = (1 + 0.1 * torch.randn((Dm,), generator=gen)).cuda()
    b = torch.zeros(Dm, device="cuda")
    dy = torch.randn((N, Dm), generator=gen).cuda()
    _, mu, rs = kernels.layer_norm_fwd(x, g, b, 1e-6, torch.float32)
    xf = x.float()
    # the same x one element off a 16-byte boundary: the general kernel
    x_off = torch.empty(N * Dm + 1, dtype=dt, device="cuda")[1:].view(N, Dm)
    x_off.copy_(x)
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
        "general_ms": time_ms(
            lambda: kernels.layer_norm_bwd(x_off, g, mu, rs, dy)[0], n),
        "shape": f"N={N} D={Dm} x bfloat16, dy float32 (library call: x "
                 "float32)",
    })
    train_ln = {"train_shape": f"N={N} D={Dm} bfloat16 -> float32, with "
                               "mu/rs",
                **{f"train_{k}": v for k, v in ln_fwd_times(
                    kernels, reference, F, x, g, b, True, n).items()}}
    return entries, train_ln


def check_quant_group(kernels, reference, xs, seeds, what):
    """One grouped quantize against the plain group, bit for bit, with
    ceil(k / 64) launches for the k non-empty leaves."""
    import torch

    scales = torch.stack([x.abs().amax() / 127.0 if x.numel() else
                          torch.ones((), device="cuda") for x in xs]) \
        if xs else torch.empty(0, device="cuda")
    live = sum(x.numel() > 0 for x in xs)
    before = kernels.launch_counts()["quantize_int8_scaled"]
    got = kernels.quantize_int8_scaled_group(xs, scales, seeds)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()["quantize_int8_scaled"] - before
    if launched != -(-live // kernels.QUANT_GROUP_LEAVES):
        fail(f"grouped quantize {what}: {launched} launches for {live} "
             "leaves")
    want = reference.quantize_int8_scaled_group(xs, scales, seeds)
    if len(got) != len(xs):
        fail(f"grouped quantize {what}: {len(got)} outputs")
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            fail(f"grouped quantize {what}: leaf {i} ({a.numel()} elements) "
                 f"differs in {int((a != b).sum())}")
    return ("quantize_int8_scaled", f"group {what}: {len(xs)} leaves, "
            f"{launched} launches", 0.0)


def check_int8_kernels(kernels, reference, gen, leaf_sizes):
    """Phase 3, the int8 codec: each kernel against its plain version on
    the same card tensors and seeds, bit for bit (the grouped quantize
    over ``leaf_sizes``, ResNet-18's kernel-sized leaves, and over the
    other groups the docstring lists); then two statistical checks on the
    largest leaf. Returns (cases, max abs err per kernel, the
    statistics)."""
    import torch

    def leaves(sizes):
        return [(torch.randn(m, generator=gen) * 0.05).cuda() for m in sizes]

    cases = [
        check_quant_group(kernels, reference, leaves(leaf_sizes),
                          list(range(100, 100 + len(leaf_sizes))),
                          "ResNet-18's leaves"),
        check_quant_group(kernels, reference, leaves(INT8_GROUP_CHUNKED),
                          list(range(len(INT8_GROUP_CHUNKED))), "chunked"),
        check_quant_group(kernels, reference, [], [], "empty"),
    ]
    # a leaf one element off its 16-byte boundary, an empty leaf, a leaf
    # of 3 among aligned ones
    xs = leaves((2359296 + 1, 36865, 0, 3, 16384))
    xs[0] = xs[0][1:]
    cases.append(check_quant_group(kernels, reference, xs, [5, 6, 7, 8, 9],
                                   "misaligned leaf"))
    for n in INT8_SIZES:
        x = (torch.randn(n, generator=gen) * 0.05).cuda()
        scale = x.abs().amax() / 127.0
        seed = 1000 + n
        q = kernels.quantize_int8_scaled(x, scale, seed)
        torch.cuda.synchronize()
        want = reference.quantize_int8_scaled(x, scale, seed=seed)
        if not torch.equal(q, want):
            fail(f"quantize_int8_scaled n={n}: "
                 f"{int((q != want).sum())} elements differ")
        cases.append(("quantize_int8_scaled", f"n={n}", 0.0))
    for shape in INT8_SHAPES:
        x = (torch.randn(shape, generator=gen) * 3).cuda()
        seed = shape[0] * 7919 + shape[1]
        q, s = kernels.quantize_int8(x, seed)
        torch.cuda.synchronize()
        qw, sw = reference.quantize_int8(x, seed=seed)
        if not (torch.equal(q, qw) and s.item() == sw.item()):
            fail(f"quantize_int8 {shape}: q equal {torch.equal(q, qw)}, "
                 f"scale {s.item()} vs {sw.item()}")
        d = kernels.dequantize_int8(q, s)
        torch.cuda.synchronize()
        if not torch.equal(d, reference.dequantize_int8(q, s)):
            fail(f"dequantize_int8 {shape}: not equal to the plain version")
        cases += [("quantize_int8", str(shape), 0.0),
                  ("dequantize_int8", str(shape), 0.0)]
    # the own-scale quantize around the elements its grid holds in
    # registers (past them, a second pass over x in the same launch), at
    # one element and on an all-zero x (scale 1), aligned and one element
    # off; launched twice, bit for bit equal
    held = kernels.quantize_int8_register_elements()
    for n in (1, held - 3, held, held + 5, 2 * held + 3, 5000):
        x = (torch.randn(n, generator=gen) * 3).cuda()
        if n == 5000:
            x.zero_()
        seed = n & 0xFFFF
        for xx, where in ((x, "aligned"), (misaligned(x), "misaligned")):
            q, s = kernels.quantize_int8(xx, seed)
            q2, s2 = kernels.quantize_int8(xx, seed)
            torch.cuda.synchronize()
            qw, sw = reference.quantize_int8(xx, seed=seed)
            what = (f"quantize_int8 n={n} ({held} held in registers) "
                    f"{where}" + (" all zero" if n == 5000 else ""))
            if not (torch.equal(q, qw) and s.item() == sw.item()):
                fail(f"{what}: q equal {torch.equal(q, qw)}, scale "
                     f"{s.item()} vs {sw.item()}")
            if not (torch.equal(q, q2) and torch.equal(s, s2)):
                fail(f"{what}: two launches differ")
            cases.append(("quantize_int8", what, 0.0))
    # unbiased: the mean error over the largest leaf within 4 of its
    # standard errors of 0 (each element's error has variance
    # f (1 - f) scale^2, f the fraction x / scale - floor(x / scale))
    n = INT8_SIZES[-1]
    x = (torch.randn(n, generator=gen) * 0.05).cuda()
    scale = x.abs().amax() / 127.0
    q = kernels.quantize_int8_scaled(x, scale, 7)
    err = q.double() * scale.double() - x.double()
    t = x.double() / scale.double()
    f = t - torch.floor(t)
    se = (f * (1 - f)).sum().sqrt().item() * scale.item() / n
    mean_err = err.mean().item()
    if not abs(mean_err) <= 4 * se:
        fail(f"quantize_int8_scaled is biased: mean error {mean_err} > "
             f"4 x {se}")
    q2 = kernels.quantize_int8_scaled(x, scale, 8)
    differ = int((q2 != q).sum())
    if differ == 0:
        fail("quantize_int8_scaled: seeds 7 and 8 gave the same q")
    stats = {"n": n, "mean_err": mean_err, "standard_error": se,
             "differ_other_seed": differ}
    stats["quantize_int8_register_elements"] = held
    return cases, {k: 0.0 for k in ("quantize_int8_scaled", "quantize_int8",
                                    "dequantize_int8")}, stats


def resnet_config(compression, steps, seed):
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    return TrainConfig(
        network="ResNet18", dataset="Cifar10", batch_size=RESNET_B,
        lr=RESNET_LR, momentum=0.9, lr_decay_steps=RESNET_DECAY_STEPS,
        dtype="bfloat16", compression=compression, data_layout="device",
        synthetic_size=RESNET_DATA, test_batch_size=1000, max_steps=steps,
        seed=seed)


def resnet_leaves(model):
    """The parameters whose gradients take the quantize kernel."""
    from pytorch_distributed_nn_tpu_torch.ops.compression import (
        QUANT_KERNEL_MIN_SIZE,
    )

    return [p for p in model.parameters() if p.numel() >= QUANT_KERNEL_MIN_SIZE]


def resnet_path(kernels, seed):
    """ResNet-18 on synthetic CIFAR-10 through the Trainer with int8 sync:
    launch counts read around the steps and around the eval pass."""
    import math

    import torch

    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    trainer = Trainer(resnet_config("int8", RESNET_STEPS, seed))
    # one grouped launch covers every kernel-sized leaf
    per_step = {"quantize_int8_scaled": 1}
    ev0 = trainer.evaluate()
    kernels.reset_launch_counts()
    history = trainer.train()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    ev = trainer.evaluate()
    torch.cuda.synchronize()
    eval_launches = kernels.launch_counts()
    losses = [r["loss"] for r in history]
    if len(losses) != RESNET_STEPS or not all(map(math.isfinite, losses)):
        fail(f"ResNet18 training losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"ResNet18 training loss did not fall: {losses}")
    if not ev or not ev["loss"] < ev0["loss"]:
        fail(f"ResNet18 eval loss did not fall: {ev0} -> {ev}")
    expect_launches(kernels, launches, per_step, RESNET_STEPS,
                    "ResNet18 train")
    expect_launches(kernels, eval_launches, {}, 1, "ResNet18 eval")
    step_ms = sorted(r["step_ms"] for r in history[2:])
    med = step_ms[len(step_ms) // 2]
    return {"trainer": trainer, "losses": losses, "eval_before": ev0,
            "eval": ev, "launches": launches, "eval_launches": eval_launches,
            "per_step": per_step, "step_ms": med,
            "quantized_leaves": len(resnet_leaves(trainer.model)),
            "images_per_s": RESNET_B / (med / 1e3)}


def resnet_sync_check(trainer, reference):
    """One step's gradients at the trainer's weights and next batch,
    synced by the trainer's GradSync (one grouped kernel launch over every
    leaf of 16384 or more) and by the same int8 collective with the plain
    grouped quantizer: bit for bit equal, leaf by leaf. Returns the leaf
    count and the number of kernel-sized leaves."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import compression
    from pytorch_distributed_nn_tpu_torch.ops.metrics import (
        cross_entropy_loss,
    )
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        sync_seed,
    )

    model = trainer.model
    images, labels = trainer.train_loader.next_batch()
    model.train()
    model.zero_grad(set_to_none=True)
    cross_entropy_loss(model(images), labels).backward()
    grads = [p.grad.detach().clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    seed = sync_seed(12345, 0)
    got = trainer.grad_sync(grads, seed)
    quant_seed = compression.leaf_seeds(seed, 2)[1]
    want = compression.int8_psum_mean(
        grads, quant_seed, trainer.group,
        group_quantizer=reference.quantize_int8_scaled_group)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            fail(f"int8 sync check: leaf {i} ({tuple(a.shape)}) differs "
                 f"between the kernel and the plain quantizer in "
                 f"{int((a != b).sum())} elements")
    big = sum(g.numel() >= compression.QUANT_KERNEL_MIN_SIZE for g in grads)
    return len(grads), big


def resnet_step_ms(compression, steps, seed, profile=False):
    """(median step ms, profile or None) of a fresh ResNet-18 Trainer
    (the first two steps, cuDNN's autotuning and the allocator's warm-up,
    left out); ``profile`` adds a torch.profiler breakdown of 5 steps."""
    import torch

    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    trainer = Trainer(resnet_config(compression, steps, seed))
    try:
        history = trainer.train()
        prof = profile_train(trainer) if profile else None
    finally:
        trainer.close()
    ms = sorted(r["step_ms"] for r in history[2:])
    del trainer
    torch.cuda.empty_cache()
    return ms[len(ms) // 2], prof


def time_int8_kernels(kernels, reference, gen, leaf_sizes, launches, errs):
    """Phase 6 entries of the int8 kernels. Kernel 6 at one training
    step's work (every kernel-sized leaf of ResNet-18 in one grouped
    launch); kernels 7 and 8 at ResNet-18's largest leaf, as (4608, 512).
    Also a per-size sweep of kernel 6, the leaves of each size in one
    grouped launch. Bounds: 5 bytes an element (f32 read and int8 write,
    or int8 read and f32 write)."""
    import torch

    n = N_TIMED_TRAIN
    xs = [(torch.randn(m, generator=gen) * 0.05).cuda() for m in leaf_sizes]
    scales = torch.stack([x.abs().amax() / 127.0 for x in xs])
    seeds = list(range(100, 100 + len(xs)))
    total = sum(leaf_sizes)

    def step_kernel():
        return kernels.quantize_int8_scaled_group(xs, scales, seeds)[-1]

    def step_plain():
        return reference.quantize_int8_scaled_group(xs, scales, seeds)[-1]

    bms, by = bound_ms(5 * total, 5 * total)
    entries = [{
        "name": "quantize_int8_scaled", "route": "cuda",
        "source": kernels.KERNELS["quantize_int8_scaled"]["source"],
        "replaces": kernels.KERNELS["quantize_int8_scaled"]["replaces"],
        "launches": launches["quantize_int8_scaled"],
        "max_abs_err": errs["quantize_int8_scaled"],
        "ms": time_ms(step_kernel, n), "plain_ms": time_ms(step_plain, n),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "shape": f"one ResNet-18 step: {len(leaf_sizes)} leaves, {total} "
                 "f32 elements, one grouped launch",
    }]
    sweep = []
    for m in sorted(set(leaf_sizes)):
        k = leaf_sizes.count(m)
        group = [(torch.randn(m, generator=gen) * 0.05).cuda()
                 for _ in range(k)]
        s = torch.stack([x.abs().amax() / 127.0 for x in group])
        sweep.append({"n": m, "leaves": k,
                      "ms": time_ms(lambda: kernels.quantize_int8_scaled_group(
                          group, s, list(range(k)))[-1], 100),
                      "bound_ms": bound_ms(5 * m * k, 5 * m * k)[0]})
    x = (torch.randn((4608, 512), generator=gen) * 0.05).cuda()
    m = x.numel()
    q, s = kernels.quantize_int8(x, 5)
    s0 = s.reshape(())
    bms, by = bound_ms(5 * m, 5 * m)
    shape = "(4608, 512) = 2,359,296 elements (ResNet-18's largest leaf)"
    for name, run, plain, lib in (
            ("quantize_int8", lambda: kernels.quantize_int8(x, 5)[0],
             lambda: reference.quantize_int8(x, seed=5)[0], None),
            ("dequantize_int8", lambda: kernels.dequantize_int8(q, s),
             lambda: reference.dequantize_int8(q, s),
             lambda: torch.mul(q, s0))):
        entries.append({
            "name": name, "route": "cuda",
            "source": kernels.KERNELS[name]["source"],
            "replaces": kernels.KERNELS[name]["replaces"],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": time_ms(run, n), "plain_ms": time_ms(plain, n),
            "bound_ms": bms, "bound_by": by,
            "library_ms": None if lib is None else time_ms(lib, n),
            "shape": shape,
        })
    return entries, sweep



# -- phase 7: checkpoints, resume, the evaluator, SIGTERM ---------------------

#: the resumed BertBase run against the uninterrupted one: the same
#: weights, batches and dropout masks, equal bit for bit on an H100 so
#: far. Between that and the faulty resumes of the phase, which read a
#: loss 0.004 (dropout seeded once) and 0.022 (data a batch on) apart and
#: parameters 3e-4 apart after two Adam steps of lr 1e-4 (PERF.md §6);
#: above a float32 ulp of either (1e-6 at 10.45, 1.2e-7 at 1)
BERT_RESUME_TOL = 1e-5  # the losses of steps 5 and 6
RESUME_PARAM_TOL = 1e-6  # the parameters after step 6
#: the evaluator subprocess against Trainer.evaluate() of the same state:
#: the same kernels and weights in another process, equal bit for bit on
#: an H100 so far; 160x below the eval loss's move from step 4 to step 6
#: (1.6e-3), which the phase checks it stays above. acc1 and acc5 read 0
#: at this init, so the loss carries the comparison
EVAL_TOL = 1e-5


def first_difference(got, want, where=""):
    """The path of the first leaf where two state dicts differ in keys,
    dtype, shape or any bit; None when they are equal."""
    import numpy as np

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return where or "/"
        for k in want:
            d = first_difference(got[k], want[k], f"{where}/{k}")
            if d:
                return d
        return None
    if want is None:
        return None if got is None else where
    g, w = np.asarray(got), np.asarray(want)
    if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
        return where
    return None


def read_stream(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def checked_checkpoint(ckpt, directory, want_steps, what):
    """The newest checkpoint of ``directory``, after checking the steps
    left, its manifest and its magic."""
    steps = ckpt.all_steps(directory)
    if steps != want_steps:
        fail(f"{what}: checkpoints {steps}, expected {want_steps} "
             "(--keep-last 1)")
    path = ckpt.checkpoint_path(directory, steps[-1])
    ok, reason = ckpt.verify_checkpoint(path)
    with open(path, "rb") as f:
        magic = f.read(4)
    if not ok or magic != b"PDTZ":
        fail(f"{what}: {path} verifies {ok} ({reason}), magic {magic!r}")
    return path


def write_events(stream, steps, what):
    writes = [e for e in stream if e.get("type") == "checkpoint_write"]
    if [w["step"] for w in writes] != steps or not all(
            w.get("async") and w["bytes"] > 0 and w["write_ms"] > 0
            and w["stall_ms"] >= 0 for w in writes):
        fail(f"{what}: checkpoint_write events {writes}")
    return writes


def resnet_checkpoints(kernels, seed, root):
    """ResNet-18 int8 (phase 5's configuration): 20 steps at --eval-freq
    10 --keep-last 1, async; the files; a sync save of the same state;
    --resume to step 25."""
    import dataclasses
    import math

    import torch

    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils import flax_msgpack

    d = os.path.join(root, "resnet")
    cfg = dataclasses.replace(resnet_config("int8", 20, seed), eval_freq=10,
                              keep_last=1, train_dir=d)
    t1 = Trainer(cfg)
    try:
        history = t1.train()
    finally:
        t1.close()
    path = checked_checkpoint(ckpt, d, [20], "ResNet18")
    stream = read_stream(os.path.join(d, "telemetry.jsonl"))
    writes = write_events(stream, [10, 20], "ResNet18")
    gc = [e for e in stream if e.get("type") == "checkpoint_gc"]
    if not gc or gc[-1]["deleted"] != [10]:
        fail(f"ResNet18: model_step_10 was not collected: {gc}")
    waits = [e["waited_ms"] for e in stream
             if e.get("type") == "ckpt_backpressure"]
    saved = ckpt.state_tree(t1.state)
    t0 = time.perf_counter()
    sync_path = ckpt.save_checkpoint(os.path.join(root, "resnet_sync"),
                                     t1.state, step=20)
    sync_ms = (time.perf_counter() - t0) * 1e3
    with open(path, "rb") as a, open(sync_path, "rb") as b:
        if a.read() != b.read():
            fail("ResNet18: the sync save of step 20's state differs from "
                 "the async checkpoint")
    raw = 4 + flax_msgpack.pack_array(saved).nbytes
    del t1
    torch.cuda.empty_cache()
    t2 = Trainer(dataclasses.replace(cfg, max_steps=25, resume=True))
    try:
        if t2.start_step != 20:
            fail(f"ResNet18 resume started at {t2.start_step}, not 20")
        diff = first_difference(ckpt.state_tree(t2.state), saved)
        if diff:
            fail(f"ResNet18 resume: the restored state differs from the "
                 f"saved one at {diff}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore_checkpoint(path, t2.state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        kernels.reset_launch_counts()
        resumed = t2.train()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        t2.close()
    del t2
    torch.cuda.empty_cache()
    expect_launches(kernels, launches, {"quantize_int8_scaled": 1}, 5,
                    "ResNet18 resumed")
    if [r["step"] for r in resumed] != [21, 22, 23, 24, 25] or not all(
            math.isfinite(r["loss"]) for r in resumed):
        fail(f"ResNet18 resumed steps {resumed}")
    before, after = save_windows(history)
    return {"path": path, "pdtz_bytes": os.path.getsize(path),
            "raw_bytes": raw, "writes": writes, "backpressure_ms": waits,
            "sync_write_ms": sync_ms, "restore_ms": restore_ms,
            "launches": launches,
            "steps_without_save_ms": before, "steps_after_save_ms": after,
            "losses": [r["loss"] for r in history + resumed]}


def save_windows(history):
    """Step ms of a run that saves at steps 10 and 20, in step order:
    steps 2-10 (no save in flight) and steps 11-20 (the step-10 save
    being written)."""
    return ([r["step_ms"] for r in history[1:10]],
            [r["step_ms"] for r in history[10:20]])


def window_stats(ms):
    """Median, mean and max of a list of step ms."""
    s = sorted(ms)
    return {"median": s[len(s) // 2], "mean": sum(s) / len(s), "max": s[-1]}


def start_evaluator(repo, model_dir, seed, log_path):
    """The polling evaluator as a subprocess on the BertBase train_dir,
    started before the run writes: it follows the newest checkpoint."""
    cmd = [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch",
           "evaluator", "--model-dir", model_dir, "--network", "BertBase",
           "--dataset", "MLMSynth", "--eval-freq", "2", "--follow-latest",
           "--eval-interval", "0.5", "--max-evals", "2", "--timeout", "300",
           "--test-batch-size", "16", "--eval-batches", "2", "--seed",
           str(seed), "--attn-impl", "pallas", "--fused-ln", "--dtype",
           "bfloat16"]
    err = open(log_path, "w")
    try:
        proc = subprocess.Popen(cmd, cwd=repo, stdout=subprocess.PIPE,
                                stderr=err, text=True)
    except OSError:
        err.close()
        raise
    # the run starts once the evaluator polls (it imports torch and builds
    # its model first), so that it sees the first checkpoints
    deadline = time.monotonic() + 180
    while proc.poll() is None and time.monotonic() < deadline:
        with open(log_path) as f:
            if "Evaluator polling" in f.read():
                return proc, err
        time.sleep(0.2)
    proc.kill()
    proc.communicate(timeout=60)
    err.close()
    with open(log_path) as f:
        fail(f"the evaluator subprocess did not start polling: "
             f"{f.read()[-4000:]}")


def finish_evaluator(proc, err, log_path, timeout=360.0):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate(timeout=60)
        fail(f"evaluator subprocess did not end in {timeout} s")
    finally:
        err.close()
    if proc.returncode != 0:
        with open(log_path) as f:
            fail(f"evaluator subprocess exited {proc.returncode}: "
                 f"{f.read()[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def state_gaps(got, want):
    """Max |got - want| over two trainers' parameters, and over their
    optimizer state, on the card."""
    from pytorch_distributed_nn_tpu_torch.models.convert import (
        train_state_tensors,
    )

    _, a = train_state_tensors(got.state)
    _, b = train_state_tensors(want.state)
    if set(a) != set(b):
        fail(f"state keys differ: {sorted(set(a) ^ set(b))[:8]}")
    gaps = {"params": 0.0, "opt_state": 0.0}
    for k, t in a.items():
        part = "params" if k.startswith("params/") else "opt_state"
        gap = (t.float() - b[k].float()).abs().max().item()
        gaps[part] = max(gaps[part], gap)
    return gaps


def bert_checkpoints(kernels, seed, root, repo):
    """BertBase (phase 5's configuration): 4 steps at --eval-freq 2
    --keep-last 1, --resume to step 6 with exact launch counts, the
    resumed run against an uninterrupted 6-step run (its losses and its
    final state), two faulty resumes the check must tell apart (the data
    stream one batch on, the dropout generator seeded once and never
    again, as the port's was), and the evaluator subprocess polling the
    same train_dir meanwhile."""
    import dataclasses
    import math
    import shutil

    import torch

    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils import flax_msgpack

    d = os.path.join(root, "bert")
    faulty_dir = os.path.join(root, "bert_faulty")
    log_path = os.path.join(root, "evaluator.log")
    proc, err = start_evaluator(repo, d, seed, log_path)
    try:
        cfg = train_config("BertBase", 4, seed=seed, eval_freq=2,
                           keep_last=1, train_dir=d)
        t1 = Trainer(cfg)
        try:
            t1.train()
            ev4 = t1.evaluate()
        finally:
            t1.close()
        path4 = checked_checkpoint(ckpt, d, [4], "BertBase")
        raw = 4 + flax_msgpack.pack_array(ckpt.state_tree(t1.state)).nbytes
        del t1
        torch.cuda.empty_cache()
        # the faulty resumes start from a copy of step 4 (the resumed run
        # collects it)
        os.makedirs(faulty_dir)
        for f in (path4, ckpt.meta_path(path4), ckpt.data_state_path(path4)):
            shutil.copy(f, faulty_dir)
        t2 = Trainer(dataclasses.replace(cfg, max_steps=6, resume=True))
        L = t2.model.config.num_layers
        per_step = {"flash_attention_fwd": L, "flash_attention_dq": L,
                    "flash_attention_dkv": L, "layer_norm": 2 * L + 2,
                    "layer_norm_bwd": 2 * L + 2}
        try:
            if t2.start_step != 4:
                fail(f"BertBase resume started at {t2.start_step}, not 4")
            kernels.reset_launch_counts()
            resumed = t2.train()
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            ev6 = t2.evaluate()
        finally:
            t2.close()
        path = checked_checkpoint(ckpt, d, [6], "BertBase resumed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore_checkpoint(path, t2.state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        out = finish_evaluator(proc, err, log_path)
    finally:
        err.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=60)
    expect_launches(kernels, launches, per_step, 2, "BertBase resumed")
    stream = read_stream(os.path.join(d, "telemetry.jsonl"))
    writes = write_events(stream, [2, 4, 6], "BertBase")
    straight = Trainer(train_config("BertBase", 6, seed=seed))
    try:
        want = straight.train()
        ref = [r["loss"] for r in want[4:6]]
        sound = {"losses": [r["loss"] for r in resumed],
                 **state_gaps(t2, straight)}
        del t2
        torch.cuda.empty_cache()
        faulty = {}
        for fault in ("data stream one batch on", "dropout seeded once"):
            t = Trainer(train_config("BertBase", 6, seed=seed, resume=True,
                                     train_dir=faulty_dir))
            try:
                if fault.startswith("data"):
                    t.train_loader.skip(1)
                else:
                    t.state.dropout_generator.manual_seed(t.state.seed)
                    t.state.dropout_generator = None  # the model keeps it
                faulty[fault] = {"losses": [r["loss"] for r in t.train()],
                                 **state_gaps(t, straight)}
            finally:
                t.close()
            del t
            torch.cuda.empty_cache()
    finally:
        straight.close()
    del straight
    torch.cuda.empty_cache()
    for r in (sound, *faulty.values()):
        r["loss_gap"] = max(abs(x - y) for x, y in zip(r["losses"], ref))
    got = sound["losses"]
    if [r["step"] for r in resumed] != [5, 6] or not all(
            math.isfinite(x) for x in got) or \
            sound["loss_gap"] > BERT_RESUME_TOL or \
            sound["params"] > RESUME_PARAM_TOL:
        fail(f"BertBase resumed losses {got} against the uninterrupted "
             f"run's {ref} (tol {BERT_RESUME_TOL}); parameters apart by "
             f"{sound['params']} (tol {RESUME_PARAM_TOL})")
    for fault, r in faulty.items():
        if r["loss_gap"] <= BERT_RESUME_TOL or \
                r["params"] <= RESUME_PARAM_TOL:
            fail(f"BertBase resume check cannot tell a faulty resume "
                 f"({fault}) from a sound one: {r}")
    # the evaluator: its metrics against Trainer.evaluate() of the state
    evaluated = {int(k): v for k, v in out["evaluated"].items()}
    compared = {s: e for s, e in ((4, ev4), (6, ev6)) if s in evaluated}
    if len(evaluated) != 2 or not compared:
        fail(f"evaluator evaluated steps {sorted(evaluated)} (expected 2 of "
             "2, 4, 6, with 4 or 6 among them)")
    if abs(ev4["loss"] - ev6["loss"]) <= EVAL_TOL:
        fail(f"the evaluator check cannot tell step 4 from step 6: eval "
             f"losses {ev4['loss']} and {ev6['loss']} (tol {EVAL_TOL})")
    for s, e in compared.items():
        if any(abs(evaluated[s][k] - e[k]) > EVAL_TOL
               for k in ("loss", "acc1", "acc5")):
            fail(f"evaluator step {s}: {evaluated[s]} against "
                 f"Trainer.evaluate() {e} (tol {EVAL_TOL})")
    per_batch = {"flash_attention_fwd": L, "layer_norm": 2 * L + 2}
    expect_launches(kernels, out["launches"], per_batch,
                    len(evaluated) * out["eval_batches"], "evaluator")
    return {"path": path, "pdtz_bytes": os.path.getsize(path),
            "raw_bytes": raw, "writes": writes, "restore_ms": restore_ms,
            "launches": launches, "per_step": per_step,
            "straight_losses": ref, "sound": sound, "faulty": faulty,
            "eval_steps": {4: ev4, 6: ev6},
            "evaluator": out, "compared": {s: {"trainer": e,
                                               "evaluator": evaluated[s]}
                                           for s, e in compared.items()}}


def sigterm_run(repo, root):
    """A supervised ``train`` subprocess on the card (ResNet-18 int8, a
    small synthetic set) gets SIGTERM once its first step is done: it must
    exit 0 and leave an emergency checkpoint at its completed step."""
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    d = os.path.join(root, "sigterm")
    cmd = [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "train",
           "--network", "ResNet18", "--dataset", "Cifar10", "--batch-size",
           "256", "--learning-rate", "0.05", "--dtype", "bfloat16",
           "--compress-grad", "int8", "--synthetic-size", "2048",
           "--max-steps", "100000", "--supervise", "--train-dir", d]
    log_path = os.path.join(root, "sigterm.log")
    exit_s = None
    with open(log_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=repo, stdout=subprocess.DEVNULL,
                                stderr=err)
        try:
            deadline = time.monotonic() + 300
            while not os.path.exists(os.path.join(d, "heartbeat.json")):
                if proc.poll() is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            if proc.poll() is None:
                t0 = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
                proc.wait(timeout=180)
                exit_s = time.perf_counter() - t0
        except subprocess.TimeoutExpired:
            pass
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
                fail("the supervised train subprocess did not exit on "
                     "SIGTERM")
    if proc.returncode != 0 or exit_s is None:
        with open(log_path) as f:
            fail(f"the supervised train subprocess exited "
                 f"{proc.returncode} (signalled: {exit_s is not None}): "
                 f"{f.read()[-4000:]}")
    stream = read_stream(os.path.join(d, "telemetry.jsonl"))
    preempt = [e for e in stream if e.get("type") == "preempt"]
    if len(preempt) != 1 or preempt[0]["signal"] != signal.SIGTERM:
        fail(f"SIGTERM run: preempt events {preempt}")
    step = preempt[0]["step"]
    path = checked_checkpoint(ckpt, d, [step], "SIGTERM run")
    return {"step": step, "path": path, "exit_s": exit_s,
            "bytes": os.path.getsize(path)}


def checkpoint_phase(kernels, seed, smi, repo, root):
    """Phase 7 in ``root``, whose train_dirs phase 8 exports from."""
    from pytorch_distributed_nn_tpu_torch.ops import host_codec

    if not host_codec.available():
        fail("the native host codec (native/codec.cpp) did not build: the "
             "card's checkpoints must be PDTZ")
    resnet = resnet_checkpoints(kernels, seed, root)
    rw = resnet["writes"]
    log(f"phase 7 codec: native/codec.cpp built; checkpoints are PDTZ "
        f"({smi})")
    log(f"phase 7 ResNet18 checkpoints (B={RESNET_B}, bf16, int8 sync, "
        f"20 steps, --eval-freq 10 --keep-last 1, async): model_step_20 "
        f"verifies, PDTZ, model_step_10 collected; PDTZ "
        f"{resnet['pdtz_bytes']} bytes, raw {resnet['raw_bytes']} bytes "
        f"({smi})")
    for w in rw:
        log(f"phase 7 ResNet18 async checkpoint_write step {w['step']}: "
            f"{w['bytes']} bytes, write_ms {w['write_ms']}, stall_ms "
            f"{w['stall_ms']}, fetch_ms {w['fetch_ms']}, queued_ms "
            f"{w['queued_ms']} ({smi})")
    log(f"phase 7 ResNet18 sync save of step 20's state: the same bytes "
        f"as the async file; write_ms {resnet['sync_write_ms']:.3f}; "
        f"backpressure waits {resnet['backpressure_ms']} ms ({smi})")
    log(f"phase 7 ResNet18 --resume to step 25: parameters, momentum "
        f"buffers and BatchNorm statistics bit for bit equal to the "
        f"saved ones; restore {resnet['restore_ms']:.3f} ms; launches "
        f"{resnet['launches']} (5 x quantize_int8_scaled 1) ({smi})")
    b = window_stats(resnet["steps_without_save_ms"])
    a = window_stats(resnet["steps_after_save_ms"])
    log(f"phase 7 ResNet18 step ms, steps 2-10 (no save in flight): "
        f"median {b['median']:.3f}, mean {b['mean']:.3f}, max "
        f"{b['max']:.3f}; steps 11-20 (the step-10 save being written): "
        f"median {a['median']:.3f}, mean {a['mean']:.3f}, max "
        f"{a['max']:.3f}; in order "
        f"{[round(x, 3) for x in resnet['steps_after_save_ms']]} "
        f"({smi})")
    bert = bert_checkpoints(kernels, seed, root, repo)
    log(f"phase 7 BertBase checkpoints (B=16, L=512, bf16, adam, 4 "
        f"steps at --eval-freq 2 --keep-last 1, --resume to 6): "
        f"model_step_6 verifies, PDTZ; PDTZ {bert['pdtz_bytes']} bytes, "
        f"raw {bert['raw_bytes']} bytes; restore "
        f"{bert['restore_ms']:.3f} ms ({smi})")
    for w in bert["writes"]:
        log(f"phase 7 BertBase async checkpoint_write step {w['step']}: "
            f"{w['bytes']} bytes, write_ms {w['write_ms']}, stall_ms "
            f"{w['stall_ms']}, fetch_ms {w['fetch_ms']} ({smi})")
    log(f"phase 7 BertBase resumed launches {bert['launches']} (= 2 x "
        f"{bert['per_step']}) ({smi})")
    for what, r in (("the resumed run", bert["sound"]),
                    *(("faulty resume: " + k, v)
                      for k, v in bert["faulty"].items())):
        log(f"phase 7 BertBase {what}: losses (steps 5, 6) "
            f"{r['losses']} against the uninterrupted run's "
            f"{bert['straight_losses']}, apart by {r['loss_gap']} (tol "
            f"{BERT_RESUME_TOL}); state after step 6 apart by "
            f"{r['params']} (parameters, tol {RESUME_PARAM_TOL}), "
            f"{r['opt_state']} (Adam's m and v) ({smi})")
    ev = bert["evaluator"]
    log(f"phase 7 evaluator subprocess: steps "
        f"{sorted(int(s) for s in ev['evaluated'])}, launches "
        f"{ev['launches']} ({ev['eval_batches']} batches an evaluation: "
        f"12 flash forward and 26 LayerNorm forward a batch, no "
        f"backward); against Trainer.evaluate() "
        f"{bert['compared']} (tol {EVAL_TOL}; Trainer.evaluate() at "
        f"steps 4 and 6: {bert['eval_steps']}) ({smi})")
    for s, m in sorted(ev["evaluated"].items(), key=lambda x: int(x[0])):
        log(f"phase 7 evaluator step {s}: restore_ms "
            f"{m['restore_ms']:.3f}, eval_ms {m['eval_ms']:.3f}, loss "
            f"{m['loss']:.6f}, acc1 {m['acc1']:.6f}, acc5 "
            f"{m['acc5']:.6f} ({smi})")
    sig = sigterm_run(repo, root)
    log(f"phase 7 SIGTERM: a supervised train subprocess exited 0 "
        f"{sig['exit_s']:.3f} s after SIGTERM with an emergency "
        f"checkpoint model_step_{sig['step']} ({sig['bytes']} bytes) "
        f"that verifies ({smi})")
    for r in (resnet, bert):
        r.pop("path", None)
    return {"resnet": resnet, "bert": bert, "sigterm": sig}


# -- phase 8: single-pass serving of ResNet-18 and BertBase ------------------

#: ResNet-18's logits on the card against the same artifact on the CPU
#: (f32, TF32 off on the card): max |card - cpu| over max |cpu|. The two
#: differ by the convolutions' reduction order only
SERVE_RTOL = 1e-4
#: BertBase served (the LayerNorm kernel) against the same weights with
#: the plain LayerNorm on the card. The two LayerNorms agree to
#: TOL["float32"], but their f32 outputs are cast to bf16 before the next
#: layer, where a difference at a rounding boundary moves a value one bf16
#: step, and 12 layers carry that on: measured on one H100, the two bf16
#: models' logits differed by 3.5e-2. So the check is the gradient
#: check's: each bf16 model against the plain model in f32, the kernel
#: model no further than BERT_SERVE_NOISE_FACTOR times the plain bf16
#: model's own error, plus BERT_SERVE_ABS
BERT_SERVE_NOISE_FACTOR = 2.0
BERT_SERVE_ABS = 1e-3
#: timed batches per bucket (the median is reported)
SERVE_TIMED = 25
BERT_BUCKETS = (1, 2, 4, 8)
#: rows of the 8 concurrent HTTP clients
CLIENT_ROWS = (1, 2, 3, 4, 4, 3, 2, 1)
#: the batches of a fresh ``serve bench`` whose infer_ms is reported: the
#: first ones on the scheduler thread
FIRST_BATCHES = 50
#: the LayerNorm forward at BertBase's serving shapes: rows (batch bucket
#: x length bucket) of D = 768, from one row to bucket 8 at L = 512
LN_SERVE_ROWS = (1, 4096)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def start_server(repo, art, root, name, *flags):
    """A ``serve run`` subprocess on the card, on an ephemeral port."""
    port_file = os.path.join(root, f"{name}.port")
    log_path = os.path.join(root, f"{name}.log")
    err = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "serve",
         "run", "--artifact", art, "--port", "0", "--port-file", port_file,
         "--serve-dir", os.path.join(root, name), *flags],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=err)
    return {"proc": proc, "err": err, "log": log_path,
            "port_file": port_file, "name": name}


def server_log(server):
    server["err"].flush()
    with open(server["log"]) as f:
        return f.read()


def kill_server(server):
    if server["proc"].poll() is None:
        server["proc"].kill()
        server["proc"].wait(timeout=60)
    server["err"].close()


def server_url(server, timeout=240.0):
    deadline = time.monotonic() + timeout
    while not os.path.exists(server["port_file"]):
        if server["proc"].poll() is not None or time.monotonic() > deadline:
            fail(f"serve run {server['name']} did not come up (exit "
                 f"{server['proc'].poll()}): {server_log(server)[-4000:]}")
        time.sleep(0.05)
    with open(server["port_file"]) as f:
        return f"http://127.0.0.1:{int(f.read())}"


def drain_server(server, timeout=60.0):
    """SIGTERM: the server must drain, then exit 0. Returns the seconds
    from the signal to the exit."""
    proc = server["proc"]
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    exit_s = time.perf_counter() - t0
    text = server_log(server)
    kill_server(server)
    if proc.returncode != 0 or "drain complete" not in text:
        fail(f"serve run {server['name']}: SIGTERM gave exit "
             f"{proc.returncode}: {text[-4000:]}")
    return exit_s


def profile_infer(engine, xs, calls: int = 5):
    """torch.profiler over ``calls`` batches of ``engine.infer``: wall
    time, device time by kernel and copy, device busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.infer(xs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            engine.infer(xs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r["device_ms"] for r in rows)
    return {"calls": calls, "wall_ms": wall_ms / calls,
            "device_ms": device_ms / calls,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "top": [{**r, "device_ms": r["device_ms"] / calls}
                    for r in rows[:8]]}


def bucket_times(engine, xs, buckets):
    """Median ``infer_ms`` and ``pad_ms`` of :data:`SERVE_TIMED` batches
    at each batch bucket (full buckets), with the bucket's FLOPs."""
    out = {}
    for b in buckets:
        stats = [engine.infer(xs[:b])[1] for _ in range(SERVE_TIMED)]
        infer_ms = median([st["infer_ms"] for st in stats])
        flops = stats[0]["flops"]
        out[b] = {"infer_ms": infer_ms,
                  "pad_ms": median([st["pad_ms"] for st in stats]),
                  "flops": flops,
                  "achieved_tflop_per_s": flops / infer_ms / 1e9}
    return out


def resnet_serving(seed, repo, root):
    """ResNet-18: phase 7's checkpoint exported (f32 and int8), served by
    the engine on the card (buckets 1-32) and held to the CPU; over HTTP
    by ``serve run`` subprocesses (8 concurrent clients, a 429 under
    ``--max-queue 1``, a SIGTERM drain each); and ``serve bench``'s
    open-loop sweep."""
    import numpy as np
    import torch

    from pytorch_distributed_nn_tpu_torch.serving import loadgen
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        export_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        DEFAULT_BATCH_BUCKETS,
        InferenceEngine,
    )

    td = os.path.join(root, "resnet")
    arts, export_s = {}, {}
    for q in ("none", "int8"):
        arts[q] = os.path.join(root, f"resnet_artifact_{q}")
        t0 = time.perf_counter()
        m = export_artifact(td, arts[q], quantize=q)
        export_s[q] = time.perf_counter() - t0
        if m["network"] != "ResNet18" or m["param_count"] != 11173962:
            fail(f"ResNet18 export ({q}): {m['network']}, "
                 f"{m['param_count']} parameters")
        step = m["source"]["step"]
    # the HTTP servers start while the engines are checked (untimed)
    servers = [start_server(repo, arts["none"], root, "resnet_serve"),
               start_server(repo, arts["none"], root, "resnet_shed",
                            "--max-queue", "1")]
    try:
        rng = np.random.RandomState(seed)
        xs = [rng.rand(32, 32, 3).astype(np.float32) for _ in range(32)]
        result = {"export_s": export_s, "step": step}
        engines = {}
        for q, art in arts.items():
            engine = InferenceEngine(art)
            warm_s = engine.warmup()
            got, stats = engine.infer(xs)
            cpu = InferenceEngine(art, batch_buckets=(32,), device="cpu")
            want, _ = cpu.infer(xs)
            del cpu
            got, want = np.stack(got), np.stack(want)
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            top1 = bool((got.argmax(1) == want.argmax(1)).all())
            if not rel <= SERVE_RTOL or not top1 or stats["nonfinite"]:
                fail(f"ResNet18 ({q}) on the card vs the CPU: relative err "
                     f"{rel} (tol {SERVE_RTOL}), top-1 equal {top1}, "
                     f"nonfinite {stats['nonfinite']}")
            result[q] = {"warmup_s": warm_s, "rel_err": rel,
                         "max_abs_logit": float(np.abs(want).max()),
                         "bytes": engine.manifest["bytes"]}
            engines[q] = engine
        urls = [server_url(srv) for srv in servers]  # both warm: idle
        for q in ("none", "int8", "int8", "none"):  # in turns
            result[q].setdefault("buckets", []).append(bucket_times(
                engines[q], xs, DEFAULT_BATCH_BUCKETS))
        for q, engine in engines.items():
            result[q]["retraces"] = engine.retraces()
            if engine.retraces() != 0:
                fail(f"ResNet18 ({q}) engine: retraces() = "
                     f"{engine.retraces()} after warmup")
        engine = engines["none"]
        result["profile"] = profile_infer(engine, xs)

        # HTTP: 8 concurrent clients of 1-4 rows against the in-process
        # engine's top-1 (and logits, at the card-vs-card tolerance)
        url = urls[0]
        start, bodies = 0, []
        for n in CLIENT_ROWS:
            bodies.append(xs[start:start + n])
            start += n
        replies = [None] * len(bodies)

        def client(i):
            replies[i] = post(f"{url}/v1/infer", {
                "inputs": [x.tolist() for x in bodies[i]],
                "timeout_s": 30.0})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        http_s = time.perf_counter() - t0
        http_err = 0.0
        for i, r in enumerate(replies):
            if r is None or r[0] != 200:
                fail(f"ResNet18 HTTP client {i}: {r and r[:2]}")
            mine, _ = engine.infer(bodies[i])
            if r[1]["top1"] != [int(np.argmax(o)) for o in mine]:
                fail(f"ResNet18 HTTP client {i}: top1 {r[1]['top1']} vs the "
                     f"in-process engine's")
            http_err = max(http_err, float(np.abs(
                np.asarray(r[1]["outputs"]) - np.stack(mine)).max()))
        if http_err > SERVE_RTOL * result["none"]["max_abs_logit"]:
            fail(f"ResNet18 HTTP logits vs the in-process engine: max abs "
                 f"err {http_err}")
        # a scalar image row is refused at admission; the server serves on
        bad = post(f"{url}/v1/infer", {"inputs": [xs[0].tolist(), 0.5]})
        good = post(f"{url}/v1/infer", {"inputs": [xs[0].tolist()]})
        mine, _ = engine.infer(xs[:1])
        if bad[0] != 400 or good[0] != 200 \
                or good[1]["top1"] != [int(np.argmax(mine[0]))]:
            fail(f"ResNet18 HTTP: a scalar image row gave {bad[0]} "
                 f"(expected 400), the next good row {good[0]} "
                 f"{good[1].get('top1')}")
        shed = post(f"{urls[1]}/v1/infer", {
            "inputs": [x.tolist() for x in xs[:8]], "timeout_s": 30.0})
        if shed[0] != 429 or int(shed[2].get("Retry-After", 0)) < 1:
            fail(f"ResNet18 --max-queue 1: 8 rows gave {shed[0]} "
                 f"{shed[1]} (expected 429 with Retry-After)")
        drain_s = [drain_server(s) for s in servers]
        result["http"] = {"clients": len(bodies), "rows": sum(CLIENT_ROWS),
                          "wall_s": http_s, "max_abs_err": http_err,
                          "latency_ms": [r[1]["latency_ms"] for r in replies],
                          "bad_row": bad[0], "after_bad_row": good[0],
                          "shed": {"status": shed[0],
                                   "retry_after": shed[2].get("Retry-After")},
                          "drain_s": drain_s}
        del engines, engine
        torch.cuda.empty_cache()
        # `serve bench` as a user runs it: a fresh process
        proc = subprocess.run(
            [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch",
             "serve", "bench", "--artifact", arts["none"], "--offered",
             "500,1000,2000", "--duration", "2", "--out",
             os.path.join(root, "resnet_bench_cli"), "--json"],
            cwd=repo, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"serve bench exited {proc.returncode}: "
                 f"{proc.stderr[-4000:]}")
        result["bench_cli"] = json.loads(proc.stdout.strip().splitlines()[-1])
        result["bench_cli"]["first_infer_ms"] = first_batches(
            os.path.join(root, "resnet_bench_cli", "serving.jsonl"))
        # the same sweep in this process, whose heap holds phases 1-7's
        # objects, counting Python's garbage collections
        pauses = []  # (generation, ms) of each garbage collection

        def on_gc(phase, info):
            if phase == "start":
                on_gc.t0 = time.perf_counter()
            else:
                pauses.append((info["generation"],
                               (time.perf_counter() - on_gc.t0) * 1e3))

        gc.callbacks.append(on_gc)
        try:
            result["bench"] = loadgen.sweep(
                arts["none"], offered=(500.0, 1000.0, 2000.0),
                duration_s=2.0, out_dir=os.path.join(root, "resnet_bench"),
                log=lambda msg: None)
        finally:
            gc.callbacks.remove(on_gc)
        result["bench_gc"] = {
            "collections": len(pauses),
            "generation_2": sum(g == 2 for g, _ in pauses),
            "max_ms": max((ms for _, ms in pauses), default=0.0),
            "total_ms": sum(ms for _, ms in pauses)}
    finally:
        for s in servers:
            kill_server(s)
    return result


def bert_serving(kernels, reference, F, seed, root):
    """BertBase: phase 7's checkpoint exported and served with batch
    buckets 1-8 and length buckets up to 512: exactly 26 LayerNorm
    forward launches a batch and no other kernel, over the engine and one
    short HTTP request; the logits against the plain-LayerNorm model; the
    LayerNorm forward kernel at the serving shapes."""
    import numpy as np
    import torch

    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        export_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )
    from pytorch_distributed_nn_tpu_torch.serving.server import ServingServer

    art = os.path.join(root, "bert_artifact")
    t0 = time.perf_counter()
    m = export_artifact(os.path.join(root, "bert"), art)
    export_s = time.perf_counter() - t0
    engine = InferenceEngine(art, batch_buckets=BERT_BUCKETS)
    warm_s = engine.warmup()
    cfg = engine.model.config
    per_batch = 2 * cfg.num_layers + 2
    rng = np.random.RandomState(seed)

    def rows(n, length):
        return [rng.randint(1, cfg.vocab_size, size=length).astype(np.int32)
                for _ in range(n)]

    # the dtypes each LayerNorm sees (an uncounted batch)
    seen = set()
    hooks = [mod.register_forward_hook(
        lambda mod, inp, out: seen.add((str(inp[0].dtype), str(out.dtype))))
        for mod in engine.model.modules()
        if type(mod).__name__ == "LayerNorm"]
    engine.infer(rows(1, 7))
    for h in hooks:
        h.remove()

    batcher = Batcher(engine, default_timeout_s=60.0)
    server = ServingServer(engine, batcher, port=0)
    server.start()
    shapes = ((1, 5), (3, 100), (8, 512), (2, 16))
    try:
        kernels.reset_launch_counts()
        batches0 = engine.infer_batches
        infer = [engine.infer(rows(n, length))[1] for n, length in shapes]
        refused = post(f"http://127.0.0.1:{server.port}/v1/infer",
                       {"inputs": [[1, cfg.vocab_size]]})
        reply = post(f"http://127.0.0.1:{server.port}/v1/infer",
                     {"inputs": [r.tolist() for r in rows(1, 12)],
                      "timeout_s": 60.0})
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        batches = engine.infer_batches - batches0
    finally:
        server.close()
        batcher.close()
    expect_launches(kernels, launches, {"layer_norm": per_batch}, batches,
                    "BertBase serving")
    if refused[0] != 400:
        fail(f"BertBase over HTTP: an id of {cfg.vocab_size} gave "
             f"{refused[0]} {refused[1]} (expected 400)")
    if reply[0] != 200 or np.shape(reply[1]["outputs"][0]) != \
            (16, cfg.vocab_size) or any(st["nonfinite"] for st in infer):
        fail(f"BertBase over HTTP: {reply[0]} "
             f"{np.shape(reply[1].get('outputs'))}; nonfinite "
             f"{[st['nonfinite'] for st in infer]}")

    # against the same weights with the plain LayerNorm on the card, in
    # bf16 and in f32
    xs = rows(2, 128)
    got = np.stack(engine.infer(xs)[0])
    tokens = torch.from_numpy(np.stack(xs)).cuda()
    plain = {}
    for dtype in ("bfloat16", "float32"):
        model = build_model("BertBase", use_kernels=False,
                            **{**m["model_kw"], "dtype": dtype})
        model.load_state_dict(engine.model.state_dict())
        with torch.inference_mode():
            plain[dtype] = model.cuda().eval()(tokens).float().cpu().numpy()
        del model
        torch.cuda.empty_cache()
    errs = {"kernels_vs_plain": np.abs(got - plain["bfloat16"]).max(),
            "kernels_vs_f32": np.abs(got - plain["float32"]).max(),
            "plain_vs_f32": np.abs(plain["bfloat16"]
                                   - plain["float32"]).max()}
    errs = {k: float(v) for k, v in errs.items()}
    bound = BERT_SERVE_NOISE_FACTOR * errs["plain_vs_f32"] + BERT_SERVE_ABS
    if not errs["kernels_vs_f32"] <= bound:
        fail(f"BertBase served logits: {errs} (the kernels' model may be "
             f"at most {bound} from the f32 plain model)")
    times = {}
    for b in (1, 8):
        stats = [engine.infer(rows(b, 512))[1] for _ in range(SERVE_TIMED)]
        times[f"{b}x512"] = {"infer_ms": median([s["infer_ms"]
                                                 for s in stats]),
                             "flops": stats[0]["flops"]}
    prof = {k: profile_infer(engine, rows(b, 512))
            for k, b in (("1x512", 1), ("8x512", 8))}
    if engine.retraces() != 0:
        fail(f"BertBase engine: retraces() = {engine.retraces()}")

    # the LayerNorm forward kernel at the serving shapes: bf16 in, f32 out
    gen = torch.Generator().manual_seed(seed)
    D = cfg.d_model
    g = torch.randn(D, generator=gen).cuda()
    b = torch.randn(D, generator=gen).cuda()
    ln = []
    for n in LN_SERVE_ROWS:
        x = torch.randn((n, D), generator=gen).cuda().to(torch.bfloat16)
        xf = x.float()
        err = (kernels.layer_norm(x, g, b, 1e-6, torch.float32)
               - reference.layer_norm(x, g, b, 1e-6, torch.float32)
               ).abs().max().item()
        if not err <= TOL["float32"]:
            fail(f"layer_norm at the serving shape ({n}, {D}) bf16 -> f32: "
                 f"max abs err {err} > {TOL['float32']}")
        ln.append({"shape": f"N={n} D={D} bfloat16 -> float32",
                   "max_abs_err": err,
                   **ln_fwd_times(kernels, reference, F, x, g, b)})
    del engine
    torch.cuda.empty_cache()
    return {"export_s": export_s, "bytes": m["bytes"],
            "step": m["source"]["step"],
            "params": m["param_count"], "warmup_s": warm_s,
            "shapes": len(BERT_BUCKETS) * 10, "ln_dtypes": sorted(seen),
            "launches": launches, "batches": batches,
            "per_batch": per_batch, "logit_errs": errs,
            "vocab": cfg.vocab_size, "refused": refused[0],
            "logit_bound": bound,
            "http_latency_ms": reply[1]["latency_ms"], "times": times,
            "profile": prof, "ln": ln}


def serving_phase(kernels, reference, F, seed, smi, repo, root):
    resnet = resnet_serving(seed, repo, root)
    for q in ("none", "int8"):
        r = resnet[q]
        log(f"phase 8 ResNet18 artifact ({q}, step "
            f"{resnet['step']}, {r['bytes']} bytes, exported "
            f"in {resnet['export_s'][q]:.3f} s): engine warmed (buckets "
            f"1-32) in {r['warmup_s']:.3f} s; retraces {r['retraces']}; "
            f"logits vs the CPU relative err {r['rel_err']:.3e} (tol "
            f"{SERVE_RTOL}), top-1 equal ({smi})")
        for i, run in enumerate(r["buckets"]):
            log(f"phase 8 ResNet18 ({q}, timing {i + 1} of 2, in turns "
                f"none, int8, int8, none) infer_ms median of {SERVE_TIMED} "
                f"by bucket: " + "; ".join(
                    f"{b}: {t['infer_ms']:.3f} ms (pad {t['pad_ms']:.3f}, "
                    f"{t['achieved_tflop_per_s']:.2f} TFLOP/s of "
                    f"{t['flops'] / 1e9:.3f} GFLOP)"
                    for b, t in run.items()) + f" ({smi})")
    p = resnet["profile"]
    log(f"phase 8 ResNet18 bucket 32 profile: wall {p['wall_ms']:.3f} ms, "
        f"device {p['device_ms']:.3f} ms a batch, busy "
        f"{p['device_busy_share']:.4f}; top " + "; ".join(
            f"{t['name'][:60]} {t['device_ms']:.3f} ms" for t in p["top"][:5])
        + f" ({smi})")
    h = resnet["http"]
    log(f"phase 8 ResNet18 serve run: {h['clients']} concurrent clients, "
        f"{h['rows']} rows -> 200, top-1 equal to the in-process engine, "
        f"logits max abs err {h['max_abs_err']:.3e}, in {h['wall_s']:.3f} "
        f"s; a scalar image row: {h['bad_row']}, the next good row "
        f"{h['after_bad_row']}; --max-queue 1: 429, Retry-After {h['shed']['retry_after']}; "
        f"SIGTERM drained and exited 0 in "
        f"{', '.join(f'{x:.3f}' for x in h['drain_s'])} s ({smi})")
    for key, where in (("bench_cli", "serve bench (a fresh process)"),
                       ("bench", "the same sweep in this process")):
        bench = resnet[key]
        for r in bench["sweep"]:
            log(f"phase 8 ResNet18 {where}: offered {r['offered_rps']:g} "
                f"req/s -> sustained {r['sustained_rps']} req/s, p50 "
                f"{r['latency_ms']['p50']} ms, p95 "
                f"{r['latency_ms']['p95']} ms, p99 "
                f"{r['latency_ms']['p99']} ms, dropped {r['dropped']}, shed "
                f"{r['shed']}, achieved {r['achieved_gflops_per_s']} "
                f"GFLOP/s; spans p50/p99 {r['spans']} ({smi})")
        log(f"phase 8 ResNet18 {where}: retraces "
            f"{bench['retraces_after_warmup']}, warmup {bench['warmup_s']} "
            "s")
    first = resnet["bench_cli"]["first_infer_ms"]
    ms = [t for _, t in first]
    log(f"phase 8 ResNet18 serve bench (a fresh process): infer_ms of its "
        f"first {len(first)} batches: max {max(ms)} ms, median "
        f"{median(ms)} ms; the first of each bucket "
        f"{dict(reversed(first))} ({smi})")
    g = resnet["bench_gc"]
    log(f"phase 8 ResNet18 sweep in this process: Python's garbage "
        f"collections {g['collections']} ({g['generation_2']} of "
        f"generation 2), longest {g['max_ms']:.3f} ms, "
        f"{g['total_ms']:.3f} ms in all")
    bert = bert_serving(kernels, reference, F, seed, root)
    log(f"phase 8 BertBase artifact (step {bert['step']}, "
        f"{bert['params']} params, "
        f"{bert['bytes']} bytes, exported in {bert['export_s']:.3f} s): "
        f"engine warmed ({bert['shapes']} shapes: buckets 1-8 x lengths "
        f"1-512) in {bert['warmup_s']:.3f} s; LayerNorm (in, out) dtypes "
        f"{bert['ln_dtypes']}; launches over {bert['batches']} batches "
        f"(4 engine batches, 1 HTTP request) {bert['launches']} (= "
        f"{bert['batches']} x {bert['per_batch']} layer_norm); an id of "
        f"{bert['vocab']}: {bert['refused']}; logits max "
        f"abs err (2 x 128): kernels vs plain LayerNorm, bf16 "
        f"{bert['logit_errs']['kernels_vs_plain']:.3e}; against the plain "
        f"model in f32: kernels {bert['logit_errs']['kernels_vs_f32']:.3e}, "
        f"plain bf16 {bert['logit_errs']['plain_vs_f32']:.3e} (bound "
        f"{bert['logit_bound']:.3e}); HTTP latency "
        f"{bert['http_latency_ms']} ms; "
        f"infer_ms median of {SERVE_TIMED}: " + "; ".join(
            f"{k}: {t['infer_ms']:.3f} ms, {t['flops'] / 1e9:.1f} GFLOP"
            for k, t in bert["times"].items()) + f" ({smi})")
    for shape, p in bert["profile"].items():
        log(f"phase 8 BertBase {shape} profile: wall {p['wall_ms']:.3f} "
            f"ms, device {p['device_ms']:.3f} ms a batch, busy "
            f"{p['device_busy_share']:.4f}; top " + "; ".join(
                f"{t['name'][:60]} {t['device_ms']:.3f} ms"
                for t in p["top"][:5]) + f" ({smi})")
    for e in bert["ln"]:
        log(f"phase 8 kernel layer_norm at a serving shape ({e['shape']}): "
            f"{ln_row(e)}; max abs err vs plain {e['max_abs_err']:.3e} "
            f"({smi})")
    return {"resnet": resnet, "bert": bert}


def first_batches(stream, n=FIRST_BATCHES):
    """``(bucket, infer_ms)`` of the first ``n`` batches in a serving
    stream. The
    scheduler thread writes a batch's records one after another, one per
    served request, so a batch is ``batch`` records long."""
    steps = [r for r in read_stream(stream) if r.get("kind") == "step"]
    out, i = [], 0
    while i < len(steps) and len(out) < n:
        out.append((steps[i]["bucket"], steps[i]["infer_ms"]))
        i += steps[i]["batch"]
    return out


# -- phases 9-13: faults, the flight recorder, the profiler, TF32, elastic --

#: phase 9's fault plan for ResNet-18 (1-indexed steps, checkpoints at
#: every even step): a NaN batch, a failed first publish, a torn periodic
#: checkpoint, a 1 s host delay, a torn emergency checkpoint and the crash
#: that writes it. The resume's newest-first scan meets step 19's torn
#: file (the emergency checkpoint of the crash), quarantines it and
#: restores step 18; step 6's stays convicted by its manifest but unread
FAULT_SPEC = ("nan_grad@3,flaky_io@4,torn_ckpt@6,delay@14:1.0s,"
              "torn_ckpt@19,crash@20")
#: the fault plan's entries as (step, fault), and the resumed run's end
FAULT_FIRED = [(3, "nan_grad"), (4, "flaky_io"), (6, "torn_ckpt"),
               (14, "delay"), (19, "torn_ckpt"), (20, "crash")]
FAULT_STEPS = 26
#: the resumed run's losses (steps 19-26) against an uninterrupted run
#: whose data stream restarts where the resume restarts it (the image
#: loaders begin their epoch again on resume, as the JAX package's do),
#: absolute: the same state, batches and sync seeds on a card with
#: cuDNN's deterministic algorithms, so anything past reduction-order
#: noise is a resume fault (phase 7's BERT_RESUME_TOL)
FAULT_RESUME_TOL = 1e-5
#: BertBase steps of the --profile runs: step 1, the window (2 and 3), 4
PROFILE_STEPS = 4
PROFILE_WINDOW = 2
#: device ms per step from the exported trace (utils/profiling.py) against
#: the same profile's key_averages (device_rows): relative
PROFILE_AGREE = 0.02
#: BertBase bf16 steps with the flags off, then with the flight recorder
#: armed and idle
ARMED_STEPS = 8
#: phase 11's serve run fault plan and its sequential requests
SERVE_FAULTS = "slow_infer@1:0.2s:x8,conn_reset@12,http_503@15:x3"
SERVE_FAULT_REQUESTS = 20
#: phases 12 and 13: ResNet-20 f32 on a synthetic CIFAR-10 of 256 images,
#: the host layout (the same numpy draws on the card and the CPU)
SMALL_IMAGE_FLAGS = ("--network", "ResNet20", "--dataset", "Cifar10",
                     "--synthetic-size", "256", "--batch-size", "64",
                     "--test-batch-size", "128", "--data-layout", "host")
#: the f32 image path on the card against --device cpu, with TF32 at
#: PyTorch's defaults in the card's process: relative
TF32_RTOL = 1e-4


def step_records(stream):
    return {r["step"]: r for r in stream if r.get("kind") == "step"}


def fault_phase(kernels, seed, root):
    """Phase 9: ResNet-18 (phase 5's configuration, host layout) under
    FAULT_SPEC with --skip-nonfinite --supervise --flightrec default
    --heartbeat-grace 30 --eval-freq 2 until its crash; --resume to step
    26; an uninterrupted run of the same faults but the crash."""
    import dataclasses
    import math

    import torch

    from pytorch_distributed_nn_tpu_torch.data.datasets import load_dataset
    from pytorch_distributed_nn_tpu_torch.data.loader import DataLoader
    from pytorch_distributed_nn_tpu_torch.observability import flightrec
    from pytorch_distributed_nn_tpu_torch.resilience.faults import (
        InjectedCrash,
    )
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils import profiling

    d = os.path.join(root, "faults")
    base = dataclasses.replace(resnet_config("int8", FAULT_STEPS, seed),
                               data_layout="host", skip_nonfinite=True)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        trainer = Trainer(dataclasses.replace(
            base, train_dir=d, eval_freq=2, faults=FAULT_SPEC,
            supervise=True, flightrec="default", heartbeat_grace=30.0))
        snaps, inner = {}, trainer.step

        def step(batch):  # the state after steps 2 and 3 (NaN batch)
            m = inner(batch)
            if trainer.state.step in (2, 3):
                snaps[trainer.state.step] = {
                    k: v.detach().clone()
                    for k, v in trainer.model.state_dict().items()}
            return m

        trainer.step = step
        kernels.reset_launch_counts()
        crashed = None
        try:
            trainer.train()
        except InjectedCrash as e:
            crashed = str(e)
        finally:
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            trainer.close()
        if crashed != "fault: crash@20":
            fail(f"phase 9: the faulted run ended with {crashed!r}")
        expect_launches(kernels, launches, {"quantize_int8_scaled": 1}, 19,
                        "phase 9 faulted ResNet18 run (steps 1-19)")
        stream = read_stream(os.path.join(d, "telemetry.jsonl"))
        events = [r for r in stream if r.get("kind") == "event"]
        fired = sorted((r["step"], r["fault"]) for r in events
                       if r["type"] == "fault_injected")
        if fired != FAULT_FIRED:
            fail(f"phase 9 fault_injected events {fired}, want {FAULT_FIRED}")
        skips = [r["step"] for r in events if r["type"] == "nonfinite_skip"]
        retries = [r.get("label", "") for r in events if r["type"] == "retry"]
        if skips != [3]:
            fail(f"phase 9 nonfinite_skip at steps {skips}, want [3]")
        if len(retries) != 1 or "model_step_4" not in retries[0]:
            fail(f"phase 9 retry events {retries}, want one for step 4")
        diff = [k for k in snaps[2] if not torch.equal(snaps[2][k],
                                                       snaps[3][k])]
        if diff:
            fail(f"phase 9 the skipped step 3 changed {diff[:5]}")
        incidents = flightrec.list_incidents(d)
        regress = [i for i in incidents if i["name"] == "14-step_regression"]
        if len(regress) != 1 or not regress[0]["has_trace"] \
                or not regress[0]["has_report"]:
            fail(f"phase 9 incident bundles {incidents}")
        bundle = regress[0]["path"]
        with open(os.path.join(bundle, "incident.json")) as f:
            meta = json.load(f)
        lo, hi = meta["capture_from_step"], meta["capture_until_step"]
        trace = os.path.join(bundle, "trace")
        summary = profiling.summarize_trace(trace)
        quant = sum(r.count for rows in summary.values() for r in rows
                    if r.name == "quant_group_kernel")
        if quant != hi - lo:
            fail(f"phase 9 the bundle's trace holds {quant} "
                 f"quant_group_kernel launches over steps {lo + 1}..{hi}, "
                 f"not one a step: {summary}")
        records = step_records(stream)
        window = [records[s]["step_ms"] for s in range(lo + 1, hi + 1)]
        # outside: the steps before the delay; the step after the window
        # runs beside the report thread's read of the trace
        outside = [records[s]["step_ms"] for s in range(2, 14)]
        after_window = records[hi + 1]["step_ms"]
        verified = {s: ckpt.verify_checkpoint(ckpt.checkpoint_path(d, s))
                    for s in ckpt.all_steps(d)}
        if verified.get(6, (True,))[0] or not verified[18][0]:
            fail(f"phase 9 checkpoints before the resume: {verified}")

        trainer = Trainer(dataclasses.replace(
            base, train_dir=d, eval_freq=2, resume=True, supervise=True))
        start = trainer.start_step
        kernels.reset_launch_counts()
        try:
            resumed = trainer.train()
        finally:
            torch.cuda.synchronize()
            resume_launches = kernels.launch_counts()
            trainer.close()
        quarantined = sorted(os.listdir(os.path.join(d, ckpt.QUARANTINE_DIR)))
        if start != 18 or quarantined != ["model_step_19",
                                          "model_step_19.meta.json"]:
            fail(f"phase 9 resume: start step {start}, quarantined "
                 f"{quarantined}")
        expect_launches(kernels, resume_launches, {"quantize_int8_scaled": 1},
                        FAULT_STEPS - 18, "phase 9 resumed run")

        ref = Trainer(dataclasses.replace(
            base, faults=FAULT_SPEC.replace(",crash@20", ""), max_steps=18,
            train_dir=os.path.join(root, "faults_ref")))
        kernels.reset_launch_counts()
        try:
            before = ref.train()
            # where the resume restarts the image loader
            c = ref.config
            ref.train_loader.close()
            ref.train_loader = DataLoader(
                load_dataset(c.dataset, train=True, data_dir=c.data_dir,
                             synthetic_size=c.synthetic_size),
                c.batch_size, shuffle=True, seed=c.seed, device=ref.device)
            ref.start_step = ref.state.step
            c.max_steps = FAULT_STEPS
            after = ref.train()
        finally:
            torch.cuda.synchronize()
            ref_launches = kernels.launch_counts()
            ref.close()
    finally:
        torch.backends.cudnn.deterministic = saved
    expect_launches(kernels, ref_launches, {"quantize_int8_scaled": 1},
                    FAULT_STEPS, "phase 9 uninterrupted run")
    got = [r["loss"] for r in resumed]
    want = [r["loss"] for r in after]
    if [r["step"] for r in resumed] != list(range(19, FAULT_STEPS + 1)) \
            or not all(map(math.isfinite, got)):
        fail(f"phase 9 resumed steps {[r['step'] for r in resumed]}: {got}")
    err = max(abs(a - b) for a, b in zip(got, want))
    pre = [(records[r["step"]]["loss"], r["loss"]) for r in before]
    pre_err = max(abs(a - b) for a, b in pre
                  if math.isfinite(a) or math.isfinite(b))
    if not err <= FAULT_RESUME_TOL or not pre_err <= FAULT_RESUME_TOL:
        fail(f"phase 9 resumed losses {got} against the uninterrupted "
             f"{want}: max abs diff {err}; steps 1-18 {pre_err} (tol "
             f"{FAULT_RESUME_TOL})")
    return {"fired": fired, "bundles": [i["name"] for i in incidents],
            "capture": [lo + 1, hi], "quant_in_trace": quant,
            "window_ms": window, "outside_ms": outside,
            "after_ms": after_window,
            "top": [(r.name, r.count, r.total_ms)
                    for rows in summary.values() for r in rows[:12]],
            "overlap": profiling.collective_overlap_report(trace),
            "families": profiling.family_summary(summary),
            "resume_err": err, "pre_crash_err": pre_err,
            "losses": got, "launches": {
                k: launches[k] + resume_launches[k] + ref_launches[k]
                for k in launches}}


def profile_phase(kernels, seed, root):
    """Phase 10: BertBase f32 (--attn-impl pallas) and bf16 (--fused-ln)
    with --profile 2; the summary's kernel counts against the wrappers'
    counters and its device time against device_rows of the same
    profile; then bf16 with the flight recorder armed and idle."""
    import torch

    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils import profiling

    #: a wrapper's kernels in a trace (either LayerNorm kernel counts)
    kernels_of = {
        "float32": {"flash_attention_fwd": ("flash_fwd_3xtf32_kernel",),
                    "flash_attention_dq": ("flash_dq_3xtf32_kernel",),
                    "flash_attention_dkv": ("flash_dkv_3xtf32_kernel",)},
        "bfloat16": {"flash_attention_fwd": ("flash_fwd_tc_kernel",),
                     "flash_attention_dq": ("flash_dq_tc_kernel",),
                     "flash_attention_dkv": ("flash_dkv_tc_kernel",)}}
    for names in kernels_of.values():
        names.update({"layer_norm": ("ln_fwd_vec_kernel", "ln_fwd_kernel"),
                      "layer_norm_bwd": ("ln_bwd_vec_kernel",
                                         "ln_bwd_kernel"),
                      "layer_norm_bwd_sum": ("ln_bwd_sum_kernel",)})
    out, total = {}, {k: 0 for k in kernels.KERNELS}
    for dtype, flags in (("float32", F32_FLAGS), ("bfloat16", {})):
        d = os.path.join(root, f"profile_{dtype}")
        trainer = Trainer(train_config(
            "BertBase", PROFILE_STEPS, seed=seed, train_dir=d,
            profile_steps=PROFILE_WINDOW, **flags))
        L = trainer.model.config.num_layers
        per = {"flash_attention_fwd": L, "flash_attention_dq": L,
               "flash_attention_dkv": L, "layer_norm": 2 * L + 2,
               "layer_norm_bwd": 2 * L + 2}
        kernels.reset_launch_counts()
        try:
            history = trainer.train()
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            # the session's lead-in launches are not the steps'
            own = [r for r in device_rows(trainer.last_profile)
                   if "spin_kernel" not in r["name"]]
        finally:
            trainer.close()
        expect_launches(kernels, launches, per, PROFILE_STEPS,
                        f"phase 10 BertBase {dtype} --profile run")
        for k in total:
            total[k] += launches[k]
        trace = os.path.join(d, "profile")
        summary = profiling.summarize_trace(trace)
        rows = {}
        for rs in summary.values():
            for r in rs:
                rows[r.name] = rows.get(r.name, 0) + r.count
        counts = {w: sum(rows.get(n, 0) for n in names)
                  for w, names in kernels_of[dtype].items()}
        want = {w: per[w.replace("_sum", "")] * PROFILE_WINDOW
                for w in counts}
        raw = {}  # the trace's own kernel names, as it kept them
        for ev in profiling.device_events(profiling.load_trace(
                profiling.find_trace(trace))):
            raw[ev.name] = raw.get(ev.name, 0) + 1
        mangled = sum(n for name, n in raw.items() if name.startswith("_Z"))
        if counts != want:
            ours = {k: n for k, n in raw.items()
                    if "flash" in k or "ln_" in k}
            fail(f"phase 10 BertBase {dtype}: kernel launches in the trace "
                 f"{counts}, want {want} ({PROFILE_WINDOW} steps of the "
                 f"wrappers' counts {launches}); the trace's names {ours}")
        dev = profiling.device_step_time_ms(trace, PROFILE_WINDOW)
        own_ms = sum(r["device_ms"] for r in own) / PROFILE_WINDOW
        agree = abs(dev - own_ms) / own_ms
        if not agree <= PROFILE_AGREE:
            fail(f"phase 10 BertBase {dtype}: device ms/step {dev} from the "
                 f"trace against {own_ms} from key_averages ({agree:.4f} > "
                 f"{PROFILE_AGREE})")
        ms = [r["step_ms"] for r in history]
        out[dtype] = {"launch_counts": counts, "mangled": mangled,
                      "device_ms": dev,
                      "device_rows_ms": own_ms, "agree": agree,
                      "profiled_ms": ms[1:1 + PROFILE_WINDOW],
                      "unprofiled_ms": ms[1 + PROFILE_WINDOW:],
                      "families": profiling.family_summary(summary)}
        del trainer
        torch.cuda.empty_cache()
    # the flags off, then the flight recorder armed (and idle), back to back
    for name, flags in (("off", {}), ("armed", {"flightrec": "default"})):
        d = os.path.join(root, name)
        trainer = Trainer(train_config("BertBase", ARMED_STEPS, seed=seed,
                                       train_dir=d, **flags))
        kernels.reset_launch_counts()
        try:
            history = trainer.train()
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        finally:
            trainer.close()
        for k in total:
            total[k] += launches[k]
        ms = sorted(r["step_ms"] for r in history[1:])
        bundles = os.path.join(d, "incidents")
        out[name] = {"step_ms": ms[len(ms) // 2],
                     "bundles": len(os.listdir(bundles))
                     if os.path.isdir(bundles) else 0}
        del trainer
        torch.cuda.empty_cache()
    out["launches"] = total
    return out


def serve_fault_phase(repo, root):
    """Phase 11: serve run --faults SERVE_FAULTS on phase 8's ResNet-18
    artifact, one client sending SERVE_FAULT_REQUESTS requests in turn."""
    import http.client

    server = start_server(repo, os.path.join(root, "resnet_artifact_none"),
                          root, "resnet_faults", "--faults", SERVE_FAULTS,
                          "--buckets", "1,2,4")
    try:
        port = int(server_url(server).rsplit(":", 1)[1])
        body = json.dumps({"inputs": [[[[0.0] * 3] * 32] * 32]})
        results = []
        for _ in range(SERVE_FAULT_REQUESTS):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                conn.request("POST", "/v1/infer", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                results.append((resp.status, json.loads(resp.read())))
            except (http.client.RemoteDisconnected, ConnectionError) as e:
                results.append(("reset", repr(e)))
            finally:
                conn.close()
    finally:
        if server["proc"].poll() is None:
            drain_server(server)
    statuses = [s for s, _ in results]
    want = [200] * SERVE_FAULT_REQUESTS
    want[11] = "reset"
    want[14:17] = [503] * 3
    infer_ms = [doc["infer_ms"][0] if s == 200 else None
                for s, doc in results]
    slow = [ms for ms in infer_ms[:8]]
    if statuses != want or not all(ms >= 200.0 for ms in slow) or any(
            ms >= 200.0 for ms in infer_ms[8:] if ms is not None):
        fail(f"phase 11 serve run --faults: statuses {statuses}, want "
             f"{want}; infer_ms {infer_ms}")
    stream = read_stream(os.path.join(root, "resnet_faults", "serving.jsonl"))
    fired = [(r["fault"], r["request"]) for r in stream
             if r.get("type") == "fault_injected"]
    if fired != [("slow_infer", 1), ("conn_reset", 12), ("http_503", 15)]:
        fail(f"phase 11 fault_injected events {fired}")
    return {"statuses": statuses, "infer_ms": infer_ms, "fired": fired}


def run_cli(repo, args, timeout=600.0):
    """Start ``python -m pytorch_distributed_nn_tpu_torch ARGS``."""
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", *args],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_cli(proc, what, timeout=600.0):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    if proc.returncode != 0:
        fail(f"{what} exited {proc.returncode}: {err[-4000:]}")
    return out


def tf32_phase(repo, root):
    """Phase 12: ``train`` (2 steps, then its eval) and the ``evaluator``
    of ResNet-20 at the CLI's default --dtype float32, on the card in
    subprocesses (TF32 at PyTorch's defaults there) and with --device cpu;
    losses and eval metrics within TF32_RTOL."""
    runs = {}
    procs = {}
    for dev in ("card", "cpu"):
        d = os.path.join(root, f"tf32_{dev}")
        procs[dev] = run_cli(repo, [
            "train", *SMALL_IMAGE_FLAGS, "--max-steps", "2", "--eval-freq",
            "2", "--train-dir", d, "--metrics-path",
            os.path.join(d, "metrics.jsonl")]
            + (["--device", "cpu"] if dev == "cpu" else []))
    for dev, proc in procs.items():
        finish_cli(proc, f"phase 12 train ({dev})")
    for dev in ("card", "cpu"):
        d = os.path.join(root, f"tf32_{dev}")
        procs[dev] = run_cli(repo, [
            "evaluator", "--model-dir", d, *SMALL_IMAGE_FLAGS[:6],
            "--test-batch-size", "128", "--data-layout", "host",
            "--eval-freq", "2", "--max-evals", "1", "--timeout", "300"]
            + (["--device", "cpu"] if dev == "cpu" else []))
    for dev, proc in procs.items():
        out = finish_cli(proc, f"phase 12 evaluator ({dev})")
        stream = read_stream(os.path.join(root, f"tf32_{dev}",
                                          "metrics.jsonl"))
        runs[dev] = {
            "losses": [r["loss"] for r in stream if r.get("kind") == "step"],
            "eval": [r["loss"] for r in stream
                     if r.get("type") == "eval_result"],
            "evaluator": json.loads(out.strip().splitlines()[-1])[
                "evaluated"]["2"]}
    card, cpu = runs["card"], runs["cpu"]
    pairs = (list(zip(card["losses"], cpu["losses"]))
             + list(zip(card["eval"], cpu["eval"]))
             + [(card["evaluator"][k], cpu["evaluator"][k])
                for k in ("loss", "acc1", "acc5")])
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
    if len(card["losses"]) != 2 or len(card["eval"]) != 1 \
            or not rel <= TF32_RTOL:
        fail(f"phase 12 the f32 image path on the card against the CPU: "
             f"{runs} (relative {rel}, tol {TF32_RTOL})")
    return {"card": card, "cpu": cpu, "max_rel": rel}


def elastic_phase(repo, root):
    """Phase 13: 2 gloo ranks on the CPU (torchrun) checkpoint ResNet-20
    at step 2; --resume on the card at world size 1 adapts (dp 2 -> 1,
    the global batch kept) and continues; with --strict-geometry it
    raises, naming both geometries."""
    import math
    import socket

    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    d = os.path.join(root, "elastic")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port", str(port), "-m",
         "pytorch_distributed_nn_tpu_torch", "train", "--device", "cpu",
         "--num-workers", "2", *SMALL_IMAGE_FLAGS, "--max-steps", "2",
         "--eval-freq", "2", "--train-dir", d],
        cwd=repo, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"phase 13 torchrun of 2 gloo ranks exited {proc.returncode}: "
             f"{proc.stderr[-4000:]}")
    before = step_records(read_stream(os.path.join(d, "telemetry.jsonl")))
    cfg = dict(network="ResNet20", dataset="Cifar10", synthetic_size=256,
               batch_size=64, test_batch_size=128, data_layout="host",
               max_steps=4, eval_freq=2, train_dir=d, num_workers=2,
               resume=True)
    try:
        Trainer(TrainConfig(**cfg, strict_geometry=True))
        fail("phase 13 --strict-geometry resumed across dp 2 -> 1")
    except ValueError as e:
        strict = str(e)
    if "data=2" not in strict or "data=1" not in strict:
        fail(f"phase 13 --strict-geometry error names {strict!r}")
    trainer = Trainer(TrainConfig(**cfg))
    try:
        start, history = trainer.start_step, trainer.train()
    finally:
        trainer.close()
    stream = read_stream(os.path.join(d, "telemetry.jsonl"))
    (ev,) = [r for r in stream if r.get("type") == "elastic_resume"]
    losses = [r["loss"] for r in history]
    last = before[2]["loss"]
    if start != 2 or [r["step"] for r in history] != [3, 4] \
            or ev["old"]["mesh"]["data"] != 2 or ev["num_workers"] != 1 \
            or ev["batch_size"] != 64 or ev["per_device_batch"] != 64 \
            or not all(map(math.isfinite, losses)) \
            or not abs(losses[0] - last) <= 0.5 * last:
        fail(f"phase 13 elastic resume: start {start}, event {ev}, losses "
             f"{losses} after {last}")
    return {"event": ev, "strict": strict, "losses": losses,
            "before": [before[s]["loss"] for s in sorted(before)]}


# -- --step-times: this checkout's training steps, nothing checked ---------

STEP_TIMES_STEPS = 40
STEP_TIMES = ("BertBase", "BertBase-f32", "ResNet18", "ResNet18-saves")


def step_times(which, seed):
    """Step ms of the training paths of the checkout beside this script,
    as phases 5 and 7 train them: BertBase (bf16, and f32 with
    :data:`F32_FLAGS`) and ResNet18 over
    STEP_TIMES_STEPS steps (the median of steps 3 on); ResNet18-saves 20
    steps at --eval-freq 10 --keep-last 1, async (``save_windows``; its
    ``checkpoint_write`` events, the writer's pack and compress calls, the
    end of each step after the tenth and Python's garbage collections of
    generation 2 or of 1 ms or more, each in seconds from the tenth
    step's record). To
    compare two commits, copy this script into a checkout of each and
    run them in turn in one call (parent, change, change, parent): the
    host-bound steps spread between calls."""
    import dataclasses

    import torch

    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    from pytorch_distributed_nn_tpu_torch.ops import host_codec
    from pytorch_distributed_nn_tpu_torch.utils import flax_msgpack

    collections = []  # (generation, wall-clock start, ms) of each collection
    phases = []  # (writer phase, wall-clock start, ms) of each call

    def on_gc(phase, info):
        if phase == "start":
            on_gc.t0 = time.time()
        else:
            collections.append((info["generation"], on_gc.t0,
                                (time.time() - on_gc.t0) * 1e3))

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.time()
            try:
                return fn(*args, **kw)
            finally:
                phases.append((name, t0, (time.time() - t0) * 1e3))
        return call

    out = {}
    for name in which:
        with tempfile.TemporaryDirectory(prefix="chip_steps_") as d:
            if name == "BertBase":
                cfg = train_config("BertBase", STEP_TIMES_STEPS, seed=seed)
            elif name == "BertBase-f32":
                cfg = train_config("BertBase", STEP_TIMES_STEPS, seed=seed,
                                   **F32_FLAGS)
            elif name == "ResNet18":
                cfg = resnet_config("int8", STEP_TIMES_STEPS, seed)
            else:
                cfg = dataclasses.replace(resnet_config("int8", 20, seed),
                                          eval_freq=10, keep_last=1,
                                          train_dir=d)
            trainer = Trainer(cfg)
            collections.clear()
            phases.clear()
            gc.callbacks.append(on_gc)
            # the writer's two host phases, timed where the checkpoint
            # module calls them
            pack, compress = flax_msgpack.pack_array, host_codec.compress_parts
            flax_msgpack.pack_array = timed("pack", pack)
            host_codec.compress_parts = timed("compress", compress)
            try:
                history = trainer.train()
            finally:
                gc.callbacks.remove(on_gc)
                flax_msgpack.pack_array = pack
                host_codec.compress_parts = compress
                trainer.close()
            del trainer
            torch.cuda.empty_cache()
            if name == "ResNet18-saves":
                stream = read_stream(os.path.join(d, "telemetry.jsonl"))
                # wall-clock times from the step-10 record's on
                t10 = next(r["time"] for r in stream
                           if r.get("kind") == "step" and r["step"] == 10)
                writes = [{"time_s": e["time"] - t10,
                           **{k: e[k] for k in ("step", "fetch_ms",
                                                "write_ms", "stall_ms")}}
                          for e in stream
                          if e.get("type") == "checkpoint_write"]
                writer = [{"phase": n, "start_s": t - t10, "ms": ms}
                          for n, t, ms in phases]
                step_end_s = [r["time"] - t10 for r in stream
                              if r.get("kind") == "step"
                              and r.get("step", 0) > 10]
                gcs = [{"generation": g, "start_s": t - t10, "ms": ms}
                       for g, t, ms in collections
                       if t >= t10 and (g == 2 or ms >= 1.0)]
        if name == "ResNet18-saves":
            before, after = save_windows(history)
            out[name] = {"steps_2_10_ms": before, "steps_11_20_ms": after,
                         "steps_2_10": window_stats(before),
                         "steps_11_20": window_stats(after),
                         "writes": writes, "writer_phases": writer,
                         "step_end_s": step_end_s, "collections": gcs}
        else:
            ms = sorted(r["step_ms"] for r in history[2:])
            out[name] = {"step_ms": ms, "median_ms": ms[len(ms) // 2]}
    return out


# -- --serve-bench: this checkout's serve bench, nothing checked -----------


def serve_bench_runs(repo, seed, runs):
    """``serve bench`` of the checkout beside this script, ``runs`` times,
    each in a fresh process as phase 8 runs it (500, 1000 and 2000 req/s
    for 2 s each), on a random-init ResNet-18 artifact exported through
    that checkout: each run's sustained req/s and p99 by offered rate,
    warmup seconds, and the bucket and ``infer_ms`` of its first
    :data:`FIRST_BATCHES` batches. To compare two commits, copy this
    script into a checkout of each and run them in turn in one call
    (parent, change, change, parent)."""
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

    out = []
    with tempfile.TemporaryDirectory(prefix="chip_bench_") as d:
        model = build_model("ResNet18", 10).init_weights(
            torch.Generator().manual_seed(seed))
        state = create_train_state(
            model, lambda p: build_optimizer("sgd", p, 0.1), "cpu",
            seed=seed)
        ckpt.save_checkpoint(os.path.join(d, "td"), state, step=1)
        art = os.path.join(d, "art")
        export_artifact(os.path.join(d, "td"), art, network="ResNet18",
                        num_classes=10)
        for i in range(runs):
            bench = os.path.join(d, f"bench{i}")
            proc = subprocess.run(
                [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch",
                 "serve", "bench", "--artifact", art, "--offered",
                 "500,1000,2000", "--duration", "2", "--out", bench,
                 "--json"],
                cwd=repo, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                fail(f"serve bench exited {proc.returncode}: "
                     f"{proc.stderr[-4000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            out.append({
                "warmup_s": rec["warmup_s"],
                "retraces": rec["retraces_after_warmup"],
                "sweep": [{"offered_rps": r["offered_rps"],
                           "sustained_rps": r["sustained_rps"],
                           "p99_ms": r["latency_ms"]["p99"]}
                          for r in rec["sweep"]],
                "first_infer_ms": first_batches(
                    os.path.join(bench, "serving.jsonl"))})
    return out


def post(url, doc, timeout=120.0):
    """(status, JSON body, headers) of a POST; an HTTP error status is a
    result, not an exception."""
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here, with a "
                         "per-shape kernel sweep and a profile of decode "
                         "steps")
    ap.add_argument("--step-times", default=None,
                    help="only time the training steps of a comma list "
                         f"of {', '.join(STEP_TIMES)} and print them as "
                         "one JSON line (nothing checked)")
    ap.add_argument("--ln-times", action="store_true",
                    help="only time the LayerNorm forward at BertBase's and "
                         "GptMini's shapes and print the rows as one JSON "
                         "line (nothing checked)")
    ap.add_argument("--flash-times", action="store_true",
                    help="only time the flash kernels at BertBase's f32 and "
                         "bf16 training shapes and print the rows as one "
                         "JSON line (nothing checked)")
    ap.add_argument("--serve-bench", type=int, default=0, metavar="RUNS",
                    help="only run serve bench RUNS times on a random-init "
                         "ResNet-18 artifact and print the runs as one JSON "
                         "line (nothing checked)")
    args = ap.parse_args()
    which = args.step_times.split(",") if args.step_times else []
    if not set(which) <= set(STEP_TIMES):
        ap.error(f"--step-times takes a comma list of {STEP_TIMES}")

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
    if which:
        print(json.dumps(step_times(which, args.seed)), flush=True)
        return 0
    if args.serve_bench:
        print(json.dumps(serve_bench_runs(repo, args.seed, args.serve_bench)),
              flush=True)
        return 0
    if args.ln_times:
        print(json.dumps(ln_times(kernels, reference, F, args.seed)),
              flush=True)
        return 0
    if args.flash_times:
        print(json.dumps(flash_times(kernels, reference, F, args.seed)),
              flush=True)
        return 0

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {sorted(kernels.KERNELS)} built and loaded in "
        f"{build_s:.3f} s")
    report["phases"]["build_s"] = build_s
    from pytorch_distributed_nn_tpu_torch.utils.native_build import (
        ptxas_usage,
    )

    usage = ptxas_usage("flash_attention")
    log("phase 2 ptxas -v, flash_attention.cu (sm_90a): " + "; ".join(
        f"{k} {u.get('registers')} registers, {u.get('stack')} B stack, "
        f"{u.get('spill_stores')}/{u.get('spill_loads')} B spill "
        "stores/loads" for k, u in sorted(usage.items())))
    for tag, what in (("_tc_kernel<", "bf16"), ("_3xtf32_kernel<", "f32")):
        tc = {k: u for k, u in usage.items() if tag in k}
        if len(tc) != 9 or any(u.get("spill_stores", 1)
                               or u.get("spill_loads", 1)
                               for u in tc.values()):
            fail(f"the {what} tensor-core flash kernels (3 x D in "
                 f"{{16, 32, 64}}) must build without spills: {tc}")
    redesigned = {k: u for lib in ("layer_norm", "int8_quant",
                                   "decode_attention")
                  for k, u in ptxas_usage(lib).items()
                  if k.startswith(("ln_bwd_vec_kernel<", "ln_fwd_vec_kernel<",
                                   "quant_group_kernel", "quant_own_kernel",
                                   "decode_attn_kernel<"))}
    log("phase 2 ptxas -v, layer_norm.cu, int8_quant.cu and "
        "decode_attention.cu (sm_90a): "
        + "; ".join(f"{k} {u.get('registers')} registers, {u.get('stack')} B "
                    f"stack, {u.get('spill_stores')}/{u.get('spill_loads')} B "
                    "spill stores/loads" for k, u in sorted(redesigned.items())))
    #: the vectorised LayerNorm backward and forward: 4 type pairs each
    #: at every width
    n_vec = 2 * 4 * len(kernels.LN_WIDTHS)
    #: decode: 2 dtypes x (3 head dims + the general one) x 2 slot counts
    n_decode = 2 * (len(kernels.DECODE_HEAD_DIMS) + 1) * 2
    if len(redesigned) != n_vec + 2 + n_decode or any(
            u.get("spill_stores", 1) or u.get("spill_loads", 1)
            for u in redesigned.values()):
        fail(f"the vectorised LayerNorm backward and forward ({n_vec} "
             f"instantiations), "
             f"the grouped and the own-scale quantize and decode attention "
             f"({n_decode} instantiations) must build without spills: "
             f"{redesigned}")
    report["ptxas"] = {**usage, **redesigned}

    # -- 3. kernels vs plain versions at GptMini shapes -------------------
    gen = torch.Generator().manual_seed(args.seed)
    cfg = build_model("GptMini").config
    H, Dh, d_model = cfg.num_heads, cfg.d_model // cfg.num_heads, cfg.d_model
    checks = check_decode(kernels, reference, gen, H, Dh)
    errs = {"decode_attention": max(c[-1] for c in checks),
            "layer_norm": 0.0}
    for in_dt, out_dt in ((torch.float32, torch.float32),
                          (torch.bfloat16, torch.float32),
                          (torch.bfloat16, torch.bfloat16)):
        tol = LN_FWD_TOL[str(out_dt).split(".")[1]]
        for N, D, shift in LN_CHECK_SHAPES:
            x = (torch.randn((N, D), generator=gen) * 3 + 1).to("cuda", in_dt)
            if shift:
                x = misaligned(x)
            g = (1 + 0.1 * torch.randn((D,), generator=gen)).cuda()
            b = (0.1 * torch.randn((D,), generator=gen)).cuda()
            vec = kernels.layer_norm_fwd_vectorised(
                x, torch.empty(x.shape, dtype=out_dt, device="cuda"), g, b)
            what = (f"layer_norm ({N},{D}) {in_dt}->{out_dt} "
                    + ("vectorised" if vec else "general"))
            if vec != (D in kernels.LN_WIDTHS and not shift):
                fail(f"{what}: dispatch says vectorised={vec}")
            got = kernels.layer_norm(x, g, b, 1e-6, out_dt)
            again = kernels.layer_norm(x, g, b, 1e-6, out_dt)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"{what}: two launches differ")
            want = reference.layer_norm(x, g, b, 1e-6, out_dt)
            over, err = excess(got, want, *tol)
            checks.append(("layer_norm", f"{in_dt}->{out_dt}"
                           + (" misaligned" if shift else ""), N, D, err))
            if out_dt == torch.float32:
                errs["layer_norm"] = max(errs["layer_norm"], err)
            if not over <= 0:
                fail(f"{what}: max abs err {err} past tolerance {tol}")
    log(f"phase 3 kernels vs plain: {len(checks)} cases pass; max abs err "
        f"decode_attention {errs['decode_attention']:.3e} (tol f32 "
        f"{TOL['float32']}, bf16 {TOL['bfloat16']}; every decode case "
        f"launched twice, bit for bit equal: GptMini's buckets, "
        f"misaligned caches on the scalar branch, S = "
        f"{list(DECODE_LONG_S)} at H = 12, D = 64 on the split path, and "
        f"{DECODE_FILL[0]} x {DECODE_FILL[1]} heads), layer_norm "
        f"{errs['layer_norm']:.3e} with f32 out (tol {LN_FWD_TOL}; at "
        f"{[c[:2] for c in LN_CHECK_SHAPES]}, the vectorised kernel at "
        f"widths {list(kernels.LN_WIDTHS)} on aligned rows, else the general "
        f"one; every case launched twice, bit for bit equal)")
    train_cases, train_errs = check_training_kernels(kernels, reference, gen)
    atol_needed = train_errs.pop("bf16_bwd_atol_needed")
    log(f"phase 3 training kernels vs plain (TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}): {len(train_cases)} cases "
        f"pass, each flash kernel bit for bit the same over two launches; "
        f"max abs err " + ", ".join(
            f"{k} {v:.3e}" for k, v in train_errs.items())
        + f" (flash tol {FLASH_TOL}, bf16 dq and dk/dv {FLASH_BWD_TOL_BF16}: "
        f"at rtol {FLASH_BWD_TOL_BF16[1]} they need atol {atol_needed:.3e}; "
        f"LN bwd tol {LN_BWD_TOL})")
    report["bf16_bwd_atol_needed"] = atol_needed
    errs.update(train_errs)
    errs["layer_norm"] = max(errs["layer_norm"], train_errs["layer_norm_train"])
    resnet_leaf_sizes = [p.numel() for p in resnet_leaves(
        build_model("ResNet18"))]
    int8_cases, int8_errs, int8_stats = check_int8_kernels(
        kernels, reference, gen, resnet_leaf_sizes)
    log(f"phase 3 int8 kernels vs plain: {len(int8_cases)} cases bit for bit "
        f"equal (quantize_int8_scaled at n = {list(INT8_SIZES)}; grouped "
        f"over ResNet-18's {len(resnet_leaf_sizes)} kernel-sized leaves in "
        f"one launch, over {len(INT8_GROUP_CHUNKED)} leaves in two, with a "
        f"misaligned leaf, and an empty group in none; "
        f"quantize_int8 and dequantize_int8 at {list(INT8_SHAPES)}; "
        f"quantize_int8 around the "
        f"{int8_stats['quantize_int8_register_elements']} elements its grid "
        f"holds in registers, at n = 1 and all zero, aligned and not, "
        f"twice each); "
        f"largest leaf: mean error of q * scale - x {int8_stats['mean_err']:.3e}"
        f" (4 standard errors {4 * int8_stats['standard_error']:.3e}); "
        f"another seed changes {int8_stats['differ_other_seed']} of "
        f"{int8_stats['n']} elements")
    errs.update(int8_errs)
    report["checks"] = checks + train_cases + int8_cases
    report["int8_stats"] = int8_stats

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
    server = ServingServer(engine, None, port=0, generator=scheduler)
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
        steps_before = engine.decode_steps
        t_burst = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t_burst
        launches = kernels.launch_counts()
        decode_steps = engine.decode_steps - steps_before
    finally:
        scheduler.close()
        server.close()
    for name in ("decode_attention", "layer_norm"):
        if launches[name] < 1:
            fail(f"the serving path never launched kernel {name}: {launches}")
    # one decode launch per layer per decode step (4 for GptMini), and
    # none in the prefills
    if launches["decode_attention"] != cfg.num_layers * decode_steps:
        fail(f"the burst's {decode_steps} decode steps launched decode "
             f"attention {launches['decode_attention']} times, not "
             f"{cfg.num_layers} per step")
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
        f"launches {launches} ({decode_steps} decode steps x "
        f"{cfg.num_layers} decode launches); retraces {engine.retraces()}; "
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
    bert32 = train_path(kernels, "BertBase", args.seed, F32_TRAIN_STEPS,
                        must_learn=False, **F32_FLAGS)
    train32_profile = profile_train(bert32["trainer"]) if args.out else None
    del bert32["trainer"]
    torch.cuda.empty_cache()
    log(f"phase 5 train BertBase f32 (B=16, L=512, --dtype float32 "
        f"--attn-impl pallas --optimizer adam: the 3xTF32 flash kernels): "
        f"losses {[round(x, 4) for x in bert32['losses']]}; "
        f"launches per run of {F32_TRAIN_STEPS} steps {bert32['launches']} "
        f"(= {F32_TRAIN_STEPS} x {bert32['per_step']}); eval launches "
        f"{bert32['eval_launches']}; step {bert32['step_ms']:.3f} ms, "
        f"{bert32['tokens_per_s']:.1f} tokens/s")
    grad_checks = {}
    for dtype in ("float32", "bfloat16"):
        grad_errs, grad_where, floor, failures = grad_check(
            kernels, reference, args.seed, dtype)
        torch.cuda.empty_cache()
        tol = GRAD_TOL if dtype == "float32" else GRAD_TOL_BF16
        sizes = sorted(size for _, size in grad_errs.values())
        extra = ""
        if floor:
            worst = max(floor, key=lambda n: floor[n][0]
                        - GRAD_NOISE_FACTOR * floor[n][1])
            extra = (f"; against the f32 plain model: kernels worst "
                     f"{max(k for k, _ in floor.values()):.3e}, plain bf16 "
                     f"worst {max(p for _, p in floor.values()):.3e}; "
                     f"closest to the noise bound {worst}: kernels "
                     f"{floor[worst][0]:.3e}, plain {floor[worst][1]:.3e} "
                     f"(bound {GRAD_NOISE_FACTOR} x plain + "
                     f"{GRAD_TOL_BF16_ABS})")
        log(f"phase 5 gradient check BertBase {dtype} B=2 L=512: kernels vs "
            f"plain, {len(grad_errs)} parameters, worst relative error "
            f"{grad_errs[grad_where][0]:.3e} at {grad_where} (tol {tol}); "
            f"gradient sizes max|g| from {sizes[0]:.3e} to {sizes[-1]:.3e}"
            + extra)
        log(f"phase 5 gradient check {dtype} per parameter (relative error"
            + (", max|g|, kernels vs f32, plain vs f32" if floor else
               ", max|g|") + "): " + json.dumps(
                {n: [float(f"{x:.3e}") for x in
                     (r, g, *(floor[n] if floor else ()))]
                 for n, (r, g) in grad_errs.items()}))
        if failures:
            fail(f"gradient check {dtype}: {len(failures)} parameters past "
                 f"tolerance: {failures[:8]}")
        grad_checks[dtype] = {"worst_relative_err": grad_errs[grad_where][0],
                              "at": grad_where, "tolerance": tol,
                              "per_parameter": grad_errs,
                              "against_f32": floor}
    gpt = train_path(kernels, "GptMini", args.seed, 3, must_learn=False)
    log(f"phase 5 train GptMini (causal flash, B=16, L=128, bf16): losses "
        f"{[round(x, 4) for x in gpt['losses']]}; launches "
        f"{gpt['launches']}; eval launches {gpt['eval_launches']}")
    resnet = resnet_path(kernels, args.seed)
    log(f"phase 5 train ResNet18 (B={RESNET_B}, bf16, SGD lr {RESNET_LR} "
        f"momentum 0.9 decayed 10x every {RESNET_DECAY_STEPS} steps, int8 "
        f"sync, NCCL world of "
        f"{resnet['trainer'].n_workers}, data on the card, synthetic "
        f"CIFAR-10 of {RESNET_DATA} images): losses "
        f"{[round(x, 4) for x in resnet['losses']]}; eval loss "
        f"{resnet['eval_before']['loss']:.4f} -> {resnet['eval']['loss']:.4f}"
        f"; launches per run of {RESNET_STEPS} steps {resnet['launches']} (= "
        f"{RESNET_STEPS} x {resnet['per_step']}, each covering "
        f"{resnet['quantized_leaves']} leaves); eval launches "
        f"{resnet['eval_launches']}; step {resnet['step_ms']:.3f} ms, "
        f"{resnet['images_per_s']:.1f} images/s")
    n_leaves, n_big = resnet_sync_check(resnet["trainer"], reference)
    log(f"phase 5 int8 sync check ResNet18: {n_leaves} gradient leaves "
        f"({n_big} through one grouped quantize_int8_scaled launch) synced "
        f"with the kernel and with the plain grouped quantizer at the same "
        f"weights, batch and seed: "
        f"bit for bit equal")
    resnet_profile = profile_train(resnet["trainer"]) if args.out else None
    leaf_sizes = [p.numel() for p in resnet_leaves(resnet["trainer"].model)]
    resnet["trainer"].close()
    del resnet["trainer"]
    torch.cuda.empty_cache()
    path_launches = {name: serve_launches[name] + sum(
        run[key][name] for run in (bert, bert32, gpt, resnet)
        for key in ("launches", "eval_launches")) for name in kernels.KERNELS}
    report["training"] = {
        "bert": {k: v for k, v in bert.items()},
        "bert_f32": {**bert32, "profile": train32_profile},
        "gpt": {k: v for k, v in gpt.items() if k != "trainer"},
        "grad_check": grad_checks,
        "profile": train_profile,
        "resnet": {**resnet, "sync_check_leaves": n_leaves,
                   "profile": resnet_profile},
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
    decode_off_path = time_decode_off_path(kernels, reference, F, gen)
    report["decode_off_path"] = decode_off_path
    N = B
    x = torch.randn((N, d_model), generator=gen).cuda()
    g = torch.ones(d_model, device="cuda")
    b = torch.zeros(d_model, device="cuda")
    entries.append({
        "name": "layer_norm", "route": "cuda",
        "source": kernels.KERNELS["layer_norm"]["source"],
        "replaces": kernels.KERNELS["layer_norm"]["replaces"],
        "launches": path_launches["layer_norm"],
        "max_abs_err": errs["layer_norm"],
        **ln_fwd_times(kernels, reference, F, x, g, b),
        "shape": f"N={N} D={d_model} float32 -> float32",
    })
    ln_rows = ln_sweep(kernels, reference, F, d_model, gen)
    report["ln_sweep"] = ln_rows
    train_entries, train_ln = time_training_kernels(
        kernels, reference, F, gen, path_launches, errs)
    entries[1].update(train_ln)
    entries += train_entries
    full_ms = train_step_ms("BertBase", "full", 6, args.seed)
    full32_ms = train_step_ms("BertBase", "full", 6, args.seed, **F32_FLAGS)
    from pytorch_distributed_nn_tpu_torch.tools import mma_tf32

    mma_rate = mma_tf32.mma_tf32_rate()
    mma_sums = mma_tf32.mma_tf32_sums(seed=args.seed)
    report["mma_tf32"] = {"rate": mma_rate, "sums": mma_sums}
    int8_entries, int8_sweep = time_int8_kernels(
        kernels, reference, gen, leaf_sizes, path_launches, errs)
    entries += int8_entries
    report["int8_sweep"] = int8_sweep
    resnet_none_ms, resnet_none_profile = resnet_step_ms(
        "none", 8, args.seed, profile=bool(args.out))
    report["training"]["resnet_none_profile"] = resnet_none_profile
    if args.out:
        report["sweep"] = sweep(kernels, reference, F, H, Dh, d_model, gen)
        report["decode_profile"] = profile_decode(engine, kvs)
    for e in entries:
        lib = "n/a" if e["library_ms"] is None else f"{e['library_ms']:.6f} ms"
        extra = ""
        if "eager_ms" in e:
            extra += f"; eager back-to-back {e['eager_ms']:.6f} ms per call"
        if "library_eager_ms" in e:
            extra += f" (library {e['library_eager_ms']:.6f})"
        if "tflop_per_s" in e:
            extra += (f"; {e['gflop']:.3f} GFLOP counted, achieved "
                      f"{e['tflop_per_s']:.1f} TFLOP/s")
        if "f32_ms" in e:
            extra += (f"; f32 (3xTF32) {e['f32_ms']:.6f} ms, "
                      f"{e['f32_gflop']:.3f} f32 GFLOP, achieved "
                      f"{e['f32_tflop_per_s']:.1f} f32 TFLOP/s "
                      f"({3 * e['f32_tflop_per_s']:.1f} TF32), bound "
                      f"{e['f32_bound_ms']:.6f} ms ({e['f32_bound_by']}: "
                      f"three TF32 products at "
                      f"{PEAK_FLOPS['tf32'] / 1e12:.1f} TFLOP/s; counted "
                      f"once at the CUDA cores' f32 rate "
                      f"{e['f32_cuda_core_bound_ms']:.6f} ms), plain "
                      f"{e['f32_plain_ms']:.6f} ms, "
                      f"library (SDPA f32, "
                      + ("forward" if e["name"] == "flash_attention_fwd"
                         else "autograd backward: dq, dk, dv in one call")
                      + f") {e['f32_library_ms']:.6f} ms")
        if "general_ms" in e:
            extra += (f"; general kernel (x one element off a 16-byte "
                      f"boundary) {e['general_ms']:.6f} ms")
        if "sdpa_fwd_bwd_ms" in e:
            extra += (f"; library flash fwd+bwd {e['sdpa_fwd_bwd_ms']:.6f} "
                      f"ms; library backward (dq, dk, dv in one call) vs "
                      f"the kernels max abs diff "
                      f"{e['library_vs_kernels']:.3e}")
        if "train_ms" in e:
            extra += f"; at {e['train_shape']}: " + ln_row(
                {k[6:]: v for k, v in e.items() if k.startswith("train_")})
        log(f"phase 6 kernel {e['name']} ({e['shape']}): {e['ms']:.6f} ms; "
            f"plain {e['plain_ms']:.6f} ms; library {lib}; bound "
            f"{e['bound_ms']:.6f} ms ({e['bound_by']}); launches "
            f"{e['launches']}{extra}")
    for r in ln_rows:
        log(f"phase 6 layer_norm at a GptMini serving shape ({r['shape']}): "
            f"{ln_row(r)} ({smi})")
    for r in decode_off_path:
        log(f"phase 6 decode_attention off the main path ({r['shape']}): "
            f"{r['ms']:.6f} ms; plain {r['plain_ms']:.6f} ms; library "
            f"{r['library_ms']:.6f} ms; bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}); plan {r['plan']}")
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
    log(f"phase 6 training BertBase B=16 L=512 f32 ({smi}): attn pallas "
        f"{bert32['step_ms']:.3f} ms/step, {bert32['tokens_per_s']:.1f} "
        f"tokens/s")
    log(f"phase 6 training BertBase B=16 L=512 f32 ({smi}): attn full "
        f"{full32_ms:.3f} ms/step, {tokens / full32_ms * 1e3:.1f} tokens/s")
    log(f"phase 6 mma.sync m16n8k8 TF32, the f32 flash kernels' ceiling "
        f"({smi}; tools/mma_tf32.py): " + "; ".join(
            f"{r['chains']} accumulators a warp, {r['blocks_per_sm']} "
            f"blocks of {r['threads']} threads an SM: "
            f"{r['tflop_per_s']:.1f} TFLOP/s, {r['ns_per_mma_a_warp']:.3f} "
            f"ns a product a warp" for r in mma_rate))
    log(f"phase 6 sums of 16 x K by K x 8 products against f64 ({smi}; "
        f"tools/mma_tf32.py): " + "; ".join(
            f"K={r['K']} {r['sum']}: median |err|/|c| "
            f"{r['median_rel_err']:.3e}, max |err|/sum|a||b| "
            f"{r['max_err_over_size']:.3e}, mean err/sum|a||b| "
            f"{r['mean_err_over_size']:+.3e}" for r in mma_sums))
    for row in int8_sweep:
        log(f"phase 6 quantize_int8_scaled grouped launch of the "
            f"{row['leaves']} leaves of n={row['n']} of a ResNet-18 step: "
            f"{row['ms']:.6f} ms, bound {row['bound_ms']:.6f} ms")
    log(f"phase 6 training ResNet18 B={RESNET_B} bf16: int8 sync "
        f"{resnet['step_ms']:.3f} ms/step, {resnet['images_per_s']:.1f} "
        f"images/s; no compression {resnet_none_ms:.3f} ms/step, "
        f"{RESNET_B / resnet_none_ms * 1e3:.1f} images/s; int8 sync overhead "
        f"{resnet['step_ms'] - resnet_none_ms:.3f} ms/step")
    for what, prof in (("ResNet18 int8", resnet_profile),
                       ("ResNet18 no compression", resnet_none_profile),
                       ("training", train_profile),
                       ("training f32", train32_profile)):
        if not prof:
            continue
        log(f"phase 6 {what} profile (5 steps): wall "
            f"{prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} "
            f"ms, busy {prof['device_busy_share']:.4f}")
        for r in prof["port_kernels"]:
            name = r["name"].split("::", 1)[-1].split("(", 1)[0]
            log(f"phase 6 {what} profile: {name} {r['count']} launches, "
                f"{r['device_ms'] / r['count'] * 1e3:.3f} us each")
    report["phases"].update({
        "train_step_ms": bert["step_ms"], "train_full_step_ms": full_ms,
        "train_f32_step_ms": bert32["step_ms"],
        "train_f32_full_step_ms": full32_ms,
        "resnet_int8_step_ms": resnet["step_ms"],
        "resnet_none_step_ms": resnet_none_ms,
        "path_launches": path_launches,
        "warmup_s": warm_s, "launches": launches, "logit_err": logit_err,
        "decode_step_ms": decode_step_ms, "burst_s": burst_s,
        "tokens_per_s": tok_s, "ttft_ms": ttft,
    })
    report["kernels"] = entries

    with tempfile.TemporaryDirectory(prefix="chip_ckpt_") as root:
        # -- 7. checkpoints, resume, the evaluator, SIGTERM ---------------
        report["checkpoints"] = checkpoint_phase(kernels, args.seed, smi,
                                                 repo, root)
        # -- 8. single-pass serving of phase 7's checkpoints --------------
        serving = serving_phase(kernels, reference, F, args.seed, smi, repo,
                                root)
        # -- 9-13. faults, the flight recorder, the profiler, TF32, elastic
        serve_faults = serve_fault_phase(repo, root)
        faults = fault_phase(kernels, args.seed, root)
        prof = profile_phase(kernels, args.seed, root)
        tf32 = tf32_phase(repo, root)
        elastic = elastic_phase(repo, root)
    report["serving"] = serving
    report.update(faults=faults, profiler=prof, serve_faults=serve_faults,
                  tf32=tf32, elastic=elastic)
    log(f"phase 9 faults ResNet18 (B={RESNET_B}, bf16, int8 sync, host "
        f"layout, cuDNN deterministic; {smi}): --faults {FAULT_SPEC} fired "
        f"once each at {faults['fired']}; nonfinite_skip at step 3 with the "
        f"state after it bit for bit the state after step 2; one retry of "
        f"step 4's publish; the crash's emergency checkpoint (step 19, torn) "
        f"quarantined on --resume, which restored step 18 and ran to "
        f"{FAULT_STEPS}; resumed losses against an uninterrupted run max abs "
        f"diff {faults['resume_err']:.3e}, steps 1-18 "
        f"{faults['pre_crash_err']:.3e} (tol {FAULT_RESUME_TOL})")
    log(f"phase 9 flight recorder ({smi}): bundles {faults['bundles']}; "
        f"torch.profiler trace of steps {faults['capture'][0]}.."
        f"{faults['capture'][1]} holds {faults['quant_in_trace']} "
        f"quant_group_kernel launches (one a step); step ms in the capture "
        f"window {[round(x, 3) for x in faults['window_ms']]} (median "
        f"{median(faults['window_ms']):.3f}), before it (steps 2-13) median "
        f"{median(faults['outside_ms']):.3f}; the step after it (the report "
        f"thread reads the trace) {faults['after_ms']:.3f}; NCCL overlap "
        f"{faults['overlap']}; device time by family over the window "
        f"{faults['families']}")
    for dtype in ("float32", "bfloat16"):
        r = prof[dtype]
        off = bert32["step_ms"] if dtype == "float32" else bert["step_ms"]
        log(f"phase 10 profiler BertBase {dtype} --profile "
            f"{PROFILE_WINDOW} ({smi}): launches in the trace "
            f"{r['launch_counts']} (= {PROFILE_WINDOW} steps of the "
            f"wrappers' counts; {r['mangled']} kernel events kept their "
            f"mangled names); device ms/step from the trace "
            f"{r['device_ms']:.3f}, from key_averages "
            f"{r['device_rows_ms']:.3f} (diff {r['agree']:.4f}, tol "
            f"{PROFILE_AGREE}); step ms profiled "
            f"{[round(x, 3) for x in r['profiled_ms']]}, unprofiled "
            f"{[round(x, 3) for x in r['unprofiled_ms']]}, phase 5 without "
            f"--profile {off:.3f}; families {r['families']}")
    log(f"phase 10 BertBase bf16 --flightrec default armed and idle "
        f"({smi}): step {prof['armed']['step_ms']:.3f} ms (median of "
        f"{ARMED_STEPS - 1}), {prof['armed']['bundles']} bundles; the run "
        f"before it with the flags off {prof['off']['step_ms']:.3f} ms; "
        f"phase 5 {bert['step_ms']:.3f} ms")
    served_ms = [None if x is None else round(x, 3)
                 for x in serve_faults["infer_ms"]]
    log(f"phase 11 serve run --faults {SERVE_FAULTS} ({smi}): statuses "
        f"{serve_faults['statuses']}; infer_ms {served_ms}; fault_injected "
        f"{serve_faults['fired']}")
    log(f"phase 12 TF32 ({smi}): ResNet20 --dtype float32 train (2 steps, "
        f"eval) and evaluator on the card with TF32 at PyTorch's defaults "
        f"against --device cpu: losses {tf32['card']['losses']} vs "
        f"{tf32['cpu']['losses']}, eval {tf32['card']['eval']} vs "
        f"{tf32['cpu']['eval']}, evaluator loss "
        f"{tf32['card']['evaluator']['loss']} vs "
        f"{tf32['cpu']['evaluator']['loss']}: max relative diff "
        f"{tf32['max_rel']:.3e} (tol {TF32_RTOL})")
    log(f"phase 13 elastic ({smi}): 2 gloo ranks on the CPU (losses "
        f"{elastic['before']}) resumed on the card at world size 1: "
        f"elastic_resume {elastic['event']['old']} -> "
        f"{elastic['event']['new']}, global batch "
        f"{elastic['event']['batch_size']} (per rank "
        f"{elastic['event']['per_device_batch']}); losses "
        f"{elastic['losses']}; --strict-geometry: {elastic['strict']}")
    for e in entries:
        e["launches"] += (faults["launches"].get(e["name"], 0)
                          + prof["launches"].get(e["name"], 0))
    ln_entry = entries[1]
    ln_entry["launches"] += serving["bert"]["launches"]["layer_norm"]
    ln_entry["max_abs_err"] = max(
        [ln_entry["max_abs_err"]]
        + [e["max_abs_err"] for e in serving["bert"]["ln"]])
    ln_entry["serving_shapes"] = serving["bert"]["ln"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, default=str)

    # -- 14. result lines -------------------------------------------------
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
