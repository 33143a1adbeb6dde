"""The port's collectives beyond ring and Ulysses across processes: the
tensor-parallel sums, the data-parallel gradient sync in each mode, a
dp x tp x sp training step and the sharded save by every rank, over gloo
on the CPU or over NCCL with one card a rank.

    python -m torch.distributed.run --nproc-per-node 4 \\
        --master-addr 127.0.0.1 --master-port 29543 \\
        -m pytorch_distributed_nn_tpu_torch.tools.dist_sync_check \\
        --device cuda --mesh 2,1,2 --mesh 4,1,1

For each ``--mesh data,seq,model`` (its product the world size; default
``2,1,2`` and ``4,1,1`` at four ranks) every rank builds the mesh
(``parallel.mesh.make_mesh``: each mesh's groups under a store prefix of
their own) and runs, at the same point as every other rank:

1. ``tp`` (a model extent above 1): the sums of
   ``parallel/tensor_parallel.py`` over the model group, forward and
   backward, on (B / dp, L, d_model) activations drawn for every model
   rank from one seed, against the same sums computed whole on every
   rank: the sums within ``n`` f32 roundings of the sum of magnitudes
   (NCCL adds in its own order), the identities and the max bit for bit.
2. ``sync none``, ``sync int8``, ``sync topk`` (error feedback) and
   ``sync int8 bucket`` (``--bucket-kb``; a data extent above 1): the
   gradient sync of ``parallel/grad_sync.py`` over the data group on the
   network's parameter shapes (BertBase's 201 leaves, 76 of them kernel
   sized) with scale-exact gradients (integers in [-127, 127], a 127 in
   every leaf and every bucket on the last data rank, integer residuals),
   against the world-size-n result computed on every rank from every data
   rank's gradients with the same noise keys (the plain grouped quantizer
   on the card): bit for bit. topk also holds sent + new residual ==
   gradient + old residual, bit for bit.
3. ``spmd step``: two steps of ``training/spmd.py`` (SGD lr 0.1 with
   momentum 0.9, dropout 0, f32, the global batch of ``--batch`` MLM
   sequences of ``--seq-len``) from one random init, against the same two
   steps at world size 1 on the rank's own card with the whole batch:
   the losses within 1e-5 relative, every parameter within 1e-5 absolute
   plus relative (``tests/test_torch_spmd.py``'s bounds between meshes).
4. ``sharded save``: every rank writes its shard of the state after step
   2 into one ``pdtn-sharded-v1`` directory; a restore on the same mesh
   gives every leaf back bit for bit, and a restore at world size 1, cut
   to each rank's regions, equals that rank's live state bit for bit.

A hung collective ends the process after ``WATCHDOG_S`` seconds with
every thread's traceback. Each rank prints a JSON line of each case as
it ends; rank 0 prints the card's name and power limit (on the card) and,
last, one JSON line: each case's largest error over all ranks, that error
over its bound (at most 1 in bounds), the elements not equal where the
bound is bit for bit (``unequal``, 0 in bounds; -0 equals 0, as the gloo
tests' ``assert_array_equal`` holds them), and the slowest rank's ms.
The exit code is 1 if any case is out of bounds.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    shard_state_tree,
    state_leaves,
)
from pytorch_distributed_nn_tpu_torch.ops import compression as C
from pytorch_distributed_nn_tpu_torch.ops import reference
from pytorch_distributed_nn_tpu_torch.optim import (
    build_optimizer,
    make_schedule,
)
from pytorch_distributed_nn_tpu_torch.parallel import mesh as pmesh
from pytorch_distributed_nn_tpu_torch.parallel import tensor_parallel as tp
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    make_grad_sync,
)
from pytorch_distributed_nn_tpu_torch.parallel.ring_attention import (
    make_mesh_attn,
)
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training import spmd
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    create_train_state,
)

#: the spmd step against world size 1: the losses (relative) and the
#: parameters (absolute, relative) after step 2
TOL = {"loss": 1e-5, "param": (1e-5, 1e-5)}
#: the sums of the tp case: ``n`` f32 roundings of the sum of magnitudes
F32_EPS = float(np.finfo(np.float32).eps)
SYNC_MODES = ("none", "int8", "topk", "int8 bucket")
TOPK_RATIO = 0.01
LR, MOMENTUM, STEPS = 0.1, 0.9, 2
#: the seed of every rank's draws (weights, batches, gradients)
SEED = 0
#: seconds before a hung collective ends the process
WATCHDOG_S = 480.0


def _sync_cuda(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _unequal(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``got`` not equal to ``want``'s (a NaN equals a NaN,
    -0 equals 0, as ``numpy.testing.assert_array_equal`` holds them);
    every element when the shapes or dtypes differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.numel(), want.numel(), 1)
    differ = got != want
    if got.dtype.is_floating_point:
        differ &= ~(torch.isnan(got) & torch.isnan(want))
    return int(differ.sum())


def _exact(pairs) -> dict:
    """The case fields of (got, want) pairs that must be equal."""
    err = max((float((g.double() - w.double()).abs().max())
               if g.numel() else 0.0) for g, w in pairs)
    bad = sum(_unequal(g, w) for g, w in pairs)
    return {"err": err, "of_bound": 0.0, "unequal": bad}


# -- 1. the tensor-parallel sums --------------------------------------------


def tp_case(mesh, shape, seed: int, device) -> dict:
    """Forward and backward of ``copy_to_group``, ``reduce_from_group`` and
    ``max_from_group`` over the model group against the whole sums."""
    group = mesh.groups[pmesh.MODEL_AXIS]
    n, m = mesh.shape[pmesh.MODEL_AXIS], mesh.coords[pmesh.MODEL_AXIS]
    gen = torch.Generator(device=device)

    def draw(i):
        gen.manual_seed(seed * 1000 + i)
        return torch.randn(shape, generator=gen, device=device)

    xs, ws = [draw(i) for i in range(n)], [draw(100 + i) for i in range(n)]
    t0 = time.perf_counter()
    # g: the sum forward, the identity backward
    x = xs[m].clone().requires_grad_(True)
    y = tp.reduce_from_group(x, group)
    y.backward(ws[0])
    # f: the identity forward, the sum backward
    x0 = xs[0].clone().requires_grad_(True)
    z = tp.copy_to_group(x0, group)
    z.backward(ws[m])
    mx = tp.max_from_group(xs[m], group)
    _sync_cuda(device)
    ms = (time.perf_counter() - t0) * 1e3
    total, total_w = sum(xs), sum(ws)
    bound = (n * F32_EPS * sum(t.abs() for t in xs),
             n * F32_EPS * sum(t.abs() for t in ws))
    diffs = [(y.detach() - total).abs(), (x0.grad - total_w).abs()]
    exact = _exact([(x.grad, ws[0]), (z.detach(), xs[0]),
                    (mx, torch.stack(xs).amax(0))])
    return {"err": max([exact["err"]] + [float(d.max()) for d in diffs]),
            "of_bound": max(float((d / (b + 1e-30)).max())
                            for d, b in zip(diffs, bound)),
            "unequal": exact["unequal"], "ms": ms}


# -- 2. the data-parallel sync ------------------------------------------------


def scale_exact_grads(shapes: Sequence[tuple], n: int, seed: int, device,
                      bucket_elems: int) -> List[List[torch.Tensor]]:
    """Every data rank's gradients (``[rank][leaf]``): integers in [-127,
    127] as f32, the last rank holding a 127 at the start of every leaf
    and of every bucket of ``bucket_elems`` elements, so every shared
    scale is 1 and the int8 payload is the gradient whatever the noise."""
    sizes = [int(np.prod(s)) for s in shapes]
    total = sum(sizes)
    gen = torch.Generator(device=device)
    out = []
    for r in range(n):
        gen.manual_seed(seed * 7919 + r)
        flat = torch.randint(-127, 128, (total,), generator=gen,
                             device=device).to(torch.float32)
        if r == n - 1:
            flat[::bucket_elems] = 127.0
            flat[np.cumsum([0] + sizes[:-1]).tolist()] = 127.0
        out.append([part.view(s) for part, s in
                    zip(flat.split(sizes), shapes)])
    return out


def _int8_whole(per_rank, seed: int, n: int) -> List[torch.Tensor]:
    """The int8 sync's world-size-n result from every rank's leaves: the
    shared amax, each rank's payload with the plain grouped quantizer and
    the same noise keys, the int32 sum, and the dequantized mean (the
    arithmetic of ``compression.int8_psum_mean``)."""
    k = len(per_rank[0])
    amax = torch.stack([torch.stack([g.abs().amax().float() for g in gs])
                        for gs in per_rank]).amax(0)
    seeds = C.leaf_seeds(seed, k)
    totals = None
    for gs in per_rank:
        qs = [q.to(torch.int32) for q in C.quantize_leaves(
            gs, seeds, amax, reference.quantize_int8_scaled_group)]
        totals = qs if totals is None else [a + b for a, b in
                                            zip(totals, qs)]
    scales = torch.where(amax > 0, amax * reference.RECIP127,
                         torch.zeros_like(amax))
    recip = reference.f32_reciprocal(n)
    return [(t.to(torch.float32) * scales[i] * recip).to(g.dtype)
            for i, (t, g) in enumerate(zip(totals, per_rank[0]))]


def sync_cases(mesh, shapes, seed: int, device, bucket_kb: int) -> dict:
    """Each mode of :data:`SYNC_MODES` over the data group against the
    world-size-n result computed here from every data rank's gradients."""
    group = mesh.groups[pmesh.DATA_AXIS]
    n, d = mesh.shape[pmesh.DATA_AXIS], mesh.coords[pmesh.DATA_AXIS]
    bucket_bytes = bucket_kb * 1024
    # the model and seq coordinates pick other gradients for each column
    col = mesh.coords[pmesh.MODEL_AXIS] + 31 * mesh.coords[pmesh.SEQ_AXIS]
    grads = scale_exact_grads(shapes, n, seed + col, device,
                              bucket_bytes // 4)
    recip = reference.f32_reciprocal(n)
    sync_seed = seed + 17
    _, quant_seed = C.leaf_seeds(sync_seed, 2)
    out = {}
    for mode in SYNC_MODES:
        kw = {"compression": mode.split()[0]}
        if mode == "int8 bucket":
            kw["bucket_bytes"] = bucket_bytes
        if mode == "topk":
            kw["topk_ratio"] = TOPK_RATIO
        sync = make_grad_sync(group, **kw)
        state = None
        residuals = None
        if mode == "topk":
            gen = torch.Generator(device=device)
            residuals = []
            for r in range(n):
                gen.manual_seed(seed * 104729 + col * 13 + r)
                residuals.append([torch.randint(-8, 9, s, generator=gen,
                                                device=device).float()
                                  for s in shapes])
            state = [e.clone() for e in residuals[d]]
        # a first call builds the quantize kernel; the second is timed
        # and checked
        sync([g.clone() for g in grads[d]], state, sync_seed)
        mine = [g.clone() for g in grads[d]]
        _sync_cuda(device)
        t0 = time.perf_counter()
        synced, new_state = sync(mine, state, sync_seed)
        _sync_cuda(device)
        ms = (time.perf_counter() - t0) * 1e3
        if mode == "none":
            want = [sum(gs[i] for gs in grads) * recip
                    for i in range(len(shapes))]
        elif mode == "int8":
            want = _int8_whole(grads, quant_seed, n)
        elif mode == "int8 bucket":
            flat = [C.flatten_buckets(gs, bucket_bytes) for gs in grads]
            want = C.unflatten_buckets(
                _int8_whole([b for b, _ in flat], quant_seed, n), flat[0][1])
        else:
            sent = [C.topk_compress_ef(gs, es, TOPK_RATIO, "auto")[0]
                    for gs, es in zip(grads, residuals)]
            want = [sum(s[i] for s in sent) * recip
                    for i in range(len(shapes))]
        pairs = list(zip(synced, want))
        if mode == "topk":
            # sent + new residual == gradient + old residual, on this rank
            mine_sent = C.topk_compress_ef(grads[d], residuals[d],
                                           TOPK_RATIO, "auto")[0]
            pairs += [(s + e, g + o) for s, e, g, o in
                      zip(mine_sent, new_state, grads[d], residuals[d])]
        out[f"sync {mode}"] = {**_exact(pairs), "ms": ms}
    return out


# -- 3. the spmd step and 4. the sharded save -------------------------------


def _batches(vocab: int, L: int, B: int, seed: int):
    from pytorch_distributed_nn_tpu_torch.data.text import MLMBatches

    data = MLMBatches(vocab_size=vocab, seq_len=L, batch_size=B, seed=seed)
    return [next(data) for _ in range(STEPS)]


def _spmd_run(full, net, model_kw, mesh, batches, device, attn):
    """STEPS steps of the spmd step on ``mesh`` from ``full``'s weights:
    (the state, the losses, the ms of the steps)."""
    local = build_model(net, dtype="float32", mesh=mesh, attn_fn=attn,
                        **model_kw)
    spmd.shard_model(full, local, mesh)
    sched = make_schedule(LR)
    state = spmd.create_spmd_state(
        local, lambda p: build_optimizer("sgd", p, sched, momentum=MOMENTUM),
        mesh, device, seed=1)
    step = spmd.build_spmd_train_step(mesh)
    dp, d = mesh.shape[pmesh.DATA_AXIS], mesh.coords[pmesh.DATA_AXIS]
    losses = []
    _sync_cuda(device)
    t0 = time.perf_counter()
    for i, (x, y) in enumerate(batches):
        B = x.shape[0]
        rows = slice(d * B // dp, (d + 1) * B // dp)
        m = step(state, (torch.from_numpy(x[rows]).long().to(device),
                         torch.from_numpy(y[rows]).long().to(device)),
                 seed=11 + i)
        losses.append(float(m["loss"]))
    _sync_cuda(device)
    return state, losses, (time.perf_counter() - t0) * 1e3


def _flat(tree) -> Dict[str, np.ndarray]:
    return {k: np.asarray(a) for k, _, a in state_leaves(tree)}


def _tree_equal(got: dict, want: dict) -> dict:
    if set(got) != set(want):
        return {"err": math.inf, "of_bound": 0.0,
                "unequal": len(set(got) ^ set(want))}
    return _exact([(torch.from_numpy(np.ascontiguousarray(got[k])),
                    torch.from_numpy(np.ascontiguousarray(want[k])))
                   for k in sorted(want)])


def spmd_and_save_cases(mesh, full, net: str, model_kw: dict, B: int,
                        L: int, seed: int, device, directory: str) -> dict:
    """Cases 3 and 4 on ``mesh`` from ``full``'s weights: the step against
    world size 1, then the sharded save of its state and both restores."""
    batches = _batches(full.config.vocab_size, L, B, seed)
    attn = (make_mesh_attn(mesh, "ring")
            if mesh.shape[pmesh.SEQ_AXIS] > 1 else None)
    state, losses, ms = _spmd_run(full, net, model_kw, mesh, batches, device,
                                  attn)
    one = pmesh.make_mesh(None, 1, 1, 1)
    state1, losses1, ms1 = _spmd_run(full, net, model_kw, one, batches,
                                     device, None)
    live = _flat(ckpt.state_tree(state))
    whole1 = ckpt.state_tree(state1)
    want = _flat(shard_state_tree(whole1, mesh.shape, mesh.coords))
    del state1
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, losses1))
    atol, rtol = TOL["param"]
    p_err, p_of = 0.0, 0.0
    for k, w in want.items():
        if not k.startswith(".params"):
            continue
        diff = np.abs(live[k].astype(np.float64) - w.astype(np.float64))
        p_err = max(p_err, float(diff.max()))
        p_of = max(p_of, float((diff / (atol + rtol * np.abs(w))).max()))
    out = {"spmd step": {
        "err": max(loss_err, p_err), "loss_rel_err": loss_err,
        "param_err": p_err, "of_bound": max(loss_err / TOL["loss"], p_of),
        "unequal": 0, "ms": ms, "world1_ms": ms1,
        "losses": losses, "world1_losses": losses1}}

    # 4. every rank writes its shard, then the two restores
    _sync_cuda(device)
    t0 = time.perf_counter()
    path = ckpt.save_sharded(directory, state, geometry={
        "devices": mesh.size, "processes": mesh.size,
        "mesh": pmesh.axis_sizes(mesh)})
    save_ms = (time.perf_counter() - t0) * 1e3
    again, _, _ = _spmd_run(full, net, model_kw, mesh, [], device, attn)
    t0 = time.perf_counter()
    ckpt.restore_sharded(path, again)
    _sync_cuda(device)
    restore_ms = (time.perf_counter() - t0) * 1e3
    same = _tree_equal(_flat(ckpt.state_tree(again)), live)
    del again
    full1 = build_model(net, dtype="float32", **model_kw)
    sched = make_schedule(LR)
    fresh1 = create_train_state(
        full1, lambda p: build_optimizer("sgd", p, sched, momentum=MOMENTUM),
        device)
    ckpt.restore_resharded(path, fresh1)
    mine = _flat(shard_state_tree(ckpt.state_tree(fresh1), mesh.shape,
                                  mesh.coords))
    one_eq = _tree_equal(mine, live)
    out["sharded save"] = {
        "err": max(same["err"], one_eq["err"]), "of_bound": 0.0,
        "unequal": same["unequal"] + one_eq["unequal"],
        "ms": save_ms, "restore_ms": restore_ms,
        "leaves": len(live), "step": int(state.step)}
    return out


def check_mesh(group, shape, net: str, model_kw: dict, B: int, L: int,
               seed: int, device, bucket_kb: int, directory: str,
               report=None):
    """The mesh and this rank's cases on ``shape = (data, seq, model)``:
    ``{"tp": {...}, "sync int8": {...}, ...}`` with ``err``, ``of_bound``
    (at most 1 in bounds), ``unequal`` (0 in bounds) and ``ms``.
    ``report(name, case)`` is called as each case ends. Every rank calls
    this at the same point."""
    num_data, num_seq, num_model = shape
    mesh = pmesh.make_mesh(group, num_data, num_model=num_model,
                           num_seq=num_seq)
    if B % num_data or L % num_seq:
        raise ValueError(f"batch {B} and seq-len {L} must divide by the "
                         f"mesh's data {num_data} and seq {num_seq}")
    full = build_model(net, dtype="float32", **model_kw)
    full.init_weights(torch.Generator().manual_seed(seed))
    out = {}

    def done(cases):
        for name, case in cases.items():
            out[name] = case
            if report is not None:
                report(name, case)

    if num_model > 1:
        done({"tp": tp_case(mesh, (B // num_data, L // num_seq,
                                   full.config.d_model), seed, device)})
    if num_data > 1:
        shapes = [tuple(p.shape) for p in full.parameters()]
        done(sync_cases(mesh, shapes, seed, device, bucket_kb))
    done(spmd_and_save_cases(mesh, full, net, model_kw, B, L, seed, device,
                             directory))
    return mesh, out


def _emit(record: dict) -> None:
    """One JSON line in one write: the ranks share the output, and
    ``print`` writes the line and its newline apart, so two ranks' lines
    could run together."""
    sys.stdout.write(json.dumps(record) + "\n")
    sys.stdout.flush()


def _world_max(values, group, device) -> list:
    t = torch.tensor(values, dtype=torch.float64, device=device)
    return pmesh.all_reduce(t, "max", group).tolist()


def _shared_dir(group, device) -> str:
    """One temporary directory of rank 0's (the sharded saves), named to
    every rank."""
    r = pmesh.rank(group)
    name = tempfile.mkdtemp(prefix="pdtn_sync_check_") if r == 0 else ""
    buf = torch.zeros(1024, dtype=torch.uint8, device=device)
    if r == 0:
        raw = name.encode()
        buf[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    pmesh.all_reduce(buf, "sum", group)
    return bytes(buf.cpu().tolist()).rstrip(b"\0").decode()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--mesh", action="append", default=None,
                    help="data,seq,model (repeatable); default 2,1,2 and "
                         "4,1,1 on four ranks, else WORLD,1,1")
    ap.add_argument("--network", default="BertBase")
    ap.add_argument("--batch", type=int, default=8,
                    help="the global batch of the spmd step")
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--bucket-kb", type=int, default=1024)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group, device = pmesh.init_group(torch.device(args.device))
    world = pmesh.world_size(group)
    default = ["2,1,2", "4,1,1"] if world == 4 else [f"{world},1,1"]
    meshes = [tuple(int(x) for x in m.split(","))
              for m in (args.mesh or default)]
    model_kw = {"dropout_rate": 0.0, "max_len": args.seq_len}
    r = pmesh.rank(group)
    if r == 0 and device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    root = _shared_dir(group, device)
    result, ok = {"world": world, "device": device.type,
                  "network": args.network, "batch": args.batch,
                  "seq_len": args.seq_len, "bucket_kb": args.bucket_kb,
                  "tol": TOL, "meshes": {}}, True
    groups = [group]
    try:
        for shape in meshes:
            label = "x".join(map(str, shape))

            def report(name, case, label=label):
                _emit({"rank": r, "mesh": label, "case": name, **case})

            mesh, cases = check_mesh(
                group, shape, args.network, model_kw, args.batch,
                args.seq_len, SEED, device, args.bucket_kb,
                os.path.join(root, label), report=report)
            groups += [g for g in mesh.groups.values() if g is not None]
            keys = ("err", "of_bound", "unequal", "ms")
            names = sorted(cases)
            worst = _world_max([float(cases[n][k]) for n in names
                                for k in keys], group, device)
            rows = {n: dict(zip(keys, worst[len(keys) * i:
                                            len(keys) * (i + 1)]))
                    for i, n in enumerate(names)}
            for n in names:  # rank 0's extras (losses, leaves, ...)
                rows[n].update({k: v for k, v in cases[n].items()
                                if k not in keys})
            ok = ok and all(row["of_bound"] <= 1 and row["unequal"] == 0
                            for row in rows.values())
            result["meshes"][label] = rows
    finally:
        pmesh.all_reduce(torch.zeros(1, device=device), "sum", group)
        if r == 0:
            shutil.rmtree(root, ignore_errors=True)
    result["ok"] = ok
    if r == 0:
        _emit(result)
    for g in groups:  # NCCL's communicators, before the process exits
        close = getattr(g, "shutdown", None) or getattr(g, "_shutdown", None)
        if device.type == "cuda" and close is not None:
            close()
    faulthandler.cancel_dump_traceback_later()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
