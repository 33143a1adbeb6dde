"""Ring and Ulysses attention across processes: each rank's output and
gradients against full attention on the whole sequence, over gloo on the
CPU or over NCCL with one card a rank.

    python -m torch.distributed.run --nproc-per-node 4 \\
        --master-addr 127.0.0.1 --master-port 29541 \\
        -m pytorch_distributed_nn_tpu_torch.tools.seq_parallel_check \\
        --device cuda --mesh 2,2,1 --mesh 1,4,1

For each ``--mesh data,seq,model`` (its product the world size) every
rank builds the mesh (``parallel.mesh.make_mesh``), draws the same full
q, k, v, output gradient and pad mask from one seed, and runs ring and
Ulysses attention (``--impl`` one of them), causal and not, on its seq
chunk over its seq group: the forward and the backward (the ring's
second pass). Each is held against full attention on the whole sequence
at the rank's chunk, within the JAX suite's bounds (forward 2e-5,
gradients 1e-4, absolute plus relative), and timed (the median of 5
forward-and-backward calls, CUDA events on the card). The default shape
is BertBase's attention at training length (B 16, L 512, H 12, D 64,
f32): a K/V block of seq 2 is 12.6 MB, far past NCCL's point-to-point
buffer, where the order of a hop's sends and receives decides whether
the pair deadlocks.

A hung collective ends the process after ``WATCHDOG_S`` seconds with
every thread's traceback. Each rank prints a JSON line of each case as
it ends; rank 0 prints the card's name and power limit (on the card)
and, last, one JSON line: each case's largest error over all ranks, that
error over its bound, and the slowest rank's ms. The exit code is 1 if
any case is out of bounds.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import subprocess
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.models.transformer import (
    full_attention,
)
from pytorch_distributed_nn_tpu_torch.parallel import mesh as pmesh
from pytorch_distributed_nn_tpu_torch.parallel.ring_attention import (
    make_mesh_attn,
)

#: (atol, rtol) of the forward and the gradients: the JAX suite's bounds
#: (``tests/test_sequence_parallel.py``)
TOL = {"fwd": (2e-5, 2e-5), "grad": (1e-4, 1e-4)}
IMPLS = ("ring", "ulysses")
#: seconds before a hung collective ends the process
WATCHDOG_S = 240.0


def _inputs(B: int, L: int, H: int, D: int, seed: int, device):
    """The full q, k, v, output gradient (B, L, H, D) f32 and the (B, L)
    pad mask (each row keeps a prefix of at least L / 2), the same on
    every rank."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(
        rng.standard_normal((B, L, H, D), dtype=np.float32)).to(device)
        for _ in range(4))
    keep = rng.integers(L // 2, L + 1, size=B)
    mask = torch.from_numpy(
        (np.arange(L)[None, :] < keep[:, None]).astype(np.int32)).to(device)
    return q, k, v, g, mask


def _errors(pairs, tol):
    """(max |got - want|, the largest of |got - want| / (atol + rtol
    |want|): at most 1 in bounds) over the (got, want) ``pairs``."""
    atol, rtol = tol
    diffs = [((got - want).abs(), atol + rtol * want.abs())
             for got, want in pairs]
    return (max(float(d.max()) for d, _ in diffs),
            max(float((d / b).max()) for d, b in diffs))


def _timed(fn, iters: int, device) -> float:
    """Median ms of ``fn()`` over ``iters`` calls after one warm call."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def check_mesh(group, shape, B: int = 16, L: int = 512, H: int = 12,
               D: int = 64, impls=IMPLS, seed: int = 0, iters: int = 5,
               device: Optional[torch.device] = None, report=None
               ) -> Tuple[pmesh.Mesh, Dict[str, dict]]:
    """The mesh and this rank's cases on the ``shape = (data, seq,
    model)`` mesh over ``group``, for each of ``impls``: ``{"ring
    causal": {"fwd_err": e, "fwd_of_bound": b, "grad_err": e,
    "grad_of_bound": b, "ms": t}, ...}``: the largest absolute error, the
    largest error over its bound (at most 1 in bounds), and this rank's
    ms. ``report(name, case)`` is called as each case ends. Every rank
    calls this at the same point."""
    num_data, num_seq, num_model = shape
    mesh = pmesh.make_mesh(group, num_data, num_model=num_model,
                           num_seq=num_seq)
    device = device or mesh.device
    S, s = num_seq, mesh.coords[pmesh.SEQ_AXIS]
    if L % S:
        raise ValueError(f"L={L} not divisible by seq={S}")
    Lc = L // S
    q, k, v, g, mask = _inputs(B, L, H, D, seed, device)
    chunk = slice(s * Lc, (s + 1) * Lc)
    out = {}
    for impl in impls:
        attn = make_mesh_attn(mesh, impl)
        for causal in (False, True):
            ref_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ref = full_attention(*ref_in, mask, causal=causal)
            ref.backward(g)
            local = [t[:, chunk].clone().requires_grad_(True)
                     for t in (q, k, v)]

            def fwd_bwd():
                for t in local:
                    t.grad = None
                o = attn(*local, mask[:, chunk], causal=causal)
                o.backward(g[:, chunk])
                return o

            o = fwd_bwd()
            errs = {}
            errs["fwd_err"], errs["fwd_of_bound"] = _errors(
                [(o.detach(), ref.detach()[:, chunk])], TOL["fwd"])
            errs["grad_err"], errs["grad_of_bound"] = _errors(
                [(t.grad, r.grad[:, chunk]) for t, r in zip(local, ref_in)],
                TOL["grad"])
            errs["ms"] = _timed(fwd_bwd, iters, device)
            name = f"{impl} {'causal' if causal else 'full'}"
            out[name] = errs
            if report is not None:
                report(name, errs)
    return mesh, out


def _world_max(values, group, device) -> list:
    t = torch.tensor(values, dtype=torch.float64, device=device)
    return pmesh.all_reduce(t, "max", group).tolist()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--mesh", action="append", default=None,
                    help="data,seq,model (repeatable); default 1,WORLD,1")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--impl", action="append", choices=IMPLS, default=None,
                    help="ring or ulysses (repeatable); default both")
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    group, device = pmesh.init_group(torch.device(args.device))
    world = pmesh.world_size(group)
    meshes = [tuple(int(x) for x in m.split(","))
              for m in (args.mesh or [f"1,{world},1"])]
    r = pmesh.rank(group)
    if r == 0 and device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    result, ok = {"world": world, "device": device.type,
                  "shape": [args.batch, args.seq_len, args.heads,
                            args.head_dim], "tol": TOL, "meshes": {}}, True
    groups = [group]
    for shape in meshes:
        label = "x".join(map(str, shape))

        def report(name, case, label=label):
            print(json.dumps({"rank": r, "mesh": label, "case": name,
                              **case}), flush=True)

        mesh, cases = check_mesh(group, shape, args.batch, args.seq_len,
                                 args.heads, args.head_dim,
                                 tuple(args.impl or IMPLS), device=device,
                                 report=report)
        groups += [g for g in mesh.groups.values() if g is not None]
        names, keys = sorted(cases), sorted(cases[next(iter(cases))])
        worst = _world_max([cases[n][k] for n in names for k in keys],
                           group, device)
        rows = {n: dict(zip(keys, worst[len(keys) * i:len(keys) * (i + 1)]))
                for i, n in enumerate(names)}
        ok = ok and all(row["fwd_of_bound"] <= 1 and row["grad_of_bound"] <= 1
                        for row in rows.values())
        result["meshes"][label] = rows
    result["ok"] = ok
    if r == 0:
        print(json.dumps(result), flush=True)
    for g in groups:  # NCCL's communicators, before the process exits
        close = getattr(g, "shutdown", None) or getattr(g, "_shutdown", None)
        if device.type == "cuda" and close is not None:
            close()
    faulthandler.cancel_dump_traceback_later()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
