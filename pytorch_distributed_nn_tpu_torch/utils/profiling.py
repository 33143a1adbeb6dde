"""``torch.profiler`` trace capture and offline summaries of its Chrome
traces: the port of ``pytorch_distributed_nn_tpu/utils/profiling.py``.

Capture: :func:`start_trace` / :func:`stop_trace` (one session at a
time, as ``jax.profiler``'s) and :func:`trace_span` wrap a span of steps
in a ``torch.profiler`` session over the CPU and, with a card, CUDA
activity; on stop the session is written to
``<log_dir>/<host>_<pid>.<ms>.pt.trace.json`` (Chrome trace format,
viewable in Perfetto or ``chrome://tracing``). On the card a session
opens with lead-in launches that the summaries leave out (the comment
on :data:`_LEAD_PER_S`).

Summaries (the counterparts of ``summarize_xplane`` and friends) read the
newest ``*.pt.trace.json`` under a directory and take its device events:
category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``, one table per
device stream (``GPU <d> stream <s>``). A CPU-only trace has none, and
every summary is then empty.

Families (:data:`FAMILIES`, the JAX package's four) of a CUDA kernel,
by :func:`op_family`:

- GEMMs and convolutions (cuBLAS, cuBLASLt and CUTLASS GEMMs, cuDNN
  convolutions: names holding ``gemm``, ``gemv``, ``xmma``, ``cutlass``,
  ``cublas``, ``nvjet`` or ``conv``) are forward compute
  (``convert_reduce_fusion``) or backward compute
  (``multiply_add_fusion``): backward when the host op that launched the
  kernel lies inside autograd's backward
  (``autograd::engine::evaluate_function: ...``). The summary marks their
  rows ``<name> [fwd]`` or ``<name> [bwd]``.
- The port's own kernels (``flash_*``, ``ln_*``, ``quant_*``,
  ``dequant_kernel``, ``decode_attn_kernel``) keep their names as rows
  and are never folded into the tail: the forward ones (``flash_fwd_*``,
  ``ln_fwd_*``, ``decode_attn_kernel``) are forward compute, the
  backward ones (``flash_dq_*``, ``flash_dkv_*``, ``ln_bwd_*``) backward
  compute, the int8 codec of the gradient sync (``quant_*``,
  ``dequant_kernel``) ``other``.
- NCCL kernels, copies and memsets, and the folded tail: ``other``.
- Every other kernel (elementwise, reductions, normalisation, softmax,
  indexing: the bandwidth-bound work XLA fuses) is ``elementwise``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import json
import os
import platform
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

_session = None  # (profile, log_dir) of the open trace, if any
#: A session of ``torch.profiler`` on an H100 host lost the first kernel
#: records of its window ten minutes into a process (the first flash
#: forward and LayerNorms of a BertBase step), with or without idle time
#: at its edges, and sessions that opened with launches of
#: ``torch.cuda._sleep(0)`` (``spin_kernel``) kept every kernel. The
#: losses grew with the process's age, so a session opens with
#: _LEAD_PER_S such launches a second of that age, _LEAD_MIN at least,
#: and the summaries leave them out: they are not the traced program's.
_LEAD_PER_S = 0.5
_LEAD_MIN, _LEAD_MAX = 64, 20000
_LEAD_KERNEL = "spin_kernel"
_LOADED = time.monotonic()


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` session writing into ``log_dir`` at
    :func:`stop_trace`. Raises when one is already open (two sessions
    cannot nest)."""
    global _session
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _session is not None:
        raise RuntimeError(
            f"a profiler trace into {_session[1]} is already open")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    if torch.cuda.is_available():  # the lead-in (module comment)
        age = time.monotonic() - _LOADED
        for _ in range(min(max(int(age * _LEAD_PER_S), _LEAD_MIN),
                           _LEAD_MAX)):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
    _session = (prof, log_dir)


def stop_trace():
    """Stop the open session and write its Chrome trace; returns the
    ``torch.profiler.profile`` (its ``key_averages()`` stay readable)."""
    global _session
    if _session is None:
        raise RuntimeError("no profiler trace is open")
    (prof, log_dir), _session = _session, None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    name = (f"{platform.node() or 'host'}_{os.getpid()}."
            f"{int(time.time() * 1000)}.pt.trace.json")
    prof.export_chrome_trace(os.path.join(log_dir, name))
    return prof


def trace_active() -> bool:
    return _session is not None


@contextlib.contextmanager
def trace_span(log_dir: str):
    """Context manager: a ``torch.profiler`` trace of the block into
    ``log_dir``; yields nothing (read the trace, or the profile
    :func:`stop_trace` returns)."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


@dataclass
class OpTime:
    """Aggregated device time for one kernel (or kernel family)."""

    name: str
    total_ms: float
    count: int
    pct: float


#: the canonical families of the JAX package's roofline tables
FAMILIES = (
    "convert_reduce_fusion",  # forward compute: GEMMs/convs, the port's
    #                           forward kernels
    "multiply_add_fusion",    # backward compute: GEMMs/convs under
    #                           autograd's backward, the backward kernels
    "elementwise",            # bandwidth-bound kernels
    "other",                  # copies, collectives, the int8 codec, the tail
)

#: a library GEMM or convolution ("convert" is an elementwise cast)
_COMPUTE_RE = re.compile(r"gemm|gemv|xmma|cutlass|cublas|nvjet|conv(?!ert)")
_PORT_PREFIXES = ("flash_", "ln_", "quant_", "dequant_", "decode_attn_")
_PORT_FORWARD = ("flash_fwd_", "ln_fwd_", "decode_attn_")
_PORT_BACKWARD = ("flash_dq_", "flash_dkv_", "ln_bwd_")
_FWD, _BWD = " [fwd]", " [bwd]"
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_BACKWARD_OP = "autograd::engine::evaluate_function"


def _outer_text(name: str) -> str:
    """``name`` without template arguments and parameters (text at
    template depth 0, up to the parameter list)."""
    s = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif not depth:
            if ch == "(":
                break
            out.append(ch)
    return "".join(out)


def _mangled_identifier(name: str) -> str:
    """The last name component of an Itanium-mangled function name before
    its template arguments (``_ZN12_GLOBAL__N_117ln_fwd_vec_kernelI...``
    -> ``ln_fwd_vec_kernel``; ``_Z23flash_fwd_3xtf32_kernelILi64E...`` ->
    ``flash_fwd_3xtf32_kernel``); ``""`` when there is none."""
    i, last = 2, ""
    nested = name.startswith("N", i)
    if nested:
        i += 1
        while i < len(name) and name[i] in "rVKRO":  # qualifiers
            i += 1
    while i < len(name) and name[i].isdigit():
        j = i
        while j < len(name) and name[j].isdigit():
            j += 1
        n = int(name[i:j])
        last, i = name[j:j + n], j + n
        if not nested:
            break
    return last


def kernel_base_name(name: str) -> str:
    """A CUDA kernel's function name without return type, namespaces,
    template arguments and parameters (``void (anonymous
    namespace)::ln_fwd_vec_kernel<float, float, 768>(...)`` ->
    ``ln_fwd_vec_kernel``), also when the trace kept the name mangled
    (an H100 trace named a cuDNN CUTLASS convolution
    ``_ZN17cutlass__5x_cudnn6KernelI...``); copies keep their kind
    (``Memcpy HtoD``)."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (", 1)[0]
    if name.startswith("_Z"):
        return _mangled_identifier(name) or name
    words = _outer_text(name).split()
    return (words[-1].split("::")[-1] if words else "") or name


def is_port_kernel(name: str) -> bool:
    """Whether ``name`` is one of the port's hand-written kernels."""
    base = kernel_base_name(name)
    return base.startswith(_PORT_PREFIXES) and base.endswith("_kernel")


def is_compute_kernel(name: str) -> bool:
    """A GEMM or a convolution of a library (see the module doc): a
    marker in the name outside its template arguments, or ``gemm`` in
    them (CUTLASS's ``Kernel2<..._gemm_...>``)."""
    if is_port_kernel(name):
        return False
    outer = _outer_text(name).lower()
    return (bool(_COMPUTE_RE.search(outer)) or "gemm" in name.lower())


#: the kinds of operation :func:`family` tells apart
COMPUTE, KERNEL, OTHER, ELEMENTWISE = "compute", "kernel", "other", \
    "elementwise"


def family(kind: str, backward: bool = False, kernel: str = "") -> str:
    """The family of one operation: the one rule that the trace
    summaries (:func:`op_family`) and the cost walk
    (:mod:`..analysis.costmodel`) both apply (module doc).

    - ``COMPUTE`` (a GEMM or a convolution): ``multiply_add_fusion``
      inside autograd's backward, else ``convert_reduce_fusion``;
    - ``KERNEL`` (one of the port's kernels, ``kernel`` its base name):
      forward or backward compute by its prefix, else ``other`` (the
      int8 codec);
    - ``OTHER`` (collectives, copies and memsets): ``other``;
    - anything else: ``elementwise``."""
    if kind == COMPUTE:
        return "multiply_add_fusion" if backward else "convert_reduce_fusion"
    if kind == KERNEL:
        if kernel.startswith(_PORT_FORWARD):
            return "convert_reduce_fusion"
        if kernel.startswith(_PORT_BACKWARD):
            return "multiply_add_fusion"
        return "other"
    if kind == OTHER:
        return "other"
    return "elementwise"


def op_family(name: str) -> str:
    """The family of a summary row's name (module doc, :func:`family`)."""
    if name.endswith((_FWD, _BWD)):
        return family(COMPUTE, backward=name.endswith(_BWD))
    if is_port_kernel(name):
        return family(KERNEL, kernel=kernel_base_name(name))
    if (name.startswith(("Memcpy", "Memset", "(other "))
            or "nccl" in name.lower()):
        return family(OTHER)
    if is_compute_kernel(name):  # a raw name without its direction
        return family(COMPUTE)
    return family(ELEMENTWISE)


def family_summary(summary: Dict[str, List[OpTime]]) -> Dict[str, dict]:
    """Collapse a per-kernel device-time table into the four families
    (always all four, zeros included), ``{total_ms, count, pct}`` over
    every device stream."""
    out = {f: {"total_ms": 0.0, "count": 0, "pct": 0.0} for f in FAMILIES}
    total = 0.0
    for rows in summary.values():
        for r in rows:
            fam = op_family(r.name)
            out[fam]["total_ms"] += r.total_ms
            out[fam]["count"] += r.count
            total += r.total_ms
    if total > 0:
        for rec in out.values():
            rec["pct"] = 100.0 * rec["total_ms"] / total
            rec["total_ms"] = round(rec["total_ms"], 3)
            rec["pct"] = round(rec["pct"], 1)
    return out


def format_family_summary(
    families: Dict[str, dict],
    cost: Optional[Dict[str, dict]] = None,
    steps: Optional[int] = None,
) -> str:
    """The per-family table; with a static per-step cost (``{family:
    {"flops": .., "hbm_bytes": ..}}``) and a step count, the FLOPs/bytes
    and achieved-TFLOP/s columns are appended."""
    derivable = bool(cost) and bool(steps)
    header = f"  {'family':<24} {'ms':>10} {'%':>6} {'n':>7}"
    if derivable:
        header += f" {'GFLOP/step':>11} {'MB/step':>9} {'TFLOP/s':>9}"
    lines = [header]
    for fam in FAMILIES:
        rec = families.get(fam) or {}
        ms = float(rec.get("total_ms", 0.0))
        line = (f"  {fam:<24} {ms:>10.3f} {rec.get('pct', 0.0):>6.1f} "
                f"{rec.get('count', 0):>7}")
        if derivable:
            c = (cost or {}).get(fam) or {}
            flops = float(c.get("flops", 0.0))
            hbm = float(c.get("hbm_bytes", 0.0))
            ach = (
                flops * steps / (ms / 1000.0) / 1e12 if ms > 0 and flops
                else 0.0
            )
            line += (f" {flops / 1e9:>11.3f} {hbm / 1e6:>9.2f} "
                     f"{ach:>9.2f}")
        lines.append(line)
    return "\n".join(lines)


def find_trace(trace_dir: str) -> str:
    """The newest ``*.pt.trace.json`` under ``trace_dir``."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(
            f"no *.pt.trace.json under {trace_dir} — was a trace captured "
            "here?")
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    return doc if isinstance(doc, dict) else {"traceEvents": doc}


@dataclass
class DeviceEvent:
    stream: str  # "GPU <device> stream <stream>"
    name: str  # the kernel's name, " [fwd]"/" [bwd]" on GEMMs and convs
    begin_us: float
    end_us: float


def _backward_windows(events) -> Dict[object, List[List[float]]]:
    """Per host thread, the merged spans of autograd's backward ops."""
    spans = collections.defaultdict(list)
    for ev in events:
        if ev.get("cat") == "cpu_op" and _BACKWARD_OP in str(ev.get("name")):
            t0 = float(ev.get("ts", 0.0))
            spans[(ev.get("pid"), ev.get("tid"))].append(
                (t0, t0 + float(ev.get("dur", 0.0))))
    merged = {}
    for key, ws in spans.items():
        out: List[List[float]] = []
        for w0, w1 in sorted(ws):
            if out and w0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], w1)
            else:
                out.append([w0, w1])
        merged[key] = out
    return merged


def _inside(windows: List[List[float]], t: float) -> bool:
    i = bisect.bisect_right([w[0] for w in windows], t) - 1
    return i >= 0 and windows[i][0] <= t <= windows[i][1]


def device_events(trace: dict) -> List[DeviceEvent]:
    """The trace's device events (kernels, copies, memsets) but a
    session's lead-in, GEMMs and convolutions named by direction (module
    doc)."""
    events = trace.get("traceEvents") or []
    launches = {}  # correlation id -> (pid, tid, ts) of the host launch
    for ev in events:
        if ev.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ((ev.get("pid"), ev.get("tid")),
                                  float(ev.get("ts", 0.0)))
    backward = _backward_windows(events)
    out = []
    for ev in events:
        if ev.get("cat") not in _DEVICE_CATEGORIES or ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        name = str(ev.get("name", "?"))
        if kernel_base_name(name) == _LEAD_KERNEL:
            continue  # a session's lead-in
        if ev.get("cat") == "kernel" and is_compute_kernel(name):
            launch = launches.get(args.get("correlation"))
            bwd = launch is not None and _inside(
                backward.get(launch[0], []), launch[1])
            name += _BWD if bwd else _FWD
        t0 = float(ev.get("ts", 0.0))
        out.append(DeviceEvent(
            stream=f"GPU {args.get('device', ev.get('pid'))} stream "
                   f"{args.get('stream', ev.get('tid'))}",
            name=name, begin_us=t0, end_us=t0 + float(ev.get("dur", 0.0))))
    return out


def _row_key(name: str, collapse: bool) -> str:
    if not collapse:
        return name
    for mark in (_FWD, _BWD):
        if name.endswith(mark):
            return kernel_base_name(name[:-len(mark)]) + mark
    return kernel_base_name(name)


def summarize_trace(
    trace_dir: str,
    top: int = 30,
    collapse: bool = True,
) -> Dict[str, List[OpTime]]:
    """Per-kernel device-time table of the newest trace under
    ``trace_dir``: ``{"GPU <d> stream <s>": [OpTime, ...]}``, largest
    first. ``collapse=True`` keys rows by the kernel's base name
    (:func:`kernel_base_name`); ``collapse=False`` keeps full names. Past
    ``top`` rows the rest fold into one ``(other N ops)`` row, so every
    table sums to its stream's device time; the port's kernels are never
    folded."""
    tot: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    cnt: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    for ev in device_events(load_trace(find_trace(trace_dir))):
        key = _row_key(ev.name, collapse)
        tot[ev.stream][key] += (ev.end_us - ev.begin_us) / 1e3
        cnt[ev.stream][key] += 1
    out: Dict[str, List[OpTime]] = {}
    for stream in sorted(tot):
        t, c = tot[stream], cnt[stream]
        total = sum(t.values())
        ordered = [k for k, _ in t.most_common()]
        keep = ordered[:top] + [k for k in ordered[top:] if is_port_kernel(k)]
        rows = [OpTime(name=k, total_ms=t[k], count=c[k],
                       pct=100.0 * t[k] / total if total else 0.0)
                for k in keep]
        kept = set(keep)
        rest = [k for k in ordered if k not in kept]
        if rest:
            shown = sum(r.total_ms for r in rows)
            rows.append(OpTime(
                name=f"(other {len(rest)} ops)",
                total_ms=total - shown,
                count=sum(c.values()) - sum(r.count for r in rows),
                pct=100.0 * (total - shown) / total if total else 0.0,
            ))
        out[stream] = rows
    return out


def format_summary(summary: Dict[str, List[OpTime]]) -> str:
    lines = []
    for stream, ops in summary.items():
        total = sum(o.total_ms for o in ops)
        lines.append(f"== {stream}: {total:.2f} ms device time ==")
        for o in ops:
            lines.append(
                f"  {o.total_ms:9.3f} ms {o.pct:5.1f}% n={o.count:<5} "
                f"{o.name[:110]}"
            )
    return "\n".join(lines)


def device_step_time_ms(trace_dir: str, num_steps: int) -> Optional[float]:
    """Device time over every stream of the newest trace, over
    ``num_steps``: the step's device cost without the host's dispatch.
    ``None`` when the trace has no device events."""
    summary = summarize_trace(trace_dir, top=10**6)
    if not summary:
        return None
    total = sum(o.total_ms for ops in summary.values() for o in ops)
    return total / max(num_steps, 1)


def collective_overlap_report(trace_dir: str) -> Dict[str, float]:
    """How much collective (NCCL) time hides under compute: per device,
    the NCCL kernels' spans merged into disjoint windows
    (``collective_in_flight_ms``), the time of kernels on other streams
    inside them (``overlapped_compute_ms``), the in-flight time they leave
    uncovered (``exposed_ms``) and ``overlap_ratio`` = overlapped /
    in-flight (0 with no NCCL kernel, e.g. at world size 1)."""
    report = {
        "collective_in_flight_ms": 0.0,
        "overlapped_compute_ms": 0.0,
        "exposed_ms": 0.0,
        "overlap_ratio": 0.0,
    }
    by_device = collections.defaultdict(list)
    for ev in device_events(load_trace(find_trace(trace_dir))):
        by_device[ev.stream.split(" stream ")[0]].append(ev)
    for evs in by_device.values():
        coll = [e for e in evs if "nccl" in e.name.lower()]
        coll_streams = {e.stream for e in coll}
        merged: List[List[float]] = []
        for e in sorted(coll, key=lambda e: e.begin_us):
            if merged and e.begin_us <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e.end_us)
            else:
                merged.append([e.begin_us, e.end_us])
        in_flight = sum(w1 - w0 for w0, w1 in merged) / 1e3
        covered = 0.0
        for e in evs:
            if e.stream in coll_streams:
                continue
            for w0, w1 in merged:
                if w0 >= e.end_us:
                    break
                covered += max(min(e.end_us, w1) - max(e.begin_us, w0), 0.0)
        covered /= 1e3
        report["collective_in_flight_ms"] += in_flight
        report["overlapped_compute_ms"] += min(covered, in_flight)
        report["exposed_ms"] += max(in_flight - covered, 0.0)
    if report["collective_in_flight_ms"] > 0:
        report["overlap_ratio"] = (report["overlapped_compute_ms"]
                                   / report["collective_in_flight_ms"])
    return {k: round(v, 3) for k, v in report.items()}
