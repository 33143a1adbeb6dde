"""Roofline calibration: per-family ceilings, persisted profiles, fitting
(the port of ``pytorch_distributed_nn_tpu/analysis/calibration.py``; the
same ``calibration.json``, so each package reads the other's).

- :class:`CalibrationProfile` — per-family compute ceilings + HBM/ICI
  bandwidths + the nominal peak (the MFU denominator), JSON round-trip.
- ``default_profile(backend)`` — the checked-in defaults: the JAX
  package's TPU-v5e and CPU profiles, and for ``"gpu"``/``"cuda"`` the
  H100 SXM's DATA-SHEET peaks (not measured: fit them with
  ``fit_from_trace`` or ``fit_microbench``): 989 TFLOP/s dense bf16,
  67 TFLOP/s f32 on the CUDA cores (the port's f32 steps run with TF32
  off), 3.35 TB/s HBM and NVLink 4's 450 GB/s a direction as its ICI.
- ``peak_flops_per_device(backend, kind, dtype)`` — the MFU peak. Where
  the JAX package uses one peak per device (v5e's bf16), the port's
  follows the step's compute dtype: an f32 step on an H100 is held to
  the f32 rate, a bf16 step to the tensor cores' bf16 rate. The trainer
  records the dtype it used (``step_cost.peak_dtype``).
- ``predict_step_ms`` — the planner's roofline score (copied exactly).
- ``fit_from_trace`` — ceilings from a ``torch.profiler`` Chrome trace
  (:func:`..utils.profiling.summarize_trace` and ``family_summary``):
  per family, the walk's FLOPs x steps over the family's device time.
- ``fit_microbench`` — one large matmul chain in the step's dtype and one
  large copy, timed on ``device`` (n >= 4096 on the card, so that launch
  time is under 5% of the window).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Optional

from pytorch_distributed_nn_tpu_torch.utils.profiling import FAMILIES

CALIBRATION_BASENAME = "calibration.json"

#: nominal per-device peak FLOP/s by backend — the MFU denominator (the
#: JAX package's table but its generic "gpu" entry: the port's card is an
#: H100, below; the CPU entry is a planning default)
PEAK_FLOPS_PER_DEVICE = {
    "tpu": 197e12,   # v5e bf16 (PERF.md roofline)
    "cpu": 5e10,     # planning default — see the JAX module
}

#: the NVIDIA H100 SXM's data-sheet peaks (dense) by compute dtype: the
#: bf16 tensor cores, and f32 on the CUDA cores (TF32 is off)
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_HBM_BYTES_PER_S = 3.35e12
#: NVLink 4: 900 GB/s a card in both directions together
H100_NVLINK_BYTES_PER_S = 450e9


def _backend(backend: str) -> str:
    b = (backend or "cpu").lower()
    return "gpu" if b == "cuda" else b


def peak_flops_per_device(backend: str, device_kind: str = "",
                          dtype: str = "bfloat16") -> float:
    """The MFU denominator of one device: an H100 (or any ``gpu``/``cuda``
    backend: the port's card) by the step's compute ``dtype``, a v5e at
    its bf16 rate, else the backend's planning default."""
    kind = (device_kind or "").lower()
    if "v5" in kind:
        return 197e12
    if "h100" in kind or _backend(backend) == "gpu":
        return H100_PEAK_FLOPS.get(dtype, H100_PEAK_FLOPS["float32"])
    return PEAK_FLOPS_PER_DEVICE.get(_backend(backend),
                                     PEAK_FLOPS_PER_DEVICE["cpu"])


@dataclasses.dataclass
class CalibrationProfile:
    """Per-family roofline ceilings for one device family."""

    name: str
    backend: str                       # cpu | tpu | gpu
    peak_flops_per_s: float            # nominal per-device peak (MFU denom)
    compute_ceilings: Dict[str, float]  # family -> achieved FLOP/s ceiling
    hbm_bytes_per_s: float             # measured/fit HBM ceiling
    hbm_peak_bytes_per_s: float        # nominal HBM peak (util denominator)
    ici_bytes_per_s: float             # per-device interconnect ceiling
    shared_substrate: bool = False     # virtual devices share host cores
    source: str = "default"            # default | trace | microbench | file

    def ceiling(self, family: str) -> float:
        return float(
            self.compute_ceilings.get(family)
            or self.compute_ceilings.get("other")
            or self.peak_flops_per_s
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationProfile":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            d = json.load(f)
        prof = cls.from_dict(d)
        prof.source = "file"
        return prof


def _h100(dtype: str) -> CalibrationProfile:
    peak = H100_PEAK_FLOPS[dtype]
    return CalibrationProfile(
        name=f"h100_datasheet_{dtype}",
        backend="gpu",
        peak_flops_per_s=peak,
        compute_ceilings={f: peak for f in FAMILIES},
        hbm_bytes_per_s=H100_HBM_BYTES_PER_S,
        hbm_peak_bytes_per_s=H100_HBM_BYTES_PER_S,
        ici_bytes_per_s=H100_NVLINK_BYTES_PER_S,
    )


#: the checked-in default profiles: the JAX package's TPU and CPU ones,
#: and the H100's data sheet for the card (at its bf16 peak;
#: :func:`default_profile` gives the f32 one on request)
DEFAULT_PROFILES = {
    "tpu": CalibrationProfile(
        name="tpu_v5e",
        backend="tpu",
        peak_flops_per_s=197e12,
        compute_ceilings={
            "convert_reduce_fusion": 60e12,
            "multiply_add_fusion": 118.7e12,
            "elementwise": 197e12,
            "other": 60e12,
        },
        hbm_bytes_per_s=690e9,
        hbm_peak_bytes_per_s=819e9,
        ici_bytes_per_s=9e10,
    ),
    "cpu": CalibrationProfile(
        name="cpu_fallback",
        backend="cpu",
        peak_flops_per_s=5e10,
        compute_ceilings={f: 5e10 for f in FAMILIES},
        hbm_bytes_per_s=2e10,
        hbm_peak_bytes_per_s=2e10,
        # ranks on one host: collective bytes go through host RAM
        ici_bytes_per_s=1e10,
        shared_substrate=True,
    ),
    "gpu": _h100("bfloat16"),
}


def default_profile(backend: str,
                    dtype: str = "bfloat16") -> CalibrationProfile:
    """A fresh copy of ``backend``'s checked-in profile (``"cuda"`` is
    ``"gpu"``); on the card, the data sheet at ``dtype``'s peak."""
    b = _backend(backend)
    if b == "gpu":
        return _h100(dtype if dtype in H100_PEAK_FLOPS else "float32")
    prof = DEFAULT_PROFILES.get(b, DEFAULT_PROFILES["cpu"])
    # defensive copy: callers mutate ceilings when fitting
    return CalibrationProfile.from_dict(prof.to_dict())


# ---------------------------------------------------------------------------
# Roofline prediction (the planner's scoring function; copied exactly)
# ---------------------------------------------------------------------------


def predict_step_ms(
    cost: dict,
    profile: CalibrationProfile,
    devices: int = 1,
) -> dict:
    """Predicted step milliseconds for one program under the roofline.

    ``cost`` is a ``StepCost.to_dict()`` (per program instance — per
    device for SPMD-partitioned HLO). Per family the time is the roofline
    max of the compute term and the HBM term; families sum (XLA overlaps
    *within* a fusion, not across the step's serial schedule), and the
    collective payload is charged additively at the ICI ceiling — the
    conservative no-overlap model, which is exactly what makes the
    ranking monotone: more ICI bytes on a slower link can never win.

    ``shared_substrate`` profiles (CPU virtual devices) multiply the
    per-device work by ``devices``: N virtual devices share one physical
    substrate, so partitioning buys no compute time at all there.
    """
    mult = float(devices) if profile.shared_substrate else 1.0
    compute_ms = 0.0
    hbm_bound_ms = 0.0
    fams = cost.get("families") or {}
    if fams:
        for fam, fc in fams.items():
            flops = float(fc.get("flops", 0.0)) * mult
            nbytes = float(fc.get("hbm_bytes", 0.0)) * mult
            t_compute = flops / profile.ceiling(fam)
            t_mem = nbytes / profile.hbm_bytes_per_s
            compute_ms += max(t_compute, t_mem) * 1000.0
            hbm_bound_ms += t_mem * 1000.0
    else:
        flops = float(cost.get("flops", 0.0)) * mult
        nbytes = float(cost.get("hbm_bytes", 0.0)) * mult
        compute_ms = max(
            flops / profile.ceiling("other"),
            nbytes / profile.hbm_bytes_per_s,
        ) * 1000.0
        hbm_bound_ms = nbytes / profile.hbm_bytes_per_s * 1000.0
    ici_ms = (
        float(cost.get("ici_bytes", 0.0)) * mult
        / profile.ici_bytes_per_s * 1000.0
    )
    return {
        "predicted_ms": compute_ms + ici_ms,
        "compute_ms": compute_ms,
        "hbm_ms": hbm_bound_ms,
        "ici_ms": ici_ms,
    }


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------


def fit_from_trace(
    trace_dir: str,
    cost: dict,
    steps: int,
    base: Optional[CalibrationProfile] = None,
) -> CalibrationProfile:
    """Fit per-family ceilings from the newest ``torch.profiler`` Chrome
    trace under ``trace_dir`` (a ``--profile`` run's profile dir).

    ``cost`` is the step's ``StepCost.to_dict()`` (the walk's, per rank)
    and ``steps`` how many steps the trace covers; each family's fitted
    ceiling is its FLOPs x steps over its device time. Families with no
    FLOPs or no trace time keep the base profile's ceiling. HBM is fit
    from the elementwise family (bandwidth bound by construction); ICI
    from the collective (NCCL) kernels' device time when the trace has
    any. A trace with no device events (a CPU run) raises ``ValueError``.
    """
    from pytorch_distributed_nn_tpu_torch.utils.profiling import (
        family_summary,
        summarize_trace,
    )

    summary = summarize_trace(trace_dir, top=10 ** 6)
    if not summary:
        raise ValueError(
            f"no device events in the trace under {trace_dir} — "
            "CPU-only captures cannot calibrate; use --microbench"
        )
    prof = base or default_profile("gpu")
    fams = family_summary(summary)
    cost_fams = cost.get("families") or {}
    for fam in FAMILIES:
        flops = float((cost_fams.get(fam) or {}).get("flops", 0.0))
        ms = float((fams.get(fam) or {}).get("total_ms", 0.0))
        if flops > 0 and ms > 0:
            prof.compute_ceilings[fam] = flops * steps / (ms / 1000.0)
    ew_bytes = float(
        (cost_fams.get("elementwise") or {}).get("hbm_bytes", 0.0)
    )
    ew_ms = float((fams.get("elementwise") or {}).get("total_ms", 0.0))
    if ew_bytes > 0 and ew_ms > 0:
        prof.hbm_bytes_per_s = ew_bytes * steps / (ew_ms / 1000.0)
    coll_ms = sum(r.total_ms for rows in summary.values() for r in rows
                  if "nccl" in r.name.lower())
    ici = float(cost.get("ici_bytes", 0.0))
    if ici > 0 and coll_ms > 0:
        prof.ici_bytes_per_s = ici * steps / (coll_ms / 1000.0)
    prof.source = "trace"
    prof.name = prof.name + "+trace"
    return prof


#: the microbench's matmul side on the card: n >= 4096 keeps a launch
#: under 5% of a chained product's time
MICROBENCH_N = {"cuda": 8192, "cpu": 1024}


def fit_microbench(
    base: Optional[CalibrationProfile] = None,
    device: str = "cuda",
    dtype: str = "bfloat16",
    matmul_n: Optional[int] = None,
    copy_mb: int = 256,
    repeats: int = 5,
) -> CalibrationProfile:
    """Bounded microbenches on ``device``: one chain of four dense n x n
    matmuls in ``dtype`` sets every compute ceiling (and, on the CPU, the
    peak: the measured rate is the best this host does), one large
    device copy (read + write) sets the HBM ceiling. Never calibrates ICI
    (that needs a multi-card trace)."""
    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    n = matmul_n or MICROBENCH_N["cuda" if on_card else "cpu"]
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    prof = base or default_profile("gpu" if on_card else "cpu", dtype)

    def timed(fn) -> float:
        fn()  # warm: the library's kernel choice, the allocator
        sync()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    from pytorch_distributed_nn_tpu_torch.utils.precision import no_tf32

    a = torch.ones((n, n), dtype=dt, device=dev) / n

    def chain():
        x = a
        for _ in range(4):
            x = x @ a
        return x

    with no_tf32():
        measured = 4 * 2 * n ** 3 / timed(chain)
    for fam in FAMILIES:
        prof.compute_ceilings[fam] = measured
    if prof.backend == "cpu":
        prof.peak_flops_per_s = measured
    src = torch.ones((copy_mb << 20) // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    prof.hbm_bytes_per_s = 2.0 * src.nbytes / timed(lambda: dst.copy_(src))
    if prof.backend == "cpu":
        prof.hbm_peak_bytes_per_s = prof.hbm_bytes_per_s
    prof.source = "microbench"
    prof.name = f"{prof.backend}_microbench_{dtype}"
    del a, src, dst
    return prof
