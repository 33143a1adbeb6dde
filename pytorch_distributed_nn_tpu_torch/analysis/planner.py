"""Mesh planner: candidate configurations ranked under the calibrated
roofline (the port of ``pytorch_distributed_nn_tpu/analysis/planner.py``:
the same candidates, labels and result keys).

Search space, as in the JAX package:

- **Mesh factorizations.** Text models: every ``dp x tp x sp`` whose
  product is ``devices`` (minus those the model's shapes reject: heads
  not divisible by tp, seq not divisible by sp). Image models train data
  parallel only, so their candidates are ``dp`` over the divisors of
  ``devices``: fewer devices is a legal answer.
- **Partitioning-rule overrides.** For tp > 1 the rule table
  (``parallel.partitioning.DEFAULT_RULES``) and its overrides by
  ``override_rule`` (a replicated LM head, a replicated MLP) are
  candidates of their own. The port's model splits its leaves by
  ``DEFAULT_RULES`` alone, so an override candidate is listed with its
  label and skipped, with that reason.

Every candidate's step is walked (:func:`.costmodel.step_cost_from_walk`:
rank 0's step, on the meta device, under a fake process group of the
candidate's ranks, :func:`.costmodel.walk_step`), so the collectives
charged are the ones the port posts. The model is the one the run would
train: text models with the flash kernels (ring or Ulysses attention
under sp), the kernel LayerNorm.

``validate=True`` also measures each candidate: its ranks run as
processes of :mod:`..parallel.launch` (``python -m
pytorch_distributed_nn_tpu_torch.analysis.planner --measure-rank JOB``),
training the port's ``Trainer`` for a few steps on ``device``: one card a
rank on the card (ranks never share one; a candidate needing more cards
than the host has gets ``measured_ms: null`` and the reason in
``unmeasured``), gloo ranks of one torch thread each on the CPU. Its
``measured_ms`` is the median step time past the first steps, and its
``launches`` the port's kernel launch counts of rank 0's steps.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import statistics
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

from pytorch_distributed_nn_tpu_torch.analysis.calibration import (
    CalibrationProfile,
    default_profile,
    predict_step_ms,
)

logger = logging.getLogger(__name__)

MODEL_ALIASES = {"bert_tiny": "BertTiny", "bert_base": "BertBase",
                 "lenet": "LeNet", "resnet18": "ResNet18", "vgg11": "VGG11"}

#: validation: steps a rank trains, and the first ones left out of the
#: median (the first builds cuDNN's and cuBLAS's plans)
MEASURE_STEPS, MEASURE_WARMUP = 12, 2
#: seconds a validation launch may take
MEASURE_TIMEOUT_S = 600.0


@dataclasses.dataclass
class Candidate:
    """One planned configuration and its roofline score."""

    mesh: Tuple[int, int, int]          # (data, model, seq)
    rules: str                          # "default" or the override label
    devices: int
    predicted_ms: float
    compute_ms: float
    ici_ms: float
    cost: dict                          # StepCost.to_dict (per device)
    measured_ms: Optional[float] = None
    skipped: Optional[str] = None       # reason when not walkable
    unmeasured: Optional[str] = None    # reason when validate could not run
    launches: Optional[Dict[str, int]] = None

    def label(self) -> str:
        d, m, s = self.mesh
        out = f"{d}x{m}x{s}" if (m > 1 or s > 1) else str(d)
        if self.rules != "default":
            out += f" [{self.rules}]"
        return out

    def to_dict(self) -> dict:
        out = {
            "mesh": {"data": self.mesh[0], "model": self.mesh[1],
                     "seq": self.mesh[2]},
            "rules": self.rules,
            "devices": self.devices,
            "predicted_ms": round(self.predicted_ms, 3),
            "compute_ms": round(self.compute_ms, 3),
            "ici_ms": round(self.ici_ms, 3),
            "measured_ms": (
                round(self.measured_ms, 3)
                if self.measured_ms is not None else None
            ),
            "flops_per_device": self.cost.get("flops"),
            "ici_bytes_per_device": self.cost.get("ici_bytes"),
            "skipped": self.skipped,
        }
        if self.unmeasured is not None:
            out["unmeasured"] = self.unmeasured
        if self.launches is not None:
            out["launches"] = self.launches
        return out


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_meshes(devices: int, text_model: bool) -> List[Tuple[int, int, int]]:
    """Candidate (dp, tp, sp) meshes for ``devices`` devices."""
    if not text_model:
        return [(d, 1, 1) for d in _divisors(devices)]
    out = []
    for tp in _divisors(devices):
        for sp in _divisors(devices // tp):
            dp = devices // (tp * sp)
            out.append((dp, tp, sp))
    return sorted(set(out))


#: the JAX planner's partitioning-rule overrides searched at tp > 1
#: (``override_rule`` of the LM head and the MLP to replicated). The
#: port's model splits its leaves by ``DEFAULT_RULES`` alone, so these
#: are listed, labelled as the JAX planner labels them, and skipped
RULE_OVERRIDES = ("vocab->replicated", "mlp->replicated")
RULES_NOT_PORTED = ("the port's model splits its leaves by DEFAULT_RULES "
                    "alone (rule overrides not ported)")


def plan(
    model: str,
    devices: int,
    profile: Optional[CalibrationProfile] = None,
    batch_size: Optional[int] = None,
    optimizer: str = "adam",
    seq_len: Optional[int] = None,
    model_kw: Optional[Dict] = None,
    rule_search: bool = True,
    validate: bool = False,
    seq_attn: str = "ring",
    device: str = "cuda",
) -> dict:
    """Rank candidate configurations for ``model`` on ``devices`` devices.

    Returns ``{"model", "devices", "global_batch", "profile", "candidates":
    [Candidate.to_dict(), ...ranked fastest-first], "top": <label>}`` (and
    with ``validate``, ``measured_fastest`` and ``agreement``). The walk
    needs no device; ``device`` ("cuda" or "cpu") picks the default
    profile and where ``validate`` measures."""
    from pytorch_distributed_nn_tpu_torch.analysis import costmodel
    from pytorch_distributed_nn_tpu_torch.models import is_text_model

    model_name = MODEL_ALIASES.get(model, model)
    text = is_text_model(model_name)
    if profile is None:
        profile = default_profile("gpu" if device == "cuda" else "cpu")
    model_kw = dict(model_kw or {})
    batch = batch_size or 2 * devices

    candidates: List[Candidate] = []
    for dp, tp, sp in enumerate_meshes(devices, text):
        total = dp * tp * sp
        labels = ("default",) + (RULE_OVERRIDES if text and rule_search
                                 and tp > 1 else ())
        cost = None
        for rules_label in labels:
            cand = Candidate(
                mesh=(dp, tp, sp), rules=rules_label, devices=total,
                predicted_ms=float("inf"), compute_ms=0.0, ici_ms=0.0,
                cost={},
            )
            try:
                if rules_label != "default":
                    raise ValueError(RULES_NOT_PORTED)
                if cost is None:
                    cost = costmodel.walk_step(
                        model_name, (dp, tp, sp), batch, optimizer,
                        seq_len, model_kw, seq_attn)[0].to_dict()
                cand.cost = cost
                pred = predict_step_ms(cand.cost, profile, devices=total)
                cand.predicted_ms = pred["predicted_ms"]
                cand.compute_ms = pred["compute_ms"]
                cand.ici_ms = pred["ici_ms"]
            except ValueError as e:
                cand.skipped = str(e)
                logger.info("plan: skipping %s: %s", cand.label(), e)
            candidates.append(cand)

    ranked = sorted(
        (c for c in candidates if c.skipped is None),
        key=lambda c: c.predicted_ms,
    ) + [c for c in candidates if c.skipped is not None]
    if validate:
        for c in ranked:
            if c.skipped is None:
                _validate(c, model_name, text, batch, optimizer, seq_len,
                          model_kw, seq_attn, device)
    result = {
        "model": model_name,
        "devices": devices,
        "global_batch": batch,
        "profile": {"name": profile.name, "source": profile.source},
        "candidates": [c.to_dict() for c in ranked],
        "top": ranked[0].label() if ranked and not ranked[0].skipped
        else None,
    }
    if validate:
        measured = [
            c for c in ranked
            if c.skipped is None and c.measured_ms is not None
        ]
        if measured:
            fastest = min(measured, key=lambda c: c.measured_ms)
            result["measured_fastest"] = fastest.label()
            result["agreement"] = fastest.label() == result["top"]
    return result


# ---------------------------------------------------------------------------
# Validation: the candidate's ranks train a few steps
# ---------------------------------------------------------------------------


def _cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _train_config(model_name: str, text: bool, mesh_dims, batch: int,
                  optimizer: str, seq_len: Optional[int], model_kw: dict,
                  seq_attn: str) -> dict:
    """The ``TrainConfig`` fields a candidate's ranks train with."""
    dp, tp, sp = mesh_dims
    cfg = dict(network=model_name, batch_size=batch, num_workers=dp,
               tensor_parallel=tp, seq_parallel=sp, optimizer=optimizer,
               lr=1e-4 if optimizer == "adam" else 0.01,
               max_steps=MEASURE_STEPS, test_batch_size=batch, seed=0)
    if text:
        # the zoo model at its widths: TrainConfig takes no width flags
        cfg.update(dataset="MLMSynth", seq_len=seq_len, eval_batches=1,
                   attn_impl="pallas" if sp == 1 else "full",
                   fused_ln=tp == 1 and sp == 1, seq_attn=seq_attn,
                   vocab_size=model_kw.get("vocab_size"),
                   dtype=model_kw.get("dtype", "bfloat16"))
    else:
        cfg.update(dataset="MNIST" if model_name == "LeNet" else "Cifar10",
                   synthetic_size=batch * (MEASURE_STEPS + 1),
                   data_layout="device")
    return cfg


def _validate(cand: Candidate, model_name: str, text: bool, batch: int,
              optimizer: str, seq_len, model_kw: dict, seq_attn: str,
              device: str) -> None:
    """Measure ``cand`` by its ranks' processes (module doc)."""
    from pytorch_distributed_nn_tpu_torch.parallel.launch import (
        RankProcesses,
    )

    world = cand.devices
    if device == "cuda":
        cards = _cards()
        if world > cards:
            cand.unmeasured = (f"needs {world} cards, the host has {cards}"
                               " (ranks never share a card)")
            return
    with tempfile.TemporaryDirectory(prefix="pdtn_plan_") as tmp:
        job = os.path.join(tmp, "job.json")
        out = os.path.join(tmp, "result.json")
        with open(job, "w") as f:
            json.dump({"config": _train_config(
                model_name, text, cand.mesh, batch, optimizer, seq_len,
                model_kw, seq_attn), "device": device, "out": out,
                "train_dir": os.path.join(tmp, "train")}, f)
        env = dict(os.environ)
        if device != "cuda":
            env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
        ranks = RankProcesses.start(
            [sys.executable, "-m", __name__, "--measure-rank", job], world,
            env, logs=logs)
        ranks.join(MEASURE_TIMEOUT_S)
        rc = ranks.exitcode
        if rc is None:
            ranks.kill()
            cand.unmeasured = f"timed out after {MEASURE_TIMEOUT_S:g} s"
            return
        if rc != 0 or not os.path.exists(out):
            bad = ranks.failed if ranks.failed is not None else 0
            with open(logs[bad], errors="replace") as f:
                tail = f.read()[-600:]
            cand.unmeasured = f"rank {bad} exited {rc}: {tail}"
            return
        with open(out) as f:
            res = json.load(f)
    cand.measured_ms = float(res["measured_ms"])
    cand.launches = res["launches"]


def _measure_rank(job_path: str) -> int:
    """One rank of a validation launch (``--measure-rank JOB``): train
    the candidate's configuration; rank 0 writes the median step ms past
    :data:`MEASURE_WARMUP` and its kernel launch counts."""
    with open(job_path) as f:
        job = json.load(f)
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import kernels
    from pytorch_distributed_nn_tpu_torch.training.trainer import (
        TrainConfig,
        Trainer,
    )

    if job["device"] != "cuda":
        torch.set_num_threads(1)
    cfg = TrainConfig(train_dir=job["train_dir"], **job["config"])
    trainer = Trainer(cfg, device=None if job["device"] == "cuda"
                      else job["device"])
    kernels.reset_launch_counts()
    history = trainer.train()
    if trainer.rank == 0:
        ms = [r["step_ms"] for r in history[MEASURE_WARMUP:]]
        with open(job["out"] + ".tmp", "w") as f:
            json.dump({"measured_ms": statistics.median(ms),
                       "launches": kernels.launch_counts()}, f)
        os.replace(job["out"] + ".tmp", job["out"])
    return 0


# ---------------------------------------------------------------------------
# Rendering (copied from the JAX package)
# ---------------------------------------------------------------------------


def render_plan(result: dict) -> str:
    """Human-readable ranked table."""
    lines = [
        f"plan: {result['model']} over {result['devices']} device(s), "
        f"global batch {result['global_batch']}, profile "
        f"{result['profile']['name']} ({result['profile']['source']})",
        "",
        f"  {'rank':>4} {'mesh (dp x tp x sp)':<26} {'pred ms':>9} "
        f"{'compute':>9} {'ici':>8} {'measured':>9}",
    ]
    rank = 0
    for c in result["candidates"]:
        if c.get("skipped"):
            lines.append(
                f"     - {_mesh_label(c):<26} skipped: {c['skipped']}"
            )
            continue
        rank += 1
        meas = (
            f"{c['measured_ms']:>9.2f}" if c.get("measured_ms") is not None
            else f"{'-':>9}"
        )
        lines.append(
            f"  {rank:>4} {_mesh_label(c):<26} {c['predicted_ms']:>9.2f} "
            f"{c['compute_ms']:>9.2f} {c['ici_ms']:>8.2f} {meas}"
        )
    if result.get("top"):
        lines.append("")
        lines.append(f"predicted fastest: {result['top']}")
    if "measured_fastest" in result:
        lines.append(
            f"measured fastest:  {result['measured_fastest']} "
            f"({'AGREE' if result.get('agreement') else 'DISAGREE'})"
        )
    return "\n".join(lines)


def _mesh_label(c: dict) -> str:
    m = c["mesh"]
    out = (
        f"{m['data']}x{m['model']}x{m['seq']}"
        if (m["model"] > 1 or m["seq"] > 1) else str(m["data"])
    )
    if c.get("rules") and c["rules"] != "default":
        out += f" [{c['rules']}]"
    return out


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--measure-rank":
        sys.exit(_measure_rank(sys.argv[2]))
    sys.exit("usage: python -m pytorch_distributed_nn_tpu_torch.analysis."
             "planner --measure-rank JOB.json")
