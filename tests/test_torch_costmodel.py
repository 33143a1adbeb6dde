"""The port's cost model, calibration, planner and run metrics
(``pytorch_distributed_nn_tpu_torch/analysis``) against the JAX
package's, on the CPU at small sizes.

The JAX package counts a step by walking its HLO; the port by walking
one step's dispatched operations on the meta device. Held against each
other: hand-checked matmul and convolution (FLOPs and bytes equal to the
JAX walk's), the LeNet dp step at 2 ranks (FLOPs within 5% of the JAX
step's ``lowered.cost_analysis()``, ICI bytes within 1% of its audit's
ring estimate), BertTiny (within 3% of the JAX plain-attention step's
``lowered.cost_analysis()``), and the closed forms copied from the JAX
package (decode cost, roofline prediction) exactly. The trainer stamps
its step cost only with a telemetry sink, and a port stream that times
its steps in ``step_ms`` gets the JAX stream's MFU gauge and efficiency
section.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.analysis import calibration as jax_cal
from pytorch_distributed_nn_tpu.analysis import costmodel as jax_cost
from pytorch_distributed_nn_tpu.analysis import planner as jax_planner
from pytorch_distributed_nn_tpu.analysis import run_metrics as jax_rm
from pytorch_distributed_nn_tpu_torch.analysis import (
    calibration,
    costmodel,
    planner,
    run_metrics,
)
from pytorch_distributed_nn_tpu_torch.models import build_model, input_spec
from pytorch_distributed_nn_tpu_torch.ops import kernels
from pytorch_distributed_nn_tpu_torch.optim import (
    build_optimizer,
    make_schedule,
)
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    make_grad_sync,
)
from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    fake_group,
    make_mesh,
)
from pytorch_distributed_nn_tpu_torch.training.spmd import spmd_audit_bundle
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    dp_audit_bundle,
)
from pytorch_distributed_nn_tpu_torch.utils import profiling

import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_ranks import run_ranks

#: the port's walk against the JAX step's lowered.cost_analysis(): LeNet
#: (the JAX walk's own band against its oracle is 30%), BertTiny
LENET_BAND, BERT_BAND = 0.05, 0.03


def _opt(name, lr=1e-3):
    return lambda params: build_optimizer(name, params, make_schedule(lr))


def _jax_walk(fn, *args):
    return jax_cost.step_cost_from_hlo(
        jax.jit(fn).lower(*args).as_text(dialect="hlo"))


def _seeded(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# hand-checked shapes
# ---------------------------------------------------------------------------


def test_matmul_flops_and_bytes_equal_the_jax_walk():
    a, b = _seeded((64, 128), 0), _seeded((128, 32), 1)
    want = _jax_walk(lambda a, b: a @ b, jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).to("meta") for x in (a, b))
    got = costmodel.step_cost_from_walk(torch.mm, (ta, tb))
    assert got.flops == want.hlo_flops == 2 * 64 * 32 * 128
    assert got.hbm_bytes == want.hbm_bytes == 4 * (64 * 128 + 128 * 32
                                                   + 64 * 32)
    assert got.families["convert_reduce_fusion"].flops == got.flops


def test_conv_flops_and_bytes_equal_the_jax_walk():
    x, k = _seeded((2, 8, 8, 4), 2), _seeded((3, 3, 4, 8), 3)

    def conv(x, k):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = _jax_walk(conv, jnp.asarray(x), jnp.asarray(k))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to("meta")
    tk = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().to("meta")
    got = costmodel.step_cost_from_walk(torch.nn.functional.conv2d,
                                        (tx, tk))
    assert got.flops == want.hlo_flops == 2 * (2 * 6 * 6 * 8) * 3 * 3 * 4
    assert got.hbm_bytes == want.hbm_bytes


# ---------------------------------------------------------------------------
# whole steps against the JAX package
# ---------------------------------------------------------------------------


def _jax_lenet_dp2():
    from pytorch_distributed_nn_tpu import analysis
    from pytorch_distributed_nn_tpu.models import build_model as jbuild
    from pytorch_distributed_nn_tpu.models import input_spec as jspec
    from pytorch_distributed_nn_tpu.optim import build_optimizer as jopt
    from pytorch_distributed_nn_tpu.parallel import make_grad_sync as jsync
    from pytorch_distributed_nn_tpu.parallel import make_mesh as jmesh
    from pytorch_distributed_nn_tpu.training import dp_audit_bundle as jdp

    bundle = jdp(jbuild("LeNet", 10), jopt("sgd", 0.1), jsync("allreduce"),
                 jmesh(2, 1, 1), jspec("LeNet"), 8)
    ca = bundle["step_fn"].lower(*bundle["args"]).cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return ca["flops"], analysis.audit(**bundle)


def test_lenet_dp_step_at_two_ranks_against_jax():
    """Rank 0's walk of the 2-rank LeNet step (4 rows of 8): families
    partition the totals exactly, FLOPs within 5% of the JAX step's
    lowered count, ICI within 1% of the JAX audit's ring estimate, and
    the collectives are the gradient all-reduce and the metrics'."""
    with torch.device("meta"):
        model = build_model("LeNet", 10)
    bundle = dp_audit_bundle(model, _opt("sgd", 0.1),
                             make_grad_sync(fake_group(0, 2), "allreduce"),
                             input_spec("LeNet"), 8)
    sc = costmodel.step_cost_from_walk(bundle["step_fn"], bundle["args"])
    assert sum(f.flops for f in sc.families.values()) == sc.flops
    assert sum(f.hbm_bytes for f in sc.families.values()) == sc.hbm_bytes
    assert sc.families["convert_reduce_fusion"].flops > 0
    assert sc.families["multiply_add_fusion"].flops > 0
    assert sc.source == "walk" and sc.xla_flops is None
    jax_flops, report = _jax_lenet_dp2()
    assert sc.flops == pytest.approx(jax_flops, rel=LENET_BAND)
    assert sc.ici_bytes == pytest.approx(report.est_ici_bytes_per_step(),
                                         rel=0.01)
    params = sum(p.numel() for p in bundle["params"])
    assert sorted((c.kind, c.shape, c.group_size)
                  for c in sc.collectives) == [
        ("all-reduce", (3,), 2), ("all-reduce", (params,), 2)]
    assert set(sc.to_dict()) == set(report.cost.to_dict())


def _bert_walk(attn_fn, B=8, L=128):
    mesh = make_mesh(fake_group(0, 1), 1, 1, 1)
    with torch.device("meta"):
        model = build_model("BertTiny", mesh=mesh, attn_fn=attn_fn)
    bundle = spmd_audit_bundle(model, _opt("adam"), mesh, (B, L))
    return costmodel.step_cost_from_walk(bundle["step_fn"], bundle["args"])


def test_bert_tiny_against_jax_and_flash_equals_plain():
    """BertTiny's step within 3% of the JAX plain-attention step's
    lowered count; the flash path walks to exactly the plain path's
    FLOPs (each kernel is charged the function it computes), with the
    flash kernels' work in their compute families."""
    from pytorch_distributed_nn_tpu.models import build_model as jbuild
    from pytorch_distributed_nn_tpu.optim import build_optimizer as jopt
    from pytorch_distributed_nn_tpu.parallel import make_mesh as jmesh
    from pytorch_distributed_nn_tpu.training import spmd_audit_bundle as jsa

    plain = _bert_walk(None)
    flash = _bert_walk(kernels.flash_attention)
    jb = jsa(jbuild("BertTiny", 0), jopt("adam", 1e-3), jmesh(1, 1, 1),
             (8, 128))
    ca = jb["step_fn"].lower(*jb["args"]).cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    assert plain.flops == pytest.approx(ca["flops"], rel=BERT_BAND)
    assert flash.flops == plain.flops
    # the flash forward is forward compute, its backward kernels
    # backward compute: the GEMM families hold more than the plain path's
    assert (flash.families["convert_reduce_fusion"].flops
            > plain.families["convert_reduce_fusion"].flops)
    assert (flash.families["elementwise"].flops
            < plain.families["elementwise"].flops)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked,causal", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_flash_charge_equals_the_plain_attention(dtype, masked, causal):
    """The charge table's flash forward and backward equal the walk of
    the plain attention (``models.transformer.full_attention``) on the
    same shapes, mask and causal flag: the same work whatever
    implements it."""
    from pytorch_distributed_nn_tpu_torch.models.transformer import (
        full_attention,
    )

    def walk(fn):
        q, k, v = (torch.empty(2, 16, 4, 32, device="meta", dtype=dtype,
                               requires_grad=True) for _ in range(3))
        mask = (torch.ones(2, 16, dtype=torch.int64, device="meta")
                if masked else None)

        def step():
            fn(q, k, v, mask, causal=causal).float().sum().backward()

        return costmodel.step_cost_from_walk(step)

    assert walk(kernels.flash_attention).flops == walk(full_attention).flops


def test_int8_resnet_step_charges_the_grouped_quantize():
    """The int8 sync's grouped quantize is charged in the step's cost,
    in the ``other`` family (the codec), by its function: 5 FLOPs an
    element of the leaves it takes."""
    from pytorch_distributed_nn_tpu_torch.ops.compression import (
        QUANT_KERNEL_MIN_SIZE,
    )

    calls = []
    with torch.device("meta"):
        model = build_model("ResNet18", 10, dtype="bfloat16")
    bundle = dp_audit_bundle(
        model, _opt("sgd", 0.05),
        make_grad_sync(fake_group(0, 1), "allreduce", compression="int8"),
        input_spec("ResNet18"), 4)
    walk = costmodel._Walk()
    hook = walk.charge_kernel

    def spy(name, ins, outs, **kw):
        calls.append((name, sum(o.numel() for o in outs)))
        hook(name, ins, outs, **kw)

    with walk, kernels.charging(spy):
        bundle["step_fn"](*bundle["args"])
    big = sum(p.numel() for p in bundle["params"]
              if p.numel() >= QUANT_KERNEL_MIN_SIZE)
    assert calls == [("quantize_int8_scaled", big)]
    assert walk.families["other"].flops == 5.0 * big


def test_host_read_on_meta_raises_and_unknown_ops_are_named():
    x = torch.empty(4, device="meta")
    with pytest.raises(costmodel.WalkError, match="host"):
        costmodel.step_cost_from_walk(lambda: float(x.sum()))
    # a host op on CPU tensors runs for real and is counted, not charged
    sc = costmodel.step_cost_from_walk(
        lambda: torch.randperm(4, generator=torch.Generator()))
    assert sc.flops == 0 and sc.host_ops == {"randperm": 1}
    # an op with no rule raises, naming it: the walk never skips an op
    sorted_ = torch.empty(8, device="meta")
    with pytest.raises(costmodel.WalkError,
                       match=r"no rule for aten\.searchsorted"):
        costmodel.step_cost_from_walk(
            lambda: torch.searchsorted(sorted_, x))


def test_family_rule_is_shared_with_the_trace_summaries():
    fam = profiling.family
    assert fam(profiling.COMPUTE, backward=True) == profiling.op_family(
        "ampere_sgemm_128x64_nn [bwd]") == "multiply_add_fusion"
    for name, (prefix, _) in costmodel.KERNEL_CHARGES.items():
        assert fam(profiling.KERNEL, kernel=prefix) == profiling.op_family(
            f"void {prefix}kernel<float>(float*)"), name
    assert profiling.op_family("ncclDevKernel_AllReduce") == fam(
        profiling.OTHER) == "other"


# ---------------------------------------------------------------------------
# closed forms and calibration, exactly the JAX package's
# ---------------------------------------------------------------------------


def test_decode_cost_and_prediction_equal_jax():
    kw = dict(num_layers=4, d_model=128, d_ff=512, vocab_size=1024,
              cache_len=96, batch=8, kv_bytes_per_elem=2)
    got, want = costmodel.decode_phase_cost(**kw), jax_cost.decode_phase_cost(
        **kw)
    assert got.to_dict() == want.to_dict() and got.to_text() == want.to_text()
    assert got.predicted_tokens_per_s(989e12, 3.35e12) == \
        want.predicted_tokens_per_s(989e12, 3.35e12)
    cost = {"flops": 3e9, "hbm_bytes": 2e8, "ici_bytes": 5e6, "families": {
        "convert_reduce_fusion": {"flops": 1e9, "hbm_bytes": 5e7},
        "multiply_add_fusion": {"flops": 2e9, "hbm_bytes": 5e7},
        "elementwise": {"flops": 1e6, "hbm_bytes": 1e8}}}
    for backend in ("cpu", "tpu"):
        for devices in (1, 4):
            assert calibration.predict_step_ms(
                cost, calibration.default_profile(backend), devices) == \
                jax_cal.predict_step_ms(
                    cost, jax_cal.default_profile(backend), devices)


def test_calibration_json_read_both_ways(tmp_path):
    port = calibration.default_profile("cuda", "float32")
    assert port.peak_flops_per_s == 67e12 and port.backend == "gpu"
    assert calibration.peak_flops_per_device("gpu", "NVIDIA H100 80GB HBM3",
                                             "bfloat16") == 989e12
    p1 = str(tmp_path / "port.json")
    port.save(p1)
    back = jax_cal.CalibrationProfile.load(p1)
    assert {**back.to_dict(), "source": "default"} == port.to_dict()
    p2 = str(tmp_path / "jax.json")
    jax_cal.default_profile("tpu").save(p2)
    got = calibration.CalibrationProfile.load(p2)
    assert got.to_dict() == {**jax_cal.default_profile("tpu").to_dict(),
                             "source": "file"}


def _chrome_trace(path, kernels_us):
    """A Chrome trace with one kernel event per (name, us)."""
    events, t = [], 0.0
    for i, (name, us) in enumerate(kernels_us):
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": t,
                       "dur": us, "pid": 0, "tid": 7,
                       "args": {"device": 0, "stream": 7,
                                "correlation": i}})
        t += us
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "h_1.1.pt.trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)


def test_fit_from_trace_on_a_synthetic_chrome_trace(tmp_path):
    tdir = str(tmp_path / "profile")
    _chrome_trace(tdir, [("flash_fwd_tc_kernel", 10000.0),
                         ("flash_dq_tc_kernel", 5000.0),
                         ("vectorized_elementwise_kernel", 2000.0),
                         ("ncclDevKernel_AllReduce_Sum_f32", 2000.0)])
    cost = {"flops": 1.51e9, "ici_bytes": 1e6, "families": {
        "convert_reduce_fusion": {"flops": 1e9, "hbm_bytes": 1e8},
        "multiply_add_fusion": {"flops": 5e8, "hbm_bytes": 5e7},
        "elementwise": {"flops": 1e7, "hbm_bytes": 2e7},
        "other": {"flops": 0.0, "hbm_bytes": 0.0}}}
    base = calibration.default_profile("gpu")
    prof = calibration.fit_from_trace(tdir, cost, steps=4, base=base)
    assert prof.source == "trace"
    assert prof.compute_ceilings["convert_reduce_fusion"] == \
        pytest.approx(1e9 * 4 / 0.010)
    assert prof.compute_ceilings["multiply_add_fusion"] == \
        pytest.approx(5e8 * 4 / 0.005)
    assert prof.hbm_bytes_per_s == pytest.approx(2e7 * 4 / 0.002)
    assert prof.ici_bytes_per_s == pytest.approx(1e6 * 4 / 0.002)
    assert prof.compute_ceilings["other"] == \
        calibration.default_profile("gpu").compute_ceilings["other"]
    path = prof.save(str(tmp_path / "calibration.json"))
    assert jax_cal.CalibrationProfile.load(path).compute_ceilings == \
        prof.compute_ceilings
    cpu_only = str(tmp_path / "cpu")
    _chrome_trace(cpu_only, [])
    with pytest.raises(ValueError, match="no device events"):
        calibration.fit_from_trace(cpu_only, cost, 1)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def _jax_labels(devices, text):
    out = []
    for dp, tp, sp in jax_planner.enumerate_meshes(devices, text):
        for rules, _ in (jax_planner._rule_variants(tp) if text
                         else [("default", None)]):
            out.append(jax_planner.Candidate(
                mesh=(dp, tp, sp), rules=rules, devices=dp * tp * sp,
                predicted_ms=0.0, compute_ms=0.0, ici_ms=0.0,
                cost={}).label())
    return sorted(out)


def _labels(result):
    return sorted(jax_planner._mesh_label(c) for c in result["candidates"])


def test_plan_lenet_two_devices_like_jax():
    got = planner.plan("lenet", 2, batch_size=4, optimizer="sgd",
                       device="cpu")
    want = jax_planner.plan("lenet", 2, batch_size=4, optimizer="sgd")
    assert _labels(got) == _labels(want) == _jax_labels(2, False)
    # the CPU profile is shared-substrate: dp 1 ranks first in both
    assert got["candidates"][0]["mesh"] == want["candidates"][0]["mesh"] \
        == {"data": 1, "model": 1, "seq": 1}
    assert got["top"] == want["top"] == "1"
    assert set(got) == set(want)
    assert set(got["candidates"][0]) == set(want["candidates"][0])
    assert all(c["predicted_ms"] > 0 for c in got["candidates"])
    assert planner.render_plan(got).splitlines()[-1] == \
        "predicted fastest: 1"


def test_plan_bert_tiny_four_devices_has_the_jax_candidates():
    """Every JAX candidate label, rule overrides included; the overrides
    are skipped (the port's model splits by DEFAULT_RULES alone) and
    every mesh walks under a fake group of its ranks."""
    got = planner.plan("bert_tiny", 4, device="cpu")
    assert _labels(got) == _jax_labels(4, True)
    for c in got["candidates"]:
        if c["rules"] == "default":
            assert c["skipped"] is None and c["predicted_ms"] > 0
        else:
            assert "DEFAULT_RULES" in c["skipped"]
    tp2 = next(c for c in got["candidates"]
               if c["mesh"] == {"data": 2, "model": 2, "seq": 1})
    assert tp2["ici_bytes_per_device"] > 0


# ---------------------------------------------------------------------------
# run metrics
# ---------------------------------------------------------------------------


def test_run_metrics_equal_jax_on_one_stream(tmp_path):
    from pytorch_distributed_nn_tpu.observability import reader as jreader

    path = jreader.write_synthetic_run(str(tmp_path), steps=15)
    got, want = run_metrics.load_metrics(path), jax_rm.load_metrics(path)
    assert got == want
    assert run_metrics.summarize(got) == jax_rm.summarize(want)
    assert run_metrics.time_cost_report(got) == jax_rm.time_cost_report(
        want)
    assert run_metrics.speedup(got, got[::-1]) == jax_rm.speedup(
        want, want[::-1])
    # a port stream (step_ms, images_per_sec) summarizes alike
    port = [{k: v for k, v in r.items()
             if k not in ("step_time", "imgs_per_sec")}
            | {"step_ms": r["step_time"] * 1e3,
               "images_per_sec": r["imgs_per_sec"]} for r in want]
    s = run_metrics.summarize(port)
    assert s["mean_step_time"] == pytest.approx(
        jax_rm.summarize(want)["mean_step_time"], rel=1e-12)


# ---------------------------------------------------------------------------
# the trainer's step cost and the step_ms repair
# ---------------------------------------------------------------------------


def test_port_stream_with_step_ms_gets_mfu_and_efficiency(tmp_path):
    """A stream with a ``step_cost`` whose records time their steps in
    ``step_ms`` (the port's) gets the ``mfu`` gauge and ``obs summary``'s
    efficiency section, as one with ``step_time`` (the JAX trainer's)."""
    from pytorch_distributed_nn_tpu_torch.observability import core, reader

    path = str(tmp_path / "telemetry.jsonl")
    manifest = core.run_manifest(step_cost={
        "flops": 2e8, "hbm_bytes": 1e7, "ici_bytes": 0.0,
        "peak_flops_per_s": 1e11, "peak_hbm_bytes_per_s": 1e10,
        "devices": 1, "source": "walk", "predicted_ms": 8.0})
    tel = core.Telemetry.for_run(path, manifest)
    for step in range(1, 6):
        tel.log_step({"step": step, "loss": 1.0, "step_ms": 10.0})
    tel.close()
    assert tel.registry.get("mfu").value == pytest.approx(0.2)
    eff = reader.summarize_run(reader.read_stream(path))["efficiency"]
    assert eff["mfu"]["overall"] == pytest.approx(0.2)
    assert eff["measured_p50_ms"] == pytest.approx(10.0)


def _lenet_config(path, **kw):
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    return TrainConfig(network="LeNet", dataset="MNIST", synthetic_size=64,
                       batch_size=16, test_batch_size=16, max_steps=3,
                       metrics_path=path, **kw)


def test_two_rank_run_stamps_its_step_cost(tmp_path):
    """A 2-rank gloo LeNet run with ``metrics_path``: rank 0's manifest
    holds the walk's step cost (global, ICI from the sync's payload by
    the ring estimate), ``obs summary`` has an efficiency section and the
    exposition a ``pdtn_mfu`` gauge."""
    from pytorch_distributed_nn_tpu_torch.observability import (
        promexport,
        reader,
    )
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    path = str(tmp_path / "m.jsonl")

    def run(r, group):
        t = Trainer(_lenet_config(path, num_workers=2), device="cpu",
                    group=group)
        try:
            t.train()
        finally:
            t.close()
        return promexport.render(t.telemetry.registry)

    expo = run_ranks(2, run)[0]
    rs = reader.read_stream(path)
    sc = rs.manifest["step_cost"]
    assert sc["source"] == "walk" and sc["devices"] == 2
    assert sc["ici_bytes"] == pytest.approx(rs.manifest[
        "sync_bytes_per_step"])  # 2 P (n - 1) / n at n = 2
    assert sc["ici_bytes"] > 0 and sc["flops"] > 0
    assert sc["peak_flops_per_s"] == 2 * 5e10 and sc["peak_dtype"] == \
        "float32"
    assert reader.summarize_run(rs)["efficiency"]["mfu"]["overall"] > 0
    assert "pdtn_mfu" in expo


def test_a_run_without_a_sink_does_not_walk(tmp_path, monkeypatch):
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    def no_walk(*a, **kw):
        raise AssertionError("walked without a telemetry sink")

    monkeypatch.setattr(costmodel, "step_cost_from_walk", no_walk)
    t = Trainer(_lenet_config(None), device="cpu")
    try:
        assert len(t.train()) == 3
    finally:
        t.close()
    assert t.telemetry.manifest.get("step_cost") is None
