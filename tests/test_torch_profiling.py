"""The port's ``torch.profiler`` summaries (``utils/profiling.py``,
``observability/xplane.py``) on a synthetic Chrome trace of known
layout: kernel names, the four families (a GEMM's direction read from
the autograd op that launched it), the folded tail summing to the
total, the port's kernels never folded, device time per step and the
NCCL/compute overlap; then real CPU traces, which hold no device event
and degrade cleanly, and the trainer's ``--profile`` window."""

import json
import os

import pytest

import torch_cpu  # noqa: F401  (one intra-op thread)
from pytorch_distributed_nn_tpu_torch.observability import xplane
from pytorch_distributed_nn_tpu_torch.utils import profiling

GEMM = ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
        "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas")
FLASH = ("void flash_fwd_tc_kernel<__nv_bfloat16, 64>(__nv_bfloat16 const*, "
         "float*)")
LN_BWD = ("void (anonymous namespace)::ln_bwd_vec_kernel<__nv_bfloat16, "
          "float, 768, 8, 1, 256, 2>(float const*, int)")
QUANT = "quant_group_kernel(LeafGroup const*, int)"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3> >"
       "(int, at::native::CUDAFunctor_add<float>, at::detail::Array<char*, "
       "3>)")
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"


@pytest.mark.parametrize("name,base,family", [
    (GEMM + " [fwd]", GEMM, "convert_reduce_fusion"),
    (GEMM + " [bwd]", GEMM, "multiply_add_fusion"),
    (FLASH, "flash_fwd_tc_kernel", "convert_reduce_fusion"),
    ("flash_dkv_3xtf32_kernel", "flash_dkv_3xtf32_kernel",
     "multiply_add_fusion"),
    (LN_BWD, "ln_bwd_vec_kernel", "multiply_add_fusion"),
    ("decode_attn_kernel", "decode_attn_kernel", "convert_reduce_fusion"),
    (QUANT, "quant_group_kernel", "other"),
    ("dequant_kernel", "dequant_kernel", "other"),
    (ADD, "vectorized_elementwise_kernel", "elementwise"),
    (NCCL, "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "other"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD", "other"),
    ("Memset (Device)", "Memset", "other"),
    ("(other 4 ops)", "(other 4 ops)", "other"),
    # names a trace kept mangled
    ("_Z23flash_fwd_3xtf32_kernelILi64ELi16ELi2ELi3EEvPKfS1_S1_Pf",
     "flash_fwd_3xtf32_kernel", "convert_reduce_fusion"),
    ("_ZN12_GLOBAL__N_117ln_fwd_vec_kernelIffLi768ELi6ELi256ELi2EEEvPKT_",
     "ln_fwd_vec_kernel", "convert_reduce_fusion"),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolution"
     "IiEEEEvNT_6ParamsE", "Kernel", "convert_reduce_fusion"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEE"
     "EEviT0_T1_", "vectorized_elementwise_kernel", "elementwise"),
])
def test_kernel_names_and_families(name, base, family):
    raw = name[:-6] if name.endswith(("[fwd]", "[bwd]")) else name
    assert profiling.kernel_base_name(raw) == base
    assert profiling.op_family(name) == family


def _x(cat, name, ts, dur, pid=0, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _trace():
    """Two steps on device 0: a forward GEMM launched by a forward op, the
    same GEMM launched under autograd's backward on the backward thread,
    the port's flash forward, LayerNorm backward and quantize, many small
    elementwise kernels, a copy; an NCCL kernel on stream 20 over
    [1000, 1100) us with compute on stream 7 at [1050, 1150) and
    [980, 1020)."""
    ev, corr = [], [0]

    def launch(name, ts, dur, host_tid, host_ts, stream=7):
        corr[0] += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", host_ts, 2,
                     tid=host_tid, correlation=corr[0]))
        ev.append(_x("kernel", name, ts, dur, pid=0, tid=stream, device=0,
                     stream=stream, correlation=corr[0]))

    # a session's lead-in (utils/profiling.py): not the program's
    for i in range(3):
        launch("void at::cuda::(anonymous namespace)::spin_kernel(long)",
               i * 2.0, 1.0, 1, i * 2.0)
    for step in range(2):
        t = step * 500.0
        ev.append(_x("cpu_op", "aten::mm", t, 20, tid=1))
        launch(GEMM, t + 100, 40, 1, t + 5)
        ev.append(_x("cpu_op", "autograd::engine::evaluate_function: "
                     "MmBackward0", t + 30, 20, tid=2))
        launch(GEMM, t + 150, 60, 2, t + 35)
        launch(FLASH, t + 220, 10, 1, t + 8)
        launch(LN_BWD, t + 240, 3, 2, t + 40)
        launch(QUANT, t + 250, 2, 1, t + 10)
        for i in range(6):
            launch(f"elementwise_kernel_{i}<float>(float*)", t + 260 + i * 5,
                   1 + i, 1, t + 12)
        ev.append(_x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)",
                     t + 300, 4, tid=7, device=0, stream=7))
    launch(NCCL, 1000, 100, 1, 990, stream=20)
    launch(ADD, 1050, 100, 1, 995)
    launch(ADD, 980, 40, 1, 996)
    ev.append(_x("cpu_op", "aten::add", 0, 1, tid=1))  # host only
    return {"traceEvents": ev}


@pytest.fixture
def trace_dir(tmp_path):
    d = tmp_path / "profile" / "sub"
    d.mkdir(parents=True)
    (d / "h_1.1000.pt.trace.json").write_text(json.dumps(_trace()))
    # an older, emptier trace beside it is not the one read
    old = d / "h_1.0001.pt.trace.json"
    old.write_text(json.dumps({"traceEvents": []}))
    os.utime(old, (1, 1))
    return str(tmp_path / "profile")


def test_summary_folds_the_tail_and_keeps_the_port_kernels(trace_dir):
    full = profiling.summarize_trace(trace_dir, top=10**6)
    assert set(full) == {"GPU 0 stream 7", "GPU 0 stream 20"}
    assert not any("spin" in r.name for rows in full.values() for r in rows)
    s7 = {r.name: r for r in full["GPU 0 stream 7"]}
    assert s7[GEMM + " [fwd]"].count == 2 and s7[GEMM + " [fwd]"].total_ms \
        == pytest.approx(0.08)
    assert s7[GEMM + " [bwd]"].total_ms == pytest.approx(0.12)
    assert s7["flash_fwd_tc_kernel"].count == 2
    assert s7["Memcpy HtoD"].count == 2
    total7 = sum(r.total_ms for r in full["GPU 0 stream 7"])
    short = profiling.summarize_trace(trace_dir, top=2)["GPU 0 stream 7"]
    names = [r.name for r in short]
    assert names[:2] == ["vectorized_elementwise_kernel", GEMM + " [bwd]"]
    # the port's small kernels stay rows; everything else folds into one
    assert {"flash_fwd_tc_kernel", "ln_bwd_vec_kernel",
            "quant_group_kernel"} <= set(names)
    assert names[-1].startswith("(other ")
    assert sum(r.total_ms for r in short) == pytest.approx(total7)
    assert sum(r.count for r in short) == sum(
        r.count for r in full["GPU 0 stream 7"])
    assert sum(r.pct for r in short) == pytest.approx(100.0)


def test_families_step_time_and_overlap(trace_dir):
    summary = profiling.summarize_trace(trace_dir, top=10**6)
    fams = profiling.family_summary(summary)
    assert list(fams) == list(profiling.FAMILIES)
    assert fams["convert_reduce_fusion"]["total_ms"] == pytest.approx(
        0.08 + 0.02)  # GEMM fwd + flash fwd
    assert fams["multiply_add_fusion"]["total_ms"] == pytest.approx(
        0.12 + 0.006)  # GEMM bwd + LN bwd
    assert fams["other"]["total_ms"] == pytest.approx(
        0.004 + 0.008 + 0.1)  # quantize, copies, NCCL
    assert fams["elementwise"]["count"] == 14
    total = sum(r.total_ms for rows in summary.values() for r in rows)
    assert profiling.device_step_time_ms(trace_dir, 2) == pytest.approx(
        total / 2)
    assert profiling.collective_overlap_report(trace_dir) == {
        "collective_in_flight_ms": 0.1, "overlapped_compute_ms": 0.07,
        "exposed_ms": 0.03, "overlap_ratio": 0.7}
    text = xplane.trace_summary_text(trace_dir)
    assert "GPU 0 stream 7" in text and "per family" in text


def test_overlap_reads_zero_without_collectives(tmp_path):
    doc = _trace()
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if "nccl" not in e["name"]]
    (tmp_path / "a.pt.trace.json").write_text(json.dumps(doc))
    assert profiling.collective_overlap_report(str(tmp_path)) == {
        "collective_in_flight_ms": 0.0, "overlapped_compute_ms": 0.0,
        "exposed_ms": 0.0, "overlap_ratio": 0.0}


def test_xplane_main_prints_the_tables(trace_dir, capsys):
    assert xplane.main([trace_dir, "--steps", "2", "--overlap"]) == 0
    out = capsys.readouterr().out
    assert "ms/step over 2 steps" in out and "overlap_ratio" in out


def test_cpu_trace_degrades_cleanly(tmp_path, capsys):
    import torch

    d = str(tmp_path / "cpu")
    with profiling.trace_span(d):
        torch.ones(8).add_(1).sum()
    assert not profiling.trace_active()
    assert profiling.find_trace(d).endswith(".pt.trace.json")
    assert profiling.summarize_trace(d) == {}
    assert profiling.device_step_time_ms(d, 1) is None
    assert "no device planes" in xplane.trace_summary_text(d)
    assert xplane.main([d]) == 1
    with pytest.raises(FileNotFoundError):
        profiling.find_trace(str(tmp_path / "none"))
    profiling.start_trace(d)
    try:
        with pytest.raises(RuntimeError, match="already open"):
            profiling.start_trace(d)
    finally:
        profiling.stop_trace()


@pytest.mark.parametrize("max_steps,window", [(4, 2), (2, 5)])
def test_trainer_profile_window(tmp_path, max_steps, window):
    """--profile N traces steps 2..N+1; a run that ends inside the window
    still stops and writes its trace."""
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    trainer = Trainer(TrainConfig(
        network="LeNet", dataset="MNIST", batch_size=16, synthetic_size=32,
        test_batch_size=16, max_steps=max_steps, profile_steps=window,
        train_dir=str(tmp_path)), device="cpu")
    try:
        history = trainer.train()
    finally:
        trainer.close()
    assert len(history) == max_steps and not profiling.trace_active()
    assert trainer.last_profile is not None
    path = profiling.find_trace(str(tmp_path / "profile"))
    names = {e.get("name") for e in profiling.load_trace(path)["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
