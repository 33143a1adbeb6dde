"""Package rules of the PyTorch port (pytorch_distributed_nn_tpu_torch):
it imports nothing of JAX, flax or the JAX package; its entry points run
on the card unless asked for the CPU; the chip smoke refuses to run
without a card; the CLI serves a generative artifact."""

import ast
import json
import os
import pathlib
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

import torch_cpu  # one intra-op thread here and in subprocesses

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "pytorch_distributed_nn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pytorch_distributed_nn_tpu")


def _port_sources():
    # the card-only tests run where JAX is not installed
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "tests" / "test_torch_cuda.py"]
    assert len(files) > 20
    return files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    # whole-name match: pytorch_distributed_nn_tpu_torch shares a prefix
    # with the JAX package but is not it
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_match_is_by_whole_name():
    assert _forbidden("pytorch_distributed_nn_tpu.ops.host_codec")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("pytorch_distributed_nn_tpu_torch.ops.kernels")
    assert not _forbidden("jaxtyping")


def test_kernel_sources_include_no_torch_headers():
    """The kernels bind through a plain C interface: nvcc builds them in
    seconds, without PyTorch's headers."""
    sources = sorted((PORT / "ops" / "csrc").glob("*.cu"))
    assert [p.stem for p in sources] == ["decode_attention", "flash_attention",
                                         "int8_quant", "layer_norm"]
    for src in sources:
        text = src.read_text()
        assert "torch/" not in text and "ATen" not in text
        assert 'extern "C"' in text


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory, without the package beside it, it fails too
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_resolve_device_never_falls_back_to_the_cpu():
    from pytorch_distributed_nn_tpu_torch.serving.generate.engine import (
        resolve_device,
    )

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


def test_cli_serve_run_on_the_cpu(tmp_path):
    """``python -m pytorch_distributed_nn_tpu_torch serve run --device cpu``
    serves a port-written GptTiny artifact over /v1/generate."""
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        save_artifact,
    )

    model = build_model("GptTiny").init_weights(
        torch.Generator().manual_seed(0))
    art = str(tmp_path / "art")
    save_artifact(art, model.state_dict(), "GptTiny",
                  model_kw={"fused_ln": True})
    port_file = tmp_path / "port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "serve",
         "run", "--artifact", art, "--device", "cpu", "--port", "0",
         "--port-file", str(port_file), "--batch-buckets", "1,2"],
        cwd=REPO, env=torch_cpu.SUBPROCESS_ENV, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
    )
    try:
        deadline = time.monotonic() + 60
        while not port_file.exists() or not port_file.read_text():
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        url = f"http://127.0.0.1:{port_file.read_text()}/v1/generate"
        req = urllib.request.Request(
            url, data=json.dumps({"inputs": [[1, 2, 3]],
                                  "max_new_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            doc = json.loads(r.read())
        assert doc["new_tokens"] == [3]
        assert all(0 <= t < 256 for t in doc["outputs"][0])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:  # never leave a server behind
            proc.kill()
            proc.wait(timeout=30)
    assert os.path.exists(os.path.join(art, "serve", "serving.jsonl"))


def test_ptxas_report_is_read_per_kernel():
    """``native_build.parse_ptxas`` reads nvcc's ``--ptxas-options=-v``
    report into registers, stack and spills per kernel, the template
    arguments demangled (``chip_smoke.py`` fails on a spilling tensor-core
    flash kernel)."""
    from pytorch_distributed_nn_tpu_torch.utils.native_build import (
        parse_ptxas,
    )

    fwd = ("_ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi64EEEvPK13__nv_bfloat16"
           "S3_S3_PKfPS1_PfiiNS_7StridesES8_S8_if")
    dkv = ("_ZN12_GLOBAL__N_123flash_dkv_3xtf32_kernelILi64ELi16ELi2ELi2EEEvPKf"
           "S2_S2_S2_S2_S2_S2_PfS3_iiNS_7StridesES4_S4_S4_if")
    text = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 160 registers, used 1 barriers, 508 bytes "
        "cmem[0]",
        f"ptxas info    : Compiling entry function '{dkv}' for 'sm_90a'",
        f"ptxas info    : Function properties for {dkv}",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, 520 bytes cmem[0]",
    ])
    assert parse_ptxas(text) == {
        "flash_fwd_tc_kernel<64>": {"registers": 160, "stack": 0,
                                    "spill_stores": 0, "spill_loads": 0},
        "flash_dkv_3xtf32_kernel<64,16,2,2>": {
            "registers": 128, "stack": 8, "spill_stores": 8,
            "spill_loads": 4},
    }


_LN_NS = "_ZN46_GLOBAL__N__772f812e_13_layer_norm_cu_42f3f65717"


@pytest.mark.parametrize("mangled,name", [
    # entry names as an sm_90a build of csrc/layer_norm.cu and
    # csrc/int8_quant.cu prints them (``ptxas -v``, ``cuobjdump -sass``)
    (_LN_NS + "ln_bwd_vec_kernelI13__nv_bfloat16S1_Li32ELi3ELi192ELi2EEEvPKT_"
     "PKT0_PKfS9_S9_PS2_Pfx", "ln_bwd_vec_kernel<bf16,bf16,32,3,192,2>"),
    (_LN_NS + "ln_bwd_vec_kernelI13__nv_bfloat16fLi32ELi3ELi192ELi2EEEvPKT_"
     "PKT0_PKfS9_S9_PS2_Pfx", "ln_bwd_vec_kernel<bf16,float,32,3,192,2>"),
    (_LN_NS + "ln_bwd_vec_kernelIf13__nv_bfloat16Li8ELi1ELi256ELi2EEEvPKT_"
     "PKT0_PKfS9_S9_PS2_Pfx", "ln_bwd_vec_kernel<float,bf16,8,1,256,2>"),
    (_LN_NS + "ln_bwd_vec_kernelIffLi16ELi1ELi256ELi2EEEvPKT_PKT0_PKfS8_S8_"
     "PS1_Pfx", "ln_bwd_vec_kernel<float,float,16,1,256,2>"),
    (_LN_NS + "ln_bwd_sum_kernelEPKfiiPf", "ln_bwd_sum_kernel"),
    ("_ZN46_GLOBAL__N__d77a33f1_13_int8_quant_cu_ae572f0118quant_group_"
     "kernelENS_9LeafGroupE", "quant_group_kernel"),
    # a substitution for the namespace (S_) or the template (S0_) is not
    # bf16: the name comes back as it is
    (_LN_NS + "ln_bwd_vec_kernelI13__nv_bfloat16S_Li8ELi1ELi256ELi2EEEvPKT_",
     None),
    (_LN_NS + "ln_bwd_vec_kernelI13__nv_bfloat16S0_Li8ELi1ELi256ELi2EEEvPKT_",
     None),
])
def test_ptxas_names_tell_every_instantiation_apart(mangled, name):
    """Each instantiation of the vectorised LayerNorm backward keeps its
    own entry (a repeated bf16 argument is mangled as a substitution), so
    ``chip_smoke.py`` can hold every one of them to no spills."""
    from pytorch_distributed_nn_tpu_torch.utils.native_build import (
        _kernel_name,
    )

    assert _kernel_name(mangled) == (mangled if name is None else name)


def test_chip_smoke_profile_knows_every_kernel_of_the_sources():
    """``chip_smoke.py --out`` reports each of the port's CUDA kernels
    apart in its step profiles; the kernels it looks for are read from
    the sources, so a new kernel is reported without a list to keep."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    names = chip_smoke.port_kernel_names()
    for want in ("decode_attn_kernel", "ln_fwd_kernel", "ln_fwd_vec_kernel",
                 "ln_bwd_kernel", "ln_bwd_vec_kernel", "ln_bwd_sum_kernel",
                 "flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                 "flash_dkv_tc_kernel", "flash_fwd_3xtf32_kernel",
                 "flash_dq_3xtf32_kernel", "flash_dkv_3xtf32_kernel",
                 "quant_group_kernel",
                 "dequant_kernel"):
        assert want in names
    from pytorch_distributed_nn_tpu_torch.ops import kernels

    sources = "".join((REPO / "pytorch_distributed_nn_tpu_torch" / "ops"
                       / "csrc" / f"{lib}.cu").read_text()
                      for lib in kernels.LIBRARIES)
    assert len(names) == sources.count("__global__")


def test_fault_profiler_and_recorder_modules_load_no_jax():
    """The modules of the faults, profiler, flight recorder and elastic
    resume slice, imported with the trainer, the server and the CLI,
    bring no JAX module into the process."""
    mods = ["resilience.faults", "resilience.elastic",
            "serving.faultinject", "observability.detect",
            "observability.flightrec", "observability.xplane",
            "utils.profiling", "utils.precision", "training.trainer",
            "serving.server", "cli"]
    code = ("import importlib, sys\n"
            + "".join(f"importlib.import_module("
                      f"'pytorch_distributed_nn_tpu_torch.{m}')\n"
                      for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\nprint(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=torch_cpu.SUBPROCESS_ENV)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for m in mods:
        assert (PORT / (m.replace(".", "/") + ".py")).is_file()
