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
                                         "layer_norm"]
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
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
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
        proc.wait(timeout=30)
    assert os.path.exists(os.path.join(art, "serve", "serving.jsonl"))
