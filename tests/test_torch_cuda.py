"""The port's CUDA kernels and its engine on an NVIDIA card.

Every test here carries the ``cuda`` marker and skips without a card: a
CUDA kernel has no CPU mode. This file imports nothing of JAX, so it
runs on a machine that has only PyTorch; the repository's conftest
imports JAX, hence, on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: each kernel against its plain version (ops/reference.py) on
the same card tensors, f32 at atol 1e-5 (reduction order only), bf16 at
2e-2 plus 1e-2 relative (outputs rounded to bf16, whose step is up to
2^-7 of the value, may round one step apart); the engine
on the card against the same engine on the CPU at 1e-4 (f32 logits
after 2 layers and a few decode steps).
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu_torch.ops import kernels, reference

H, D = 4, 32  # GptMini's heads


def _max_excess(got, want, dtype):
    """Largest error past the dtype's tolerance (<= 0 passes)."""
    atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (2e-2, 1e-2)
    got, want = got.float(), want.float()
    return ((got - want).abs() - atol - rtol * want.abs()).max().item()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _attn_inputs(B, S, seed, device, dtype, pad=0):
    """q, k, v, positions; with ``pad`` the caches are views into a
    longer panel, so the kernel must follow their strides."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, 1, H, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, S + pad, H, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, S + pad, H, D).astype(np.float32))
    pos = rng.randint(0, S, size=B).astype(np.int32)
    pos[0], pos[-1] = 0, S - 1
    q, k, v = (t.to(device, dtype) for t in (q, k, v))
    return q, k[:, :S], v[:, :S], torch.from_numpy(pos).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [0, 8])
def test_cuda_decode_attention_matches_plain(card, dtype, pad):
    for S in (16, 32, 64, 128):
        for B in (1, 2, 4, 8):
            q, k, v, pos = _attn_inputs(B, S, S * B, card, dtype, pad)
            before = kernels.launch_counts()["decode_attention"]
            got = kernels.decode_attention(q, k, v, pos)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["decode_attention"] == before + 1
            want = reference.decode_attention(q, k, v, pos)
            assert got.dtype == dtype and got.shape == (B, 1, H, D)
            assert _max_excess(got, want, dtype) <= 0


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(card):
    q, k, v, pos = _attn_inputs(2, 16, 0, card, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.decode_attention(q, k, v, pos)
    q, k, v, pos = _attn_inputs(2, 16, 0, card, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        kernels.decode_attention(q, k, v, pos.long())
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.decode_attention(q, k.cpu(), v, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dt,out_dt", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16),
])
def test_cuda_layer_norm_matches_plain(card, in_dt, out_dt):
    gen = torch.Generator().manual_seed(0)
    for shape in ((8, 128), (128, 128), (37, 200), (2, 5, 128), (3, 1)):
        Dm = shape[-1]
        x = (torch.randn(shape, generator=gen) * 3 + 1).to(card, in_dt)
        g = (torch.rand(Dm, generator=gen) + 0.5).to(card)
        b = torch.randn(Dm, generator=gen).to(card)
        got = kernels.layer_norm(x, g, b, 1e-6, out_dt)
        torch.cuda.synchronize()
        want = reference.layer_norm(x, g, b, 1e-6, out_dt)
        assert got.dtype == out_dt and got.shape == x.shape
        assert _max_excess(got, want, out_dt) <= 0


@pytest.mark.cuda
def test_cuda_engine_matches_the_cpu_engine(card, tmp_path):
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        save_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.serving.generate import (
        GenerativeEngine,
    )

    model = build_model("GptTiny", fused_ln=True).init_weights(
        torch.Generator().manual_seed(0))
    art = str(tmp_path / "art")
    save_artifact(art, model.state_dict(), "GptTiny",
                  model_kw={"fused_ln": True})
    kw = dict(batch_buckets=(1, 2), seq_buckets=(16, 32), pool_slots=2)
    on_card = GenerativeEngine(art, **kw)
    on_cpu = GenerativeEngine(art, device="cpu", **kw)
    assert on_card.device.type == "cuda"
    on_card.warmup()
    kernels.reset_launch_counts()
    prompt = np.asarray([5, 4, 3, 2, 1, 7, 9], np.int32)
    logits = []
    for eng in (on_card, on_cpu):
        first, kvs, _ = eng.prefill(prompt)
        slot = eng.pools[32].alloc(eng.epoch)
        eng.insert(32, slot, kvs)
        steps = [first]
        for i, tok in enumerate((11, 12, 13)):
            out, _ = eng.decode(32, [slot], [tok], [len(prompt) + i])
            steps.append(out[0])
        eng.pools[32].free(slot)
        logits.append(np.stack(steps))
    launches = kernels.launch_counts()
    assert launches["decode_attention"] == 3 * 2  # 3 steps x 2 layers
    assert launches["layer_norm"] == 4 * (2 * 2 + 1)
    np.testing.assert_allclose(logits[0], logits[1], atol=1e-4)
    assert on_card.retraces() == 0
