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
after 2 layers and a few decode steps). The flash backward and the
LayerNorm backward sum up to L products per output: f32 at 1e-4 plus
1e-4 relative; bf16 flash at 3e-2 plus 3e-2 relative (the forward's
probabilities are rounded to bf16 against the running max of each
64-key tile, the plain version's against the row's max). The gradients
of a whole BertTiny and GptTiny on the card, kernels against plain
versions, f32: 1e-4 of each parameter's plain gradient size.
"""

import importlib.util
import pathlib

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


FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}


def _excess(got, want, atol, rtol):
    got, want = got.float(), want.float()
    return ((got - want).abs() - atol - rtol * want.abs()).max().item()


def _flash_inputs(B, L, H, Dh, device, dtype, seed, pad):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, L, H, Dh).astype(np.float32))
                   .to(device, dtype) for _ in range(4))
    mask = None
    if pad:
        m = np.ones((B, L), np.int32)
        m[-1, L - pad:] = 0  # every row keeps at least one key
        mask = torch.from_numpy(m).to(device)
    return q, k, v, do, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,Dh,pad", [(64, 64, 0), (100, 32, 7),
                                      (128, 16, 0), (77, 64, 5)])
def test_cuda_flash_attention_matches_plain(card, dtype, causal, L, Dh, pad):
    """Forward (out, lse), dq and dk/dv kernels against their plain
    versions, ragged L and pad masks included."""
    q, k, v, do, mask = _flash_inputs(2, L, 3, Dh, card, dtype, L + Dh, pad)
    atol, rtol = FLASH_TOL[dtype]
    before = kernels.launch_counts()
    out, lse = kernels.flash_attention_fwd(q, k, v, mask, causal)
    want_out, want_lse = reference.flash_attention_fwd(q, k, v, mask, causal)
    assert out.dtype == dtype and lse.shape == (2, 3, L)
    assert _excess(out, want_out, atol, rtol) <= 0
    assert _excess(lse, want_lse, 1e-4, 1e-5) <= 0
    delta = reference.flash_attention_delta(want_out, do)
    dq = kernels.flash_attention_dq(q, k, v, mask, want_lse, delta, do,
                                    causal)
    dk, dv = kernels.flash_attention_dkv(q, k, v, mask, want_lse, delta, do,
                                         causal)
    torch.cuda.synchronize()
    want_dq = reference.flash_attention_dq(q, k, v, mask, want_lse, delta,
                                           do, causal)
    want_dk, want_dv = reference.flash_attention_dkv(q, k, v, mask, want_lse,
                                                     delta, do, causal)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == q.shape
        assert _excess(got, want, atol, rtol) <= 0
    after = kernels.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert after[name] == before[name] + 1


@pytest.mark.cuda
def test_cuda_flash_attention_autograd_matches_plain(card):
    q, k, v, do, mask = _flash_inputs(2, 96, 4, 32, card, torch.float32, 3,
                                      9)
    grads = []
    for fn in (kernels.flash_attention, reference.flash_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, mask, causal=True)
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _excess(got, want, 1e-4, 1e-4) <= 0


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_does_not_take(card):
    for Dh in (48, 128):
        q = torch.zeros((1, 8, 2, Dh), device=card)
        with pytest.raises(ValueError, match="head dim"):
            kernels.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 32), device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dt,out_dt", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16),
])
def test_cuda_layer_norm_backward_matches_plain(card, in_dt, out_dt):
    gen = torch.Generator().manual_seed(1)
    for shape in ((8, 128), (300, 768), (37, 200), (2, 5, 96), (70, 3000)):
        Dm = shape[-1]
        x = (torch.randn(shape, generator=gen) * 3 + 1).to(card, in_dt)
        g = (torch.rand(Dm, generator=gen) + 0.5).to(card)
        b = torch.randn(Dm, generator=gen).to(card)
        dy = torch.randn(shape, generator=gen).to(card, out_dt)
        y, mu, rs = kernels.layer_norm_fwd(x, g, b, 1e-6, out_dt)
        want_y, want_mu, want_rs = reference.layer_norm_fwd(x, g, b, 1e-6,
                                                            out_dt)
        assert _max_excess(y, want_y, out_dt) <= 0
        assert _excess(mu, want_mu, 1e-5, 1e-6) <= 0
        assert _excess(rs, want_rs, 1e-5, 1e-5) <= 0
        got = kernels.layer_norm_bwd(x, g, want_mu, want_rs, dy)
        torch.cuda.synchronize()
        want = reference.layer_norm_bwd(x, g, want_mu, want_rs, dy)
        assert got[0].dtype == in_dt and got[0].shape == x.shape
        assert _max_excess(got[0], want[0], in_dt) <= 1e-4
        for a, w in zip(got[1:], want[1:]):
            assert a.shape == (Dm,) and _excess(a, w, 1e-4, 1e-4) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("network", ["BertTiny", "GptTiny"])
def test_cuda_model_gradients_match_the_plain_model(card, network):
    """The LayerNorm of the port is differentiable on the card: every
    parameter's gradient of a model on the kernels (flash attention,
    LayerNorm fwd/bwd) matches the same model on the plain versions."""
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.ops.metrics import (
        masked_cross_entropy,
    )

    kw = dict(dtype="float32", dropout_rate=0.0)
    fast = build_model(network, attn_fn=kernels.flash_attention, **kw)
    fast.init_weights(torch.Generator().manual_seed(0))
    plain = build_model(network, use_kernels=False,
                        attn_fn=reference.flash_attention, **kw)
    plain.load_state_dict(fast.state_dict())
    rng = np.random.RandomState(0)
    V, L = fast.config.vocab_size, 32
    tokens = torch.from_numpy(rng.randint(0, V, (2, L))).to(card)
    labels = torch.from_numpy(
        np.where(rng.rand(2, L) < 0.3, rng.randint(0, V, (2, L)), -1)
    ).to(card)
    kernels.reset_launch_counts()
    grads = []
    for model in (fast, plain):
        model.to(card).train()
        masked_cross_entropy(model(tokens), labels).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    launches = kernels.launch_counts()
    layers = fast.config.num_layers
    lns = 2 * layers + (2 if network == "BertTiny" else 1)
    assert launches["layer_norm"] == launches["layer_norm_bwd"] == lns
    assert launches["flash_attention_fwd"] == layers
    assert launches["flash_attention_dq"] == launches[
        "flash_attention_dkv"] == layers
    for name, want in grads[1].items():
        assert grads[0][name] is not None, f"{name} got no gradient"
    # every leaf within 1e-4 of its plain gradient's size (chip_smoke.py's
    # gradient check)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for name, (rel, _) in chip_smoke.leaf_grad_errors(*grads).items():
        assert rel <= chip_smoke.GRAD_TOL, name
