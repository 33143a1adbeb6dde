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
64-key tile, the plain version's against the row's max), the bf16 dq and
dk/dv at 2e-3 plus 2^-7 relative (chip_smoke.py's FLASH_BWD_TOL_BF16:
one bf16 step apart at most, and dq's ds may round to either side of a
bf16 boundary on the two sides). The gradients
of a whole BertTiny and GptTiny on the card, kernels against plain
versions, f32: 1e-4 of each parameter's plain gradient size. The int8
kernels against their plain versions: equal bit for bit.
"""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu_torch.ops import kernels, reference

import torch_cpu  # noqa: F401  (one intra-op thread)

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


def _misaligned(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,Dh,mis", [
    (8, 128, 4, 32, False),   # GptMini's largest bucket: one warp a head
    (8, 128, 4, 32, True),    # the scalar branch
    (3, 77, 4, 16, True),
    (2, 77, 3, 24, False),    # the general head-dim instantiation
    (2, 512, 12, 64, False),  # long caches: the split path
    (2, 512, 12, 64, True),
    (2, 2048, 12, 64, False),
    (1, 2048, 12, 64, True),
    (2, 16384, 12, 64, False),  # several rounds a warp, scored again
    (1, 16384, 12, 64, True),
    (1, 50000, 2, 64, False),
    (2, 4000, 2, 256, False),  # wide rows: 2 warps, general head dim
    (64, 128, 32, 32, False),  # heads enough to fill the card
])
def test_cuda_decode_attention_paths_match_plain_and_repeat(
        card, dtype, B, S, nh, Dh, mis):
    """Each path of the decode kernel (one warp a head, split over a
    block's warps, 16-byte or scalar staging, templated or general head
    dim) against the plain version; two launches equal bit for bit."""
    gen = torch.Generator().manual_seed(S + B)
    q = torch.randn((B, 1, nh, Dh), generator=gen).to(card, dtype)
    k = torch.randn((B, S, nh, Dh), generator=gen).to(card, dtype)
    v = torch.randn((B, S, nh, Dh), generator=gen).to(card, dtype)
    if mis:
        k, v = _misaligned(k), _misaligned(v)
    pos = torch.randint(0, S, (B,), generator=gen, dtype=torch.int32)
    pos[0], pos[-1] = 0, S - 1
    pos = pos.to(card)
    assert kernels.decode_vector_loads(k, v) == (not mis)
    got = kernels.decode_attention(q, k, v, pos)
    again = kernels.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = reference.decode_attention(q, k, v, pos)
    assert got.dtype == dtype and got.shape == (B, 1, nh, Dh)
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
FLASH_BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 2**-7)}


def _excess(got, want, atol, rtol):
    got, want = got.float(), want.float()
    return ((got - want).abs() - atol - rtol * want.abs()).max().item()


def _flash_inputs(B, L, H, Dh, device, dtype, seed, pad,
                  dout_layout="contiguous"):
    """q, k, v, dO and the pad mask. ``dout_layout`` "heads_major" gives
    dO as a (B, H, L, D) tensor seen as (B, L, H, D), as autograd may hand
    it over: not contiguous, rows still 16-byte aligned, read in place."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, L, H, Dh).astype(np.float32))
                   .to(device, dtype) for _ in range(4))
    if dout_layout == "heads_major":
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
        assert not do.is_contiguous()
    mask = None
    if pad:
        m = np.ones((B, L), np.int32)
        m[-1, L - pad:] = 0  # every row keeps at least one key
        mask = torch.from_numpy(m).to(device)
    return q, k, v, do, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,Dh,pad,dout_layout,nh", [
    (64, 64, 0, "contiguous", 3), (100, 32, 7, "contiguous", 3),
    (128, 16, 0, "contiguous", 3), (77, 64, 5, "contiguous", 3),
    (512, 64, 0, "contiguous", 3), (200, 16, 9, "heads_major", 3),
    (512, 64, 0, "heads_major", 3), (512, 64, 37, "contiguous", 12),
    (200, 64, 0, "contiguous", 12)])
def test_cuda_flash_attention_matches_plain(card, dtype, causal, L, Dh, pad,
                                            dout_layout, nh):
    """Forward (out, lse), dq and dk/dv kernels against their plain
    versions, ragged L, pad masks, BertBase's L 512 / 12 heads of 64 (with
    a pad mask too) and a dO that is not contiguous included; a second
    launch gives the same bits."""
    q, k, v, do, mask = _flash_inputs(2, L, nh, Dh, card, dtype, L + Dh, pad,
                                      dout_layout)
    atol, rtol = FLASH_TOL[dtype]
    before = kernels.launch_counts()
    out, lse = kernels.flash_attention_fwd(q, k, v, mask, causal)
    want_out, want_lse = reference.flash_attention_fwd(q, k, v, mask, causal)
    assert out.dtype == dtype and lse.shape == (2, nh, L)
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
        assert _excess(got, want, *FLASH_BWD_TOL[dtype]) <= 0
    after = kernels.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert after[name] == before[name] + 1
    again = (*kernels.flash_attention_fwd(q, k, v, mask, causal),
             kernels.flash_attention_dq(q, k, v, mask, want_lse, delta, do,
                                        causal),
             *kernels.flash_attention_dkv(q, k, v, mask, want_lse, delta, do,
                                          causal))
    for a, b in zip((out, lse, dq, dk, dv), again):
        assert torch.equal(a, b)


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


def _misaligned_operands_give_the_aligned_bits(card, dtype):
    """A view of q whose data starts one element off a 16-byte boundary,
    and a dO whose head stride is not a multiple of the elements of 16
    bytes, are copied by the wrappers (the same bits as the aligned
    operands give); the C entry point refuses them outright."""
    elems = 16 // torch.empty((), dtype=dtype).element_size()
    q, k, v, do, _ = _flash_inputs(2, 64, 2, 32, card, dtype, 5, 0)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
    q_off = shifted[1:].view(q.shape)
    q_off.copy_(q)
    wide = torch.zeros((2, 64, 2, 32 + elems // 2), dtype=q.dtype,
                       device=card)
    do_odd = wide[..., :32]
    do_odd.copy_(do)
    assert q_off.data_ptr() % 16 != 0 and do_odd.stride(2) % elems != 0
    assert kernels._flash_operand(q) is q
    assert kernels._flash_operand(q_off).data_ptr() % 16 == 0
    assert kernels._flash_operand(do_odd).is_contiguous()
    out, lse = kernels.flash_attention_fwd(q, k, v)
    out2, lse2 = kernels.flash_attention_fwd(q_off, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    delta = reference.flash_attention_delta(out, do)
    args = (k, v, None, lse, delta)
    assert torch.equal(kernels.flash_attention_dq(q, *args, do),
                       kernels.flash_attention_dq(q_off, *args, do_odd))
    for a, b in zip(kernels.flash_attention_dkv(q, *args, do),
                    kernels.flash_attention_dkv(q_off, *args, do_odd)):
        assert torch.equal(a, b)
    lib = kernels._lib("flash_attention")
    B, L, H, Dh = q.shape
    rc = lib.pdtn_flash_fwd(
        kernels._DTYPE_CODES[dtype], Dh, 0, q_off.data_ptr(), k.data_ptr(),
        v.data_ptr(), None, out.data_ptr(), lse.data_ptr(), B, H, L,
        *kernels._strides(q_off, k, v), 1.0 / Dh ** 0.5, kernels._stream(q))
    assert rc != 0 and "misaligned" in \
        lib.pdtn_cuda_error_string(rc).decode().lower()


@pytest.mark.cuda
def test_cuda_flash_attention_copies_misaligned_bf16_operands(card):
    """The bf16 kernels copy 16-byte rows with cp.async: misaligned
    operands are copied by the wrapper and refused by the C entry."""
    _misaligned_operands_give_the_aligned_bits(card, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_flash_attention_copies_misaligned_f32_operands(card):
    """The f32 kernels stream 16-byte rows with cp.async too: the same
    holds for f32 operands (a head stride off a multiple of 4 elements)."""
    _misaligned_operands_give_the_aligned_bits(card, torch.float32)


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


@pytest.mark.cuda
@pytest.mark.parametrize("x_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dy_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dm", [64, 96, 128, 200, 768, 1024])
def test_cuda_layer_norm_backward_kernels_match_plain(card, x_dt, dy_dt, Dm):
    """Both backward kernels against the plain version: the vectorised one
    at the widths it is built for, the general one at the others and on a
    copy of x one element off a 16-byte boundary; N = 1 and row counts no
    block size divides; two launches equal bit for bit; one count per
    call."""
    gen = torch.Generator().manual_seed(Dm)
    g = (torch.rand(Dm, generator=gen) + 0.5).to(card)
    dx_tol = (1e-4, 1e-4) if x_dt == torch.float32 else (2e-2, 1e-2)
    for N in (1, 37, 1000):
        x = (torch.randn((N, Dm), generator=gen) * 3 + 1).to(card, x_dt)
        dy = torch.randn((N, Dm), generator=gen).to(card, dy_dt)
        _, mu, rs = reference.layer_norm_fwd(x, g, torch.zeros_like(g))
        want = reference.layer_norm_bwd(x, g, mu, rs, dy)
        x_off = torch.empty(N * Dm + 1, dtype=x_dt, device=card)[1:]
        x_off = x_off.view(N, Dm).copy_(x)
        for xin, vec in ((x, Dm in kernels.LN_WIDTHS), (x_off, False)):
            assert kernels.layer_norm_bwd_vectorised(
                xin, dy, torch.empty_like(x)) == vec
            before = kernels.launch_counts()["layer_norm_bwd"]
            got = kernels.layer_norm_bwd(xin, g, mu, rs, dy)
            again = kernels.layer_norm_bwd(xin, g, mu, rs, dy)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["layer_norm_bwd"] == before + 2
            for a, b in zip(got, again):
                assert torch.equal(a, b)
            assert got[0].dtype == x_dt and got[0].shape == x.shape
            assert _excess(got[0], want[0], *dx_tol) <= 0
            for a, w in zip(got[1:], want[1:]):
                assert a.shape == (Dm,) and _excess(a, w, 1e-4, 1e-4) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("in_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dm", [64, 128, 768])
def test_cuda_layer_norm_forward_kernels_match_plain(card, in_dt, out_dt, Dm):
    """Both forward kernels against the plain version, y, mu and rs: the
    vectorised one at each width it is built for, the general one on a
    copy of x one element off a 16-byte boundary; N = 1, 3 and 4097 (a
    tail no block's rows divide) and, at 768, 8192; with the statistics
    (training) and without (serving, the same y bit for bit); two
    launches equal bit for bit; one count per call; the two kernels
    within the tolerance of each other."""
    gen = torch.Generator().manual_seed(Dm)
    g = (torch.rand(Dm, generator=gen) + 0.5).to(card)
    b = torch.randn(Dm, generator=gen).to(card)
    y_tol = (1e-5, 0.0) if out_dt == torch.float32 else (2e-2, 1e-2)
    for N in (1, 3, 4097) + ((8192,) if Dm == 768 else ()):
        x = (torch.randn((N, Dm), generator=gen) * 3 + 1).to(card, in_dt)
        x_off = torch.empty(N * Dm + 1, dtype=in_dt, device=card)[1:]
        x_off = x_off.view(N, Dm).copy_(x)
        want = reference.layer_norm_fwd(x, g, b, 1e-6, out_dt)
        ys = []
        for xin, vec in ((x, True), (x_off, False)):
            y_probe = torch.empty((N, Dm), dtype=out_dt, device=card)
            assert kernels.layer_norm_fwd_vectorised(xin, y_probe, g, b) == vec
            before = kernels.launch_counts()["layer_norm"]
            got = kernels.layer_norm_fwd(xin, g, b, 1e-6, out_dt)
            again = kernels.layer_norm_fwd(xin, g, b, 1e-6, out_dt)
            served = kernels.layer_norm(xin, g, b, 1e-6, out_dt)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["layer_norm"] == before + 3
            for a, c in zip(got, again):
                assert torch.equal(a, c)
            assert torch.equal(served, got[0])
            y, mu, rs = got
            assert y.dtype == out_dt and y.shape == x.shape
            assert mu.shape == rs.shape == (N,)
            assert _excess(y, want[0], *y_tol) <= 0
            assert _excess(mu, want[1], 1e-5, 0.0) <= 0
            assert _excess(rs, want[2], 1e-5, 1e-5) <= 0
            ys.append(y)
        assert _excess(ys[0], ys[1], *y_tol) <= 0


# -- the int8 gradient codec: kernel and plain version equal bit for bit
# (the same Philox noise, IEEE division, the same floor and clip)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [
    (1,), (3,), (16384,), (36865,), (2359296,), (1, 3, 16384, 36865, 2359296),
    tuple(1 + 997 * i for i in range(70)), (), (5, 0, 16384)])
@pytest.mark.parametrize("misaligned", [False, True])
def test_cuda_quantize_int8_scaled_group_equals_plain_bitwise(card, sizes,
                                                              misaligned):
    """One grouped launch per 64 non-empty leaves (none for an empty
    group), each leaf bit for bit its plain quantize with its own scale
    and seed; ``misaligned`` starts every leaf one element off its
    16-byte boundary (such a leaf goes element by element)."""
    rng = np.random.RandomState(len(sizes))
    xs = [torch.from_numpy((rng.randn(n + misaligned) * rng.uniform(0.01, 1))
                           .astype(np.float32)).to(card)[misaligned:]
          for n in sizes]
    scales = torch.tensor([x.abs().max().item() / 127.0 if x.numel() else 1.0
                           for x in xs], device=card)
    seeds = [1000 + 7 * i for i in range(len(sizes))]
    live = sum(n > 0 for n in sizes)
    before = kernels.launch_counts()["quantize_int8_scaled"]
    got = kernels.quantize_int8_scaled_group(xs, scales, seeds)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["quantize_int8_scaled"] == before + -(
        -live // kernels.QUANT_GROUP_LEAVES)
    want = reference.quantize_int8_scaled_group(xs, scales, seeds)
    assert len(got) == len(sizes)
    for a, b in zip(got, want):
        assert a.dtype == torch.int8 and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 16383, 16384, 131072, 131073,
                               2359296])
def test_cuda_quantize_int8_scaled_equals_plain_bitwise(card, n):
    rng = np.random.RandomState(n)
    x = torch.from_numpy((rng.randn(n) * 0.05).astype(np.float32)).to(card)
    scale = x.abs().amax() / 127.0
    before = kernels.launch_counts()["quantize_int8_scaled"]
    q = kernels.quantize_int8_scaled(x, scale, 77 + n)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["quantize_int8_scaled"] == before + 1
    assert torch.equal(q, reference.quantize_int8_scaled(x, scale,
                                                         seed=77 + n))
    # a view that starts off the 16-byte boundary takes the scalar path
    assert torch.equal(kernels.quantize_int8_scaled(x[1:], scale, 5),
                       reference.quantize_int8_scaled(x[1:], scale, seed=5))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (8, 125), (257, 510), (4608, 512)])
def test_cuda_quantize_and_dequantize_int8_equal_plain(card, shape):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3).to(card)
    q, s = kernels.quantize_int8(x, 9)
    qw, sw = reference.quantize_int8(x, seed=9)
    torch.cuda.synchronize()
    assert torch.equal(q, qw) and s.item() == sw.item()
    assert torch.equal(kernels.dequantize_int8(q, s),
                       reference.dequantize_int8(q, s))
    z, sz = kernels.quantize_int8(torch.zeros(shape, device=card), 1)
    assert sz.item() == 1.0 and not z.any()


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["below", "at", "above", "twice", "one",
                                   "zeros"])
def test_cuda_quantize_int8_around_its_register_capacity(card, where):
    """The own-scale quantize on both sides of the elements its grid holds
    in registers (past them, a second pass over x in the same launch), at
    one element and on an all-zero x, aligned and one element off: bit
    for bit equal to the plain version, and to itself on a second
    launch."""
    held = kernels.quantize_int8_register_elements()
    n = {"below": held - 3, "at": held, "above": held + 5,
         "twice": 2 * held + 3, "one": 1, "zeros": 5000}[where]
    gen = torch.Generator().manual_seed(n % 1000)
    x = (torch.randn(n, generator=gen) * 3).to(card)
    if where == "zeros":
        x.zero_()
    for xx in (x, _misaligned(x)):
        before = kernels.launch_counts()["quantize_int8"]
        q, s = kernels.quantize_int8(xx, 21)
        q2, s2 = kernels.quantize_int8(xx, 21)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["quantize_int8"] == before + 2
        qw, sw = reference.quantize_int8(xx, seed=21)
        assert torch.equal(q, qw) and s.item() == sw.item()
        assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.cuda
def test_cuda_quantize_int8_captures_in_a_cuda_graph(card):
    """The cooperative launch replays from a CUDA graph (chip_smoke.py
    times it that way) and gives the same bits."""
    x = (torch.randn(4608 * 512, generator=torch.Generator().manual_seed(3))
         * 0.05).to(card)
    q0, s0 = kernels.quantize_int8(x, 8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.quantize_int8(x, 8)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        q, s = kernels.quantize_int8(x, 8)
    q.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(q, q0) and torch.equal(s, s0)


@pytest.mark.cuda
def test_cuda_int8_wrappers_refuse_what_the_kernels_do_not_take(card):
    with pytest.raises(TypeError):
        kernels.quantize_int8_scaled(torch.zeros(8, device=card,
                                                 dtype=torch.float64), 1.0, 0)
    with pytest.raises(TypeError):
        kernels.dequantize_int8(torch.zeros(8, device=card,
                                            dtype=torch.int32), 1.0)
    with pytest.raises(ValueError):
        kernels.quantize_int8_scaled(torch.zeros(8, device=card),
                                     torch.ones(2, device=card), 0)


@pytest.mark.cuda
def test_cuda_int8_sync_on_one_nccl_rank_equals_the_plain_quantizer(card):
    """GradSync int8 over a world-size-1 NCCL group: one grouped kernel
    launch over the large leaves, bit for bit the plain grouped
    quantizer's result."""
    from pytorch_distributed_nn_tpu_torch.ops import compression
    from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
        make_grad_sync,
    )
    from pytorch_distributed_nn_tpu_torch.parallel.mesh import init_group

    group, dev = init_group(card)
    rng = np.random.RandomState(2)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
             for s in ((512, 512, 3, 3), (64,), (100, 64), (256, 128, 3, 3))]
    sync = make_grad_sync(group, compression="int8")
    before = kernels.launch_counts()["quantize_int8_scaled"]
    got, _ = sync(grads, None, 123)
    assert kernels.launch_counts()["quantize_int8_scaled"] == before + 1
    want = compression.int8_psum_mean(
        grads, compression.leaf_seeds(123, 2)[1], group,
        group_quantizer=reference.quantize_int8_scaled_group)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_topk_masks_and_residuals(card):
    """topk with error feedback on card tensors: each leaf's mask equals
    the CPU's for the same values (the k-th magnitude is one value
    whatever the selection), keeps at least k coordinates, and sent +
    residual == gradient + old residual bit for bit."""
    from pytorch_distributed_nn_tpu_torch.ops import compression as C

    rng = np.random.RandomState(4)
    shapes = ((30522, 768), (768,), (3072, 768), (2,))
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(card)
             for s in shapes]
    ef = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(card)
          for s in shapes]
    # ties at the threshold: every magnitude repeated
    grads[2] = grads[2].round()
    ef[2] = torch.zeros_like(ef[2])
    sent, resid = C.topk_compress_ef(grads, ef, 0.01)
    for g, e, s_, r in zip(grads, ef, sent, resid):
        acc = g + e
        assert torch.equal(s_ + r, acc)
        mask = C.topk_mask_leaf(acc, 0.01)
        assert torch.equal(mask.cpu(), C.topk_mask_leaf(acc.cpu(), 0.01))
        assert torch.equal(s_, acc * mask)
        assert int(mask.sum()) >= max(1, int(acc.numel() * 0.01 + 0.999999))


def _bucket_count(sizes, bucket_bytes):
    from pytorch_distributed_nn_tpu_torch.ops import compression as C

    total, per = sum(sizes), bucket_bytes // 4
    big = sum(min(per, total - o) >= C.QUANT_KERNEL_MIN_SIZE
              for o in range(0, total, per))
    return -(-big // kernels.QUANT_GROUP_LEAVES)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_kb", [None, 1024])
def test_cuda_bertbase_int8_sync_launches_and_bits(card, bucket_kb):
    """GradSync int8 over one NCCL rank on BertBase's 201 gradient leaves:
    the grouped quantize launches ceil(76 / 64) = 2 times over the leaves
    of 16384 elements or more, or once per 64 kernel-sized buckets of 1
    MB (418 buckets: 7), and the synced gradient equals the plain
    grouped quantizer's bit for bit."""
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.ops import compression as C
    from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
        make_grad_sync,
    )
    from pytorch_distributed_nn_tpu_torch.parallel.mesh import init_group

    group, dev = init_group(card)
    sizes = [p.numel() for p in build_model("BertBase").parameters()]
    big = sum(n >= C.QUANT_KERNEL_MIN_SIZE for n in sizes)
    assert (len(sizes), big, sum(sizes)) == (201, 76, 109512762)
    gen = torch.Generator(device=dev).manual_seed(5)
    grads = [torch.randn(n, generator=gen, device=dev) * 1e-3
             for n in sizes]
    bucket = None if bucket_kb is None else bucket_kb * 1024
    sync = make_grad_sync(group, compression="int8", bucket_bytes=bucket)
    want_launches = (2 if bucket is None else _bucket_count(sizes, bucket))
    if bucket is not None:
        assert want_launches == 7
    before = kernels.launch_counts()["quantize_int8_scaled"]
    got, _ = sync(grads, None, 77)
    assert kernels.launch_counts()["quantize_int8_scaled"] \
        == before + want_launches
    leaves, meta = grads, None
    if bucket is not None:
        leaves, meta = C.flatten_buckets(grads, bucket)
    want = C.int8_psum_mean(
        leaves, C.leaf_seeds(77, 2)[1], group,
        group_quantizer=reference.quantize_int8_scaled_group)
    if meta is not None:
        want = C.unflatten_buckets(want, meta)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- checkpoints of a state on the card ------------------------------------


@pytest.mark.cuda
def test_cuda_async_checkpoint_holds_its_steps_state(card, tmp_path):
    """In-place safety on the card: a BertTiny (flash kernels, Adam) state
    checkpointed async at step 2 while steps 3-5 update it in place on the
    same stream (a sleep kernel ahead of the snapshot keeps the writer's
    copy waiting while they are enqueued): the file holds step 2's state
    bit for bit, the state moved on, and a sync save of step 2's state
    gives the same bytes."""
    from pytorch_distributed_nn_tpu_torch.data.text import MLMBatches
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.async_ckpt import (
        AsyncCheckpointer,
    )
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        build_train_step,
        create_train_state,
    )

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    model = build_model("BertTiny", max_len=64,
                        attn_fn=kernels.flash_attention)
    model.init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda ps: build_optimizer(
        "adam", ps, 1e-3), card, seed=1)
    step = build_train_step()
    data = MLMBatches(vocab_size=model.config.vocab_size, seq_len=64,
                      batch_size=8)

    def run():
        x, y = next(data)
        step(state, (torch.from_numpy(x).long().to(card),
                     torch.from_numpy(y).long().to(card)))

    run(), run()
    want = ckpt.state_tree(state)
    sync = ckpt.save_checkpoint(str(tmp_path / "sync"), state)
    ac = AsyncCheckpointer(str(tmp_path / "async"))
    try:
        torch.cuda._sleep(100_000_000)
        handle = ac.save(state)
        for _ in range(3):
            run()
        ac.wait()
    finally:
        ac.close(timeout=120)
    assert handle.step == 2 and state.step == 5
    assert chip_smoke.first_difference(ckpt.load_raw(handle.path), want) \
        is None
    assert chip_smoke.first_difference(ckpt.state_tree(state), want)
    with open(sync, "rb") as a, open(handle.path, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.cuda
def test_cuda_async_checkpoints_reuse_the_pinned_host_tensors(card,
                                                              tmp_path):
    """Two async saves of a ResNet-20 (SGD momentum, BatchNorm) state, a
    step apart, through the one set of page-locked host tensors the
    writer pins at warmup: each file holds its own step's state bit for
    bit."""
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
        make_grad_sync,
    )
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.async_ckpt import (
        AsyncCheckpointer,
    )
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        build_image_train_step,
        create_train_state,
    )

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    model = build_model("ResNet20")
    model.init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda ps: build_optimizer(
        "sgd", ps, 0.1, momentum=0.9), card)
    step = build_image_train_step(make_grad_sync(None, "local"))
    gen = torch.Generator().manual_seed(1)

    def run():
        x = torch.randn(16, 32, 32, 3, generator=gen).to(card)
        y = torch.randint(0, 10, (16,), generator=gen).to(card)
        step(state, (x, y), 0)

    ac = AsyncCheckpointer(str(tmp_path / "async"))
    try:
        ac.warmup(state)
        pinned = ac._host
        run()
        want = [ckpt.state_tree(state)]
        first = ac.save(state)
        run()
        ac.wait()
        want.append(ckpt.state_tree(state))
        second = ac.save(state)
        ac.wait()
        assert ac._host is pinned
        assert all(t.is_pinned() for t in pinned.values())
    finally:
        ac.close(timeout=120)
    assert (first.step, second.step) == (1, 2)
    for handle, tree in zip((first, second), want):
        assert chip_smoke.first_difference(ckpt.load_raw(handle.path),
                                           tree) is None
    assert chip_smoke.first_difference(want[0], want[1])


@pytest.mark.cuda
def test_cuda_engine_serves_a_resnet20_artifact_as_on_the_cpu(card,
                                                              tmp_path):
    """A ResNet-20 artifact (a port checkpoint through the port's
    exporter) served by the single-pass engine on the card: its logits
    equal the same engine's on the CPU at 1e-4 (cuDNN's f32 convolutions
    without TF32 against the CPU's, summed in other orders), top-1
    equal, and nothing built after warmup across mixed batch sizes."""
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        export_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        create_train_state,
    )

    model = build_model("ResNet20").init_weights(
        torch.Generator().manual_seed(0))
    state = create_train_state(
        model, lambda p: build_optimizer("sgd", p, 0.1), "cpu")
    ckpt.save_checkpoint(str(tmp_path / "td"), state, step=1)
    art = str(tmp_path / "art")
    export_artifact(str(tmp_path / "td"), art, network="ResNet20")
    gpu = InferenceEngine(art, batch_buckets=(1, 2, 4, 8), device=card)
    cpu = InferenceEngine(art, batch_buckets=(1, 2, 4, 8), device="cpu")
    gpu.warmup()
    rng = np.random.RandomState(0)
    for n in (3, 8, 1, 5):
        xs = [rng.rand(32, 32, 3).astype(np.float32) for _ in range(n)]
        got, stats = gpu.infer(xs)
        want, _ = cpu.infer(xs)
        assert stats["nonfinite"] == 0 and stats["flops"] > 0
        np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                                   atol=1e-4)
        assert [int(np.argmax(g)) for g in got] == \
            [int(np.argmax(w)) for w in want]
    assert gpu.retraces() == 0


@pytest.mark.cuda
def test_cuda_engine_holds_tf32_off_in_its_forwards_only(card, tmp_path):
    """The engine's forwards on the card run without TF32 and leave the
    process's switches as they found them; a token row with an id
    outside the vocabulary is refused on the host (on the card it would
    be a device-side assert), and the engine serves on."""
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        export_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        create_train_state,
    )

    kw = {"dtype": "float32"}
    model = build_model("BertTiny", 0, **kw).init_weights(
        torch.Generator().manual_seed(0))
    state = create_train_state(
        model, lambda p: build_optimizer("sgd", p, 0.1), "cpu")
    ckpt.save_checkpoint(str(tmp_path / "td"), state, step=1)
    art = str(tmp_path / "art")
    export_artifact(str(tmp_path / "td"), art, network="BertTiny",
                    num_classes=0, model_kw=kw)
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    try:
        matmul.allow_tf32, cudnn.allow_tf32 = True, True
        engine = InferenceEngine(art, batch_buckets=(1, 2),
                                 seq_buckets=(8, 128), device=card)
        seen = []
        engine.model.register_forward_hook(lambda *_: seen.append(
            (matmul.allow_tf32, cudnn.allow_tf32)))
        engine.warmup()
        engine.warm_thread()
        rows = [np.arange(1, 6, dtype=np.int32)] * 2
        out, stats = engine.infer(rows)
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
        assert seen and set(seen) == {(False, False)}
        with pytest.raises(ValueError, match="token ids"):
            engine.infer([np.array([1, engine.vocab_size], np.int32)])
        again, _ = engine.infer(rows)
        torch.cuda.synchronize()
        assert stats["nonfinite"] == 0
        np.testing.assert_array_equal(np.stack(again), np.stack(out))
        assert engine.retraces() == 0
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def _image_run(device, tmp_path, name):
    """ResNet-20 f32 on the synthetic CIFAR-10 (host layout: the same
    numpy draws on either device), 2 steps, then an eval pass."""
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    trainer = Trainer(TrainConfig(
        network="ResNet20", dataset="Cifar10", batch_size=64,
        test_batch_size=128, synthetic_size=256, max_steps=2,
        data_layout="host", train_dir=str(tmp_path / name)), device=device)
    try:
        losses = [r["loss"] for r in trainer.train()]
        ev = trainer.evaluate()
    finally:
        trainer.close()
    return losses, ev


@pytest.mark.cuda
def test_cuda_f32_image_training_matches_the_cpu_with_tf32_at_default(
        card, tmp_path):
    """The f32 image path's train and eval steps hold TF32 off (PyTorch's
    cuDNN default would run the convolutions with a 10-bit mantissa):
    with the switches at PyTorch's defaults the card's losses and eval
    metrics equal the CPU's within 1e-4 relative, and the switches are
    where they were afterwards."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    try:
        matmul.allow_tf32, cudnn.allow_tf32 = False, True  # the defaults
        got = _image_run(card, tmp_path, "card")
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (False, True)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
    want = _image_run("cpu", tmp_path, "cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=0)
    for k in ("loss", "acc1", "acc5"):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_cuda_profile_summary_counts_the_flash_and_layernorm_kernels(
        card, tmp_path):
    """``--profile 2`` on BertTiny with the flash and LayerNorm kernels:
    the trace's summary names each kernel, 2 steps' launches of each,
    equal to the wrappers' counters, and its device time per step is the
    profile's own device time."""
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils import profiling

    trainer = Trainer(TrainConfig(
        network="BertTiny", dataset="MLMSynth", batch_size=4, seq_len=64,
        test_batch_size=4, eval_batches=1, max_steps=3, profile_steps=2,
        optimizer="adam", lr=1e-3, attn_impl="pallas", fused_ln=True,
        train_dir=str(tmp_path)), device=card)
    try:
        kernels.reset_launch_counts()
        trainer.train()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        L = trainer.model.config.num_layers
    finally:
        trainer.close()
    trace = str(tmp_path / "profile")
    rows = {}
    for rs in profiling.summarize_trace(trace, top=5).values():
        for r in rs:
            rows[r.name] = rows.get(r.name, 0) + r.count
    # a wrapper's kernels (either LayerNorm kernel: vectorised or general)
    for names, wrapper in (
            (("flash_fwd_3xtf32_kernel",), "flash_attention_fwd"),
            (("flash_dq_3xtf32_kernel",), "flash_attention_dq"),
            (("flash_dkv_3xtf32_kernel",), "flash_attention_dkv"),
            (("ln_fwd_vec_kernel", "ln_fwd_kernel"), "layer_norm"),
            (("ln_bwd_vec_kernel", "ln_bwd_kernel"), "layer_norm_bwd"),
            (("ln_bwd_sum_kernel",), "layer_norm_bwd")):
        got = sum(rows.get(n, 0) for n in names)
        assert 2 * launches[wrapper] == 3 * got, (names, rows, launches)
    assert rows["flash_fwd_3xtf32_kernel"] == 2 * L
    dev = profiling.device_step_time_ms(trace, 2)
    # device rows of key_averages, less the optimizer's user annotation
    # (a kernel's name may hold a "#" in its lambda's name) and the
    # session's lead-in launches
    prof_ms = sum(e.self_device_time_total
                  for e in trainer.last_profile.key_averages()
                  if str(e.device_type).endswith("CUDA")
                  and not ("#" in e.key and "(" not in e.key)
                  and "spin_kernel" not in e.key) / 1e3
    assert dev == pytest.approx(prof_ms / 2, rel=0.02)


@pytest.mark.cuda
def test_cuda_flight_recorder_bundle_holds_a_device_trace(card, tmp_path):
    from pytorch_distributed_nn_tpu_torch.observability import flightrec
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils import profiling

    d = str(tmp_path)
    trainer = Trainer(TrainConfig(
        network="LeNet", dataset="MNIST", batch_size=64, synthetic_size=256,
        test_batch_size=64, max_steps=12, train_dir=d,
        metrics_path=str(tmp_path / "telemetry.jsonl"), faults="delay@8:1.0s",
        flightrec="step_regression:warmup=5,capture_steps=2"), device=card)
    try:
        trainer.train()
    finally:
        trainer.close()
    (inc,) = flightrec.list_incidents(d)
    assert inc["kind"] == "step_regression" and inc["step"] == 8
    assert inc["has_trace"] and inc["has_report"]
    summary = profiling.summarize_trace(os.path.join(inc["path"], "trace"))
    assert summary and sum(r.count for rs in summary.values() for r in rs)
    with open(os.path.join(inc["path"], "report.md")) as f:
        assert "GPU 0 stream" in f.read()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,prefetch", [("image", 2), ("image", 0),
                                           ("tokens", 2)])
def test_cuda_streamed_batches_equal_the_cpu_loaders(card, tmp_path, kind,
                                                     prefetch):
    """The streaming loader's batches copied to the card (by its output
    thread at prefetch 2, on the calling thread at 0) equal, bit for bit,
    the same loader's on the CPU, across an epoch boundary."""
    from pytorch_distributed_nn_tpu_torch.data import datasets, streaming

    d = str(tmp_path / kind)
    if kind == "image":
        streaming.export_image_dataset(
            datasets.load_dataset("Cifar10", True, synthetic_size=256), d,
            shards=4)
        kw = {}
    else:
        streaming.export_text_corpus(d, shards=4, sequences=128)
        kw = {"seq_len": 64}
    loaders = [streaming.StreamingLoader(d, 64, seed=1, prefetch=prefetch,
                                         workers=2, device=dev, **kw)
               for dev in (card, "cpu")]
    try:
        for _ in range(6):
            got, want = (ld.next_batch() for ld in loaders)
            for g, w in zip(got, want):
                assert g.device.type == "cuda" and g.dtype == w.dtype
                assert torch.equal(g.cpu(), w)
        assert loaders[0].state() == loaders[1].state()
    finally:
        for ld in loaders:
            ld.close()


# -- dp x tp x sp training at world size 1 on the card -----------------------


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [6, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_at_tp_head_shards_matches_plain(card, heads, dtype):
    """The flash kernels on the H / tp heads a tp rank of BertBase holds
    (12 over 2 and 4), D 64, at the full sequence: forward, dq and dk/dv
    against the plain version."""
    g = torch.Generator().manual_seed(heads)
    q, k, v, do = (torch.randn((2, 512, heads, 64), generator=g)
                   .to(card, dtype) for _ in range(4))
    mask = torch.ones((2, 512), dtype=torch.int32, device=card)
    mask[-1, -37:] = 0
    out, lse = kernels.flash_attention_fwd(q, k, v, mask)
    w_out, w_lse = reference.flash_attention_fwd(q, k, v, mask)
    delta = reference.flash_attention_delta(w_out, do)
    dq = kernels.flash_attention_dq(q, k, v, mask, w_lse, delta, do)
    dk, dv = kernels.flash_attention_dkv(q, k, v, mask, w_lse, delta, do)
    w_dq = reference.flash_attention_dq(q, k, v, mask, w_lse, delta, do)
    w_dk, w_dv = reference.flash_attention_dkv(q, k, v, mask, w_lse, delta,
                                               do)
    torch.cuda.synchronize()
    fwd_tol = (1e-4, 1e-4) if dtype == torch.float32 else (3e-2, 3e-2)
    bwd_tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-3, 2.0 ** -7)
    for got, want, (atol, rtol) in ((out, w_out, fwd_tol),
                                    (dq, w_dq, bwd_tol), (dk, w_dk, bwd_tol),
                                    (dv, w_dv, bwd_tol)):
        got, want = got.float(), want.float()
        assert ((got - want).abs() - atol - rtol * want.abs()).max() <= 0


@pytest.mark.cuda
def test_cuda_grouped_quantize_with_region_offsets_bit_for_bit(card):
    """quant_group_kernel with each leaf's element offset (a region of a
    larger leaf: offsets that are and are not multiples of 4) against the
    plain version, bit for bit; and the region's result equal to the
    whole leaf's at its elements."""
    g = torch.Generator().manual_seed(3)
    whole = (torch.randn(30522 * 3, generator=g) * 0.01).to(card)
    firsts = [0, 7631 * 3, 15262 * 3 + 1, 22893 * 3 + 2, 5]
    sizes = [7631 * 3, 7631 * 3, 7631 * 3 - 1, 7629 * 3 - 2, 16390]
    xs = [whole[f:f + n] for f, n in zip(firsts, sizes)]
    scale = whole.abs().amax() * reference.RECIP127
    seeds = [77] * len(xs)
    got = kernels.quantize_int8_scaled_group(xs, [scale] * len(xs), seeds,
                                             firsts=firsts)
    want = reference.quantize_int8_scaled_group(xs, [scale] * len(xs),
                                                seeds, firsts=firsts)
    full = kernels.quantize_int8_scaled_group([whole], [scale], [77])[0]
    torch.cuda.synchronize()
    for x, f, a, b in zip(xs, firsts, got, want):
        assert torch.equal(a, b)
        assert torch.equal(a, full[f:f + x.numel()])


@pytest.mark.cuda
def test_cuda_bertbase_sharded_directory_round_trip(card, tmp_path):
    """A BertBase-width spmd state (1 x 1 x 1 mesh) after one bf16 step:
    its sharded directory, saved on the card and restored into a fresh
    state there, bit for bit (the parameters and Adam's moments)."""
    from pytorch_distributed_nn_tpu_torch.data.text import MLMBatches
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.models.convert import state_leaves
    from pytorch_distributed_nn_tpu_torch.optim import (
        build_optimizer,
        make_schedule,
    )
    from pytorch_distributed_nn_tpu_torch.parallel.mesh import make_mesh
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training import spmd

    def state(seed):
        mesh = make_mesh(None)
        full = build_model("BertBase", dtype="bfloat16").init_weights(
            torch.Generator().manual_seed(seed))
        local = spmd.shard_model(
            full, build_model("BertBase", dtype="bfloat16", mesh=mesh), mesh)
        sched = make_schedule(1e-4)
        return mesh, spmd.create_spmd_state(
            local, lambda p: build_optimizer("adam", p, sched), mesh, card)

    mesh, a = state(0)
    x, y = next(MLMBatches(vocab_size=30522, seq_len=128, batch_size=4))
    spmd.build_spmd_train_step(mesh)(
        a, (torch.from_numpy(x).long().to(card),
            torch.from_numpy(y).long().to(card)))
    path = ckpt.save_sharded(str(tmp_path), a)
    _, b = state(1)
    ckpt.restore_checkpoint(path, b)
    want = {k: np.asarray(v) for k, _, v in
            state_leaves(ckpt.state_tree(a))}
    got = {k: np.asarray(v) for k, _, v in state_leaves(ckpt.state_tree(b))}
    assert set(got) == set(want) and b.step == 1
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def _two_artifacts(tmp_path, network, **model_kw):
    """Random-init port checkpoints of ``network`` at steps 1 and 2
    (other seeds), exported: {step: artifact dir}."""
    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        export_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
    from pytorch_distributed_nn_tpu_torch.training.train_step import (
        create_train_state,
    )

    text = network.startswith("Bert")
    td = str(tmp_path / "td")
    out = {}
    for step in (1, 2):
        model = build_model(network, 0 if text else 10, **model_kw)
        model.init_weights(torch.Generator().manual_seed(step))
        state = create_train_state(
            model, lambda p: build_optimizer("sgd", p, 0.1), "cpu")
        state.step = step
        ckpt.save_checkpoint(td, state, step=step)
        out[step] = str(tmp_path / f"art{step}")
        export_artifact(td, out[step], step=step, network=network,
                        num_classes=0 if text else 10, model_kw=model_kw)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("network", ["ResNet20", "BertTiny"])
def test_cuda_shadow_equals_a_fresh_engine_with_tf32_off(card, tmp_path,
                                                         network):
    """A shadow engine on the card (the canary's second engine) gives a
    fresh engine's logits on its artifact bit for bit, runs its forwards
    with TF32 off while the process has it on, and shares the stable
    engine's warm set: no retrace on either."""
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )

    kw = {"dtype": "float32"} if network == "BertTiny" else {}
    arts = _two_artifacts(tmp_path, network, **kw)
    seq = {"seq_buckets": (8, 128)} if network == "BertTiny" else {}
    stable = InferenceEngine(arts[1], batch_buckets=(1, 2, 4), device=card,
                             **seq)
    stable.warmup()
    fresh = InferenceEngine(arts[2], batch_buckets=(1, 2, 4), device=card,
                            **seq)
    rng = np.random.RandomState(0)
    if network == "BertTiny":
        xs = [rng.randint(1, stable.vocab_size, size=n).astype(np.int32)
              for n in (5, 77, 128)]
    else:
        xs = [rng.rand(32, 32, 3).astype(np.float32) for _ in range(3)]
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    try:
        matmul.allow_tf32, cudnn.allow_tf32 = True, True
        shadow = stable.shadow(arts[2])
        seen = []
        shadow.model.register_forward_hook(lambda *_: seen.append(
            (matmul.allow_tf32, cudnn.allow_tf32)))
        shadow.warm_thread()
        got, stats = shadow.infer(xs)
        want, _ = fresh.infer(xs)
        torch.cuda.synchronize()
        assert set(seen) == {(False, False)}
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
    assert stats["version"] == fresh.version != stable.version
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert stable.retraces() == shadow.retraces() == 0


@pytest.mark.cuda
def test_cuda_swap_between_batches_under_a_running_batcher(card, tmp_path):
    """Requests stream through a Batcher on the card while the engine
    swaps back and forth: each answer is wholly one version's logits
    (the version it reports), and nothing is built after warmup."""
    import threading

    from pytorch_distributed_nn_tpu_torch.observability.core import (
        Telemetry,
    )
    from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )

    arts = _two_artifacts(tmp_path, "ResNet20")
    engine = InferenceEngine(arts[1], batch_buckets=(1, 2, 4, 8),
                             device=card)
    engine.warmup()
    x = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
    want = {}
    for art in arts.values():
        ref = InferenceEngine(art, batch_buckets=(1,), device=card)
        out, stats = ref.infer([x])
        want[stats["version"]] = out[0]
    batcher = Batcher(engine, telemetry=Telemetry())
    stop, answers = threading.Event(), []

    def client():
        while not stop.is_set():
            req = batcher.submit(x, timeout_s=30.0)
            answers.append((req.wait(timeout=60.0), req.version))

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for i in range(10):
            engine.swap(arts[2] if i % 2 == 0 else arts[1])
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        batcher.close()
    assert engine.swaps == 10 and engine.retraces() == 0
    assert len(answers) > 10 and {v for _, v in answers} <= set(want)
    for out, version in answers:
        # a coalesced batch's convolutions may sum in another order than
        # one row's: 1e-4 (the engine's card-vs-CPU tolerance); the other
        # version's logits are far off
        for v, ref in want.items():
            err = float(np.abs(out - ref).max())
            assert err <= 1e-4 if v == version else err > 1e-2
