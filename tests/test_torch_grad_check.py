"""The gradient check of ``chip_smoke.py`` (``leaf_grad_errors``) on the CPU.

On the card it holds every parameter's gradient of BertBase on the kernels
against the plain model, relative to the plain gradient's size, within
``GRAD_TOL``. Here a BertTiny cut to test size (f32, no dropout) shows
where that tolerance sits: two sound backwards that differ only in their
arithmetic (blockwise attention against attention over materialised
scores) read far below it, and a backward whose dk is zeroed or off by
0.2% reads far above it.
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.transformer import full_attention
from pytorch_distributed_nn_tpu_torch.ops import reference
from pytorch_distributed_nn_tpu_torch.ops.metrics import masked_cross_entropy

import torch_cpu  # noqa: F401  (one intra-op thread)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

KW = dict(dtype="float32", dropout_rate=0.0, vocab_size=64, max_len=32,
          d_model=64, num_heads=4, num_layers=2, d_ff=128)


def _faulty_attention(dk_scale):
    """Blockwise attention whose backward gives ``dk_scale * dk``; the
    forward's value is unchanged."""
    def attn(q, k, v, mask=None, causal=False):
        k = k * dk_scale + (k * (1 - dk_scale)).detach()
        return reference.flash_attention(q, k, v, mask, causal=causal)
    return attn


def _grads(attn_fn, state, tokens, labels):
    model = build_model("BertTiny", use_kernels=False, attn_fn=attn_fn, **KW)
    model.load_state_dict(state)
    masked_cross_entropy(model(tokens), labels).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("dk_scale,sound", [(None, True), (0.0, False),
                                            (0.998, False)])
def test_gradient_check_separates_sound_and_faulty_backwards(dk_scale, sound):
    init = build_model("BertTiny", **KW).init_weights(
        torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 64, (2, 32)))
    labels = torch.from_numpy(
        np.where(rng.rand(2, 32) < 0.3, rng.randint(0, 64, (2, 32)), -1))
    want = _grads(full_attention, init.state_dict(), tokens, labels)
    attn = (reference.flash_attention if dk_scale is None
            else _faulty_attention(dk_scale))
    errs = chip_smoke.leaf_grad_errors(
        _grads(attn, init.state_dict(), tokens, labels), want)
    assert errs.keys() == want.keys()
    worst = max(r for r, _ in errs.values())
    if sound:
        # two sound f32 backwards agree to about 1e-6 of each leaf's size
        assert worst <= chip_smoke.GRAD_TOL / 10
    else:
        # the fault shows on every key projection, at 1 - dk_scale
        for name, (rel, _) in errs.items():
            if name.endswith("key.weight"):
                assert rel >= 10 * chip_smoke.GRAD_TOL, name
        assert worst > chip_smoke.GRAD_TOL


def test_gradient_check_reads_a_missing_gradient_as_inf():
    want = {"w": torch.ones(3), "key.weight": torch.ones(2),
            "key.bias": torch.full((2,), 1e-12)}
    got = {"w": None, "key.weight": torch.ones(2),
           "key.bias": torch.zeros(2)}
    errs = chip_smoke.leaf_grad_errors(got, want)
    assert math.isinf(errs["w"][0]) and errs["key.weight"][0] == 0.0
    # the key bias, zero in exact arithmetic, is held against its weight
    assert errs["key.bias"] == (pytest.approx(1e-12), pytest.approx(1e-12))
