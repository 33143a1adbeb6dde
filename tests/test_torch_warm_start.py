"""The vocabulary-curriculum warm start (pytorch_distributed_nn_tpu_torch/
training/warm_start.py, ``train --warm-start``) against the JAX package's
``merge_resized``, and ``--remat`` (models/transformer.py: each block
under ``torch.utils.checkpoint`` with its dropout generator's state put
back for the recompute), on the CPU.

Tolerances: the merge is exact (the same arrays and report as JAX's);
``remat`` with dropout 0.1 gives the run without it exactly (0.0: the
recompute draws the forward's masks and repeats its arithmetic).
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.training import warm_start as jws
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    state_dict_to_flax,
    tree_leaves,
)
from pytorch_distributed_nn_tpu_torch.ops.metrics import mlm_sums
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training import warm_start as ws
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
from torch_ranks import run_ranks
import torch_cpu  # noqa: F401  (one intra-op thread)

SMALL = dict(max_len=32, d_model=32, num_heads=4, num_layers=2, d_ff=64)


def _params(vocab, seed, **over):
    m = build_model("BertTiny", **{**SMALL, "vocab_size": vocab, **over},
                    dtype="float32")
    m.init_weights(torch.Generator().manual_seed(seed))
    return state_dict_to_flax(m.state_dict(), 4)


def test_merge_resized_matches_jax():
    src = _params(48, 0, max_len=16)
    src["stale_head"] = {"kernel": np.ones((3, 3), np.float32)}
    tgt = _params(64, 1)
    got, rep = ws.merge_resized(src, tgt)
    want, jrep = jws.merge_resized(src, tgt)
    assert rep == jrep
    assert rep["sliced"] == 3 and rep["unused_paths"] == [
        "stale_head/kernel"]
    flat_want = dict(tree_leaves(want))
    for path, a in tree_leaves(got):
        np.testing.assert_array_equal(a, np.asarray(flat_want[path]))
    emb = got["encoder"]["token_embed"]["embedding"]
    np.testing.assert_array_equal(
        emb[:48], src["encoder"]["token_embed"]["embedding"])
    np.testing.assert_array_equal(
        emb[48:], tgt["encoder"]["token_embed"]["embedding"][48:])


@pytest.mark.parametrize("bad,match", [
    (dict(d_ff=128), "only vocabulary/positional"),
    (dict(), "rank mismatch"),
])
def test_merge_resized_refuses_like_jax(bad, match):
    src = _params(64, 0, **bad)
    if not bad:  # a leaf of another rank
        src["mlm_bias"] = src["mlm_bias"][None]
    tgt = _params(64, 1)
    with pytest.raises(ValueError, match=match) as got:
        ws.merge_resized(src, tgt)
    with pytest.raises(ValueError) as want:
        jws.merge_resized(src, tgt)
    assert str(got.value) == str(want.value)


_BASE = dict(network="BertTiny", dataset="MLMSynth", batch_size=8,
             test_batch_size=8, seq_len=32, max_steps=1, eval_batches=1)


@pytest.mark.parametrize("tp", [1, 2])
def test_vocabulary_curriculum_through_the_trainer(tmp_path, tp):
    """A vocab-48 run's FILE checkpoint warm-starts a vocab-64 run (at
    tp = 2 on two gloo ranks too): the trunk is the source's, the new
    vocabulary rows the target's fresh init, and the run trains."""
    src_dir = str(tmp_path / "src")
    src = TrainConfig(**{**_BASE, "vocab_size": 48, "eval_freq": 1,
                         "train_dir": src_dir, "async_ckpt": False})
    t = Trainer(src, device="cpu")
    try:
        t.train()
    finally:
        t.close()
    path = ckpt.checkpoint_path(src_dir, 1)
    trained = ckpt.load_raw(path)["params"]
    cfg = TrainConfig(**{**_BASE, "vocab_size": 64, "warm_start": path,
                         "tensor_parallel": tp})

    def run(r, group):
        tr = Trainer(cfg, device="cpu", group=group)
        try:
            tree = ckpt.state_tree(tr.state)
            return tree["params"], tr.warm_start_report, \
                [h["loss"] for h in tr.train()]
        finally:
            tr.close()

    out = run_ranks(tp, run)
    params, report, losses = out[0]
    assert report["copied"] + report["sliced"] == len(
        list(tree_leaves(trained)))
    assert report["sliced_paths"] == ["encoder/token_embed/embedding",
                                      "mlm_bias"]
    assert np.isfinite(losses).all()
    fresh = build_model("BertTiny", vocab_size=64, max_len=32,
                        dtype="float32").init_weights(
        torch.Generator().manual_seed(cfg.seed))
    fresh_emb = fresh.encoder.token_embed.weight.detach().numpy()
    for r, (p, _, _) in enumerate(out):
        emb = p["encoder"]["token_embed"]["embedding"]
        rows = range(r * 64 // tp, (r + 1) * 64 // tp)
        for j, v in enumerate(rows):
            want = (trained["encoder"]["token_embed"]["embedding"][v]
                    if v < 48 else fresh_emb[v])
            np.testing.assert_array_equal(emb[j], want)
        np.testing.assert_array_equal(
            p["encoder"]["ln_final"]["scale"],
            trained["encoder"]["ln_final"]["scale"])


@pytest.mark.parametrize("net", ["BertTiny", "GptTiny"])
def test_remat_equals_no_remat_with_dropout(net):
    """One forward and backward in training mode with dropout 0.1: the
    loss and every gradient with ``remat`` equal the run without, exactly
    (the recompute redraws the forward's masks)."""
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, 64, (4, 32))).long()
    lab = torch.where(torch.from_numpy(rng.random((4, 32)) < 0.3), tok,
                      torch.full_like(tok, -1))
    out = []
    for remat in (False, True):
        m = build_model(net, **SMALL, vocab_size=64, dtype="float32",
                        dropout_rate=0.1, remat=remat)
        m.init_weights(torch.Generator().manual_seed(0))
        m.set_dropout_generator(torch.Generator().manual_seed(5))
        m.train()
        s = mlm_sums(m(tok), lab)
        s["loss_sum"].backward()
        out.append((float(s["loss_sum"]),
                    {n: p.grad.clone() for n, p in m.named_parameters()}))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        assert torch.equal(g, out[1][1][n]), n


def test_remat_trainer_under_tp_and_sp():
    """``--remat`` with dropout through the trainer on a (1, 2, 2) mesh of
    gloo ranks: the losses equal the run without remat exactly."""
    def run(remat):
        cfg = TrainConfig(**{**_BASE, "max_steps": 2, "vocab_size": 64,
                             "remat": remat, "tensor_parallel": 2,
                             "seq_parallel": 2})

        def fn(r, group):
            tr = Trainer(cfg, device="cpu", group=group)
            try:
                return [h["loss"] for h in tr.train()]
            finally:
                tr.close()

        return run_ranks(4, fn)[0]

    assert run(True) == run(False)
