"""topk error-feedback residuals in checkpoints (pytorch_distributed_nn_tpu_torch:
models/convert, training/checkpoint, the trainer's gather, scatter and
elastic reset) against the JAX package's layout, on the CPU.

- JAX writes, the port reads: a LeNet and a BertTiny state with random
  residuals stacked over 2 replicas, as the JAX ``TrainState`` holds
  them (``(n, *shape)`` per parameter under the flax names): each rank's
  residuals equal its JAX row bit for bit, and the port writes the same
  file back, byte for byte.
- The port writes, JAX reads: a 2-rank topk run's checkpoint restores
  into a JAX template of 2 replicas, every rank's row equal to that
  rank's live residuals bit for bit.
- Resume: at the same dp degree each rank gets its row back bit for bit
  (rank 0 reads, the others receive theirs); at another degree the
  residuals restart at zero and ``elastic_resume`` says so;
  ``--strict-geometry`` raises; a restore of another replica count
  without an elastic plan raises naming both geometries; an emergency
  save whose gather fails writes no residuals, and a resume from it
  starts at zero.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.models import build_model as jax_build_model
from pytorch_distributed_nn_tpu.optim import sgd as jax_sgd
from pytorch_distributed_nn_tpu.parallel import make_grad_sync as jax_sync
from pytorch_distributed_nn_tpu.parallel.partitioning import unbox
from pytorch_distributed_nn_tpu.training import checkpoint as jckpt
from pytorch_distributed_nn_tpu.training.train_step import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    GeometryMismatch,
    cnn_to_state_dict,
    flax_to_state_dict,
)
from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    create_train_state,
)
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
from torch_ranks import run_ranks
import torch_cpu  # noqa: F401  (one intra-op thread)

BERT_KW = dict(vocab_size=64, max_len=16, d_model=32, num_heads=2,
               num_layers=1, d_ff=64)


def _jax_state(network, n):
    """A JAX TrainState of ``n`` replicas with topk sync and random
    residuals."""
    if network == "LeNet":
        model, shape, dtype = jax_build_model("LeNet", 10), (28, 28, 1), \
            jnp.float32
    else:
        model = jax_build_model("BertTiny", dtype=jnp.float32,
                                dropout_rate=0.0, **BERT_KW)
        shape, dtype = (16,), jnp.int32
    sync = jax_sync("allreduce", compression="topk")
    state = jax_create_train_state(model, jax_sgd(0.1, momentum=0.9), sync,
                                   jax.random.PRNGKey(0), shape,
                                   num_replicas=n, input_dtype=dtype)
    rng = np.random.RandomState(7)
    ef = jax.tree.map(lambda z: jnp.asarray(
        rng.randn(*z.shape).astype(np.float32)), state.ef_state)
    return state.replace(ef_state=unbox(ef), step=jnp.asarray(3, jnp.int32))


def _port_state(network, rank, n):
    model = (build_model("LeNet") if network == "LeNet" else
             build_model("BertTiny", dtype="float32", dropout_rate=0.0,
                         **BERT_KW))
    state = create_train_state(
        model, lambda ps: build_optimizer("sgd", ps, 0.1, momentum=0.9),
        "cpu", rank=rank)
    state.ef_state = [torch.zeros_like(p) for p in model.parameters()]
    state.replicas = n
    return state


def _row(network, ef, r):
    tree = jax.tree.map(lambda a: np.asarray(a)[r], ef)
    return (cnn_to_state_dict(tree) if network == "LeNet"
            else flax_to_state_dict(tree))


@pytest.mark.parametrize("network", ["LeNet", "BertTiny"])
def test_jax_topk_checkpoints_restore_and_rewrite_byte_for_byte(network,
                                                                tmp_path):
    n = 2
    jstate = _jax_state(network, n)
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), jstate)
    states = [_port_state(network, r, n) for r in range(n)]
    for r, state in enumerate(states):
        ckpt.restore_checkpoint(path, state)
        want = _row(network, jstate.ef_state, r)
        for (name, _), e in zip(state.model.named_parameters(),
                                state.ef_state):
            assert e.dtype == want[name].dtype
            assert e.numpy().tobytes() == want[name].numpy().tobytes(), name
    rows = [torch.stack([s.ef_state[i] for s in states])
            for i in range(len(states[0].ef_state))]
    mine = ckpt.save_checkpoint(str(tmp_path / "port"), states[0],
                                ef_rows=rows)
    with open(path, "rb") as a, open(mine, "rb") as b:
        assert a.read() == b.read()


def test_a_state_of_several_replicas_needs_the_gathered_rows(tmp_path):
    state = _port_state("LeNet", 0, 2)
    with pytest.raises(ValueError, match="gathered ef_rows"):
        ckpt.save_checkpoint(str(tmp_path), state)
    path = ckpt.save_checkpoint(str(tmp_path), state, ef_rows=())
    assert ckpt.load_raw(path)["ef_state"] is None


_LENET = dict(network="LeNet", dataset="MNIST", batch_size=16,
              test_batch_size=32, synthetic_size=64, compression="topk",
              topk_ratio=0.1, lr=0.05)


def _run(cfg, n, after=None):
    """``n`` ranks train ``cfg``; each returns its residuals (and
    ``after(trainer)``)."""
    def one(rank, group):
        trainer = Trainer(dataclasses.replace(cfg), device="cpu",
                          group=group)
        try:
            trainer.train()
            extra = after(trainer) if after is not None else None
            return [e.clone() for e in trainer.state.ef_state], extra
        finally:
            trainer.close()

    return run_ranks(n, one)


def test_topk_run_saves_every_rank_and_resumes_each_row(tmp_path):
    d = str(tmp_path)
    cfg = TrainConfig(**_LENET, num_workers=2, max_steps=4, eval_freq=4,
                      train_dir=d, async_ckpt=False)
    saved = [ef for ef, _ in _run(cfg, 2)]
    path = ckpt.checkpoint_path(d, 4)
    # JAX reads it into a template of 2 replicas: each row is that rank's
    template = _jax_state("LeNet", 2)
    restored = jckpt.restore_checkpoint(path, template)
    names = [n for n, _ in build_model("LeNet").named_parameters()]
    for r in range(2):
        row = _row("LeNet", restored.ef_state, r)
        for name, e in zip(names, saved[r]):
            assert row[name].numpy().tobytes() == e.numpy().tobytes(), name
    assert any(float(e.abs().max()) > 0 for e in saved[1])
    # the same degree: rank 0 reads, each rank gets its row back
    resumed = _run(dataclasses.replace(cfg, resume=True), 2)
    for r in range(2):
        for a, b in zip(resumed[r][0], saved[r]):
            assert torch.equal(a, b)


def test_another_dp_degree_resets_the_residuals_or_raises(tmp_path):
    d = str(tmp_path)
    cfg = TrainConfig(**_LENET, num_workers=2, max_steps=2, eval_freq=2,
                      train_dir=d)  # the async writer's snapshot
    _run(cfg, 2)
    one = dataclasses.replace(cfg, num_workers=None, resume=True)
    with pytest.raises(ValueError, match="strict-geometry"):
        Trainer(dataclasses.replace(one, strict_geometry=True),
                device="cpu")
    trainer = Trainer(one, device="cpu")
    try:
        assert trainer.start_step == 2
        assert all(float(e.abs().max()) == 0 for e in trainer.state.ef_state)
    finally:
        trainer.close()
    with open(os.path.join(d, "telemetry.jsonl")) as f:
        events = [json.loads(line) for line in f]
    ev = [e for e in events if e.get("type") == "elastic_resume"]
    assert ev[-1]["ef_state"] == "reset" and ev[-1]["num_workers"] == 1
    # without an elastic plan a restore of another replica count raises
    state = _port_state("LeNet", 0, 1)
    with pytest.raises(GeometryMismatch, match="geometry mismatch"):
        ckpt.restore_checkpoint(ckpt.checkpoint_path(d, 2), state)


class _GoneGroup:
    """A group whose peer is gone: its gather fails, as gloo's does when
    a rank's connection closed; everything else is the real group's."""

    def __init__(self, group):
        self._group = group

    def gather(self, *args):
        raise RuntimeError("Connection closed by peer")

    def __getattr__(self, name):
        return getattr(self._group, name)


def test_emergency_save_without_a_rank_writes_no_residuals(tmp_path):
    """A rank is gone: the emergency save's gather fails, the checkpoint
    holds no residuals, and a resume starts them at zero."""
    d = str(tmp_path)
    cfg = TrainConfig(**_LENET, num_workers=2, max_steps=2, train_dir=d)

    def one(rank, group):
        trainer = Trainer(dataclasses.replace(cfg), device="cpu",
                          group=group)
        try:
            trainer.train()
            trainer.group = _GoneGroup(trainer.group)
            return trainer._emergency_save()
        finally:
            trainer.close()

    path, none = run_ranks(2, one)
    assert none is None and ckpt.load_raw(path)["ef_state"] is None
    state = _port_state("LeNet", 0, 1)
    state.ef_state = [torch.ones_like(e) for e in state.ef_state]
    ckpt.restore_checkpoint(path, state)
    assert all(float(e.abs().max()) == 0 for e in state.ef_state)
