"""The port's elastic resume (``resilience/elastic.py`` and the
trainer's use of it), held against the JAX package's: the degree and
microbatch rules over a grid, the plan both packages read from one
port-written train_dir, the ``elastic_resume`` event and the
``--strict-geometry`` error, and a LeNet run on 4 gloo ranks resumed on
2 whose losses stay within 1e-5 of the uninterrupted 4-rank run."""

import json
import os

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one intra-op thread)
from pytorch_distributed_nn_tpu.resilience import elastic as jelastic
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
from pytorch_distributed_nn_tpu_torch.resilience import elastic
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    create_train_state,
)
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
from torch_ranks import run_ranks

#: losses of the resumed run against the uninterrupted one: the same
#: global batch's mean gradient, summed over 2 ranks instead of 4 (f32
#: reduction order)
LOSS_TOL = 1e-5


@pytest.mark.parametrize("batch", [1, 12, 64, 96, 97, 1024])
def test_degree_and_microbatch_rules_equal_jax(batch):
    for avail in range(1, 10):
        for tp, sp in ((1, 1), (2, 1), (1, 2), (2, 2)):
            for req in (None, 1, 3, 8):
                args = (avail, batch, tp, sp, req)
                try:
                    want = jelastic.derive_data_parallel(*args)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        elastic.derive_data_parallel(*args)
                    assert str(got.value) == str(e)
                    continue
                assert elastic.derive_data_parallel(*args) == want
                for accum in (1, 2, 3, 4, 8):
                    assert elastic.rescale_grad_accum(batch, want, accum) \
                        == jelastic.rescale_grad_accum(batch, want, accum)


def _port_train_dir(path, world, step=3, where="checkpoint"):
    """A train_dir with one port checkpoint of a run of ``world`` ranks;
    its geometry in the checkpoint's manifest, or only in the run's
    telemetry manifest, or only in heartbeat.json."""
    model = build_model("LeNet").init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda ps: build_optimizer(
        "sgd", ps, 0.1, momentum=0.9), "cpu")
    geom = elastic.rank_geometry(world)
    d = str(path)
    p = ckpt.save_checkpoint(d, state, step=step, geometry=geom)
    if where != "checkpoint":
        meta = ckpt.meta_path(p)
        with open(meta) as f:
            doc = json.load(f)
        del doc["geometry"]
        with open(meta, "w") as f:
            json.dump(doc, f)
    if where == "manifest":
        with open(os.path.join(d, "telemetry.jsonl"), "w") as f:
            f.write(json.dumps({"kind": "manifest", "geometry": geom}) + "\n")
    if where == "heartbeat":
        with open(os.path.join(d, "heartbeat.json"), "w") as f:
            json.dump({"step": step, "geometry": geom}, f)
    return d


def _plan_dict(plan, drop_processes=False):
    if plan is None:
        return None
    out = {"step": plan.step, "old": plan.old.to_dict(),
           "new": plan.new.to_dict(), "num_workers": plan.num_workers,
           "grad_accum": plan.grad_accum, "batch_size": plan.batch_size,
           "changed": plan.changed, "events": plan.event_fields(),
           "describe": plan.describe()}
    if drop_processes:  # one JAX process drives every device
        for d in (out["new"], out["events"]["new"]):
            d.pop("processes")
        out.pop("changed")
        out.pop("describe")
    return out


@pytest.mark.parametrize("where", ["checkpoint", "manifest", "heartbeat"])
@pytest.mark.parametrize("written", [1, 2, 4])
def test_both_packages_plan_a_port_train_dir_alike(tmp_path, where,
                                                   written):
    d = _port_train_dir(tmp_path, written, where=where)
    for avail, req, accum in ((1, None, 1), (1, 4, 2), (2, None, 2),
                              (2, 4, 4), (3, None, 1), (4, 4, 1),
                              (8, None, 3)):
        kw = dict(batch_size=48, num_workers=req, grad_accum=accum)
        got = elastic.plan_resume(d, avail, **kw)
        want = jelastic.plan_resume(d, avail, **kw)
        if where == "heartbeat":
            # the JAX fallback reads the heartbeat through its own
            # supervisor's reader: the same geometry
            assert got.old == elastic.Geometry.from_dict(
                elastic.rank_geometry(written))
        live_is_one_process = got.num_workers == 1
        assert _plan_dict(got, not live_is_one_process) == _plan_dict(
            want, not live_is_one_process)
    assert elastic.plan_resume(str(tmp_path / "empty"), 2,
                               batch_size=8) is None


_LENET = dict(network="LeNet", dataset="MNIST", batch_size=64,
              test_batch_size=64, synthetic_size=64, lr=0.05, momentum=0.9,
              log_every=1)


def _run(world, train_dir, **kw):
    """``world`` gloo ranks (threads), each a Trainer; rank 0's losses and
    trainer."""
    def one(rank, group):
        trainer = Trainer(TrainConfig(**_LENET, train_dir=train_dir, **kw),
                          device="cpu", group=group)
        try:
            history = trainer.train()
        finally:
            trainer.close()
        return [r["loss"] for r in history], trainer

    return run_ranks(world, one)[0]


def test_four_ranks_resumed_on_two_keep_the_global_batch(tmp_path):
    """The set is one global batch (MNIST has no augmentation), so the
    image loader's restart on resume (the JAX package's semantics) gives
    every step the same images and the resumed losses stay comparable to
    the uninterrupted run's."""
    want, _ = _run(4, str(tmp_path / "straight"), max_steps=6,
                   num_workers=4)
    part = str(tmp_path / "part")
    first, _ = _run(4, part, max_steps=3, eval_freq=3, num_workers=4)
    np.testing.assert_allclose(first, want[:3], rtol=0, atol=0)
    with pytest.raises(ValueError) as e:
        _run(2, part, max_steps=6, num_workers=4, resume=True,
             strict_geometry=True)
    msg = str(e.value)
    assert "--strict-geometry" in msg and "data=4" in msg \
        and "data=2" in msg
    assert ckpt.all_steps(part) == [3]  # nothing was touched
    got, trainer = _run(2, part, max_steps=6, eval_freq=3, num_workers=4,
                        resume=True)
    assert trainer.start_step == 3 and trainer.n_workers == 2
    np.testing.assert_allclose(got, want[3:], rtol=0, atol=LOSS_TOL)
    with open(os.path.join(part, "telemetry.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    (ev,) = [r for r in recs if r.get("type") == "elastic_resume"]
    assert ev["step"] == 3 and ev["num_workers"] == 2
    assert ev["batch_size"] == 64 and ev["per_device_batch"] == 32
    assert ev["old"]["mesh"] == {"data": 4, "seq": 1, "model": 1}
    assert ev["new"] == elastic.rank_geometry(2)
    manifests = [r for r in recs if r.get("kind") == "manifest"]
    assert manifests[-1]["config"]["num_workers"] == 2
    assert manifests[-1]["geometry"] == elastic.rank_geometry(2)
    assert ckpt.checkpoint_geometry(ckpt.checkpoint_path(part, 6)) \
        == elastic.rank_geometry(2)
