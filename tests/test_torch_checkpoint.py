"""The port's checkpoints (pytorch_distributed_nn_tpu_torch: ops/host_codec,
utils/flax_msgpack, models/convert's training-state converter,
training/checkpoint, resilience/supervisor's validated resume, trainer
resume) against the JAX package's, on the CPU.

- The host codec: either package decompresses the other's blobs, and both
  give the same bytes for the same input.
- The msgpack writer gives ``flax.serialization``'s bytes.
- JAX writes, the port reads: LeNet with SGD momentum (written by the JAX
  ``Trainer``: ``torch_jax_runs.py``), ResNet-20 with BatchNorm and SGD momentum, BertTiny with
  Adam and amsgrad (the JAX train step and ``save_checkpoint``), each as
  ``PDTN`` and ``PDTZ``: the port's state equals the JAX arrays bit for
  bit, and one step from it on the same batch matches the JAX step from
  the same checkpoint at the port's step tests' tolerance (1e-5 on the
  loss and on every parameter and BatchNorm statistic).
- The port writes, JAX reads: ``verify_checkpoint`` passes, and
  ``restore_checkpoint`` (a JAX template) and ``load_raw`` give leaves
  equal to the port's bit for bit.
- Resume: BertTiny MLM with dropout, 4 steps straight against 2, resume,
  2: parameters equal bit for bit; LeNet's momentum is restored.
- Integrity: truncation, legacy manifest-less files, bad magic, sharded
  directories, quarantine, and what ``--keep-last`` GC keeps.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pytorch_distributed_nn_tpu.data.text import MLMBatches as JaxBatches
from pytorch_distributed_nn_tpu.models import build_model as jax_build_model
from pytorch_distributed_nn_tpu.ops import host_codec as jax_codec
from pytorch_distributed_nn_tpu.ops import metrics as jax_metrics
from pytorch_distributed_nn_tpu.optim import adam as jax_adam
from pytorch_distributed_nn_tpu.optim import sgd as jax_sgd
from pytorch_distributed_nn_tpu.parallel import make_grad_sync as jax_sync
from pytorch_distributed_nn_tpu.parallel import make_mesh
from pytorch_distributed_nn_tpu.parallel.mesh import DATA_AXIS
from pytorch_distributed_nn_tpu.training import checkpoint as jckpt
from pytorch_distributed_nn_tpu.training.train_step import (
    build_train_step as jax_build_train_step,
)
from pytorch_distributed_nn_tpu.training.train_step import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    cnn_to_state_dict,
    flax_to_state_dict,
)
from pytorch_distributed_nn_tpu_torch.ops import host_codec
from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    make_grad_sync,
)
from pytorch_distributed_nn_tpu_torch.resilience.supervisor import (
    resume_latest_valid,
)
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    build_image_train_step,
    build_train_step,
    create_train_state,
)
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
from pytorch_distributed_nn_tpu_torch.utils import flax_msgpack
import torch_cpu  # noqa: F401  (one intra-op thread)
from torch_jax_runs import lenet_run

#: one step from a restored state against the JAX step (the step tests'
#: tolerance: test_torch_train.py, test_torch_image_train.py)
STEP_TOL = 1e-5
BERT_KW = dict(vocab_size=64, max_len=32, d_model=64, num_heads=4,
               num_layers=2, d_ff=128)
L = 32


def assert_trees_equal(got, want, where=""):
    """Same keys, same None leaves, same dtypes and values bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (where, sorted(set(got) ^ set(want)) if isinstance(got, dict)
             else type(got))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{where}/{k}")
    elif want is None:
        assert got is None, where
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, g.dtype,
                                                           w.dtype)
        assert g.tobytes() == w.tobytes(), where


# -- the codec and the msgpack writer ---------------------------------------


@pytest.mark.parametrize("width", [1, 4])
def test_codec_blobs_cross_packages(width):
    x = (np.random.default_rng(width).standard_normal(5000) * 0.1) \
        .astype(np.float32).tobytes() + b"tail"
    ours, theirs = host_codec.compress(x, width=width), \
        jax_codec.compress(x, width=width)
    assert ours == theirs
    assert b"".join(host_codec.compress_parts(
        np.frombuffer(x, np.uint8), width=width)) == theirs
    assert jax_codec.decompress(ours) == x
    assert host_codec.decompress(theirs) == x


def test_array_codec_crosses_packages():
    a = np.random.default_rng(0).standard_normal((33, 7)).astype(np.float32)
    assert host_codec.w_compress(a) == jax_codec.w_compress(a)
    np.testing.assert_array_equal(jax_codec.w_decompress(
        host_codec.w_compress(a)), a)
    np.testing.assert_array_equal(host_codec.w_decompress(
        jax_codec.w_compress(a)), a)
    assert host_codec.available()


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint32", "int8",
                                   "float16", "bool"])
def test_msgpack_writer_gives_flax_bytes(dtype):
    rng = np.random.default_rng(1)
    leaves = [np.asarray(rng.standard_normal(s) * 9).astype(dtype)
              for s in [(), (1,), (2,), (5, 3), (300, 70)]]

    def tree():  # flax serialises in place: one fresh tree per writer
        return {"step": np.asarray(7, np.int32), "none": None, "empty": {},
                "leaves": {str(i): a for i, a in enumerate(leaves)},
                "t": leaves[-1].T}

    want = serialization.msgpack_serialize(tree(), in_place=True)
    assert flax_msgpack.pack_array(tree()).tobytes() == want
    assert flax_msgpack.packb(tree()) == want
    assert_trees_equal(flax_msgpack.unpackb(want),
                       serialization.msgpack_restore(want))


# -- the three states, written by the JAX package ---------------------------


def _images(step, B=8, hw=16, c=3):
    rng = np.random.RandomState(300 + step)
    return (rng.randn(B, hw, hw, c).astype(np.float32),
            rng.randint(0, 10, size=B).astype(np.int32))


def _port_image_step(state, batch, i):
    x, y = batch
    step = build_image_train_step(make_grad_sync(None, "local"))
    return step(state, (torch.from_numpy(x), torch.from_numpy(y).long()), i)


def _port_text_step(state, batch, i):
    x, y = batch
    return build_train_step()(state, (torch.from_numpy(x).long(),
                                      torch.from_numpy(y).long()))


class Case:
    """A JAX state after two steps, the JAX step, the batch of the third
    step, and how the port builds the same model and optimizer."""

    def __init__(self, jstate, jstep, batch, port_model, port_opt, port_step,
                 trainer_file=None):
        self.jstate, self.jstep, self.batch = jstate, jstep, batch
        self.port_model, self.port_opt = port_model, port_opt
        self.port_step = port_step
        #: the JAX Trainer's own model_step_<N>, where it wrote one
        self.trainer_file = trainer_file

    def port_state(self):
        return create_train_state(self.port_model(), self.port_opt, "cpu")

    def params(self, jstate):
        tree = jax.tree.map(np.asarray, (jstate.params, jstate.batch_stats))
        if "encoder" in tree[0]:
            return flax_to_state_dict(tree[0])
        return cnn_to_state_dict(*tree)


def _lenet(tmp):
    """Written by the JAX Trainer: LeNet, SGD momentum 0.9, 10 steps
    (torch_jax_runs.lenet_run, shared with test_torch_evaluator.py)."""
    trainer, d = lenet_run()
    step = trainer.train_step
    x, y = _images(2, B=16, hw=28, c=1)
    return Case(trainer.state,
                lambda s, b: step(s, b, jax.random.PRNGKey(1)), (x, y),
                lambda: build_model("LeNet"),
                lambda ps: build_optimizer("sgd", ps, 0.01, momentum=0.9),
                _port_image_step,
                trainer_file=jckpt.checkpoint_path(d, 10))


def _resnet20(tmp):
    model = jax_build_model("ResNet20", 10)
    opt = jax_sgd(0.1, momentum=0.9)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    sync = jax_sync("allreduce")
    jstate = jax_create_train_state(model, opt, sync, jax.random.PRNGKey(0),
                                    (16, 16, 3))
    step = jax_build_train_step(model, opt, sync, mesh, donate=False)
    for i in range(2):
        jstate, _ = step(jstate, _images(i), jax.random.PRNGKey(1))
    return Case(jstate, lambda s, b: step(s, b, jax.random.PRNGKey(1)),
                _images(2), lambda: build_model("ResNet20"),
                lambda ps: build_optimizer("sgd", ps, 0.1, momentum=0.9),
                _port_image_step)


def _bert_tiny(tmp):
    model = jax_build_model("BertTiny", dtype=jnp.float32, dropout_rate=0.0,
                            **BERT_KW)
    opt = jax_adam(1e-3, amsgrad=True)
    mesh = make_mesh(1, 1, 1, devices=jax.devices()[:1])
    sync = jax_sync("local")
    jstate = jax_create_train_state(model, opt, sync, jax.random.PRNGKey(0),
                                    (L,), input_dtype=jnp.int32)
    step = jax_build_train_step(
        model, opt, sync, mesh,
        loss_fn=jax_metrics.make_global_masked_cross_entropy(DATA_AXIS),
        metrics_fn=jax_metrics.make_global_mlm_metrics(DATA_AXIS),
        donate=False)
    data = JaxBatches(vocab_size=64, seq_len=L, batch_size=4, seed=0)
    for _ in range(2):
        jstate, _ = step(jstate, next(data), jax.random.PRNGKey(1))
    return Case(jstate, lambda s, b: step(s, b, jax.random.PRNGKey(1)),
                next(data),
                lambda: build_model("BertTiny", dtype="float32",
                                    dropout_rate=0.0, **BERT_KW),
                lambda ps: build_optimizer("adam", ps, 1e-3, amsgrad=True),
                _port_text_step)


_CASES = {"LeNet": _lenet, "ResNet20": _resnet20, "BertTiny": _bert_tiny}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    @functools.lru_cache(maxsize=None)
    def get(name):
        return _CASES[name](tmp_path_factory.mktemp(name))
    return get


def _jax_file(case, tmp_path, fmt):
    if fmt == "PDTZ" and case.trainer_file is not None:
        path = case.trainer_file  # what the JAX Trainer wrote
    else:
        path = jckpt.save_checkpoint(str(tmp_path / "jax"), case.jstate,
                                     compress=fmt == "PDTZ")
    with open(path, "rb") as f:
        assert f.read(4) == fmt.encode()
    return path


@pytest.mark.parametrize("fmt", ["PDTN", "PDTZ"])
@pytest.mark.parametrize("name", ["LeNet", "ResNet20", "BertTiny"])
def test_port_restores_jax_checkpoints_bit_for_bit(cases, name, fmt,
                                                   tmp_path):
    case = cases(name)
    path = _jax_file(case, tmp_path, fmt)
    state = case.port_state()
    ckpt.restore_checkpoint(path, state)
    want = serialization.to_state_dict(jax.device_get(case.jstate))
    assert_trees_equal(ckpt.state_tree(state), want)
    assert state.step == int(case.jstate.step) == state.optimizer.count
    # one step from the restored state against the JAX step
    jstate, jm = case.jstep(jckpt.restore_checkpoint(path, case.jstate),
                            case.batch)
    m = case.port_step(state, case.batch, 2)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= STEP_TOL
    got = state.model.state_dict()
    for k, v in case.params(jstate).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=STEP_TOL, err_msg=k)


@pytest.mark.parametrize("fmt", ["PDTN", "PDTZ"])
@pytest.mark.parametrize("name", ["LeNet", "ResNet20", "BertTiny"])
def test_jax_reads_port_checkpoints_bit_for_bit(cases, name, fmt, tmp_path):
    case = cases(name)
    state = case.port_state()
    ckpt.restore_checkpoint(_jax_file(case, tmp_path, "PDTN"), state)
    case.port_step(state, case.batch, 2)  # a state the JAX side never had
    path = ckpt.save_checkpoint(str(tmp_path / "port"), state,
                                compress=fmt == "PDTZ")
    with open(path, "rb") as f:
        assert f.read(4) == fmt.encode()
    assert jckpt.verify_checkpoint(path) == (True, "ok")
    ours = ckpt.state_tree(state)
    restored = jckpt.restore_checkpoint(path, case.jstate)
    assert_trees_equal(serialization.to_state_dict(jax.device_get(restored)),
                       ours)
    assert_trees_equal(jckpt.load_raw(path), ours)
    assert int(restored.step) == int(case.jstate.step) + 1


def test_restore_refuses_a_tree_that_is_not_the_states(cases, tmp_path):
    """Another optimizer's state raises before the state changes (as
    flax's from_state_dict refuses it), and a port-only key would make the
    JAX package refuse the file."""
    case = cases("BertTiny")
    path = _jax_file(case, tmp_path, "PDTZ")
    sgd = create_train_state(case.port_model(), lambda ps: build_optimizer(
        "sgd", ps, 0.1), "cpu")
    before = {k: v.clone() for k, v in sgd.model.state_dict().items()}
    with pytest.raises(ValueError, match="opt_state"):
        ckpt.restore_checkpoint(path, sgd)
    assert all(torch.equal(v, sgd.model.state_dict()[k])
               for k, v in before.items()) and sgd.step == 0
    plain = create_train_state(case.port_model(), lambda ps: build_optimizer(
        "adam", ps, 1e-3), "cpu")
    with pytest.raises(ValueError, match="nu_max"):
        ckpt.restore_checkpoint(path, plain)
    # params_only takes any optimizer (the evaluator's template)
    ckpt.restore_checkpoint(path, sgd, params_only=True)
    assert sgd.step == int(case.jstate.step)
    tree = ckpt.load_raw(path)
    tree["port_only"] = None
    bad = str(tmp_path / "bad")
    ckpt.save_checkpoint(bad, tree, step=2)
    with pytest.raises(ValueError):
        jckpt.restore_checkpoint(ckpt.checkpoint_path(bad, 2), case.jstate)


# -- resume ------------------------------------------------------------------

_MLM = dict(network="BertTiny", dataset="MLMSynth", batch_size=4,
            test_batch_size=4, seq_len=32, eval_batches=1, optimizer="adam",
            lr=1e-3, seed=5)


def _train(cfg):
    trainer = Trainer(cfg, device="cpu")
    try:
        history = trainer.train()
        return trainer, history, {k: v.clone()
                                  for k, v in trainer.model.state_dict().items()}
    finally:
        trainer.close()


def test_resumed_mlm_run_equals_the_uninterrupted_one(tmp_path):
    """Dropout on (BertTiny's 0.1): the generator is re-seeded from
    (seed, rank, step) and the batch stream restored from the sidecar."""
    straight = TrainConfig(**_MLM, max_steps=4, train_dir=str(tmp_path / "a"))
    assert _train(straight)[0].model.config.dropout_rate > 0
    _, want_hist, want = _train(straight)
    part = TrainConfig(**_MLM, max_steps=2, eval_freq=2,
                       train_dir=str(tmp_path / "b"))
    _train(part)
    assert ckpt.load_data_state(ckpt.checkpoint_path(
        part.train_dir, 2)) == {"format": "pdtn-mlm-state-v1", "kind": "mlm",
                                "counter": 2}
    trainer, hist, got = _train(TrainConfig(
        **_MLM, max_steps=4, eval_freq=2, resume=True,
        train_dir=part.train_dir))
    assert trainer.start_step == 2 and [r["step"] for r in hist] == [3, 4]
    assert [r["loss"] for r in hist] == [r["loss"] for r in want_hist[2:]]
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_resume_restores_momentum_and_continues_numbering(tmp_path):
    """Mirrors the JAX package's test_resume_continues_from_checkpoint."""
    base = dict(network="LeNet", dataset="MNIST", batch_size=16,
                test_batch_size=16, synthetic_size=64,
                train_dir=str(tmp_path))
    _train(TrainConfig(**base, eval_freq=6, max_steps=6))
    trainer = Trainer(TrainConfig(**base, max_steps=10, resume=True),
                      device="cpu")
    try:
        assert trainer.start_step == 6 and trainer.state.optimizer.count == 6
        bufs = [s["momentum_buffer"] for s in
                trainer.state.optimizer.optimizer.state.values()]
        assert len(bufs) == 8 and all(b.abs().sum() > 0 for b in bufs)
        history = trainer.train()
        assert [r["step"] for r in history] == [7, 8, 9, 10]
        assert trainer.state.step == 10
    finally:
        trainer.close()


# -- integrity ---------------------------------------------------------------


@pytest.fixture
def small_state():
    model = build_model("LeNet")
    model.init_weights(torch.Generator().manual_seed(0))
    return create_train_state(model, lambda ps: build_optimizer(
        "sgd", ps, 0.1, momentum=0.9), "cpu")


def _tear(path):
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: max(1, len(blob) // 2)])


def test_truncated_newest_is_quarantined_and_resume_takes_the_older(
        tmp_path, small_state):
    d = str(tmp_path)
    small_state.step = 1
    ckpt.save_checkpoint(d, small_state)
    small_state.step = 2
    ckpt.save_checkpoint(d, small_state)
    _tear(ckpt.checkpoint_path(d, 2))
    ok, reason = ckpt.verify_checkpoint(ckpt.checkpoint_path(d, 2))
    assert not ok and "size mismatch" in reason
    small_state.step = 0
    assert resume_latest_valid(d, small_state) is small_state
    assert small_state.step == 1 and ckpt.all_steps(d) == [1]
    assert sorted(os.listdir(os.path.join(d, ckpt.QUARANTINE_DIR))) == [
        "model_step_2", "model_step_2.meta.json"]


def test_manifest_less_file_is_legacy_unverified(tmp_path, small_state):
    path = ckpt.save_checkpoint(str(tmp_path), small_state, step=3)
    os.remove(ckpt.meta_path(path))
    ok, reason = ckpt.verify_checkpoint(path)
    assert ok and "legacy" in reason
    assert jckpt.verify_checkpoint(path) == (ok, reason)


def test_bad_magic_raises(tmp_path, small_state):
    path = ckpt.save_checkpoint(str(tmp_path), small_state, step=3)
    with open(path, "r+b") as f:
        f.write(b"XXXX")
    assert ckpt.verify_checkpoint(path) == (False, "bad magic bytes")
    with pytest.raises(ValueError, match="bad magic"):
        ckpt.load_raw(path)
    with pytest.raises(ValueError, match="bad magic"):
        ckpt.restore_checkpoint(path, small_state)


def test_sharded_directory_raises_naming_its_roadmap_item(tmp_path,
                                                          small_state):
    path = ckpt.checkpoint_path(str(tmp_path), 4)
    os.makedirs(path)
    for fn in (ckpt.verify_checkpoint, ckpt.load_raw,
               lambda p: ckpt.restore_checkpoint(p, small_state)):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 1"):
            fn(path)


def test_gc_keeps_resume_target_protected_published_and_evidence(
        tmp_path, small_state):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5, 6):
        ckpt.save_checkpoint(d, small_state, step=s)
    _tear(ckpt.checkpoint_path(d, 5))
    _tear(ckpt.checkpoint_path(d, 6))
    ckpt.record_published_step(d, 2, str(tmp_path / "artifact"))
    out = ckpt.gc_checkpoints(d, keep_last=1, protect=(1,))
    # 1 protected, 2 published, 4 the resume target, 5 and 6 evidence
    assert out["deleted"] == [3] and out["bytes_freed"] > 0
    assert ckpt.all_steps(d) == [1, 2, 4, 5, 6]
    assert ckpt.published_steps(d) == {2}
    ckpt.release_published_step(d, 2)
    assert ckpt.gc_checkpoints(d, keep_last=1)["deleted"] == [1, 2]
    assert ckpt.published_steps(d) == set()
