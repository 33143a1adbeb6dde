"""The port's streaming input (pytorch_distributed_nn_tpu_torch/data/
streaming.py, ``data export``/``data info``, the trainer's ``data_path``)
against the JAX package's, on the CPU.

Shards, manifests, batches, iterator states: bit for bit (shards and
manifests byte for byte both ways; each package reads the other's
directory; image and token batches and ``state()`` after every batch at
prefetch 0 and 2, workers 0 and 2; restore, skip and
``restore_repartitioned`` at consumed counts on both sides of an epoch
boundary). Data parallelism: rank r of n keeps rows [r B / n, (r + 1) B
/ n) of the host batch, so the ranks' rows put together are the JAX
batch at 2 and 4 gloo ranks; with two hosts, rank r (of 4, two a host)
keeps the same rows of its host's batch, the rows JAX device r takes of
its host's. Streamed training against the JAX trainer: LeNet with the
JAX weights carried across (losses within TOL over an epoch boundary),
and BertTiny's train step fed by each package's stream (dropout off,
the JAX weights). Each test that runs threads has its own deadline.
"""

import contextlib
import io
import json
import os
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu import cli as jax_cli
from pytorch_distributed_nn_tpu.data import datasets as jax_datasets
from pytorch_distributed_nn_tpu.data import streaming as jstream
from pytorch_distributed_nn_tpu.models import build_model as jax_build_model
from pytorch_distributed_nn_tpu.ops import metrics as jax_metrics
from pytorch_distributed_nn_tpu.ops.pallas_kernels import pallas_attention
from pytorch_distributed_nn_tpu.optim import sgd as jax_sgd
from pytorch_distributed_nn_tpu.parallel import make_grad_sync, make_mesh
from pytorch_distributed_nn_tpu.parallel.mesh import DATA_AXIS
from pytorch_distributed_nn_tpu.parallel.partitioning import unbox
from pytorch_distributed_nn_tpu.training.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_nn_tpu.training.train_step import (
    build_train_step as jax_build_train_step,
)
from pytorch_distributed_nn_tpu.training.train_step import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_nn_tpu.training.trainer import Trainer as JaxTrainer
from pytorch_distributed_nn_tpu_torch import cli
from pytorch_distributed_nn_tpu_torch.data import datasets, streaming
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    cnn_to_state_dict,
    flax_to_state_dict,
)
from pytorch_distributed_nn_tpu_torch.ops import kernels
from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    build_train_step,
    create_train_state,
)
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer
from torch_ranks import run_ranks
import torch_cpu  # one intra-op thread here and in subprocesses

TOL = 1e-5
#: each thread-running test's deadline, seconds
DEADLINE = 60.0
#: the image set: 64 synthetic CIFAR-10 images in 4 shards, B 16 -> 4
#: steps an epoch; the token corpus: 24 sequences of 8-40 tokens in 3
#: shards, B 4 x L 16 -> fewer than 10 steps an epoch
B, TOK_B, L = 16, 4, 16
TOKEN_KW = dict(shards=3, sequences=24, vocab_size=64, branching=4,
                min_len=8, max_len=40, seed=5)


def within(fn, seconds=DEADLINE):
    """fn() on a thread, failing if it takes more than ``seconds``."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # re-raised on the caller's thread
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if err:
        raise err[0]
    return out[0]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{kind: (port dir, jax dir)} exported by each package."""
    root = tmp_path_factory.mktemp("shards")
    out = {}
    port_ds = datasets.load_dataset("Cifar10", True, synthetic_size=64)
    jax_ds = jax_datasets.load_dataset("Cifar10", True, synthetic_size=64)
    out["image"] = (str(root / "port_img"), str(root / "jax_img"))
    streaming.export_image_dataset(port_ds, out["image"][0], shards=4)
    jstream.export_image_dataset(jax_ds, out["image"][1], shards=4)
    out["tokens"] = (str(root / "port_tok"), str(root / "jax_tok"))
    streaming.export_text_corpus(out["tokens"][0], **TOKEN_KW)
    jstream.export_text_corpus(out["tokens"][1], **TOKEN_KW)
    return out


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(d).iterdir())}


@pytest.mark.parametrize("kind", ["image", "tokens"])
def test_shards_and_manifest_equal_the_jax_exporters(dirs, kind):
    port, jax_dir = dirs[kind]
    got, want = _files(port), _files(jax_dir)
    assert sorted(got) == sorted(want) and "dataset.json" in got
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("kind", ["image", "tokens"])
def test_each_package_reads_the_others_directory(dirs, kind):
    port, jax_dir = dirs[kind]
    assert streaming.load_meta(jax_dir) == jstream.load_meta(port)
    for shard in streaming.load_meta(jax_dir)["shards"]:
        ours = list(streaming.iter_records(os.path.join(jax_dir,
                                                        shard["file"])))
        theirs = list(jstream.iter_records(os.path.join(port, shard["file"])))
        assert ours == theirs and len(ours) == shard["records"]
    r = streaming.ShardReader(os.path.join(jax_dir, "shard-00001.pdsr"))
    r.seek(3)
    want = list(jstream.iter_records(os.path.join(port, "shard-00001.pdsr")))
    assert r.read() == want[3]
    r.close()


def test_reader_refuses_what_the_jax_reader_refuses(tmp_path):
    bad = tmp_path / "bad.pdsr"
    bad.write_bytes(b"XXXX" + bytes(12))
    with pytest.raises(ValueError, match="bad magic"):
        streaming.ShardReader(str(bad))
    w = streaming.ShardWriter(str(tmp_path / "torn.pdsr"))
    w.write(b"0123456789")
    w.close()
    data = (tmp_path / "torn.pdsr").read_bytes()
    (tmp_path / "torn.pdsr").write_bytes(data[:-3])
    with pytest.raises(ValueError, match="torn record 0"):
        list(streaming.iter_records(str(tmp_path / "torn.pdsr")))
    with pytest.raises(FileNotFoundError, match="data export"):
        streaming.load_meta(str(tmp_path))


def _loaders(dirs, kind, prefetch=0, workers=0, rank=0, world=1,
             host=(0, 1)):
    port_dir, jax_dir = dirs[kind]
    kw = dict(seq_len=L) if kind == "tokens" else {}
    bs = TOK_B if kind == "tokens" else B
    port = streaming.StreamingLoader(
        jax_dir, bs, seed=3, prefetch=prefetch, workers=workers, rank=rank,
        world=world, host_index=host[0], host_count=host[1], device="cpu",
        **kw)
    want = jstream.StreamingLoader(port_dir, bs, seed=3, prefetch=0,
                                   host_index=host[0], host_count=host[1],
                                   **kw)
    return port, want


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 or g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", ["image", "tokens"])
@pytest.mark.parametrize("prefetch,workers", [(0, 0), (0, 2), (2, 0),
                                              (2, 2)])
def test_batches_and_state_equal_jax(dirs, kind, prefetch, workers):
    """10 batches (two and a half image epochs; more than one of the
    corpus) and the state after each, the port reading the JAX package's
    directory and the JAX loader the port's."""
    def run():
        port, want = _loaders(dirs, kind, prefetch, workers)
        try:
            for _ in range(10):
                _equal(port.next_batch(), want.next_batch())
                assert port.state() == want.state()
        finally:
            port.close()
            want.close()
        return port.steps_per_epoch, want.steps_per_epoch

    got, want = within(run)
    assert got == want and got == (4 if kind == "image" else
                                   jstream.load_meta(dirs[kind][0])[
                                       "num_tokens"] // (TOK_B * L))
    assert got < 10


@pytest.mark.parametrize("kind", ["image", "tokens"])
@pytest.mark.parametrize("consumed", [3, 4, 5, 9])
def test_restore_skip_and_repartition_equal_jax(dirs, kind, consumed):
    """At ``consumed`` batches (the image epoch ends at 4 and 8): skip's
    state, the stream after restore() of the JAX state, and
    restore_repartitioned() of a state saved by host 0 of 2."""
    def run():
        port, want = _loaders(dirs, kind)
        try:
            want.skip(consumed)
            port.skip(consumed)
            assert port.state() == want.state()
            fresh, _ = _loaders(dirs, kind, prefetch=2)
            fresh.restore(json.loads(json.dumps(want.state())))
            for _ in range(3):
                _equal(fresh.next_batch(), want.next_batch())
            fresh.close()
            half = jstream.StreamingLoader(
                dirs[kind][0], want.batch_size, seed=3, prefetch=0,
                host_index=0, host_count=2,
                **({"seq_len": L} if kind == "tokens" else {}))
            half.skip(consumed)
            saved = half.state()
            a, b = _loaders(dirs, kind)
            info_a, info_b = (a.restore_repartitioned(saved),
                              b.restore_repartitioned(saved))
            assert info_a == info_b and info_a["repartitioned"]
            assert a.state() == b.state()
            for _ in range(3):
                _equal(a.next_batch(), b.next_batch())
            assert a.state() == b.state()
            a.close()
            with pytest.raises(ValueError, match="seed"):
                a.restore_repartitioned({**saved, "seed": 4})
        finally:
            port.close()
            want.close()

    within(run)


def test_restore_refuses_another_layout_and_kind(dirs):
    img, _ = _loaders(dirs, "image")
    tok, _ = _loaders(dirs, "tokens")
    with pytest.raises(ValueError, match="kind"):
        img.restore(tok.state())
    with pytest.raises(ValueError, match="shard layout"):
        img.restore({**img.state(), "shards": ["shard-00000.pdsr"]})


@pytest.mark.parametrize("kind", ["image", "tokens"])
@pytest.mark.parametrize("world", [2, 4])
def test_rank_rows_put_together_equal_the_jax_batch(dirs, kind, world):
    """world gloo ranks, one loader each (prefetch 2, 2 workers): rank r's
    rows of 6 batches put together equal the JAX batches."""
    def one(rank, group):
        port, _ = _loaders(dirs, kind, prefetch=2, workers=2, rank=rank,
                           world=world)
        try:
            return [port.next_batch() for _ in range(6)], port.state()
        finally:
            port.close()

    parts = run_ranks(world, one, timeout=DEADLINE)
    _, want = _loaders(dirs, kind)
    for i in range(6):
        wx, wy = want.next_batch()
        for k, w in enumerate((wx, wy)):
            got = torch.cat([p[0][i][k] for p in parts])
            np.testing.assert_array_equal(got.numpy(), w)
    assert all(p[1] == want.state() for p in parts)


def test_two_hosts_keep_the_rows_of_their_own_host_batch(dirs):
    """Two hosts of two ranks each: host h reads shards h::2; rank r keeps
    rows [4r, 4r + 4) of its host's B = 16 batch, as JAX device r of the
    4-device global sharding takes rows of its host's batch."""
    def run():
        for rank in range(4):
            host = (rank // 2, 2)
            port, want = _loaders(dirs, "image", rank=rank, world=4,
                                  host=host)
            assert [s["file"] for s in port.shards] == [
                f"shard-{i:05d}.pdsr" for i in range(host[0], 4, 2)]
            for _ in range(3):
                x, y = port.next_batch()
                wx, wy = want.next_batch()
                rows = slice(4 * rank, 4 * rank + 4)
                np.testing.assert_array_equal(x.numpy(), wx[rows])
                np.testing.assert_array_equal(y.numpy(), wy[rows])

    within(run)


def test_loader_runs_on_the_card_or_raises(dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.StreamingLoader(dirs["image"][0], B)


def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["image", "tokens"])
def test_data_export_and_info_print_and_write_what_jax_does(tmp_path, kind):
    flags = (["--kind", "image", "--dataset", "MNIST", "--synthetic-size",
              "40", "--shards", "3"] if kind == "image" else
             ["--kind", "tokens", "--sequences", "30", "--shards", "2",
              "--vocab-size", "100", "--max-len", "24", "--seed", "7"])
    out = {}
    for who, main, pre in (("port", cli.main, ["data"]),
                           ("jax", jax_cli.main_data, [])):
        d = str(tmp_path / who)
        out[who] = (_run_cli(main, pre + ["export", "--out", d] + flags)
                    .replace(d, "OUT"),
                    _run_cli(main, pre + ["info", d]), _files(d))
    assert out["port"] == out["jax"]
    assert out["port"][0].startswith("wrote ")


def _jax_lenet_run(cfg_kw, data_path):
    trainer = JaxTrainer(JaxTrainConfig(num_workers=1, data_path=data_path,
                                        **cfg_kw))
    try:
        init = jax.tree.map(np.asarray, (trainer.state.params,
                                         trainer.state.batch_stats))
        return init, [r["loss"] for r in trainer.train()]
    finally:
        trainer.close()


LENET = dict(network="LeNet", dataset="MNIST", batch_size=16,
             test_batch_size=32, synthetic_size=64, max_steps=6,
             log_every=100, stream_prefetch=2)


@pytest.fixture(scope="module")
def mnist_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mnist")
    port = str(root / "port")
    streaming.export_image_dataset(
        datasets.load_dataset("MNIST", True, synthetic_size=64), port,
        shards=4)
    return port


def test_streamed_lenet_run_gives_the_jax_trainers_losses(mnist_dirs):
    """LeNet from MNIST shards for 6 steps (an epoch is 4): the port's
    Trainer, the JAX run's initial weights loaded, against the JAX
    Trainer reading the same directory."""
    init, want = _jax_lenet_run(LENET, mnist_dirs)

    def run():
        trainer = Trainer(TrainConfig(data_path=mnist_dirs, loader_workers=2,
                                      **LENET), device="cpu")
        try:
            assert isinstance(trainer.train_loader, streaming.StreamingLoader)
            trainer.model.load_state_dict(cnn_to_state_dict(*init))
            return [r["loss"] for r in trainer.train()]
        finally:
            trainer.close()

    got = within(run)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_streamed_mid_epoch_resume_continues_the_stream(mnist_dirs,
                                                        tmp_path):
    """Checkpoint at step 3 (mid-epoch), resume to 6: the loader state
    after the resume is the uninterrupted run's at step 3, and the losses
    of steps 4-6 are the uninterrupted run's, bit for bit (one process on
    the CPU)."""
    def run():
        kw = dict(LENET, data_path=mnist_dirs, max_steps=3)
        ref = Trainer(TrainConfig(**kw), device="cpu")
        try:
            ref.train()
            at3 = ref.train_loader.state()
            ref.config.max_steps = 6
            ref.start_step = 3
            want = [r["loss"] for r in ref.train()]
        finally:
            ref.close()
        d = str(tmp_path / "run")
        first = Trainer(TrainConfig(**kw, eval_freq=3, train_dir=d),
                        device="cpu")
        try:
            first.train()
        finally:
            first.close()
        resumed = Trainer(TrainConfig(**{**kw, "max_steps": 6}, resume=True,
                                      train_dir=d), device="cpu")
        try:
            assert resumed.start_step == 3
            restored = resumed.train_loader.state()
            got = [r["loss"] for r in resumed.train()]
        finally:
            resumed.close()
        return at3, restored, want, got

    at3, restored, want, got = within(run)
    assert restored == at3 and at3["consumed"] == 3 and at3["epoch"] == 0
    assert got == want


#: BertTiny cut to test size (one layer), f32, no dropout
BERT_KW = dict(vocab_size=64, max_len=L, d_model=64, num_heads=4,
               num_layers=1, d_ff=128)


def test_streamed_berttiny_steps_give_the_jax_losses(dirs):
    """Three SGD steps of BertTiny (JAX weights, dropout off): the JAX
    train step fed by the JAX loader on the port's token shards, the
    port's step by the port's loader on the JAX shards (prefetch 2)."""
    model = jax_build_model("BertTiny", attn_fn=pallas_attention,
                            fused_ln=True, dtype=jnp.float32,
                            dropout_rate=0.0, **BERT_KW)
    rng = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, unbox(model.init(
        {"params": rng, "dropout": rng}, jnp.zeros((1, L), jnp.int32),
        train=False))["params"])
    opt = jax_sgd(0.5, momentum=0.9)
    mesh = make_mesh(1, 1, 1, devices=jax.devices()[:1])
    jstep = jax_build_train_step(
        model, opt, make_grad_sync("local"), mesh,
        loss_fn=jax_metrics.make_global_masked_cross_entropy(DATA_AXIS),
        metrics_fn=jax_metrics.make_global_mlm_metrics(DATA_AXIS),
        donate=False)
    jstate = jax_create_train_state(
        model, opt, make_grad_sync("local"), jax.random.PRNGKey(0), (L,),
        input_dtype=jnp.int32)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params))
    port_model = build_model("BertTiny", attn_fn=kernels.flash_attention,
                             fused_ln=True, dtype="float32",
                             dropout_rate=0.0, **BERT_KW)
    port_model.load_state_dict(flax_to_state_dict(params))
    state = create_train_state(
        port_model, lambda ps: build_optimizer("sgd", ps, 0.5, momentum=0.9),
        "cpu")
    step = build_train_step()

    def run():
        port, want = _loaders(dirs, "tokens", prefetch=2)
        nonlocal jstate
        try:
            for _ in range(3):
                batch = want.next_batch()
                jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(1))
                m = step(state, port.next_batch())
                for k in ("loss", "acc1", "acc5"):
                    assert abs(float(m[k]) - float(jm[k])) <= TOL, k
        finally:
            port.close()
            want.close()

    within(run, seconds=120.0)


def test_trainer_refuses_shards_the_jax_trainer_refuses(dirs, mnist_dirs):
    """Shards of the other kind, a corpus vocabulary above the model's,
    and an image set of another class count: the JAX trainer's errors."""
    base = dict(batch_size=16, test_batch_size=16, max_steps=1,
                synthetic_size=64)
    with pytest.raises(ValueError, match="holds 'image' shards but network "
                       "'BertTiny' needs 'tokens' data"):
        Trainer(TrainConfig(network="BertTiny", dataset="MLMSynth",
                            seq_len=L, data_path=dirs["image"][0], **base),
                device="cpu")
    with pytest.raises(ValueError, match="exceeds the model's vocab_size=32"):
        Trainer(TrainConfig(network="BertTiny", dataset="MLMSynth",
                            seq_len=L, vocab_size=32,
                            data_path=dirs["tokens"][0], **base),
                device="cpu")
    with pytest.raises(ValueError, match="10-class dataset .* 'Cifar100' "
                       "has 100 classes"):
        Trainer(TrainConfig(network="LeNet", dataset="Cifar100",
                            data_path=dirs["image"][0], **base),
                device="cpu")


def test_nan_grad_poisons_the_streamed_host_batch(mnist_dirs):
    """``nan_grad`` with ``data_path``: the fault plan's hook poisons the
    step's host batch before its copy, and ``skip_nonfinite`` skips that
    step alone."""
    def run():
        trainer = Trainer(TrainConfig(**{**LENET, "max_steps": 3},
                                      data_path=mnist_dirs,
                                      faults="nan_grad@2",
                                      skip_nonfinite=True), device="cpu")
        try:
            return trainer.train()
        finally:
            trainer.close()

    history = within(run)
    assert [r["skipped_nonfinite"] for r in history] == [0.0, 1.0, 0.0]
    assert np.isfinite(history[2]["loss"])


def test_resume_repartitions_a_state_of_another_shard_layout(mnist_dirs,
                                                             tmp_path):
    """A checkpoint whose sidecar holds the state of host 0 of 2 (another
    shard list): the resumed run re-partitions the stream, as the JAX
    trainer does, emits ``data_refastforward`` with ``mode="repartition"``,
    and its loader sits where ``restore_repartitioned`` puts it; with
    the sidecar gone it skips the steps done (``mode="skip"``)."""
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    d = str(tmp_path / "run")

    def events(kind):
        with open(os.path.join(d, "telemetry.jsonl")) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        return [r for r in recs if r.get("type") == kind]

    def run():
        kw = dict(LENET, data_path=mnist_dirs, train_dir=d, eval_freq=2)
        first = Trainer(TrainConfig(**{**kw, "max_steps": 2}), device="cpu")
        try:
            first.train()
        finally:
            first.close()
        half = streaming.StreamingLoader(mnist_dirs, 16, seed=0,
                                         host_index=0, host_count=2,
                                         prefetch=0, device="cpu")
        half.skip(2)
        sidecar = ckpt.data_state_path(ckpt.checkpoint_path(d, 2))
        with open(sidecar) as f:
            doc = json.load(f)
        doc["state"] = half.state()
        with open(sidecar, "w") as f:
            json.dump(doc, f)
        want = streaming.StreamingLoader(mnist_dirs, 16, prefetch=0,
                                         device="cpu")
        info = want.restore_repartitioned(half.state())
        resumed = Trainer(TrainConfig(**{**kw, "max_steps": 3}, resume=True),
                          device="cpu")
        try:
            got = resumed.train_loader.state()
        finally:
            resumed.close()
        repart = events("data_refastforward")
        os.remove(sidecar)
        resumed = Trainer(TrainConfig(**{**kw, "max_steps": 3}, resume=True),
                          device="cpu")
        try:
            skipped = resumed.train_loader.state()
        finally:
            resumed.close()
        return (info, got, want.state(), repart,
                events("data_refastforward"), skipped)

    info, got, want, repart, after, skipped = within(run)
    assert info["repartitioned"] and got == want
    assert [(e["mode"], e["consumed"], e["saved_shards"], e["shards"])
            for e in repart] == [("repartition", 2, 2, 4)]
    assert [(e["mode"], e.get("batches")) for e in after[1:]] == [("skip", 2)]
    assert skipped["consumed"] == 2 and skipped["shards"] == want["shards"]
