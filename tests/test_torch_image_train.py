"""The port's image training slice (pytorch_distributed_nn_tpu_torch: data,
metrics, train_step, trainer, cli) against the JAX package, on the CPU.

Datasets and the augmentation gather: byte for byte. Three SGD steps of
ResNet-20 (16x16 inputs, global batch 8, f32, compression none) against
the JAX ``build_train_step`` on a 1-device mesh, and at dp = 2 (the port
over two gloo ranks, one thread each; JAX over a 2-device mesh) with
``bn_stats_sync`` mean and rank0: each step's loss within 1e-5, the
parameters and BatchNorm statistics after the third step within 1e-5
(SGD at lr 0.1 with momentum moves them by O(1e-2) per step; the
gradients of the two sides agree to about 1e-6, summed in other orders;
measured worst over the three cases 4.5e-6). The inputs are drawn from
seeds 300-302: at most other seeds some ReLU input of the 19 BatchNorm
layers lies within rounding (~1e-6) of 0 and falls on the other side in
one of the two programs, which moves that gradient entry by O(1e-3) and
the third step's parameters by up to ~5e-2 (9 of 12 seed offsets tried
did so). That is the f32 summation order, not the arithmetic, which the
layer tests of test_torch_cnn.py pin down.
"""

import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.data import datasets as jax_datasets
from pytorch_distributed_nn_tpu.models import build_model as jax_build
from pytorch_distributed_nn_tpu.optim import sgd as jax_sgd
from pytorch_distributed_nn_tpu.parallel import make_grad_sync as jax_sync
from pytorch_distributed_nn_tpu.parallel import make_mesh
from pytorch_distributed_nn_tpu.training.train_step import (
    build_train_step as jax_build_train_step,
)
from pytorch_distributed_nn_tpu.training.train_step import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_nn_tpu_torch.data import datasets
from pytorch_distributed_nn_tpu_torch.data.loader import (
    DataLoader,
    DeviceDataLoader,
    augment_on_device,
)
from pytorch_distributed_nn_tpu_torch.models import build_model
from pytorch_distributed_nn_tpu_torch.models.convert import (
    cnn_to_state_dict,
)
from pytorch_distributed_nn_tpu_torch.ops import metrics
from pytorch_distributed_nn_tpu_torch.optim import build_optimizer
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    make_grad_sync,
)
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    build_image_eval_step,
    build_image_train_step,
    create_train_state,
    sync_seed,
)
from pytorch_distributed_nn_tpu_torch.training.trainer import (
    TEXT_UNSUPPORTED,
    Trainer,
)
from torch_ranks import run_ranks
import torch_cpu  # one intra-op thread here and in subprocesses

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


@pytest.mark.parametrize("name", jax_datasets.DATASETS)
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_data_equals_the_jax_package(name, train):
    got = datasets.load_dataset(name, train, data_dir="/nonexistent",
                                synthetic_size=64)
    want = jax_datasets.load_dataset(name, train, data_dir="/nonexistent",
                                     synthetic_size=64)
    np.testing.assert_array_equal(got.raw_images, want.raw_images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.num_classes, got.augment, got.mean, got.std, got.synthetic) \
        == (want.num_classes, want.augment, want.mean, want.std, True)
    np.testing.assert_array_equal(got.images, want.images)
    assert datasets.spec(name) == jax_datasets._spec(name)


def test_augment_gathers_equal_the_jax_numpy_gather():
    """The host gather and the device (torch) gather against
    ``_augment_numpy`` for the same crop and flip draws; the draws in the
    JAX ``augment_batch``'s order."""
    ds = datasets.load_dataset("Cifar10", True, synthetic_size=16)
    x = ds.images
    ys, xs, flip = datasets.augment_draws(np.random.RandomState(3), len(x))
    want = jax_datasets._augment_numpy(x, ys, xs, flip)
    np.testing.assert_array_equal(datasets.augment_gather(x, ys, xs, flip),
                                  want)
    got = augment_on_device(torch.from_numpy(x), torch.from_numpy(ys),
                            torch.from_numpy(xs), torch.from_numpy(flip))
    np.testing.assert_array_equal(got.numpy(), want)
    jax_rng, rng = np.random.RandomState(5), np.random.RandomState(5)
    np.testing.assert_array_equal(
        datasets.augment_batch(x, rng),
        jax_datasets._augment_numpy(
            x, jax_rng.randint(0, 9, size=len(x)),
            jax_rng.randint(0, 9, size=len(x)), jax_rng.rand(len(x)) < 0.5))


def test_device_loader_normalises_as_the_jax_package():
    ds = datasets.load_dataset("Cifar10", False, synthetic_size=16)
    loader = DeviceDataLoader(ds, 8, "cpu", shuffle=False)
    x, y = loader.next_batch()
    np.testing.assert_allclose(
        x.numpy(), jax_datasets._normalize(ds.raw_images[:8], ds.mean,
                                           ds.std), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(y.numpy(), ds.labels[:8])


@pytest.mark.parametrize("layout", ["device", "host"])
def test_ranks_take_contiguous_slices_of_one_global_batch(layout):
    ds = datasets.load_dataset("Cifar10", True, synthetic_size=64)

    def loader(rank, world):
        if layout == "device":
            return DeviceDataLoader(ds, 16, "cpu", seed=7, rank=rank,
                                    world=world)
        return DataLoader(ds, 16, seed=7, prefetch=0, rank=rank, world=world)

    whole = loader(0, 1).next_batch()
    parts = [loader(r, 2).next_batch() for r in range(2)]
    for i in range(2):
        np.testing.assert_array_equal(
            torch.cat([p[i] for p in parts]).numpy(), whole[i].numpy())


def test_metrics_equal_the_jax_package():
    from pytorch_distributed_nn_tpu.ops import metrics as jm

    rng = np.random.RandomState(0)
    logits = rng.randn(32, 10).astype(np.float32)
    labels = rng.randint(0, 10, size=32).astype(np.int32)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    assert abs(float(metrics.cross_entropy_loss(lt, yt))
               - float(jm.cross_entropy_loss(logits, labels))) <= 1e-6
    for a, b in zip(metrics.topk_accuracy(lt, yt, (1, 5)),
                    jm.topk_accuracy(logits, labels, (1, 5))):
        assert float(a) == float(b)


def _images(step, B=8, hw=16):
    rng = np.random.RandomState(300 + step)
    return (rng.randn(B, hw, hw, 3).astype(np.float32),
            rng.randint(0, 10, size=B).astype(np.int32))


def _jax_three_steps(dp, bn_mode):
    model = jax_build("ResNet20", 10)
    opt = jax_sgd(0.1, momentum=0.9)
    mesh = make_mesh(dp, 1, devices=jax.devices()[:dp])
    sync = jax_sync("allreduce")
    state = jax_create_train_state(model, opt, sync, jax.random.PRNGKey(0),
                                   (16, 16, 3))
    params0, stats0 = jax.tree.map(np.asarray, (state.params,
                                                state.batch_stats))
    step = jax_build_train_step(model, opt, sync, mesh, bn_stats_sync=bn_mode,
                                donate=False)
    losses = []
    for i in range(3):
        state, m = step(state, _images(i), jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    final = cnn_to_state_dict(*jax.tree.map(np.asarray, (state.params,
                                                         state.batch_stats)))
    return (params0, stats0), losses, final


def _port_three_steps(dp, bn_mode, init):
    def one(rank, group):
        model = build_model("ResNet20")
        model.load_state_dict(cnn_to_state_dict(*init))
        state = create_train_state(
            model, lambda ps: build_optimizer("sgd", ps, 0.1, momentum=0.9),
            "cpu")
        step = build_image_train_step(make_grad_sync(group, "allreduce"),
                                      bn_stats_sync=bn_mode)
        per = 8 // dp
        losses = []
        for i in range(3):
            x, y = _images(i)
            local = slice(rank * per, (rank + 1) * per)
            m = step(state, (torch.from_numpy(x[local]),
                             torch.from_numpy(y[local]).long()),
                     sync_seed(1, i))
            losses.append(float(m["loss"]))
        return losses, {k: v.clone() for k, v in model.state_dict().items()}

    return run_ranks(dp, one)


@pytest.mark.parametrize("dp,bn_mode", [(1, "mean"), (2, "mean"),
                                        (2, "rank0")])
def test_three_resnet20_steps_match_jax(dp, bn_mode):
    init, want_losses, want = _jax_three_steps(dp, bn_mode)
    results = _port_three_steps(dp, bn_mode, init)
    for losses, sd in results:
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=TOL)
        assert set(sd) == set(want)
        for k in want:
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=TOL, err_msg=k)


_BASE = dict(network="LeNet", dataset="MNIST", batch_size=16,
             test_batch_size=32, max_steps=2, synthetic_size=64)


@pytest.mark.parametrize("field,value", [
    ("num_workers", 2), ("compression", "topk"), ("bucket_bytes", 1024),
    ("fused_ln", True), ("attn_impl", "pallas"), ("dataset", "MLMSynth"),
    ("loader_workers", 2), ("kill_ranks", (0,)),
])
def test_image_trainer_refuses_what_it_does_not_run(field, value):
    with pytest.raises((ValueError, NotImplementedError)):
        Trainer(TrainConfig(**{**_BASE, field: value}), device="cpu")


def test_text_models_keep_single_rank_sync():
    """The MLM step is not data-parallel yet: its sync flags raise."""
    assert set(TEXT_UNSUPPORTED) == {"num_workers", "num_aggregate",
                                     "kill_ranks", "compression",
                                     "sync_mode"}


@pytest.mark.parametrize("sync", [dict(), dict(sync_mode="local"),
                                  dict(compression="int8",
                                       data_layout="host", grad_accum=2)])
def test_image_trainer_trains_and_evaluates_on_the_cpu(sync):
    cfg = TrainConfig(**{**_BASE, "network": "ResNet20",
                         "dataset": "Cifar10", "lr": 0.05, **sync})
    trainer = Trainer(cfg, device="cpu")
    try:
        history = trainer.train()
        ev = trainer.evaluate()
    finally:
        trainer.close()
    assert [r["step"] for r in history] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["images_per_sec"] > 0
               for r in history)
    assert trainer.data_layout == sync.get("data_layout", "device")
    assert set(ev) == {"loss", "acc1", "acc5"} and np.isfinite(ev["loss"])


def test_image_trainer_runs_on_the_card_or_raises():
    cfg = TrainConfig(**_BASE)
    if torch.cuda.is_available():
        trainer = Trainer(cfg)
        assert trainer.device.type == "cuda"
        trainer.close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg)


def test_cli_trains_lenet_with_int8_sync_on_the_cpu(tmp_path):
    metrics_path = tmp_path / "m.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "train",
         "--device", "cpu", "--network", "LeNet", "--dataset", "MNIST",
         "--synthetic-size", "256", "--compress-grad", "int8",
         "--max-steps", "2", "--batch-size", "64", "--test-batch-size",
         "128", "--metrics-path", str(metrics_path)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env=torch_cpu.SUBPROCESS_ENV)
    assert proc.returncode == 0, proc.stderr
    records = [json.loads(line) for line in
               metrics_path.read_text().splitlines() if line]
    assert records[0]["kind"] == "manifest"
    steps = [r for r in records if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["images_per_sec"] > 0
               for r in steps)
    assert "Validation" in proc.stderr
    assert records[-1]["type"] == "eval_result"
    assert records[-1]["images"] == 256


@pytest.mark.parametrize("dtype,held_off", [("float32", True),
                                            ("bfloat16", False)])
def test_f32_image_steps_hold_tf32_off_and_give_it_back(dtype, held_off):
    """PyTorch's cuDNN default runs f32 convolutions in TF32; the f32
    image steps (train and eval) turn both switches off while they run
    and restore them after; a bf16 model's steps leave them alone."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    seen = []
    try:
        matmul.allow_tf32 = cudnn.allow_tf32 = True
        model = build_model("LeNet", dtype=dtype)
        model.init_weights(torch.Generator().manual_seed(0))
        model.register_forward_hook(lambda *a: seen.append(
            (matmul.allow_tf32, cudnn.allow_tf32)))
        state = create_train_state(
            model, lambda ps: build_optimizer("sgd", ps, 0.1), "cpu")
        x = torch.zeros(4, 28, 28, 1)
        y = torch.zeros(4, dtype=torch.int64)
        build_image_train_step(make_grad_sync(None, "local"))(
            state, (x, y), 0)
        build_image_eval_step(None)(state, (x, y))
        assert seen == [(not held_off, not held_off)] * 2
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
