"""The port's lr sweep (``pytorch_distributed_nn_tpu_torch/tuning.py``)
and ``tune``: the counterpart of
``tests/test_tuning_and_analysis.py::test_lr_sweep_picks_sane_lr``.

The JAX test trains on ``num_workers=8``: eight virtual CPU devices of
one process. The port runs one rank a process, so both sides here train
LeNet on ``num_workers=1``. The JAX ranking comes from its in-process
path on one CPU device; the port's from its spawned trials (the sweep
runner) and from its in-process ``device="cpu"`` path, which must rank
the candidates the same way.
"""

import jax

from pytorch_distributed_nn_tpu.training.trainer import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_nn_tpu.tuning import lr_sweep as jax_lr_sweep
from pytorch_distributed_nn_tpu_torch.experiments import load_journal
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.tuning import (
    DEFAULT_CANDIDATES,
    lr_sweep,
)
import torch_cpu  # noqa: F401  (one intra-op thread)

CANDIDATES = (10.0, 0.01)
FIELDS = dict(network="LeNet", dataset="MNIST", batch_size=32,
              test_batch_size=32, num_workers=1, synthetic_size=128,
              log_every=10**9)


def test_lr_sweep_picks_sane_lr(tmp_path, monkeypatch):
    # the spawned trials inherit one intra-op thread (torch_cpu.py)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = TrainConfig(train_dir=str(tmp_path / "port"), **FIELDS)
    # 10.0 must lose to 0.01 on this task; keep the grid tiny for speed
    results = lr_sweep(cfg, candidates=CANDIDATES, steps=15, tail=5,
                       trial_device="cpu", concurrency=1)
    assert len(results) == 2
    assert results[0].final_loss <= results[1].final_loss
    assert results[0].lr == 0.01
    assert [r["step"] for r in results[0].history] == list(range(1, 16))
    jstate = load_journal(str(tmp_path / "port" / "lr_sweep"))
    assert sorted(st.status for st in jstate.trials.values()) == \
        ["completed", "completed"]
    inproc = lr_sweep(cfg, candidates=CANDIDATES, steps=15, tail=5,
                      device="cpu")
    assert [r.lr for r in inproc] == [r.lr for r in results]
    want = jax_lr_sweep(
        JaxTrainConfig(train_dir=str(tmp_path / "jax"), **FIELDS),
        candidates=CANDIDATES, steps=15, tail=5,
        devices=jax.devices()[:1])
    assert [r.lr for r in results] == [r.lr for r in want]
    assert DEFAULT_CANDIDATES == (0.4, 0.2, 0.1, 0.05, 0.025, 0.0125,
                                  0.00625)


def test_cli_tune_on_the_cpu(tmp_path, monkeypatch, capsys):
    from pytorch_distributed_nn_tpu_torch.cli import main

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["tune", "--device", "cpu", "--network", "LeNet", "--dataset",
            "MNIST", "--synthetic-size", "64", "--batch-size", "16",
            "--test-batch-size", "16", "--num-workers", "1",
            "--candidates", "10.0,0.01", "--tune-steps", "3",
            "--concurrency", "1", "--train-dir", str(tmp_path)]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "best lr: 0.01" in out
    # an interrupted tune's journal pins its grid: another grid is rc 2
    assert main(argv[:-8] + ["--candidates", "0.1", "--tune-steps", "3",
                             "--train-dir", str(tmp_path)]) == 2
    capsys.readouterr()
