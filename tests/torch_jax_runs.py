"""A JAX ``Trainer`` run that the port's checkpoint and evaluator tests
(``test_torch_checkpoint.py``, ``test_torch_evaluator.py``) share, built
once per process: LeNet on the synthetic MNIST, 10 steps of SGD with
momentum 0.9 (lr 0.01), checkpoints at steps 5 and 10 in its train_dir
with its telemetry stream, and an eval pass. Its JAX compiles are most
of either file's time, so a process that runs both pays them once. The
train_dir is removed when the process exits."""

import atexit
import functools
import shutil
import tempfile

from pytorch_distributed_nn_tpu.training.config import TrainConfig
from pytorch_distributed_nn_tpu.training.trainer import Trainer


@functools.lru_cache(maxsize=None)
def lenet_run():
    """``(trainer, train_dir)`` of the finished (closed) run."""
    d = tempfile.mkdtemp(prefix="jax_lenet_run_")
    atexit.register(shutil.rmtree, d, True)
    trainer = Trainer(TrainConfig(
        network="LeNet", dataset="MNIST", batch_size=16, test_batch_size=32,
        synthetic_size=64, max_steps=10, eval_freq=5, num_workers=1,
        data_layout="host", train_dir=d, log_every=100))
    try:
        trainer.train()
        trainer.evaluate()
    finally:
        trainer.close()
    return trainer, d
