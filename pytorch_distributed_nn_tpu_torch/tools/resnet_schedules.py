"""ResNet-18 on the synthetic CIFAR-10 under several learning-rate
schedules, on the card: which of them train, and how far BatchNorm's
running statistics trail the weights.

    python -m pytorch_distributed_nn_tpu_torch.tools.resnet_schedules

B = 1024, bf16, SGD momentum 0.9, int8 sync, the data on the card (as
``chip_smoke.py``'s ResNet phase). For each schedule it prints every
fourth training loss and the test split's eval-mode loss and accuracy
before and after the steps; for one schedule that stops while the
weights still move, also the eval after the running statistics are
recomputed from one training batch at the final weights. The card's
name and power limit come first.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from pytorch_distributed_nn_tpu_torch.models.layers import BatchNorm
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

#: (label, TrainConfig fields) of each schedule
SCHEDULES = (
    ("lr 0.4 from step 1, 20 steps", dict(lr=0.4, max_steps=20)),
    ("lr 0.4, 20-step warmup, 20 steps",
     dict(lr=0.4, warmup_steps=20, max_steps=20)),
    ("lr 0.1, 20 steps", dict(lr=0.1, max_steps=20)),
    ("lr 0.05, 30 steps", dict(lr=0.05, max_steps=30)),
    ("lr 0.05 decayed 10x every 20 steps, 60 steps",
     dict(lr=0.05, lr_decay_steps=20, max_steps=60)),
)


def _recalibrated_eval(trainer: Trainer) -> dict:
    """Eval after the running statistics are set to one training batch's
    statistics at the final weights (momentum 0 for one forward)."""
    bns = [m for m in trainer.model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.momentum = 0.0
    with torch.no_grad():
        trainer.model.train()
        trainer.model(trainer.train_loader.next_batch()[0])
    return trainer.evaluate()


def run(label: str, fields: dict, recalibrate: bool, seed: int = 0) -> None:
    cfg = TrainConfig(network="ResNet18", dataset="Cifar10", batch_size=1024,
                      momentum=0.9, dtype="bfloat16", compression="int8",
                      data_layout="device", synthetic_size=10240,
                      test_batch_size=1000, seed=seed, **fields)
    trainer = Trainer(cfg)
    try:
        before = trainer.evaluate()
        losses = [r["loss"] for r in trainer.train()]
        after = trainer.evaluate()
        line = (f"{label}: losses {[round(x, 3) for x in losses[::4]]} "
                f"(last {losses[-1]:.4f}); eval loss {before['loss']:.4f} "
                f"-> {after['loss']:.4f}, acc1 {after['acc1']:.4f}")
        if recalibrate:
            fresh = _recalibrated_eval(trainer)
            line += (f"; with recomputed running statistics: loss "
                     f"{fresh['loss']:.4f}, acc1 {fresh['acc1']:.4f}")
        print(line, flush=True)
    finally:
        trainer.close()
        del trainer
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("resnet_schedules: needs a card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for label, fields in SCHEDULES:
        run(label, fields, recalibrate=fields.get("max_steps") == 30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
