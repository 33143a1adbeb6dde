"""Optimizers of the port: the semantics of
``pytorch_distributed_nn_tpu/optim/{sgd,adam}.py`` and the trainer's
learning-rate schedule.

- SGD is torch-0.4 SGD: ``d_p = g + wd * p``; the momentum buffer is the
  first ``d_p`` itself (no dampening on the first step), then
  ``buf = momentum * buf + d_p``; Nesterov takes ``d_p + momentum * buf``.
- Adam adds L2 weight decay to the gradient (not decoupled) and, with
  ``amsgrad``, divides by the running maximum of the second moment.

SGD is exactly what ``torch.optim.SGD`` computes, so the port uses it;
Adam is :class:`.adam.Adam`, which keeps the JAX optimizer's float32
bias corrections (the tests hold both to the JAX optimizers on the same
gradients). :func:`build_optimizer` wraps them; the wrapper owns the
schedule: the learning rate of an update is ``lr(count)`` at the count of
updates done before it, as the JAX optimizers evaluate their schedule
before incrementing, so the first update uses ``lr(0)``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch

from pytorch_distributed_nn_tpu_torch.optim.adam import Adam

Schedule = Callable[[int], float]


def make_schedule(lr: float, warmup_steps: int = 0,
                  lr_decay_steps: Optional[int] = None,
                  lr_decay_factor: float = 0.1) -> Union[float, Schedule]:
    """The trainer's schedule: linear warmup ``min(1, (count + 1) /
    warmup)`` times the step decay ``factor ** (count // decay_steps)``;
    a constant when neither is set."""
    if not warmup_steps and not lr_decay_steps:
        return lr

    def schedule(count: int) -> float:
        scale = 1.0
        if warmup_steps:
            scale = min(1.0, (count + 1) / warmup_steps)
        if lr_decay_steps:
            scale *= lr_decay_factor ** (count // lr_decay_steps)
        return lr * scale

    return schedule


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer whose learning rate follows a schedule
    of the update count."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 learning_rate: Union[float, Schedule]):
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.count = 0

    def lr(self) -> float:
        """The learning rate of the next update."""
        lr = self.learning_rate
        return float(lr(self.count)) if callable(lr) else float(lr)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1


def build_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                    learning_rate: Union[float, Schedule],
                    momentum: float = 0.9, weight_decay: float = 0.0,
                    nesterov: bool = False,
                    amsgrad: bool = False) -> ScheduledOptimizer:
    """``"sgd"`` or ``"adam"`` over ``params`` with the JAX package's
    semantics (module docstring)."""
    name = name.lower()
    params = list(params)
    if name == "sgd":
        if nesterov and momentum <= 0:
            raise ValueError("nesterov requires momentum > 0 and dampening = 0")
        opt = torch.optim.SGD(params, lr=0.0, momentum=momentum,
                              weight_decay=weight_decay, nesterov=nesterov)
    elif name == "adam":
        opt = Adam(params, lr=0.0, weight_decay=weight_decay,
                   amsgrad=amsgrad)
    else:
        raise ValueError(f"unknown optimizer {name!r}; available: sgd, adam")
    return ScheduledOptimizer(opt, learning_rate)


__all__ = ["Adam", "ScheduledOptimizer", "build_optimizer", "make_schedule"]
