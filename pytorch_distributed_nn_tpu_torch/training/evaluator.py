"""The polling evaluator: the port's
``pytorch_distributed_nn_tpu/training/evaluator.py``.

A process apart from training (the paper's evaluator, SURVEY.md §3.4)
polls ``<model_dir>/model_step_<N>`` every ``eval_interval`` seconds,
restores each checkpoint's parameters and BatchNorm statistics into its
own model (either package's files), scores the test set (loss, prec@1,
prec@5) and moves on by ``eval_freq``, or to the newest step with
``follow_latest``. A checkpoint that fails verification or restore is
skipped, never fatal; ``run`` ends after ``max_evals`` evaluations,
after ``timeout`` seconds, or at once on an empty eval set.

The forward is the port's eval step: on the card, a transformer built
with ``attn_fn=kernels.flash_attention`` runs the flash forward and
LayerNorm forward kernels.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional

from pytorch_distributed_nn_tpu_torch.models.convert import (
    is_cnn,
    load_train_state,
)
from pytorch_distributed_nn_tpu_torch.observability.core import get_telemetry
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    TrainState,
    build_eval_step,
    build_image_eval_step,
    run_eval_pass,
)

logger = logging.getLogger(__name__)


class Evaluator:
    """``state``: a ``TrainState`` whose model (on its device) receives
    each checkpoint's weights; ``eval_step`` defaults to the MLM step for
    a transformer and to the one-rank image step otherwise."""

    #: what :meth:`evaluate_checkpoint` returns for a checkpoint that exists
    #: but fails verification or restore
    CORRUPT = "corrupt"

    def __init__(self, state: TrainState, test_loader, model_dir: str,
                 eval_freq: int = 100, eval_interval: float = 10.0,
                 follow_latest: bool = False, eval_step=None):
        self.state = state
        self.test_loader = test_loader
        self.model_dir = model_dir
        self.eval_freq = eval_freq
        self.eval_interval = eval_interval
        self.follow_latest = follow_latest
        if eval_step is None:
            eval_step = (build_image_eval_step(None) if is_cnn(state.model)
                         else build_eval_step())
        self._eval_step = eval_step
        #: per evaluated step: restore and eval pass wall ms
        self.timings: dict = {}

    def evaluate_state(self, state: TrainState) -> dict:
        """Mean loss/acc1/acc5 over the test loader; ``{}`` when the eval
        set is empty."""
        return run_eval_pass(self._eval_step, state, self.test_loader)

    def evaluate_checkpoint(self, step: int):
        """The metrics of checkpoint ``step``: ``None`` while it does not
        exist, :data:`CORRUPT` when it fails verification or restore,
        ``{}`` on an empty eval set."""
        path = ckpt.checkpoint_path(self.model_dir, step)
        if not os.path.exists(path):
            return None
        t0 = time.perf_counter()
        try:  # one read: verified, then restored
            load_train_state(self.state, ckpt.load_verified(path),
                             params_only=True)
        except (ValueError, RuntimeError, KeyError, OSError) as e:
            logger.warning("Evaluator: checkpoint %s is corrupt (%s); "
                           "skipping it", path, e)
            return self.CORRUPT
        t1 = time.perf_counter()
        metrics = self.evaluate_state(self.state)
        t2 = time.perf_counter()
        if not metrics:
            logger.info("Evaluator step %d: eval set is empty, skipped", step)
            return metrics
        self.timings[step] = {"restore_ms": (t1 - t0) * 1e3,
                              "eval_ms": (t2 - t1) * 1e3}
        seqs = getattr(self.test_loader, "eval_sequences", None)
        logger.info("Evaluator evaluating step %d: loss %.4f, prec@1 %.4f, "
                    "prec@5 %.4f%s", step, metrics["loss"], metrics["acc1"],
                    metrics["acc5"],
                    f" ({seqs} sequences)" if seqs is not None else "")
        get_telemetry().emit(
            "eval_result", step=step, loss=metrics["loss"],
            acc1=metrics["acc1"], acc5=metrics["acc5"], sequences=seqs,
            source="evaluator", **{k: round(v, 3)
                                   for k, v in self.timings[step].items()})
        return metrics

    def run(self, max_evals: Optional[int] = None,
            timeout: Optional[float] = None,
            on_metrics: Optional[Callable[[int, dict], None]] = None) -> int:
        """Poll until ``max_evals`` evaluations, ``timeout`` seconds, or an
        empty eval set; returns the number of evaluations."""
        next_step = self.eval_freq
        done = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        logger.info("Evaluator polling %s from step %d every %.3g s%s",
                    self.model_dir, next_step, self.eval_interval,
                    " (following the newest step)" if self.follow_latest
                    else "")
        while (max_evals is None or done < max_evals) and (
                deadline is None or time.monotonic() < deadline):
            if self.follow_latest:
                latest = ckpt.latest_step(self.model_dir)
                if latest is not None and latest >= next_step:
                    next_step = latest
            metrics = self.evaluate_checkpoint(next_step)
            if metrics is None:
                wait = self.eval_interval
                if deadline is not None:
                    wait = max(0.0, min(wait, deadline - time.monotonic()))
                time.sleep(wait)
                continue
            if metrics is self.CORRUPT:
                # a corrupt checkpoint never becomes valid by waiting
                next_step += self.eval_freq
                continue
            if not metrics:
                logger.info("Evaluator stopping: eval set is empty")
                break
            if on_metrics is not None:
                on_metrics(next_step, metrics)
            next_step += self.eval_freq
            done += 1
        return done
