"""Admission exceptions shared by the generative scheduler and the HTTP
server (the counterparts of ``pytorch_distributed_nn_tpu/serving/batcher.py``'s;
the single-pass batcher itself is not ported yet)."""

from __future__ import annotations


class DeadlineExceeded(Exception):
    """The request's deadline passed before it was scheduled."""


class QueueShed(Exception):
    """The admission queue is at capacity: the request was rejected at
    the door (HTTP 429 + ``Retry-After``), never silently queued."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class Draining(Exception):
    """The scheduler is draining: new admissions are refused (HTTP 503)
    while queued and in-flight work finishes."""
