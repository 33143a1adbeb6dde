"""The port's resilience helpers (pytorch_distributed_nn_tpu_torch/
resilience: retry, supervisor) against the JAX package's, on the CPU:
the same backoff schedule for a seed, retries that emit ``retry``
events and re-raise the last failure, the heartbeat file, and the stall
watchdog's marker, event and callback. No test sleeps: the retry's sleep
is injected, and the watchdog is polled by hand."""

import json
import os
import time

import pytest

from pytorch_distributed_nn_tpu.resilience import retry as jax_retry
from pytorch_distributed_nn_tpu_torch.observability import core as obs
from pytorch_distributed_nn_tpu_torch.resilience import retry
from pytorch_distributed_nn_tpu_torch.resilience.supervisor import (
    HEARTBEAT_FILE,
    STALLED_FILE,
    RunSupervisor,
    Watchdog,
    heartbeat_path,
    write_heartbeat,
)
import torch_cpu  # noqa: F401  (one intra-op thread)


@pytest.fixture
def events():
    tel = obs.Telemetry()
    seen = []
    tel._publish = seen.append
    prev = obs.install(tel)
    yield seen
    obs.uninstall(tel, prev)


@pytest.mark.parametrize("attempts,seed", [(1, 0), (4, 7), (6, None)])
def test_backoff_schedule_equals_the_jax_package(attempts, seed):
    kw = dict(base_delay=0.05, max_delay=0.3, jitter=0.5)
    got = retry.backoff_delays(attempts, seed=seed, **kw)
    assert len(got) == max(attempts - 1, 0)
    if seed is not None:
        assert got == jax_retry.backoff_delays(attempts, seed=seed, **kw)
    assert all(0.05 <= d <= 0.45 for d in got)


def test_retry_call_retries_then_raises_with_events(events):
    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("EIO")
        return "ok"

    assert retry.retry_call(flaky, attempts=3, seed=1,
                            sleep=slept.append) == "ok"
    assert slept == retry.backoff_delays(3, seed=1)
    tries = [e for e in events if e.get("type") == "retry"]
    assert [(e["attempt"], e["exhausted"]) for e in tries] == [(1, False),
                                                               (2, False)]

    def broken():
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        retry.retry_call(broken, attempts=2, sleep=slept.append)
    assert [e for e in events if e.get("type") == "retry"][-1]["exhausted"]
    with pytest.raises(ValueError):
        retry.retry_call(broken, attempts=0)
    assert retry.timed_out(time.monotonic() - 2, 1.0)
    assert not retry.timed_out(time.monotonic(), None)


def test_supervisor_beats_and_watchdog_flags_a_stall(tmp_path, events):
    d = str(tmp_path)
    with RunSupervisor(d) as sup:
        sup.extra["geometry"] = {"devices": 1}
        sup.beat(3)
        assert not sup.should_stop
        sup.request_stop()
        assert sup.should_stop
    with open(os.path.join(d, HEARTBEAT_FILE)) as f:
        beat = json.load(f)
    assert beat["step"] == 3 and beat["geometry"] == {"devices": 1}

    ages = []
    dog = Watchdog(heartbeat_path(d), grace=5.0, on_stall=ages.append)
    assert dog.check_once() is None  # fresh
    with open(heartbeat_path(d), "w") as f:
        json.dump({"step": 4, "time": time.time() - 60}, f)
    age = dog.check_once()
    assert age is not None and age > 5 and dog.stalled.is_set()
    assert dog.check_once() is not None and len(ages) == 1  # one episode
    with open(os.path.join(d, STALLED_FILE)) as f:
        assert json.load(f)["step"] == 4
    stalls = [e for e in events if e.get("type") == "stall"]
    assert len(stalls) == 1 and stalls[0]["step"] == 4
    write_heartbeat(d, 5)
    assert dog.check_once() is None and not dog.stalled.is_set()
    with pytest.raises(ValueError):
        Watchdog(heartbeat_path(d), grace=0)
    # with a grace the supervisor runs the watchdog's thread, and stops it
    with RunSupervisor(d, grace=100.0) as sup:
        thread = sup._watchdog._thread
        assert thread.is_alive()
    thread.join(timeout=10)
    assert not thread.is_alive() and sup._watchdog is None
