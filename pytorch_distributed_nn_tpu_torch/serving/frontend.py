"""Replicated serving frontend: the availability layer over N replicas.

The port of ``pytorch_distributed_nn_tpu/serving/frontend.py``, on the
same flags, events and JSON contract; its replicas are the port's
``serve run`` processes, each with its own CUDA context on the card.

One replica server (serving/server.py) is a single point of failure and
a single queue: a crash is an outage, and sustained overload queues
until every deadline is missed. This module is the thin router process
that makes the serving tier degrade gracefully and survive replica loss
(docs/serving.md "Availability & overload"):

- **Replica membership is readiness-driven.** Local replicas are
  spawned as subprocesses in their own process groups with an
  ephemeral-port ``--port-file`` handshake, or attached by
  address. A health loop polls ``GET /readyz`` — distinct from
  liveness — and judges each replica by a **lease** (last successful
  contact): a replica past its lease, or whose process exited, is
  declared down ONCE (typed ``replica_down``) and rejoins ONCE when
  ``/readyz`` goes green again (typed ``replica_up``), exactly the
  lease-based liveness contract.
- **Circuit breakers, per replica.** Consecutive transport failures /
  5xx responses open the breaker (ONE edge-triggered ``breaker_open``
  per outage — a replica declared dead forces its breaker open under
  the same edge, so a SIGKILL never double-counts); an open breaker
  excludes the replica from routing until ``cooldown_s`` passes, then
  a single **half-open probe** request (admission class ``probe`` —
  always admitted by the replica, even under overload) decides:
  success closes the breaker (typed ``breaker_close``), failure
  re-opens it silently (same outage, same edge).
- **Hedged retries.** Infer requests are idempotent, so a request
  stuck behind a slow replica is hedged: after the observed p95 delay
  (floored; "auto") a second attempt fires on a DIFFERENT replica with
  the SAME request id, and the first successful response wins (typed
  ``hedge`` event; the loser's response is discarded — the request-id
  dedup that guarantees a hedge never double-serves a client).
  Failures retry on the next replica with the retry budget, which is
  what turns a replica SIGKILL's in-flight tail into zero
  client-visible failures.
- **Admission control at the door.** In-flight forwarding is bounded
  (``max_inflight``); load past the bound is SHED with 429 +
  ``Retry-After`` and a typed ``request_shed`` event, per admission
  class: probes always admit, canary traffic caps at a share of the
  bound so a ramp can never starve stable traffic (the same class
  policy the per-replica batcher enforces on its own queue).
- **Zero-downtime drain.** ``drain_replica`` marks the replica
  undispatchable, SIGTERMs it (the replica stops admissions, finishes
  in-flight batches, exits 0 — serving/server.py), and waits;
  ``rolling_restart`` drains and respawns every spawned replica one at
  a time — the rolling-restart primitive, which loses no request.

The frontend imports **no torch** (pure stdlib HTTP plumbing): the
router process never pays a CUDA context. Spawned replicas get the
frontend's ``device`` (``--device``); a replica without a card fails at
startup, and the frontend never sees it ready.
"""

from __future__ import annotations

import collections
import http.client
import json
import logging
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

#: routing admission classes — mirror of serving.batcher.TRAFFIC_CLASSES
#: (no import: the batcher imports the telemetry core's users, the
#: frontend stays torch-free)
TRAFFIC_CLASSES = ("stable", "canary", "probe")

#: statuses that count as a replica FAILURE for the circuit breaker
#: (connection errors count too); 503-draining and 429-shed do NOT —
#: they are re-route signals, not broken-replica evidence
_FAILURE_STATUSES = frozenset({500, 502, 503, 504})


def _set_nodelay(sock) -> None:
    """TCP_NODELAY on a client socket: request bodies and replies are
    small multi-write exchanges, and Nagle stacked on delayed ACKs
    costs ~40 ms per hop on the tail."""
    import socket as _socket

    if sock is not None:
        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except OSError:
            pass


class NoReplicaAvailable(RuntimeError):
    """No ready replica with a closed (or probe-ready) breaker."""


class FrontendShed(Exception):
    """The frontend's admission bound rejected the request (HTTP 429)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class CircuitBreaker:
    """Per-replica breaker: closed -> open on ``threshold`` consecutive
    failures, half-open single probe after ``cooldown_s``, closed again
    on probe success. ``open``/``close`` transitions are edge-triggered
    by the caller off the booleans the record_* methods return; a
    half-open probe failing re-opens WITHOUT a new edge (same outage).
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 3, cooldown_s: float = 2.0):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.state = self.CLOSED
        self.failures = 0  # consecutive
        self.opened_at: Optional[float] = None
        self.opens = 0
        self._probe_inflight = False
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """May a request be routed here now? An open breaker past its
        cooldown admits exactly ONE half-open probe at a time."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
        return self.try_probe()

    def try_probe(self) -> bool:
        """Grant the half-open probe slot IFF the breaker is open past
        its cooldown (or half-open with the slot free) — the ride-along
        probe the router fires NEXT TO a healthy primary, so an open
        breaker can close again even while closed-breaker replicas
        absorb all routing. Never grants on a CLOSED breaker (that
        would duplicate traffic at healthy replicas)."""
        now = time.monotonic()
        with self._lock:
            if self.state == self.CLOSED:
                return False
            if self.state == self.OPEN:
                if now - (self.opened_at or now) >= self.cooldown_s:
                    self.state = self.HALF_OPEN
                    self._probe_inflight = True
                    return True
                return False
            # HALF_OPEN: one probe in flight at a time
            if not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> bool:
        """Request-path success. Resets the consecutive-failure count
        when CLOSED; closes the breaker ONLY from HALF_OPEN (the probe
        deciding the outage is over — returns True for the caller's
        edge-triggered ``breaker_close``). A success arriving while
        OPEN is IGNORED: it is a stale straggler — a response the
        replica wrote before it died can still be read out of the
        socket buffer after a SIGKILL — and closing on it would flap
        the breaker (a re-edged ``breaker_open`` on the very next
        refused connection, against the one-edge-per-outage
        contract)."""
        with self._lock:
            if self.state == self.OPEN:
                return False
            was = self.state == self.HALF_OPEN
            self.state = self.CLOSED
            self.failures = 0
            self._probe_inflight = False
            return was

    def reset(self) -> bool:
        """Unconditional close — the health loop's REJOIN edge only
        (``/readyz`` went green again after a down/starting state): a
        fresh replica re-enters with a clean circuit. Returns True when
        this closed a non-closed breaker (the caller emits
        ``breaker_close``)."""
        with self._lock:
            was = self.state != self.CLOSED
            self.state = self.CLOSED
            self.failures = 0
            self._probe_inflight = False
            return was

    def record_failure(self) -> bool:
        """Returns True when this failure OPENED a closed breaker (the
        caller emits the edge-triggered ``breaker_open``). A half-open
        probe failing re-opens silently — same outage, same edge."""
        with self._lock:
            if self.state == self.HALF_OPEN:
                self.state = self.OPEN
                self.opened_at = time.monotonic()
                self._probe_inflight = False
                return False
            self.failures += 1
            if self.state == self.CLOSED and self.failures >= self.threshold:
                self.state = self.OPEN
                self.opened_at = time.monotonic()
                self.opens += 1
                return True
            return False

    def release_probe(self) -> None:
        """Free the half-open probe slot WITHOUT deciding the outage:
        the probe's outcome was neither a success nor broken-replica
        evidence (a 503-draining refusal, a 429 shed, a 4xx
        pass-through), so the breaker stays half-open and the next
        ``allow()`` may probe again — otherwise the slot would leak and
        the replica would be unroutable forever."""
        with self._lock:
            if self.state == self.HALF_OPEN:
                self._probe_inflight = False

    def force_open(self) -> bool:
        """Open NOW (replica declared down). Returns True on the edge —
        False when already open, so a request-failure-opened breaker and
        the down transition can never double-count one outage."""
        with self._lock:
            if self.state == self.OPEN:
                return False
            edge = self.state == self.CLOSED
            self.state = self.OPEN
            self.opened_at = time.monotonic()
            self._probe_inflight = False
            if edge:
                self.opens += 1
            return edge

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "failures": self.failures,
                    "opens": self.opens}


class Replica:
    """One member of the frontend's pool: an address (attached) or a
    spawned ``serve run`` subprocess plus its breaker and lease state."""

    def __init__(self, name: str, host: Optional[str] = None,
                 port: Optional[int] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.name = name
        self.host = host
        self.port = port
        self.breaker = breaker or CircuitBreaker()
        self.state = "starting"  # starting | ready | down
        self.draining = False
        self.last_ok: Optional[float] = None
        self.outstanding = 0  # in-flight requests routed here
        self.requests = 0
        self.failures = 0
        # spawn bookkeeping (local replicas only)
        self.proc: Optional[subprocess.Popen] = None
        self.spawn_cmd: Optional[List[str]] = None
        self.spawn_env: Optional[dict] = None
        self.port_file: Optional[str] = None
        self.log_path: Optional[str] = None

    @property
    def addr(self) -> Optional[Tuple[str, int]]:
        if self.host is None or self.port is None:
            return None
        return (self.host, self.port)

    @property
    def routable(self) -> bool:
        return (self.state == "ready" and not self.draining
                and self.addr is not None)

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "addr": f"{self.host}:{self.port}" if self.addr else None,
            "state": self.state,
            "draining": self.draining,
            "breaker": self.breaker.snapshot(),
            "outstanding": self.outstanding,
            "requests": self.requests,
            "failures": self.failures,
            "pid": self.proc.pid if self.proc is not None else None,
        }


class _Outcome:
    """One attempt's result: an upstream (status, payload) plus the
    routing classification the retry loop acts on."""

    __slots__ = ("status", "payload", "kind", "replica", "tag", "hop")

    #: kinds: "pass" (return to client), "reroute" (replica refused —
    #: draining/shed — try another, no breaker penalty), "failure"
    #: (broken replica — breaker penalty, retry another)
    def __init__(self, status, payload, kind, replica, tag):
        self.status = status
        self.payload = payload
        self.kind = kind
        self.replica = replica
        self.tag = tag
        self.hop = None  # the attempt's trace hop dict (forward path)


class Frontend:
    """The replicated frontend: membership + breakers + hedged routing
    + admission control + the router's own HTTP listener.

    Programmatic use (tests/chaos drive this directly)::

        fe = Frontend(workdir, telemetry=tel)
        fe.spawn_replica("r0", artifact); fe.spawn_replica("r1", artifact)
        fe.start(); fe.wait_ready()
        status, payload = fe.forward({"inputs": [row]}, klass="stable")
        fe.rolling_restart()
        fe.close()
    """

    def __init__(
        self,
        workdir: str,
        telemetry=None,
        host: str = "127.0.0.1",
        port: int = 0,
        timeout_s: float = 5.0,
        max_inflight: Optional[int] = 256,
        canary_share: float = 0.5,
        retries: int = 2,
        hedge_ms: Optional[float] = None,  # None = auto (p95, floored)
        hedge_floor_ms: float = 25.0,
        hedge_min_samples: int = 32,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 2.0,
        lease_s: float = 2.0,
        poll_s: float = 0.2,
        replica_max_queue: Optional[int] = 256,
        device: Optional[str] = None,
    ):
        from pytorch_distributed_nn_tpu_torch.observability.core import (
            get_telemetry,
        )

        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.telemetry = (
            telemetry if telemetry is not None else get_telemetry()
        )
        self.timeout_s = float(timeout_s)
        self.max_inflight = (
            int(max_inflight) if max_inflight else None
        )
        if not 0.0 < canary_share <= 1.0:
            raise ValueError(
                f"canary_share must be in (0, 1], got {canary_share}"
            )
        self.canary_share = float(canary_share)
        self.retries = int(retries)
        self.hedge_ms = None if hedge_ms is None else float(hedge_ms)
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.hedge_min_samples = int(hedge_min_samples)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.lease_s = float(lease_s)
        self.poll_s = float(poll_s)
        self.replica_max_queue = replica_max_queue
        # the spawned replicas' --device (None: their default, the card)
        self.device = device
        self.replicas: List[Replica] = []
        self._rlock = threading.RLock()
        self._rr = 0  # round-robin tiebreak counter
        # admission state
        self._adm_lock = threading.Lock()
        self._inflight = 0
        self._inflight_canary = 0
        self._inflight_peak = 0
        # counters (reported on /stats and asserted by chaos)
        self.forwarded = 0
        self.failed = 0  # client-visible 5xx after exhausting retries
        self.shed = 0
        self._shed_last_emit = -float("inf")
        self._shed_unreported = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.retried = 0
        self._seq = 0
        self._lat_ms: collections.deque = collections.deque(maxlen=512)
        # upstream keep-alive pool: reusing sockets is what keeps the
        # frontend's p99 overhead inside the bench acceptance band (a
        # fresh TCP handshake per forward would dominate small requests)
        self._pool: dict = {}
        self._pool_lock = threading.Lock()
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self.started = time.time()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._listen = (host, int(port))
        self.host: Optional[str] = None
        self.port: Optional[int] = None

    # -- membership --------------------------------------------------------

    def _find(self, name: str) -> Replica:
        with self._rlock:
            for r in self.replicas:
                if r.name == name:
                    return r
        raise KeyError(f"no replica named {name!r}")

    def spawn_replica(self, name: str, artifact: str,
                      serve_args: Sequence[str] = (),
                      env: Optional[dict] = None) -> Replica:
        """Spawn a local ``serve run`` replica in its own process group
        (the fleet-agent spawn discipline): ephemeral port published via
        ``--port-file`` (the bound port as plain text; the replica binds
        127.0.0.1), output to a per-replica log, admission queue bounded
        by ``replica_max_queue``, the frontend's ``device``. Registered immediately in
        state ``starting``; the health loop promotes it on ``/readyz``.
        """
        rdir = os.path.join(self.workdir, name)
        os.makedirs(rdir, exist_ok=True)
        port_file = os.path.join(rdir, "port")
        if os.path.exists(port_file):
            os.remove(port_file)
        cmd = [
            sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "serve",
            "run", "--artifact", artifact, "--port", "0",
            "--port-file", port_file,
            "--serve-dir", os.path.join(rdir, "serve"),
        ]
        if self.replica_max_queue:
            cmd += ["--max-queue", str(int(self.replica_max_queue))]
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        cmd += list(serve_args)
        replica = Replica(
            name,
            breaker=CircuitBreaker(self.breaker_threshold,
                                   self.breaker_cooldown_s),
        )
        replica.spawn_cmd = cmd
        replica.spawn_env = dict(env) if env is not None else None
        replica.port_file = port_file
        replica.log_path = os.path.join(rdir, "replica.log")
        self._spawn(replica)
        with self._rlock:
            self.replicas.append(replica)
        return replica

    def _spawn(self, replica: Replica, state: str = "starting") -> None:
        """Launch the replica's subprocess and reset its roster entry to
        ``state`` under the roster lock — a restart passes ``"down"`` so
        the concurrently running health loop can only ever observe the
        single down -> ready transition (one ``replica_up``), never a
        transient "starting" it could promote early and re-demote."""
        log_f = open(replica.log_path, "ab")
        try:
            proc = subprocess.Popen(
                replica.spawn_cmd,
                stdout=log_f, stderr=subprocess.STDOUT,
                env=(dict(os.environ, **replica.spawn_env)
                     if replica.spawn_env else None),
                start_new_session=True,  # own group: signals stay scoped
            )
        finally:
            log_f.close()
        with self._rlock:
            replica.proc = proc
            replica.state = state
            replica.draining = False
            replica.host = replica.port = None
            replica.last_ok = None
        logger.info("replica %s spawned (pid %d)", replica.name,
                    proc.pid)

    def attach_replica(self, name: str, host: str, port: int) -> Replica:
        """Register an already-running replica server by address (no
        process ownership: drain stops at readiness, restart is the
        operator's)."""
        replica = Replica(
            name, host=host, port=int(port),
            breaker=CircuitBreaker(self.breaker_threshold,
                                   self.breaker_cooldown_s),
        )
        with self._rlock:
            self.replicas.append(replica)
        return replica

    # -- health loop -------------------------------------------------------

    def _set_replica_gauges(self) -> None:
        with self._rlock:
            counts = collections.Counter(r.state for r in self.replicas)
        reg = self.telemetry.registry
        for state in ("starting", "ready", "down"):
            reg.gauge(
                "frontend_replicas",
                help="frontend replica roster by state",
                labels={"state": state},
            ).set(float(counts.get(state, 0)))

    def _mark_ready(self, replica: Replica) -> None:
        # transition under the roster lock: wait_ready/restart ticks run
        # concurrently with the health loop, and replica_up must be
        # edge-triggered — one event per transition, never two
        with self._rlock:
            was = replica.state
            replica.state = "ready"
            replica.last_ok = time.monotonic()
        if was != "ready":
            # the breaker resets ONLY on the rejoin edge (down/starting
            # -> ready). A steady-state green /readyz says nothing about
            # an alive-but-erroring replica, and resetting the
            # consecutive-failure count — or closing an open breaker —
            # every poll would defeat the cooldown/half-open discipline:
            # request-path successes and the probe govern closure.
            if replica.breaker.reset():
                self.telemetry.emit("breaker_close", replica=replica.name,
                                    source="readyz")
            self.telemetry.emit(
                "replica_up", replica=replica.name,
                addr=f"{replica.host}:{replica.port}",
                rejoin=was == "down",
            )
            logger.info("replica %s %s (%s:%s)", replica.name,
                        "rejoined" if was == "down" else "ready",
                        replica.host, replica.port)
        self._set_replica_gauges()

    def _mark_down(self, replica: Replica, reason: str) -> None:
        with self._rlock:
            if replica.state == "down":
                return
            replica.state = "down"
        # a dead replica's circuit is open BY DEFINITION — but only one
        # edge per outage: force_open is a no-op (no event) when request
        # failures already opened it
        if replica.breaker.force_open():
            self.telemetry.emit("breaker_open", replica=replica.name,
                                reason=reason, source="health")
        self.telemetry.emit("replica_down", replica=replica.name,
                            reason=reason)
        logger.warning("replica %s DOWN: %s", replica.name, reason)
        self._set_replica_gauges()

    def _probe_readyz(self, replica: Replica) -> Optional[bool]:
        """One /readyz poll; True ready, False not-ready (alive), None
        unreachable."""
        if replica.addr is None:
            return None
        try:
            conn = http.client.HTTPConnection(
                replica.host, replica.port, timeout=max(0.5, self.poll_s)
            )
            try:
                conn.request("GET", "/readyz")
                resp = conn.getresponse()
                resp.read()
                return resp.status == 200
            finally:
                conn.close()
        except OSError:
            return None

    def _health_tick(self) -> None:
        with self._rlock:
            replicas = list(self.replicas)
        for r in replicas:
            if r.proc is not None and r.proc.poll() is not None \
                    and r.state != "down" and not r.draining:
                self._mark_down(
                    r, f"process exited rc={r.proc.returncode}"
                )
                continue
            if r.addr is None and r.port_file is not None \
                    and r.proc is not None and r.proc.poll() is None:
                # ephemeral-port handshake (state-independent: a
                # restarted replica re-publishes from "down" too)
                try:
                    with open(r.port_file) as f:
                        r.port = int(f.read())
                    r.host = "127.0.0.1"
                except (OSError, ValueError):
                    continue  # not bound yet
            ready = self._probe_readyz(r)
            now = time.monotonic()
            if ready:
                if not r.draining:
                    self._mark_ready(r)
                else:
                    r.last_ok = now
            elif r.state == "ready" and not r.draining:
                # lease-based liveness (the fleet transport contract):
                # a blip inside the lease is tolerated, past it the
                # replica is declared down exactly once. A replica this
                # frontend drains answers 503 until it exits, which may
                # outlast the lease: drain_replica records its end
                if r.last_ok is None or now - r.last_ok > self.lease_s:
                    self._mark_down(r, "readiness lease expired")

    def _health_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self._health_tick()
            except Exception:
                logger.exception("frontend health tick failed")

    def wait_ready(self, n: Optional[int] = None,
                   timeout: float = 120.0) -> None:
        """Block until ``n`` replicas (default: all registered) are
        ready. Raises on timeout with the roster for diagnosis."""
        deadline = time.monotonic() + timeout
        want = n if n is not None else len(self.replicas)
        ready = 0
        while time.monotonic() < deadline:
            self._health_tick()
            with self._rlock:
                ready = sum(1 for r in self.replicas if r.state == "ready")
            if ready >= want:
                return
            time.sleep(min(0.1, self.poll_s))
        raise TimeoutError(
            f"only {ready}/{want} replicas ready after {timeout:.0f}s: "
            f"{[r.snapshot() for r in self.replicas]}"
        )

    # -- routing -----------------------------------------------------------

    def _pick(self, exclude: Sequence[Replica] = ()
              ) -> Optional[Tuple[Replica, bool]]:
        """``(replica, probing)`` — the least-outstanding routable
        replica with a CLOSED breaker (round-robin tiebreak), else a
        half-open probe slot on an open one (``probing=True``: the
        attempt goes out as admission class ``probe``, which a replica
        always admits even under overload). None when the pool is
        empty. ``allow()`` reserves the single probe slot, so it is
        only called once a closed-breaker candidate is ruled out."""
        with self._rlock:
            pool = [r for r in self.replicas
                    if r.routable and r not in exclude]
            closed = [
                r for r in pool
                if r.breaker.snapshot()["state"] == CircuitBreaker.CLOSED
            ]
            if closed:
                self._rr += 1
                rr = self._rr
                return min(
                    closed,
                    key=lambda r: (r.outstanding,
                                   (self.replicas.index(r) - rr)
                                   % max(1, len(self.replicas))),
                ), False
            for r in pool:
                if r.breaker.allow():
                    return r, True
            return None

    def _probe_candidate(self, exclude: Sequence[Replica] = ()
                         ) -> Optional[Replica]:
        """A routable replica whose OPEN breaker is past its cooldown
        and grants the half-open probe slot — the ride-along probe the
        forward path fires next to a healthy primary. Without it an
        open breaker could never close while closed-breaker replicas
        absorb all routing (``_pick`` only probes when the closed pool
        is empty), permanently losing the replica's capacity."""
        with self._rlock:
            for r in self.replicas:
                if r.routable and r not in exclude \
                        and r.breaker.try_probe():
                    return r
            return None

    def hedge_delay_ms(self) -> float:
        """When to fire the hedge: the observed p95 forward latency,
        floored (`hedge_floor_ms`) so cold/noisy samples cannot cause a
        hedge storm; fixed when `hedge_ms` was configured."""
        if self.hedge_ms is not None:
            return self.hedge_ms
        with self._adm_lock:
            lat = sorted(self._lat_ms)
        if len(lat) < self.hedge_min_samples:
            return max(self.hedge_floor_ms, self.timeout_s * 250.0)
        p95 = lat[min(len(lat) - 1, int(0.95 * len(lat)))]
        return max(self.hedge_floor_ms, p95)

    def _checkout(self, replica: Replica, timeout_s: float, addr):
        """``(conn, reused)`` — a pooled keep-alive connection to the
        replica at ``addr`` (host, port) when one is idle, else a fresh
        one."""
        key = (replica.name, *addr)
        with self._pool_lock:
            idle = self._pool.get(key)
            while idle:
                conn = idle.pop()
                if conn.sock is not None:
                    conn.sock.settimeout(timeout_s)
                    return conn, True
                try:
                    conn.close()
                except OSError:
                    pass
        conn = http.client.HTTPConnection(*addr, timeout=timeout_s)
        try:
            conn.connect()
            _set_nodelay(conn.sock)
        except OSError:
            pass  # surfaces as the attempt's connection error
        return conn, False

    def _checkin(self, replica: Replica, conn, addr) -> None:
        key = (replica.name, *addr)
        with self._pool_lock:
            idle = self._pool.setdefault(key, [])
            if conn.sock is not None and len(idle) < 32:
                idle.append(conn)
                return
        try:
            conn.close()
        except OSError:
            pass

    def _attempt(self, replica: Replica, body: bytes, headers: dict,
                 timeout_s: float, tag: str,
                 probing: bool = False) -> _Outcome:
        """One upstream POST /v1/infer; classifies the outcome and feeds
        the replica's breaker. A stale keep-alive socket from the pool
        (server closed it while idle) retries on a fresh connection
        without counting as a replica failure — only a FRESH connection
        erroring is broken-replica evidence. ``probing`` marks a
        half-open breaker probe: an outcome that feeds neither
        ``record_success`` nor ``record_failure`` must still release the
        probe slot, or the breaker stays probe-locked forever. A
        replica this frontend drained or respawned after the attempt
        picked it (its process changed, it is draining, or it has no
        address yet) refuses as a drain does: a reroute, no breaker
        penalty."""
        with self._rlock:
            replica.outstanding += 1
            replica.requests += 1
            proc, addr = replica.proc, (replica.host, replica.port)
        status, payload = None, None
        err: Optional[str] = (None if addr[0] is not None
                              else "replica respawning: no address yet")
        try:
            while err is None:
                conn, reused = self._checkout(replica, timeout_s, addr)
                try:
                    conn.request("POST", "/v1/infer", body=body,
                                 headers=headers)
                    resp = conn.getresponse()
                    raw = resp.read()
                    status = resp.status
                    try:
                        payload = json.loads(raw) if raw else {}
                    except ValueError:
                        payload = {"error": "unparseable upstream body"}
                    if resp.will_close:
                        conn.close()
                    else:
                        self._checkin(replica, conn, addr)
                    break
                except (OSError, http.client.HTTPException) as e:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    if reused:
                        continue  # stale pooled socket: fresh retry
                    err = f"{type(e).__name__}: {e}"
                    break
        finally:
            with self._rlock:
                replica.outstanding -= 1
        if err is not None:
            with self._rlock:
                moved = (replica.draining or replica.proc is not proc
                         or addr[0] is None)
            if moved:
                if probing:
                    replica.breaker.release_probe()
                return _Outcome(None, {"error": err, "draining": True},
                                "reroute", replica, tag)
            with self._rlock:
                replica.failures += 1
            if replica.breaker.record_failure():
                self.telemetry.emit(
                    "breaker_open", replica=replica.name,
                    reason=err, source="request",
                    failures=replica.breaker.threshold,
                )
            return _Outcome(None, {"error": err}, "failure", replica, tag)
        if status == 200:
            if replica.breaker.record_success():
                self.telemetry.emit("breaker_close", replica=replica.name,
                                    source="request")
            return _Outcome(status, payload, "pass", replica, tag)
        if status in (429,) or (
            status == 503 and isinstance(payload, dict)
            and payload.get("draining")
        ):
            # overload shed / drain refusal: re-route, not broken-replica
            # evidence — the breaker state stays untouched, but a probe
            # must give its slot back (e.g. an attached replica an
            # operator SIGTERMed directly: every probe answers
            # 503-draining, and a leaked slot would refuse routing
            # forever)
            if probing:
                replica.breaker.release_probe()
            return _Outcome(status, payload, "reroute", replica, tag)
        if status in _FAILURE_STATUSES:
            with self._rlock:
                replica.failures += 1
            if replica.breaker.record_failure():
                self.telemetry.emit(
                    "breaker_open", replica=replica.name,
                    reason=f"HTTP {status}", source="request",
                    failures=replica.breaker.threshold,
                )
            return _Outcome(status, payload, "failure", replica, tag)
        # 4xx: the client's problem — pass through, breaker untouched
        # (a probe carrying a bad request is no replica evidence either
        # way: release the slot so a later request can probe again)
        if probing:
            replica.breaker.release_probe()
        return _Outcome(status, payload, "pass", replica, tag)

    def forward(self, doc: dict, klass: str = "stable",
                request_id: Optional[str] = None,
                timeout_s: Optional[float] = None,
                trace=None):
        """Route one infer body through the pool: admission -> primary
        attempt -> hedge after the p95 delay -> retries on failure, all
        deduped on one request id. Returns ``(status, payload)`` where
        payload carries the upstream response plus routing metadata.
        ``trace`` is the request's root :class:`TraceContext` (the HTTP
        door derives it from a client ``X-Trace-Context`` header); one
        is minted when absent, so every forward starts a distributed
        trace — each attempt rides upstream as its own child span and
        lands in the stream record's ``hops``. Raises
        :class:`FrontendShed` past the admission bound and
        :class:`NoReplicaAvailable` with an empty pool."""
        from pytorch_distributed_nn_tpu_torch.observability import tracing

        if klass not in TRAFFIC_CLASSES:
            raise ValueError(
                f"unknown traffic class {klass!r} "
                f"(have: {', '.join(TRAFFIC_CLASSES)})"
            )
        rid = request_id if request_id is not None \
            else tracing.new_request_id()
        ctx = trace if trace is not None else tracing.new_trace_context()
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        self._admit(klass)
        t0 = time.monotonic()
        try:
            return self._forward_admitted(doc, klass, rid, timeout, t0,
                                          ctx)
        finally:
            with self._adm_lock:
                self._inflight -= 1
                if klass == "canary":
                    self._inflight_canary -= 1

    def _admit(self, klass: str) -> None:
        with self._adm_lock:
            if self.max_inflight is not None and klass != "probe":
                if self._inflight >= self.max_inflight:
                    self._shed(klass, self._inflight, self.max_inflight)
                if klass == "canary":
                    cap = max(1, int(self.max_inflight
                                     * self.canary_share))
                    if self._inflight_canary >= cap:
                        self._shed(klass, self._inflight_canary, cap)
            self._inflight += 1
            if klass == "canary":
                self._inflight_canary += 1
            if self._inflight > self._inflight_peak:
                self._inflight_peak = self._inflight
            reg = self.telemetry.registry
            reg.gauge(
                "frontend_inflight",
                help="requests currently being forwarded (bounded by "
                     "max_inflight)",
            ).set(float(self._inflight))
            reg.gauge(
                "frontend_inflight_peak",
                help="in-flight high-water mark since startup",
            ).set(float(self._inflight_peak))

    def _shed(self, klass: str, depth: int, cap: int) -> None:
        """Admission-bound rejection (caller holds ``_adm_lock``, which
        also guards ``_lat_ms``). Events are rate-limited to ~1/s with a
        covering ``count`` (the batcher's discipline): an event per shed
        under a 10x overload is an observability storm."""
        self.shed += 1
        lat = sorted(self._lat_ms)
        retry_after = round(min(
            5.0, max(0.1, (lat[len(lat) // 2] / 1000.0) * 4.0)
        ), 3) if lat else 1.0
        self.telemetry.registry.counter(
            "serving_shed_total",
            help="requests shed by admission control (bounded queue)",
        ).inc()
        self._shed_unreported += 1
        now = time.monotonic()
        if now - self._shed_last_emit >= 1.0:
            count, self._shed_unreported = self._shed_unreported, 0
            self._shed_last_emit = now
            self.telemetry.emit(
                "request_shed", klass=klass, depth=depth, max_queue=cap,
                cap=cap, retry_after_s=retry_after, layer="frontend",
                count=count,
            )
        raise FrontendShed(
            f"frontend at capacity ({depth}/{cap} in flight for class "
            f"{klass!r}): request shed, retry after {retry_after:.1f}s",
            retry_after_s=retry_after,
        )

    def _flush_shed(self) -> None:
        with self._adm_lock:
            count, self._shed_unreported = self._shed_unreported, 0
        if count:
            self.telemetry.emit(
                "request_shed", klass="stable", depth=self._inflight,
                max_queue=self.max_inflight, cap=self.max_inflight,
                retry_after_s=1.0, layer="frontend", count=count,
                trailing=True,
            )

    def _forward_admitted(self, doc: dict, klass: str, rid: str,
                          timeout: float, t0: float, ctx):
        body = json.dumps(
            {**doc, "timeout_s": doc.get("timeout_s", timeout)}
        ).encode()

        results: "queue.Queue[_Outcome]" = queue.Queue()
        tried: List[Replica] = []
        fired = 0
        # one hop span per attempt (docs/observability.md "Distributed
        # tracing"): the span id each attempt carries upstream in
        # X-Trace-Context, so the replica's record joins back to it.
        # Worker threads fill their own hop under hlock; the snapshot at
        # finish copies under the same lock (a dict being json-encoded
        # while a worker inserts would raise mid-serialization).
        hops: List[dict] = []
        hlock = threading.Lock()

        def headers(tag: str, probing: bool, hctx) -> dict:
            from pytorch_distributed_nn_tpu_torch.observability import tracing

            h = {"Content-Type": "application/json",
                 "X-Request-Id": rid,
                 tracing.TRACE_HEADER: hctx.header(),
                 # a half-open breaker probe rides class "probe" so the
                 # replica admits it even when its queue bound is full —
                 # otherwise an overloaded replica's breaker could never
                 # close
                 "X-Traffic-Class": "probe" if probing else klass}
            if tag == "hedge":
                h["X-Hedge"] = "1"
            return h

        def run_attempt(replica: Replica, tag: str, probing: bool,
                        hop: dict) -> None:
            t_a = time.monotonic()
            out = self._attempt(
                replica, body, headers(tag, probing, hop["_ctx"]),
                # per-attempt socket budget: the request deadline
                # plus scheduling grace (the replica enforces its own
                # deadline-drop; this only bounds a hung socket)
                timeout + 5.0, tag, probing=probing,
            )
            with hlock:
                hop["ms"] = round((time.monotonic() - t_a) * 1000, 3)
                hop["kind"] = out.kind
                if out.status is not None:
                    hop["status"] = out.status
                ann = hop.setdefault("annotations", [])
                if out.kind == "failure":
                    err = (out.payload or {}).get("error")
                    if err:
                        hop["error"] = str(err)[:120]
                    if replica.breaker.snapshot()["state"] != \
                            CircuitBreaker.CLOSED:
                        ann.append("breaker_open")
                elif out.kind == "reroute":
                    # the replica's refusal, as a span annotation: a
                    # drain refusal vs an admission shed read differently
                    ann.append(
                        "draining" if isinstance(out.payload, dict)
                        and out.payload.get("draining") else "shed"
                    )
                elif out.kind == "pass" and isinstance(out.payload, dict):
                    # upstream attribution off the response body: hop
                    # wall minus upstream latency = frontend overhead,
                    # split further by the replica's queue/infer numbers
                    for src, dst in (("latency_ms", "upstream_ms"),
                                     ("queue_ms", "queue_ms"),
                                     ("infer_ms", "infer_ms")):
                        vals = out.payload.get(src)
                        if isinstance(vals, list) and vals and all(
                            isinstance(v, (int, float)) for v in vals
                        ):
                            hop[dst] = round(max(vals), 3)
            out.hop = hop
            results.put(out)

        def fire(replica: Replica, tag: str, probing: bool) -> None:
            nonlocal fired
            tried.append(replica)
            if tag != "probe":
                # ride-along probes are invisible to the client-facing
                # attempt accounting: the loop must never wait on one
                fired += 1
            hop = {
                # attempt tags in the record use the catalogue names
                # (first|hedge|retry|probe); "primary" stays the
                # internal/thread name
                "span": None, "_ctx": ctx.child(),
                "tag": "first" if tag == "primary" else tag,
                "replica": replica.name,
                "start_ms": round((time.monotonic() - t0) * 1000, 3),
            }
            hop["span"] = hop["_ctx"].span_id
            if probing:
                hop["annotations"] = ["half-open probe"]
            with hlock:
                hops.append(hop)
            threading.Thread(
                target=run_attempt, args=(replica, tag, probing, hop),
                name=f"pdtn-fe-{tag}", daemon=True,
            ).start()

        def snapshot_hops(winner: Optional[dict]) -> List[dict]:
            """Plain-dict copies with the final per-attempt outcome:
            ``won`` (produced the client's response), ``failed``,
            ``rerouted``, or ``discarded`` (a losing hedge's response,
            or an attempt still in flight when the winner returned —
            the request-id dedup contract, now visible per span)."""
            outcome_by_kind = {"failure": "failed", "reroute": "rerouted",
                               "pass": "discarded"}
            snap = []
            with hlock:
                for hop in hops:
                    h = {k: v for k, v in hop.items()
                         if k not in ("_ctx", "kind")}
                    if winner is not None and hop is winner:
                        h["outcome"] = "won"
                    else:
                        h["outcome"] = outcome_by_kind.get(
                            hop.get("kind"), "discarded"
                        )
                    snap.append(h)
            return snap

        picked = self._pick()
        if picked is None:
            raise NoReplicaAvailable(
                "no ready replica (pool empty, all breakers open, or "
                "everything draining)"
            )
        first, probing = picked
        fire(first, "primary", probing)
        if not probing:
            # ride-along half-open probe: the same idempotent request
            # (same rid — the dedup that makes this safe) also goes to
            # ONE open-breaker replica past its cooldown, so its breaker
            # can close through the request path while healthy replicas
            # serve the client. Its outcome feeds the breaker inside
            # _attempt; a probe failure re-opens silently (same outage)
            # and never spends the retry budget below.
            prb = self._probe_candidate(exclude=tried)
            if prb is not None:
                fire(prb, "probe", True)
        hedge_fired = False
        hedge_at = t0 + self.hedge_delay_ms() / 1000.0
        deadline = t0 + timeout + 10.0
        attempts_left = self.retries  # extra fires beyond the primary
        received = 0
        last: Optional[_Outcome] = None
        while True:
            now = time.monotonic()
            if now >= deadline:
                break
            wait = deadline - now
            if not hedge_fired:
                wait = min(wait, max(0.0, hedge_at - now))
            try:
                out = results.get(timeout=max(0.001, wait))
            except queue.Empty:
                if not hedge_fired and time.monotonic() >= hedge_at:
                    hedge_fired = True
                    if attempts_left > 0:
                        p2 = self._pick(exclude=tried)
                        if p2 is not None:
                            r2, probing2 = p2
                            attempts_left -= 1
                            self.hedges += 1
                            self.telemetry.registry.counter(
                                "frontend_hedges_total",
                                help="hedge requests fired for slow "
                                     "primaries",
                            ).inc()
                            self.telemetry.emit(
                                "hedge", request_id=rid,
                                primary=tried[0].name, hedge=r2.name,
                                after_ms=round(
                                    (time.monotonic() - t0) * 1000, 1),
                            )
                            fire(r2, "hedge", probing2)
                continue
            if out.kind == "pass":
                if out.tag == "hedge":
                    self.hedge_wins += 1
                return self._finish(out, rid, klass, t0, fired,
                                    ctx=ctx,
                                    hops=snapshot_hops(out.hop))
            if out.tag == "probe":
                # ride-along probe failure/reroute: the breaker
                # bookkeeping already happened inside _attempt — the
                # client's outcome belongs to the primary/retries still
                # in flight, so neither `received` nor `last` moves
                continue
            received += 1
            last = out
            # failure / reroute: spend the retry budget on a fresh
            # replica (request-id dedup: same rid, so a late duplicate
            # response can never double-serve the client — the first
            # pass outcome above already returned)
            if attempts_left > 0:
                pnxt = self._pick(exclude=tried)
                if pnxt is not None:
                    nxt, probing_n = pnxt
                    attempts_left -= 1
                    self.retried += 1
                    self.telemetry.registry.counter(
                        "frontend_retries_total",
                        help="upstream attempts retried on another "
                             "replica",
                    ).inc()
                    fire(nxt, "retry", probing_n)
                    continue
            if received >= fired:
                break  # nothing in flight, nothing left to try
        if last is None:
            last = _Outcome(None, {"error": "forward timed out"},
                            "failure", first, "primary")
        return self._finish(last, rid, klass, t0, fired, failed=True,
                            ctx=ctx, hops=snapshot_hops(None))

    def _finish(self, out: _Outcome, rid: str, klass: str, t0: float,
                attempts: int, failed: bool = False, ctx=None,
                hops: Optional[List[dict]] = None):
        latency_ms = (time.monotonic() - t0) * 1000.0
        status = out.status if out.status is not None else 502
        trace_fields = ctx.fields() if ctx is not None else {}
        if failed:
            # a client-visible failure must enter the stream: the
            # availability metric (reader._serving_summary_records) is
            # served/offered, and a forward that returned 5xx after
            # exhausting its retries is offered-but-not-served — without
            # this event an outage stream would still report 1.0.
            # No rate limit: failures are bounded by max_inflight over
            # the per-request timeout, unlike sheds (carries count=1 so
            # the reader's sum-of-counts recovery stays uniform).
            self.failed += 1
            self.telemetry.registry.counter(
                "frontend_failed_total",
                help="forwards that returned a client-visible failure "
                     "after exhausting retries",
            ).inc()
            self.telemetry.emit(
                "request_failed", request_id=rid, klass=klass,
                status=status, replica=out.replica.name,
                attempts=attempts, layer="frontend", count=1,
                **trace_fields,
                **({"hops": hops} if hops else {}),
            )
        else:
            self.forwarded += 1
            with self._adm_lock:
                self._lat_ms.append(latency_ms)
            self._seq += 1
            self.telemetry.log_step({
                "step": self._seq,
                "request_id": rid,
                "latency_ms": round(latency_ms, 3),
                "replica": out.replica.name,
                "attempts": attempts,
                "hedged": out.tag == "hedge",
                "klass": klass,
                **trace_fields,
                **({"hops": hops} if hops else {}),
                **({"version": (out.payload or {}).get(
                    "versions", [None])[0]}
                   if isinstance(out.payload, dict)
                   and out.payload.get("versions") else {}),
            })
        payload = dict(out.payload or {})
        payload.setdefault("request_ids", [rid])
        payload["replica"] = out.replica.name
        payload["attempts"] = attempts
        return status, payload

    # -- drain / rolling restart -------------------------------------------

    def drain_replica(self, name: str, timeout: float = 30.0) -> bool:
        """Zero-downtime drain of one spawned replica: stop routing to
        it, SIGTERM (the replica refuses new admissions, finishes
        in-flight batches, exits 0 — serving/server.py), wait for the
        exit. Attached replicas only stop receiving traffic. Returns
        True on a clean exit inside ``timeout``."""
        r = self._find(name)
        with self._rlock:
            r.draining = True  # no new routes from this instant
        self.telemetry.emit("drain", phase="start", replica=name,
                            outstanding=r.outstanding)
        if r.proc is None:
            self.telemetry.emit("drain", phase="done", replica=name,
                                rc=None)
            return True
        try:
            r.proc.send_signal(signal.SIGTERM)
        except ProcessLookupError:
            pass
        deadline = time.monotonic() + timeout
        rc = None
        while time.monotonic() < deadline:
            rc = r.proc.poll()
            if rc is not None:
                break
            time.sleep(0.02)
        clean = rc == 0
        with self._rlock:
            r.state = "down"
        self._set_replica_gauges()
        self.telemetry.emit("drain", phase="done", replica=name, rc=rc,
                            clean=clean)
        if not clean:
            logger.warning("drain of %s did not exit cleanly (rc=%s)",
                           name, rc)
        return clean

    def restart_replica(self, name: str,
                        wait_ready_s: float = 120.0) -> Replica:
        """Respawn a (dead or drained) spawned replica and wait for its
        ``/readyz`` rejoin — the second half of a rolling restart."""
        r = self._find(name)
        if r.spawn_cmd is None:
            raise RuntimeError(
                f"replica {name!r} was attached, not spawned — restart "
                "it where it runs"
            )
        if r.proc is not None and r.proc.poll() is None:
            raise RuntimeError(f"replica {name!r} is still running")
        if os.path.exists(r.port_file):
            os.remove(r.port_file)
        # rejoin must be announced: the roster entry re-enters at "down"
        # atomically with the spawn (under _rlock inside _spawn), so
        # replica_up(rejoin=True) fires exactly once when /readyz goes
        # green — a fast-starting replica can never be promoted and then
        # forced back down for a duplicate event
        self._spawn(r, state="down")
        deadline = time.monotonic() + wait_ready_s
        while time.monotonic() < deadline:
            self._health_tick()
            if r.state == "ready":
                return r
            time.sleep(0.05)
        raise TimeoutError(
            f"replica {name!r} did not become ready in {wait_ready_s:.0f}s"
            f" (log: {r.log_path})"
        )

    def rolling_restart(self, drain_timeout: float = 30.0,
                        wait_ready_s: float = 120.0) -> int:
        """Drain + respawn every SPAWNED replica, one at a time, never
        dropping below N-1 ready — the rolling-restart primitive.
        Returns the number of replicas restarted."""
        with self._rlock:
            names = [r.name for r in self.replicas
                     if r.spawn_cmd is not None]
        for name in names:
            self.drain_replica(name, timeout=drain_timeout)
            self.restart_replica(name, wait_ready_s=wait_ready_s)
        return len(names)

    def kill_replica(self, name: str) -> None:
        """SIGKILL a spawned replica's whole process group — the chaos
        scenario's abrupt replica loss (no drain, no goodbye)."""
        r = self._find(name)
        if r.proc is None:
            raise RuntimeError(f"replica {name!r} was attached")
        try:
            os.killpg(os.getpgid(r.proc.pid), signal.SIGKILL)
        except ProcessLookupError:
            pass
        r.proc.wait()

    # -- state / lifecycle -------------------------------------------------

    def state(self) -> dict:
        with self._rlock:
            replicas = [r.snapshot() for r in self.replicas]
        with self._adm_lock:
            inflight = self._inflight
            peak = self._inflight_peak
        return {
            "replicas": replicas,
            "ready": sum(1 for r in replicas if r["state"] == "ready"),
            "inflight": inflight,
            "inflight_peak": peak,
            "max_inflight": self.max_inflight,
            "forwarded": self.forwarded,
            "failed": self.failed,
            "shed": self.shed,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "retried": self.retried,
            "hedge_delay_ms": round(self.hedge_delay_ms(), 1),
            "uptime_s": round(time.time() - self.started, 3),
        }

    def start(self) -> "Frontend":
        """Start the health loop and the frontend's own HTTP listener."""
        self._health_thread = threading.Thread(
            target=self._health_loop, name="pdtn-fe-health", daemon=True
        )
        self._health_thread.start()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive for clients
            disable_nagle_algorithm = True  # no delayed-ACK stalls

            def log_message(self, fmt, *args):
                logger.debug("frontend http: " + fmt, *args)

            def _reply(self, code: int, payload: dict,
                       request_id: Optional[str] = None,
                       retry_after_s: Optional[float] = None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if request_id is not None:
                    self.send_header("X-Request-Id", request_id)
                if retry_after_s is not None:
                    self.send_header(
                        "Retry-After",
                        str(max(1, int(round(retry_after_s)))),
                    )
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok",
                                      "role": "frontend"})
                elif self.path == "/readyz":
                    st = outer.state()
                    if st["ready"] > 0:
                        self._reply(200, {"status": "ready",
                                          "replicas": st["ready"]})
                    else:
                        self._reply(503, {"status": "no ready replicas"})
                elif self.path == "/stats":
                    self._reply(200, outer.state())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                from pytorch_distributed_nn_tpu_torch.observability import (
                    tracing,
                )

                if self.path != "/v1/infer":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    doc = json.loads(self.rfile.read(n))
                    if not isinstance(doc, dict) or not doc.get("inputs"):
                        raise ValueError("'inputs' must be a non-empty "
                                         "list")
                    header_rid = self.headers.get("X-Request-Id")
                    rid = (
                        tracing.validate_request_id(header_rid)
                        if header_rid is not None
                        else tracing.new_request_id()
                    )
                    # the door honors a client trace context (validated;
                    # garbage is a 400): the frontend's root span joins
                    # the client's trace as a child — otherwise forward
                    # mints a fresh root
                    header_tc = self.headers.get(tracing.TRACE_HEADER)
                    trace_ctx = (
                        tracing.TraceContext.from_header(header_tc)
                        .child()
                        if header_tc is not None else None
                    )
                    klass = str(self.headers.get(
                        "X-Traffic-Class", "stable"
                    )).strip().lower()
                    timeout = float(
                        doc.get("timeout_s", outer.timeout_s)
                    )
                except (KeyError, TypeError, ValueError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    status, payload = outer.forward(
                        doc, klass=klass, request_id=rid,
                        timeout_s=timeout, trace=trace_ctx,
                    )
                except FrontendShed as e:
                    self._reply(429, {"error": str(e),
                                      "retry_after_s": e.retry_after_s},
                                request_id=rid,
                                retry_after_s=e.retry_after_s)
                    return
                except NoReplicaAvailable as e:
                    self._reply(503, {"error": str(e)}, request_id=rid)
                    return
                except ValueError as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                self._reply(status, payload, request_id=rid)

        class _Server(ThreadingHTTPServer):
            # stdlib default backlog is 5: a burst of concurrent
            # clients overflows the accept queue and half-established
            # connections die with RST at the first read — exactly the
            # "failure" an availability layer must not manufacture
            request_queue_size = 128

        self._httpd = _Server(self._listen, Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="pdtn-fe-http",
            daemon=True,
        )
        self._http_thread.start()
        logger.info("frontend on http://%s:%d", self.host, self.port)
        return self

    def close(self, stop_replicas: bool = True,
              drain: bool = False) -> None:
        """Stop the listener + health loop; ``stop_replicas`` SIGTERMs
        (``drain=True``: full zero-downtime drains) every spawned
        replica."""
        self._stop.set()
        self._flush_shed()
        with self._pool_lock:
            for idle in self._pool.values():
                for conn in idle:
                    try:
                        conn.close()
                    except OSError:
                        pass
            self._pool.clear()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10.0)
        if self._health_thread is not None:
            self._health_thread.join(timeout=self.poll_s + 5.0)
        if not stop_replicas:
            return
        with self._rlock:
            owned = [r for r in self.replicas if r.proc is not None]
        for r in owned:
            if r.proc.poll() is not None:
                continue
            if drain:
                self.drain_replica(r.name)
            else:
                try:
                    r.proc.send_signal(signal.SIGTERM)
                except ProcessLookupError:
                    pass
        for r in owned:
            try:
                r.proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(os.getpgid(r.proc.pid), signal.SIGKILL)
                except ProcessLookupError:
                    pass
                r.proc.wait()


def frontend_telemetry(out_dir: str, extra: Optional[dict] = None):
    """A manifest-headed ``serving.jsonl`` stream for a FRONTEND run —
    same contract as the replica's stream (reader.find_stream falls back
    to the basename), with ``mode: "frontend"`` so a summary is
    attributable. The frontend imports no torch, so the manifest carries
    no torch version."""
    from pytorch_distributed_nn_tpu_torch.observability import core as obs

    manifest = obs.run_manifest(
        config={"mode": "frontend", **(extra or {})},
    )
    path = os.path.join(out_dir, obs.SERVING_BASENAME)
    os.makedirs(out_dir, exist_ok=True)
    return obs.Telemetry.for_run(path, manifest)
