"""experiments/fleet — the sweep orchestrator off the laptop: the port's
copy of the JAX package's ``experiments/fleet/`` (the same wire, journal
events, placement, leases, migration and exit codes).

The reference system's answer to "many hosts" was an EC2 fan-out plus an
NFS-polling evaluator loop (SURVEY.md layer 5). This package is that
layer rebuilt on the repo's own contracts:

- :mod:`.agent`     — the host agent (``cli fleet agent --listen``): a
  torch-free JSON-line TCP server that registers capacity (device count,
  labels, planner profile) and runs assigned trials as supervised
  subprocesses like the single-host pool — heartbeat relayed upstream
  through ``poll``, SIGTERM forwarded so trials emergency-checkpoint
  before the host goes away.
- :mod:`.transport` — one call interface, two implementations: ``local``
  (subprocess agents on loopback TCP — what CI, the selftest and chaos
  use) and ``tcp`` (already-running remote agents). Every call retries
  with the shared ``resilience.retry`` backoff; liveness is LEASE-based —
  an agent that cannot be reached past its lease is *declared dead*, not
  hung-waited.
- :mod:`.scheduler` — :class:`~.scheduler.FleetScheduler` extends the
  ASHA :class:`~..runner.SweepRunner`: capacity-aware placement, per-host
  mesh capping through the elastic policy, and migration — a dead host's
  in-flight trials are re-dispatched to a surviving host and
  ELASTICALLY resumed from their last valid checkpoint (a different
  device count on the new host is the normal case, not an error).
  Migration never spends the retry budget.
- :mod:`.cache`     — shared plan/calibration cache, content-addressed by
  (model, mesh, torch version).

**Devices.** The JAX package's devices map to the port's by one rule: a
JAX trial holds every device of its host in one process, a port trial
runs one process per rank.

============================================  ================================
JAX                                           port
============================================  ================================
agent ``--platform cpu --devices N``: N        agent ``--device cpu --devices
virtual devices in one trial process           N``: a trial of up to N gloo
                                               rank processes
agent on a TPU host: the trial takes the       agent ``--device cuda --devices
host's chips                                   N``: N cards of its own
                                               (``CUDA_VISIBLE_DEVICES``),
                                               never shared with another
                                               agent, never the CPU
``LocalTransport(platform="cpu")``, the JAX    ``LocalTransport(device=...)``
default for local fleets                       (None: the card). On the card
                                               agent k gets the next
                                               ``devices[k]`` cards; a fleet
                                               asking for more cards than the
                                               host has is refused before any
                                               agent starts, naming both
                                               counts (cards counted with
                                               ``nvidia-smi -L``, no torch)
============================================  ================================

Journal contract: fleet decisions ride the SAME manifest-headed
``sweep.jsonl`` stream as the single-host pool (``host_join`` /
``host_dead`` / ``trial_migrate`` typed events), so ``fleet run
--resume`` reconstructs fleet state when the *orchestrator* dies too,
and either package folds the other's journal. The orchestrator process
never imports torch (asserted in ``cli fleet --selftest``).
"""

from pytorch_distributed_nn_tpu_torch.experiments.fleet.cache import (  # noqa: F401
    FleetCache,
    cache_key,
)
from pytorch_distributed_nn_tpu_torch.experiments.fleet.scheduler import (  # noqa: F401,E501
    FleetConfig,
    FleetScheduler,
    host_mesh_overrides,
    place_trial,
)
from pytorch_distributed_nn_tpu_torch.experiments.fleet.transport import (  # noqa: F401,E501
    AgentDead,
    AgentInfo,
    AgentRefused,
    AgentUnreachable,
    LocalTransport,
    TcpTransport,
    probe_hosts,
)
