"""CPU settings shared by the port's test files (``test_torch_*.py``).

Each of those files imports this module, so whichever of them a
process runs, torch uses one intra-op thread there. The suite runs in
several pytest-xdist workers, each with XLA's own thread pool beside
torch's; torch's default of one thread per core in every worker
oversubscribes the cores, and its small ops then wait at each parallel
region for descheduled threads: a ResNet-20 trainer test that takes 4 s
alone took 20 to 40 s inside the whole suite, and it held back the other
workers' processes as long. A subprocess a test starts gets the same
setting through :data:`SUBPROCESS_ENV`.
"""

import os

import torch

torch.set_num_threads(1)

#: the environment for a command a port test runs: one intra-op thread
SUBPROCESS_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
