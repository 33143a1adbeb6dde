"""Generative decode path: KV-cache autoregressive serving.

- :mod:`.kvcache`   — bucketed fixed-size KV page pools: slot
  allocation/eviction, epoch fencing for hot swaps.
- :mod:`.engine`    — :class:`~.engine.GenerativeEngine`: a causal
  decoder over prefill / cache-insert / decode phases with
  preallocated pools, decode attention and LayerNorm on the
  hand-written kernels.
- :mod:`.scheduler` — :class:`~.scheduler.GenerateScheduler`: per-token
  continuous batching.
"""

from pytorch_distributed_nn_tpu_torch.serving.generate.engine import (  # noqa: F401
    GenerativeEngine,
)
from pytorch_distributed_nn_tpu_torch.serving.generate.kvcache import (  # noqa: F401
    KVCachePool,
    PoolExhausted,
    StaleKVPage,
)
from pytorch_distributed_nn_tpu_torch.serving.generate.scheduler import (  # noqa: F401
    GenerateRequest,
    GenerateScheduler,
)
