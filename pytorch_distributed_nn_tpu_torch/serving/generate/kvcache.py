"""Bucketed KV-cache page pools for the generative engine.

The engine preallocates its cache once, at fixed shapes, and a KV cache
is the biggest tensor in the decode path — so cache memory is organized
as **fixed-size pools per total-length bucket**: one
pool per bucket S holds ``slots`` pages of per-layer K/V arrays shaped
``(slots, S, num_heads, head_dim)``. A sequence claims the pool of the
smallest bucket that fits ``prompt_len + max_new_tokens``, holds its slot
for its whole lifetime, and frees it when it finishes — which is the
step boundary where the continuous-batching scheduler admits the next
waiting request.

The pool tensors themselves live on the ENGINE (preallocated on its
device, updated in place by every decode step); this module owns the
slot ledger — a copy of the JAX package's, which the port keeps as its
own:

- allocation / free / eviction bookkeeping (never the array data);
- **epoch fencing** (docs/serving.md "Generative serving"): every slot
  records the engine epoch (= weight-swap counter) it was prefilled
  under. After a hot swap the old epoch's pages still hold K/V computed
  with the OUTGOING weights; ``stale_slots`` names them so the scheduler
  re-prefills those sequences under the new weights instead of ever
  decoding against mixed-version state. ``checkout`` refuses a stale
  slot outright — the "no token from mixed weights" invariant is
  enforced here, not just promised.

Host-side bookkeeping only — no torch imports.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class PoolExhausted(Exception):
    """No free slot in the bucket's pool (caller queues and retries at
    the next step boundary)."""


class StaleKVPage(RuntimeError):
    """A slot's pages were written under an older weight epoch: decoding
    them would mix weight versions (re-prefill first)."""


class _Slot:
    __slots__ = ("index", "epoch", "owner")

    def __init__(self, index: int):
        self.index = index
        self.epoch: Optional[int] = None
        self.owner: Optional[str] = None  # request id, for introspection


class KVCachePool:
    """The slot ledger of one bucket's page pool.

    ``slots`` usable pages plus one reserved SCRATCH page (index
    ``slots``): decode batches are padded up to their batch bucket with
    the scratch slot, so padding rows scatter their garbage K/V into a
    page no sequence ever owns instead of corrupting a live one.
    """

    def __init__(self, bucket: int, slots: int):
        if slots < 1:
            raise ValueError(f"pool for bucket {bucket} needs >= 1 slot")
        self.bucket = int(bucket)
        self.slots = int(slots)
        self.scratch = self.slots  # reserved padding page
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.slots))
        self._live: Dict[int, _Slot] = {}
        self.allocs = 0
        self.evictions = 0

    # -- allocation --------------------------------------------------------

    def alloc(self, epoch: int, owner: Optional[str] = None) -> int:
        """Claim a free slot for a sequence prefilled at ``epoch``."""
        with self._lock:
            if not self._free:
                raise PoolExhausted(
                    f"bucket {self.bucket}: all {self.slots} slots live"
                )
            idx = self._free.pop()
            slot = _Slot(idx)
            slot.epoch = int(epoch)
            slot.owner = owner
            self._live[idx] = slot
            self.allocs += 1
            return idx

    def free(self, index: int) -> None:
        """Return a finished sequence's slot to the pool (the page data
        is dead the moment the ledger forgets it — the next owner's
        prefill insert overwrites, and positions past its own length are
        never attended)."""
        with self._lock:
            if index not in self._live:
                raise KeyError(
                    f"bucket {self.bucket}: slot {index} is not live"
                )
            del self._live[index]
            self._free.append(index)

    # -- epoch fencing -----------------------------------------------------

    def checkout(self, index: int, epoch: int) -> int:
        """Assert slot ``index`` may decode at engine ``epoch``; returns
        the index. A stale slot (prefilled under older weights) raises —
        decoding it would mix weight versions inside one sequence."""
        with self._lock:
            slot = self._live.get(index)
            if slot is None:
                raise KeyError(
                    f"bucket {self.bucket}: slot {index} is not live"
                )
            if slot.epoch != int(epoch):
                raise StaleKVPage(
                    f"bucket {self.bucket}: slot {index} holds epoch-"
                    f"{slot.epoch} KV pages but the engine is at epoch "
                    f"{epoch} — re-prefill before decoding (swap fence)"
                )
            return index

    def stale_slots(self, epoch: int) -> List[int]:
        """Live slots whose pages were written under an older epoch —
        the re-prefill worklist after a hot swap."""
        with self._lock:
            return sorted(
                idx for idx, s in self._live.items()
                if s.epoch != int(epoch)
            )

    def evict(self, index: int) -> None:
        """Forcibly free a live slot (swap fencing / shutdown): same as
        :meth:`free` but counted as an eviction."""
        self.free(index)
        with self._lock:
            self.evictions += 1

    def rebind(self, index: int, epoch: int) -> None:
        """Move a live slot to ``epoch`` after its sequence was
        re-prefilled (its pages now hold new-weights K/V)."""
        with self._lock:
            slot = self._live.get(index)
            if slot is None:
                raise KeyError(
                    f"bucket {self.bucket}: slot {index} is not live"
                )
            slot.epoch = int(epoch)

    # -- introspection -----------------------------------------------------

    @property
    def live(self) -> int:
        with self._lock:
            return len(self._live)

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    def state(self) -> dict:
        with self._lock:
            return {
                "bucket": self.bucket,
                "slots": self.slots,
                "live": len(self._live),
                "free": len(self._free),
                "allocs": self.allocs,
                "evictions": self.evictions,
                "epochs": sorted({s.epoch for s in self._live.values()}),
            }
