"""Generative inference engine: a causal decoder with bucketed KV-cache
pools, in PyTorch on one device.

The port of ``pytorch_distributed_nn_tpu/serving/generate/engine.py``.
The same three phases over the same bucket grid:

- **prefill** — one prompt (batch 1), padded to its prompt bucket, runs
  the causal forward; returns the last valid position's logits and the
  per-layer K/V;
- **insert** — copies a prefill's K/V panel into a pool page;
- **decode** — one step for up to a batch bucket of sequences of one
  cache bucket: gathers their pages, writes each row's new K/V at its
  own position, runs single-position attention (the hand-written
  kernel) and the per-token MLP and head, scatters the pages back. The
  batch is padded with the pool's scratch page at position 0.

PyTorch runs eagerly, so there are no executables to trace. What can
still appear mid-serving is a kernel build or library load:
:meth:`GenerativeEngine.warmup` runs every (phase, bucket) pair once,
which builds and loads every kernel, and :meth:`retraces` counts the
builds and loads since — it must stay 0.

Weights live in a ``CausalLM`` module; a hot swap builds a new module
and installs it under the weights lock, so one step always sees one
weight version (:meth:`snapshot`). Every swap bumps ``epoch`` and the
pools' slot ledger fences the pages written under the old weights; the
scheduler re-prefills those sequences. ``shadow`` gives a canary its own
weights and its own pools.

Entry point rule: ``device=None`` means the card. Without one, the
constructor raises; it never falls back to the CPU on its own. Tests
pass ``device="cpu"``, where the kernels' plain versions run.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.ops import kernels, reference
from pytorch_distributed_nn_tpu_torch.serving.generate.kvcache import (
    KVCachePool,
    StaleKVPage,
)
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

#: decode batch buckets: how many sequences one decode step advances
DEFAULT_DECODE_BATCH_BUCKETS = (1, 2, 4, 8)

#: smallest cache bucket
_MIN_SEQ_BUCKET = 16

#: decode attention of the engine's model: the hand-written kernel (the
#: JAX engine's ``decode_attn="pallas"``), or its plain PyTorch version
#: on any device (the JAX engine's ``"exact"``), for A/B comparisons
DECODE_ATTN = {"kernel": None, "plain": reference.decode_attention}


def default_seq_buckets(max_len: int) -> Tuple[int, ...]:
    """Powers of two from ``_MIN_SEQ_BUCKET`` up to (and always
    including) ``max_len``."""
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        length_buckets,
    )

    out = tuple(
        b for b in length_buckets(max_len)
        if b >= min(_MIN_SEQ_BUCKET, max_len)
    )
    return out or (max_len,)


class StaleBatchEpoch(RuntimeError):
    """A swap landed between the scheduler's fence round and the decode
    dispatch: the whole batch is refused so the caller re-validates.
    Nothing stale was read, so this is NOT a fence violation."""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


class GenerativeEngine:
    """Loads a causal-decoder artifact and serves prefill + per-token
    decode over bucketed KV-cache pools on ``device``."""

    def __init__(
        self,
        artifact_dir: str,
        batch_buckets: Sequence[int] = DEFAULT_DECODE_BATCH_BUCKETS,
        seq_buckets: Optional[Sequence[int]] = None,
        prompt_buckets: Optional[Sequence[int]] = None,
        pool_slots: Optional[int] = None,
        decode_attn: str = "kernel",
        device=None,
    ):
        from pytorch_distributed_nn_tpu_torch.models import is_generative_model
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            load_artifact,
        )

        self.device = resolve_device(device)
        if not batch_buckets or list(batch_buckets) != sorted(set(batch_buckets)):
            raise ValueError(
                f"batch_buckets must be strictly increasing, got "
                f"{batch_buckets!r}"
            )
        if decode_attn not in DECODE_ATTN:
            raise ValueError(
                f"unknown decode_attn {decode_attn!r}; expected "
                f"{'|'.join(DECODE_ATTN)}"
            )
        self.decode_attn = decode_attn
        self.manifest, params, _ = load_artifact(artifact_dir)
        network = self.manifest["network"]
        if not is_generative_model(network):
            raise ValueError(
                f"artifact network {network!r} is not a causal decoder — "
                "the generative engine serves GENERATIVE_MODELS only"
            )
        self.artifact_dir = artifact_dir
        self._params_flat = [(p, a.shape, a.dtype) for p, a in _flat(params)]
        self.model = self._build(params)
        cfg = self.model.config
        self.vocab_size = int(cfg.vocab_size)
        self.max_len = int(cfg.max_len)
        self.num_heads = int(cfg.num_heads)
        self.head_dim = int(cfg.d_model // cfg.num_heads)
        self.num_layers = int(cfg.num_layers)
        self.cache_dtype = cfg.dtype

        self._weights_lock = threading.Lock()
        self.swaps = 0
        #: weight-swap epoch — the KV-page fence token (kvcache ledger)
        self.epoch = 0

        self.batch_buckets = tuple(int(b) for b in batch_buckets)
        self.seq_buckets = tuple(
            int(s) for s in (seq_buckets or default_seq_buckets(self.max_len))
        )
        if self.seq_buckets[-1] > self.max_len:
            raise ValueError(
                f"seq bucket {self.seq_buckets[-1]} exceeds the model "
                f"max_len {self.max_len}"
            )
        self.prompt_buckets = tuple(
            int(s) for s in (prompt_buckets or self.seq_buckets)
        )
        self.pool_slots = int(pool_slots or 2 * self.batch_buckets[-1])
        self._new_pools()
        self._warm_events: Optional[int] = None

        # counters (obs/stats surface)
        self.prefills = 0
        self.decode_steps = 0
        self.decode_rows = 0
        self.tokens_generated = 0
        self.fence_violations = 0

    def _build(self, params):
        from pytorch_distributed_nn_tpu_torch.models import build_model
        from pytorch_distributed_nn_tpu_torch.models.convert import (
            flax_to_state_dict,
        )
        model = build_model(
            self.manifest["network"], self.manifest.get("num_classes", 0),
            decode_attn_fn=DECODE_ATTN[self.decode_attn],
            **self.manifest.get("model_kw", {}),
        )
        model.load_state_dict(flax_to_state_dict(params))
        return model.to(self.device).eval()

    def _new_pools(self) -> None:
        """Slot ledgers + the pool tensors (one scratch page past the
        usable slots: decode pads batches with it)."""
        self.pools: Dict[int, KVCachePool] = {}
        self._pool_kv: Dict[int, tuple] = {}
        for s in self.seq_buckets:
            self.pools[s] = KVCachePool(s, self.pool_slots)
            shape = (self.pool_slots + 1, s, self.num_heads, self.head_dim)
            self._pool_kv[s] = tuple(
                (torch.zeros(shape, dtype=self.cache_dtype, device=self.device),
                 torch.zeros(shape, dtype=self.cache_dtype, device=self.device))
                for _ in range(self.num_layers)
            )

    # -- identity ----------------------------------------------------------

    @property
    def version(self) -> str:
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            artifact_version,
        )

        return artifact_version(self.manifest)

    @property
    def identity(self) -> dict:
        src = self.manifest.get("source") or {}
        return {
            "version": self.version,
            "train_dir": src.get("train_dir"),
            "step": src.get("step"),
            "quantize": self.manifest.get("quantize", "none"),
            "network": self.manifest.get("network"),
            "generative": True,
            "device": str(self.device),
        }

    # -- bucket policy -----------------------------------------------------

    def select_prompt_bucket(self, length: int) -> int:
        for s in self.prompt_buckets:
            if length <= s:
                return s
        raise ValueError(
            f"prompt of {length} tokens exceeds the largest prompt "
            f"bucket {self.prompt_buckets[-1]}"
        )

    def select_seq_bucket(self, total: int) -> int:
        """Smallest cache bucket >= prompt + max_new_tokens."""
        for s in self.seq_buckets:
            if total <= s:
                return s
        raise ValueError(
            f"prompt + max_new_tokens of {total} exceeds the largest "
            f"cache bucket {self.seq_buckets[-1]}"
        )

    # -- warmup ------------------------------------------------------------

    def warmup(self) -> float:
        """Run every (phase, bucket) pair once — on the card this builds
        and loads every kernel — so steady-state generation never builds.
        Returns warmup wall seconds."""
        from pytorch_distributed_nn_tpu_torch.utils.native_build import (
            build_events,
        )

        t0 = time.perf_counter()
        if self.device.type == "cuda":
            # one nvcc per kernel source, all at once, instead of one
            # after another as the first calls below would
            kernels.build_all()
        kvs_by_bucket = {}
        for sp in self.prompt_buckets:
            _, kvs, _ = self.prefill(np.ones((1,), np.int32), bucket=sp)
            kvs_by_bucket[sp] = kvs
        for s in self.seq_buckets:
            scratch = self.pools[s].scratch
            for sp in self.prompt_buckets:
                if sp <= s:
                    self.insert(s, scratch, kvs_by_bucket[sp])
            for b in self.batch_buckets:
                self._decode_padded(s, [scratch] * b, [0] * b, [0] * b,
                                    self.model)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prefills = 0
        self._warm_events = build_events()
        dt = time.perf_counter() - t0
        logger.info(
            "generative warmup: %d prefill / %d cache / %d batch bucket(s) "
            "run in %.2fs on %s", len(self.prompt_buckets),
            len(self.seq_buckets), len(self.batch_buckets), dt, self.device,
        )
        return dt

    def retraces(self) -> Optional[int]:
        """Kernel builds and library loads since :meth:`warmup` (None
        before it)."""
        from pytorch_distributed_nn_tpu_torch.utils.native_build import (
            build_events,
        )

        if self._warm_events is None:
            return None
        return build_events() - self._warm_events

    # -- hot swap ----------------------------------------------------------

    def _check_swappable(self, manifest: dict, params) -> None:
        for key in ("network", "num_classes", "model_kw", "input"):
            if manifest.get(key) != self.manifest.get(key):
                raise ValueError(
                    f"refusing swap: artifact {key!r} differs "
                    f"({manifest.get(key)!r} vs serving "
                    f"{self.manifest.get(key)!r})"
                )
        new = [(p, a.shape, a.dtype) for p, a in _flat(params)]
        if len(new) != len(self._params_flat):
            raise ValueError("refusing swap: params tree shape differs")
        for old_leaf, new_leaf in zip(self._params_flat, new):
            if old_leaf != new_leaf:
                raise ValueError(f"refusing swap: leaf {new_leaf[0]} "
                                 "mismatches")

    def swap(self, artifact_dir: str) -> str:
        """Install another decoder artifact's weights and FENCE every
        live KV page (epoch bump). Returns the new version."""
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            artifact_version,
            load_artifact,
        )

        manifest, params, _ = load_artifact(artifact_dir)
        self._check_swappable(manifest, params)
        model = self._build(params)
        old = self.version
        with self._weights_lock:
            self.manifest = manifest
            self.model = model
            self.artifact_dir = artifact_dir
            self.swaps += 1
            self.epoch += 1
        new = artifact_version(manifest)
        fenced = sum(
            len(p.stale_slots(self.epoch)) for p in self.pools.values()
        )
        logger.info(
            "generative swap #%d: %s -> %s (epoch %d; %d KV page(s) "
            "fenced for re-prefill)", self.swaps, old, new, self.epoch,
            fenced,
        )
        return new

    def shadow(self, artifact_dir: str) -> "GenerativeEngine":
        """A canary engine: its own weights and its own pools (a canary's
        K/V can never mix with the stable side's), same buckets."""
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            load_artifact,
        )

        manifest, params, _ = load_artifact(artifact_dir)
        self._check_swappable(manifest, params)
        other = object.__new__(GenerativeEngine)
        other.__dict__.update({
            k: v for k, v in self.__dict__.items()
            if k not in ("pools", "_pool_kv")
        })
        other.manifest = manifest
        other.artifact_dir = artifact_dir
        other.model = other._build(params)
        other._weights_lock = threading.Lock()
        other.swaps = other.epoch = 0
        other._new_pools()
        other.prefills = other.decode_steps = other.decode_rows = 0
        other.tokens_generated = other.fence_violations = 0
        return other

    # -- serving primitives ------------------------------------------------

    def snapshot(self):
        """(model, version, epoch) under the swap barrier — everything
        one prefill or decode step must see consistently."""
        with self._weights_lock:
            return self.model, self.version, self.epoch

    @torch.inference_mode()
    def prefill(self, token_ids, bucket: Optional[int] = None):
        """Run one prompt through its prompt bucket.

        Returns ``(last_logits (V,) np, kvs, stats)``; ``kvs`` is the
        per-layer K/V panel handed to :meth:`insert`; ``stats`` carries
        the bucket, wall ms and the (version, epoch) snapshot.
        """
        ln = int(np.shape(token_ids)[0])
        if ln < 1:
            raise ValueError("empty prompt")
        model, version, epoch = self.snapshot()
        t0 = time.perf_counter()
        sp = bucket or self.select_prompt_bucket(ln)
        buf = np.zeros((1, sp), np.int64)
        buf[0, :ln] = np.asarray(token_ids)
        tokens = torch.from_numpy(buf).to(self.device)
        mask = (torch.arange(sp, device=self.device) < ln)[None]
        logits, kvs = model(tokens, mask=mask, return_kv=True)
        last = logits[0, ln - 1].float().cpu().numpy()
        self.prefills += 1
        return last, kvs, {
            "prompt_bucket": sp,
            "prefill_ms": round((time.perf_counter() - t0) * 1000, 3),
            "version": version,
            "epoch": epoch,
        }

    @torch.inference_mode()
    def insert(self, bucket: int, slot: int, kvs) -> None:
        """Write a prefill's K/V panel into pool page ``slot`` of
        ``bucket``."""
        for (kp, vp), (k, v) in zip(self._pool_kv[bucket], kvs):
            n = k.shape[1]
            kp[slot, :n] = k[0].to(kp.dtype)
            vp[slot, :n] = v[0].to(vp.dtype)

    @torch.inference_mode()
    def _decode_padded(self, bucket, slots, tokens, positions, model):
        dev = self.device
        slot_t = torch.as_tensor(np.asarray(slots, np.int64)).to(dev)
        tok_t = torch.as_tensor(np.asarray(tokens, np.int64)).to(dev)
        pos_t = torch.as_tensor(np.asarray(positions, np.int32)).to(dev)
        pool = self._pool_kv[bucket]
        gathered = tuple((kp[slot_t], vp[slot_t]) for kp, vp in pool)
        logits, new_kv = model(tok_t[:, None], cache=gathered,
                               positions=pos_t)
        for (kp, vp), (k, v) in zip(pool, new_kv):
            kp[slot_t] = k
            vp[slot_t] = v
        return logits.cpu().numpy()

    def decode(self, bucket: int, slots: Sequence[int],
               tokens: Sequence[int], positions: Sequence[int],
               expected_epoch: Optional[int] = None):
        """One decode step for up to a batch bucket of sequences in one
        cache bucket: returns ``(logits (n, V) np, stats)``.

        The caller (scheduler) must have epoch-checked the slots via the
        pool ledger; this method re-asserts it and counts any miss as a
        fence violation before refusing. A swap that lands after the
        caller's validation (``expected_epoch`` behind the engine) is
        refused with :class:`StaleBatchEpoch` without convicting the
        ledger.
        """
        n = len(slots)
        if n == 0:
            return np.zeros((0, self.vocab_size), np.float32), {}
        pool = self.pools[bucket]
        model, version, epoch = self.snapshot()
        if expected_epoch is not None and int(expected_epoch) != epoch:
            raise StaleBatchEpoch(
                f"decode batch formed under epoch {int(expected_epoch)} "
                f"but the engine is at epoch {epoch} (swap landed "
                f"mid-round); re-validate and re-prefill"
            )
        for s in slots:
            try:
                pool.checkout(int(s), epoch)
            except StaleKVPage:
                self.fence_violations += 1
                raise
        t0 = time.perf_counter()
        bb = next((b for b in self.batch_buckets if n <= b), None)
        if bb is None:
            raise ValueError(
                f"decode batch of {n} exceeds the largest batch bucket "
                f"{self.batch_buckets[-1]}"
            )
        pad = bb - n
        out = self._decode_padded(
            bucket, list(slots) + [pool.scratch] * pad,
            list(tokens) + [0] * pad, list(positions) + [0] * pad, model,
        )[:n]
        dt = (time.perf_counter() - t0) * 1000
        self.decode_steps += 1
        self.decode_rows += n
        self.tokens_generated += n
        return out, {
            "batch": n,
            "batch_bucket": bb,
            "bucket": bucket,
            "decode_ms": round(dt, 3),
            "version": version,
            "epoch": epoch,
        }

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        return {
            "version": self.version,
            "epoch": self.epoch,
            "swaps": self.swaps,
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "tokens_generated": self.tokens_generated,
            "decode_occupancy": (
                self.decode_rows / self.decode_steps
                if self.decode_steps else None
            ),
            "fence_violations": self.fence_violations,
            "retraces": self.retraces(),
            "pools": {s: p.state() for s, p in self.pools.items()},
        }
