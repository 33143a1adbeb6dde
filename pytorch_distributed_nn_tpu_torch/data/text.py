"""Synthetic masked-LM data: the port's own copy of
``pytorch_distributed_nn_tpu/data/text.py``.

Token streams are random walks on a fixed random bigram chain, so an MLM
model has real signal to learn; everything is generated from seeds with
numpy, so nothing is downloaded. Given the same seeds, ``MLMBatches``
yields byte-identical batches to the JAX package's (the tests hold it to
that): the same ``RandomState`` draws in the same order, batch ``i`` a
pure function of ``(seed, i)`` through a counter-based ``SeedSequence``
stream, and a fixed eval set drawn in canonical 512-sequence chunks.

Special ids follow BERT conventions: 0=[PAD] 1=[CLS] 2=[SEP] 3=[MASK];
real tokens are ids >= NUM_SPECIAL. ``MLMLoader`` moves batches to the
trainer's device as int64 tensors; over several ranks every rank draws
the same global batch and rank r of n takes its rows ``[r*B/n,
(r+1)*B/n)`` (the JAX ``batch_sharding`` split), so the stream's
position, resume and skip are the same on every rank.

The training stream's position is one counter: ``skip(n)`` fast-forwards
it, and ``state()`` / ``restore()`` carry it through a checkpoint's
``model_step_<N>.data.json`` sidecar in the JAX package's format, so a
resumed run continues the exact batch stream.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.ops.metrics import IGNORE_INDEX

PAD_ID, CLS_ID, SEP_ID, MASK_ID = 0, 1, 2, 3
NUM_SPECIAL = 4


class BigramCorpus:
    """Deterministic synthetic corpus: a sparse random bigram chain with
    ``branching`` Zipf-weighted successors per token."""

    def __init__(self, vocab_size: int, branching: int = 8, seed: int = 0):
        assert vocab_size > NUM_SPECIAL + branching
        self.vocab_size = vocab_size
        rng = np.random.RandomState(seed)
        n_real = vocab_size - NUM_SPECIAL
        self.successors = rng.randint(
            0, n_real, size=(n_real, branching)
        ).astype(np.int32)
        w = 1.0 / np.arange(1, branching + 1)
        self.succ_probs = w / w.sum()
        self.branching = branching

    def sample_tokens(self, rng: np.random.RandomState, batch: int,
                      length: int) -> np.ndarray:
        """(batch, length) int32 token ids: [CLS] walk... [SEP]."""
        n_real = self.vocab_size - NUM_SPECIAL
        out = np.empty((batch, length), np.int32)
        out[:, 0] = CLS_ID
        cur = rng.randint(0, n_real, size=batch)
        for j in range(1, length - 1):
            out[:, j] = cur + NUM_SPECIAL
            choice = rng.choice(self.branching, size=batch, p=self.succ_probs)
            cur = self.successors[cur, choice]
        out[:, length - 1] = SEP_ID
        return out


def mask_tokens(tokens: np.ndarray, rng: np.random.RandomState,
                vocab_size: int, mask_prob: float = 0.15
                ) -> Tuple[np.ndarray, np.ndarray]:
    """BERT-style masking: of the ``mask_prob`` selected, 80% -> [MASK],
    10% -> random, 10% unchanged. Returns (inputs, labels); labels are
    IGNORE_INDEX where unselected. Special tokens are never selected."""
    selectable = tokens >= NUM_SPECIAL
    sel = (rng.random_sample(tokens.shape) < mask_prob) & selectable
    labels = np.where(sel, tokens, IGNORE_INDEX).astype(np.int32)
    inputs = tokens.copy()
    r = rng.random_sample(tokens.shape)
    to_mask = sel & (r < 0.8)
    to_rand = sel & (r >= 0.8) & (r < 0.9)
    inputs[to_mask] = MASK_ID
    inputs[to_rand] = rng.randint(
        NUM_SPECIAL, vocab_size, size=int(to_rand.sum())
    ).astype(np.int32)
    return inputs, labels


class MLMBatches:
    """Infinite iterator of numpy (inputs, labels) MLM batches, int32.

    The corpus (the bigram table: "the language") and the sampling
    stream are seeded apart, so train and eval loaders share
    ``corpus_seed`` while drawing different streams."""

    #: canonical draw width of the eval stream: eval sequence #i does not
    #: depend on the batch size
    _EVAL_CHUNK = 512

    def __init__(self, vocab_size: int = 1024, seq_len: int = 128,
                 batch_size: int = 32, seed: int = 0,
                 mask_prob: float = 0.15, branching: int = 8,
                 corpus_seed: Optional[int] = None):
        if corpus_seed is None:
            corpus_seed = seed
        self.corpus = BigramCorpus(vocab_size, branching=branching,
                                   seed=corpus_seed)
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.mask_prob = mask_prob
        self._seed = seed
        self._counter = 0

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def _stream_rng(self, index: int) -> np.random.RandomState:
        # batch #i is a function of (seed, i) alone; the generator takes
        # the full SeedSequence state (one uint32 word would collide)
        ss = np.random.SeedSequence((self._seed + 1, index))
        return np.random.RandomState(np.random.MT19937(ss))

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        rng = self._stream_rng(self._counter)
        self._counter += 1
        toks = self.corpus.sample_tokens(rng, self.batch_size, self.seq_len)
        return mask_tokens(toks, rng, self.vocab_size, self.mask_prob)

    def skip(self, n: int) -> None:
        """Fast-forward the training stream by ``n`` batches (O(1))."""
        self._counter += int(n)

    #: the iterator state's format (the JAX package's)
    STATE_FORMAT = "pdtn-mlm-state-v1"

    def state(self) -> dict:
        return {"format": self.STATE_FORMAT, "kind": "mlm",
                "counter": int(self._counter)}

    def restore(self, state: dict) -> None:
        if state.get("kind") != "mlm":
            raise ValueError(f"iterator state is kind {state.get('kind')!r},"
                             " expected 'mlm'")
        self._counter = int(state["counter"])

    def eval_set(self, n_batches: int):
        """A fixed eval set of ``n_batches`` batches: the same sequences
        every call, whatever the training stream has done."""
        rng = np.random.RandomState(self._seed + 7919)
        total = n_batches * self.batch_size
        if total <= 0:
            return []
        xs, ys = [], []
        for _ in range(-(-total // self._EVAL_CHUNK)):
            toks = self.corpus.sample_tokens(rng, self._EVAL_CHUNK,
                                             self.seq_len)
            x, y = mask_tokens(toks, rng, self.vocab_size, self.mask_prob)
            xs.append(x)
            ys.append(y)
        x = np.concatenate(xs)[:total]
        y = np.concatenate(ys)[:total]
        bs = self.batch_size
        return [(x[i * bs:(i + 1) * bs], y[i * bs:(i + 1) * bs])
                for i in range(n_batches)]


class MLMLoader:
    """The trainer's view of :class:`MLMBatches`: this rank's rows of
    each global batch (``rank`` of ``world``) as int64 tensors on
    ``device``; the fixed eval set moved there once and kept.
    ``last_wait_ms`` is the time the last ``next_batch`` took (the
    batch is generated on the calling thread, so all of it is wait)."""

    def __init__(self, batches: MLMBatches, device,
                 steps_per_epoch: int = 100, eval_batches: int = 64,
                 rank: int = 0, world: int = 1):
        if batches.batch_size % world:
            raise ValueError(f"global batch {batches.batch_size} not "
                             f"divisible by {world} ranks")
        self._batches = batches
        per = batches.batch_size // world
        self._rows = slice(rank * per, (rank + 1) * per)
        self.device = torch.device(device)
        self.steps_per_epoch = steps_per_epoch
        self._eval_batches = eval_batches
        self._eval_cache = None
        self.last_wait_ms = 0.0

    @property
    def eval_sequences(self) -> int:
        """Sequences every eval pass scores."""
        return self._eval_batches * self._batches.batch_size

    def skip(self, n: int) -> None:
        self._batches.skip(n)

    def state(self) -> dict:
        """The training stream's position, for a checkpoint's sidecar."""
        return self._batches.state()

    def restore(self, state: dict) -> None:
        self._batches.restore(state)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a[self._rows].astype(np.int64)).to(
            self.device)

    def next_batch(self) -> Tuple[torch.Tensor, torch.Tensor]:
        t0 = time.perf_counter()
        x, y = next(self._batches)
        out = self._put(x), self._put(y)
        self.last_wait_ms = (time.perf_counter() - t0) * 1e3
        return out

    def epoch_batches(self):
        if self._eval_cache is None:
            self._eval_cache = [
                (self._put(x), self._put(y))
                for x, y in self._batches.eval_set(self._eval_batches)
            ]
        yield from self._eval_cache

    def close(self) -> None:
        self._eval_cache = None
