"""Single-pass inference engine: a frozen classifier or masked-LM artifact
served bucket-padded on one device.

The port of ``pytorch_distributed_nn_tpu/serving/engine.py``. A server
admits any request batch (and, for token models, any sequence length up
to the model's ``max_len``) but executes only a fixed set of padded
shapes: batch buckets, times length buckets for token models, all run
once by :meth:`InferenceEngine.warmup`. PyTorch runs eagerly, so there is
no executable cache to retrace; what can still appear mid-serving is a
kernel build or library load, or a shape warmup never ran.
:meth:`InferenceEngine.retraces` counts both since warmup; it must stay 0.

The model is the port's (:func:`..models.build_model`) with the
artifact's weights carried over by the converters (``cnn_to_state_dict``
with the BatchNorm statistics as running statistics,
``flax_to_state_dict`` for ``BertMLM``), in ``eval()`` mode under
``torch.inference_mode()``. Attention is the plain ``full_attention``
(the artifact records no ``attn_impl``, so the JAX engine runs its
``full_attention`` too); the transformer's LayerNorm is the hand-written
kernel on the card, its plain version on the CPU.

Precision: the engine's own forwards run their float32 matmuls and
convolutions without TF32 (PyTorch lets cuDNN use TF32 by default; the
JAX engine's f32 convolutions are f32). The switches are process-wide, so
the engine turns them off only while one of its forwards runs and gives
them back after. :attr:`InferenceEngine.precision` reports it; ``GET
/stats`` shows it. A bf16 model (BertBase) computes in bf16 where its
layers say so.

Input rows are checked before they reach the card
(:meth:`InferenceEngine.check_input`): a token id outside the embedding
is a device-side assert there, after which the process's CUDA context is
unusable. The JAX engine's gather clamps such an id instead; the port
refuses the row (HTTP 400).

Outputs are float32 numpy arrays. Where the JAX engine returns a bf16
array (ml_dtypes), the port returns float32 holding the same values:
numpy has no bf16.

Entry point rule: ``device=None`` means the card. Without one the
constructor raises; it never falls back to the CPU on its own. Tests pass
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device
from pytorch_distributed_nn_tpu_torch.utils.precision import (
    no_tf32 as _no_tf32,
)

logger = logging.getLogger(__name__)

#: default admission buckets: batch sizes every request batch is padded up
#: to (powers of two keep the pad fraction <= 50%)
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)

_SWAP = ("weight hot swap, shadow engines and canaries are not ported yet: "
         "ROADMAP Queue 1 item 6 (router, frontend, registry)")


def length_buckets(max_len: int) -> Tuple[int, ...]:
    """Sequence-length buckets for token models: powers of two up to (and
    always including) ``max_len``."""
    out, b = [], 1
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(sorted(set(out)))


def _state_dict(model, params, batch_stats):
    from pytorch_distributed_nn_tpu_torch.models.convert import (
        cnn_to_state_dict,
        flax_to_state_dict,
        is_cnn,
    )

    if is_cnn(model):
        return cnn_to_state_dict(params, batch_stats)
    if batch_stats:
        raise ValueError("batch_stats in a transformer's artifact")
    return flax_to_state_dict(params)


class InferenceEngine:
    """Loads a frozen artifact and serves its forward pass bucket-padded.

    ``infer`` takes a list of per-request numpy inputs (image: the
    ``input.spec`` shape, NHWC; tokens: a 1-D int32 id sequence of any
    length up to the model's max_len), pads them up to the smallest
    fitting (batch[, length]) bucket, runs the model on ``device`` and
    returns per-request outputs with the batch padding stripped (token
    models keep their length bucket's positions, as the JAX engine's).
    """

    def __init__(self, artifact_dir: str,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 seq_buckets: Optional[Sequence[int]] = None, device=None):
        from pytorch_distributed_nn_tpu_torch.models import build_model
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            load_artifact,
        )

        self.device = resolve_device(device)
        if not batch_buckets \
                or list(batch_buckets) != sorted(set(batch_buckets)):
            raise ValueError(f"batch_buckets must be strictly increasing, "
                             f"got {batch_buckets!r}")
        self.manifest, params, batch_stats = load_artifact(artifact_dir)
        self.artifact_dir = artifact_dir
        model = build_model(self.manifest["network"],
                            self.manifest["num_classes"],
                            **self.manifest.get("model_kw", {}))
        model.load_state_dict(_state_dict(model, params, batch_stats),
                              strict=True)
        self.model = model.to(self.device).eval()
        cfg = getattr(model, "config", None)
        self.precision = {"tf32": False, "dtype": str(
            getattr(cfg, "dtype", None) or getattr(model, "dtype",
                                                    torch.float32))}
        self.kind = self.manifest["input"]["kind"]
        self.input_spec = tuple(self.manifest["input"]["spec"])
        self.input_dtype = np.int32 if self.kind == "tokens" else np.float32
        self.vocab_size = (int(cfg.vocab_size) if self.kind == "tokens"
                           else None)
        self.batch_buckets = tuple(int(b) for b in batch_buckets)
        if self.kind == "tokens":
            max_len = int(self.input_spec[0])
            self.seq_buckets = tuple(
                int(s) for s in (seq_buckets or length_buckets(max_len)))
            if self.seq_buckets[-1] != max_len:
                raise ValueError(
                    f"seq_buckets must end at the model max_len {max_len}, "
                    f"got {self.seq_buckets!r}")
        else:
            self.seq_buckets = None
        self._warm_events: Optional[int] = None
        self._warm_shapes: set = set()
        self._cold_shapes = 0  # shapes run that warmup did not run
        self.infer_batches = 0
        # forward FLOPs per bucket shape (torch.utils.flop_counter at
        # warmup): the achieved-FLOP/s numerator of `serve bench` and of
        # the per-request records
        self._bucket_flops: dict = {}
        self.flops_total = 0.0

    # -- identity ----------------------------------------------------------

    @property
    def version(self) -> str:
        """``<train_dir basename>@<step>:<quantize>``, stamped on every
        serving record."""
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            artifact_version,
        )

        return artifact_version(self.manifest)

    @property
    def identity(self) -> dict:
        """The artifact identity block (stream manifest, ``GET /stats``)."""
        src = self.manifest.get("source") or {}
        return {
            "version": self.version,
            "train_dir": src.get("train_dir"),
            "step": src.get("step"),
            "quantize": self.manifest.get("quantize", "none"),
            "network": self.manifest.get("network"),
            "device": str(self.device),
        }

    # -- hot swap: ROADMAP Queue 1 item 6 ------------------------------------

    def _check_swappable(self, manifest: dict, params) -> None:
        raise NotImplementedError(_SWAP)

    def swap(self, artifact_dir: str) -> str:
        raise NotImplementedError(_SWAP)

    def shadow(self, artifact_dir: str) -> "InferenceEngine":
        raise NotImplementedError(_SWAP)

    # -- bucket policy -------------------------------------------------------

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def select_bucket(self, n: int) -> int:
        """Smallest batch bucket >= n (the batcher never exceeds max)."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest bucket {self.max_batch}")

    def select_seq_bucket(self, length: int) -> int:
        if self.seq_buckets is None:
            raise ValueError("an image artifact has no length buckets")
        for s in self.seq_buckets:
            if length <= s:
                return s
        raise ValueError(f"sequence of length {length} exceeds the model "
                         f"max_len {self.seq_buckets[-1]}")

    def _bucket_shapes(self):
        if self.kind == "tokens":
            return [(b, s) for b in self.batch_buckets
                    for s in self.seq_buckets]
        return [(b, *self.input_spec) for b in self.batch_buckets]

    def check_input(self, x) -> np.ndarray:
        """One request row as the engine's input array, or ValueError.

        A token row is 1-D, 1 to ``max_len`` integer ids in [0,
        ``vocab_size``); an image row has exactly the input spec's shape.
        The server checks every row of a body at admission (400), so one
        bad row fails neither its neighbours in a batch nor the card."""
        if self.kind == "tokens":
            a = np.asarray(x)
            max_len = self.input_spec[0]
            if a.ndim != 1 or not 1 <= a.shape[0] <= max_len:
                raise ValueError(f"a token row is 1-D, 1 to {max_len} ids "
                                 f"long; got shape {a.shape}")
            if a.dtype.kind not in "iu":
                raise ValueError(f"token ids are integers; got {a.dtype}")
            lo, hi = int(a.min()), int(a.max())
            if lo < 0 or hi >= self.vocab_size:
                raise ValueError(f"token ids lie in [0, {self.vocab_size}); "
                                 f"got ids from {lo} to {hi}")
            return a.astype(self.input_dtype)
        a = np.asarray(x, self.input_dtype)
        if a.shape != self.input_spec:
            raise ValueError(f"an image row has shape {self.input_spec}; "
                             f"got {a.shape}")
        return a

    # -- warmup --------------------------------------------------------------

    def _run(self, x: torch.Tensor, n: int):
        """The device half of a batch: the model (TF32 off on the card),
        the finiteness of each of the first ``n`` rows, and the copy of
        those rows to the host. Warmup, the thread warm pass and
        :meth:`infer` all run it, so a request launches no kernel they
        did not."""
        precision = (_no_tf32() if self.device.type == "cuda"
                     else contextlib.nullcontext())
        with torch.inference_mode(), precision:
            y = self.model(x.to(self.device))[:n].float()
            # per-row output quality on the device, not as a second
            # host pass over up to 500 MB of copied logits (BertBase)
            finite = torch.isfinite(y.reshape(n, -1)).all(dim=1).cpu()
            return y.cpu().numpy(), finite.numpy()

    def warmup(self) -> float:
        """Run every bucket shape once, counting its FLOPs: on the card
        this builds and loads every kernel the model launches, so request
        #1 of any shape builds nothing. Returns warmup wall seconds."""
        from torch.utils.flop_counter import FlopCounterMode

        from pytorch_distributed_nn_tpu_torch.utils.native_build import (
            build_events,
        )

        t0 = time.perf_counter()
        for shape in self._bucket_shapes():
            x = torch.from_numpy(np.zeros(shape, self.input_dtype))
            counter = FlopCounterMode(display=False)
            with counter:
                self._run(x, shape[0])
            self._bucket_flops[tuple(shape)] = \
                float(counter.get_total_flops()) or None
            self._warm_shapes.add(tuple(shape))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm_events = build_events()
        dt = time.perf_counter() - t0
        logger.info("engine warmup: %d bucket(s) run in %.2fs on %s",
                    len(self._warm_shapes), dt, self.device)
        return dt

    def warm_thread(self) -> None:
        """Every bucket shape once more, on the calling thread. PyTorch
        keeps cuBLAS and cuDNN handles, and cuDNN's cache of convolution
        plans, per thread; the :class:`~.batcher.Batcher` calls this on
        its scheduler thread before it takes a batch, so that thread
        builds them here and not in its first batch of each bucket."""
        for shape in self._bucket_shapes():
            self._run(torch.from_numpy(np.zeros(shape, self.input_dtype)),
                      shape[0])

    def retraces(self) -> Optional[int]:
        """Kernel builds and library loads since :meth:`warmup`, plus
        batches of a shape warmup did not run (None before warmup). The
        no-retrace invariant: 0 after any mix of request shapes."""
        from pytorch_distributed_nn_tpu_torch.utils.native_build import (
            build_events,
        )

        if self._warm_events is None:
            return None
        return build_events() - self._warm_events + self._cold_shapes

    # -- inference -----------------------------------------------------------

    def infer(self, xs: List[np.ndarray]):
        """``(outputs, stats)`` for one coalesced batch of requests.

        Pads up to the bucket, runs the model, strips the padding rows.
        ``stats``: ``bucket``, ``batch``, ``pad_ms`` (padding and the
        host-to-device copy), ``infer_ms`` (forward and the copy back),
        ``flops`` (the padded bucket's; None when uncounted), ``version``
        (the weights this batch used), ``finite_rows`` and ``nonfinite``.
        """
        n = len(xs)
        if n == 0:
            return [], {"bucket": 0, "batch": 0, "pad_ms": 0.0,
                        "infer_ms": 0.0}
        t0 = time.perf_counter()
        bucket = self.select_bucket(n)
        xs = [self.check_input(x) for x in xs]
        if self.kind == "tokens":
            seq = self.select_seq_bucket(max(len(x) for x in xs))
            batch = np.zeros((bucket, seq), self.input_dtype)
            for i, x in enumerate(xs):
                batch[i, :len(x)] = x
        else:
            batch = np.zeros((bucket, *self.input_spec), self.input_dtype)
            for i, x in enumerate(xs):
                batch[i] = x
        shape = tuple(batch.shape)
        if shape not in self._warm_shapes:
            self._cold_shapes += 1
        x = torch.from_numpy(batch).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        out, finite = self._run(x, n)
        t2 = time.perf_counter()
        self.infer_batches += 1
        flops = self._bucket_flops.get(shape)
        if flops:
            self.flops_total += flops
        stats = {
            "bucket": bucket,
            "batch": n,
            "pad_ms": round((t1 - t0) * 1000, 3),
            "infer_ms": round((t2 - t1) * 1000, 3),
            "flops": flops,
            "version": self.version,
            "finite_rows": finite,
            "nonfinite": int(n - int(finite.sum())),
        }
        return [out[i] for i in range(n)], stats
