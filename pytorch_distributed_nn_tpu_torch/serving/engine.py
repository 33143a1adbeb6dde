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

Hot swap (:meth:`InferenceEngine.swap`) and shadow engines
(:meth:`InferenceEngine.shadow`, the canary router's second engine)
replace weights, never architectures. A swap builds the new module and
copies it to the card before it takes the weights lock, so the barrier is
one reference install between two batches: each batch runs wholly on the
module it snapshotted under the lock, and its records carry that
module's version. A shadow owns its module and shares the engine's warm
set (the shapes warmup ran, the build watermark, the bucket FLOPs and the
count of cold shapes), so :meth:`InferenceEngine.retraces` on either
engine covers both, as the JAX shadow's shared jit cache does.

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
import threading
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



class _WarmSet:
    """What warmup ran, shared by an engine and its shadows: the bucket
    shapes, the native-build watermark, each shape's forward FLOPs and the
    batches of shapes warmup did not run."""

    def __init__(self):
        self.shapes: set = set()
        self.events: Optional[int] = None
        self.flops: dict = {}
        self.cold = 0


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
        self.device = resolve_device(device)
        if not batch_buckets \
                or list(batch_buckets) != sorted(set(batch_buckets)):
            raise ValueError(f"batch_buckets must be strictly increasing, "
                             f"got {batch_buckets!r}")
        # this engine's own stream on the card (a shadow gets another):
        # a batch then waits for its own work only, not the other side's
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.manifest, model = self._load(artifact_dir)
        self.artifact_dir = artifact_dir
        self.model = model
        # the swap barrier: infer() snapshots (model, version) under it,
        # so a batch completes on the weights it started with
        self._weights_lock = threading.Lock()
        self.swaps = 0
        # the last swap's ms: loading to the device, and the lock held
        self.last_swap_ms: Optional[dict] = None
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
        # forward FLOPs per bucket shape (torch.utils.flop_counter at
        # warmup) are the achieved-FLOP/s numerator of `serve bench` and
        # of the per-request records
        self._warm = _WarmSet()
        self.infer_batches = 0
        self.flops_total = 0.0

    def _load(self, artifact_dir: str):
        """``(manifest, module)``: the artifact's weights in a fresh
        ``eval()`` module on this engine's device."""
        from pytorch_distributed_nn_tpu_torch.models import build_model
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            load_artifact,
        )

        manifest, params, batch_stats = load_artifact(artifact_dir)
        model = build_model(manifest["network"], manifest["num_classes"],
                            **manifest.get("model_kw", {}))
        model.load_state_dict(_state_dict(model, params, batch_stats),
                              strict=True)
        model = model.to(self.device).eval()
        if self.device.type == "cuda":
            # the copies ran on this thread's stream; the engine's own
            # stream reads the weights next
            torch.cuda.current_stream(self.device).synchronize()
        return manifest, model

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

    # -- hot swap --------------------------------------------------------

    def _check_swappable(self, manifest: dict, model) -> None:
        """A swap replaces weights only: the same architecture and input
        contract, and a state_dict of the same names, shapes and dtypes
        as the serving module's; anything else is refused up front."""
        for key in ("network", "num_classes", "model_kw", "input"):
            if manifest.get(key) != self.manifest.get(key):
                raise ValueError(
                    f"refusing swap: artifact {key!r} differs "
                    f"({manifest.get(key)!r} vs serving "
                    f"{self.manifest.get(key)!r}) — hot swap replaces "
                    "WEIGHTS, not architectures; deploy a new engine for "
                    "a different model")
        old, new = self.model.state_dict(), model.state_dict()
        if list(old) != list(new):
            raise ValueError(
                f"refusing swap: state_dict has {len(new)} entries vs the "
                f"serving module's {len(old)}, or other names")
        for name, a in old.items():
            b = new[name]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    f"refusing swap: {name} mismatches "
                    f"({tuple(a.shape)}/{a.dtype} vs "
                    f"{tuple(b.shape)}/{b.dtype})")

    def swap(self, artifact_dir: str) -> str:
        """Install another artifact's weights under live traffic; returns
        the new version. The module is built, checked and copied to the
        device before the lock is taken; in-flight batches complete on
        the old module."""
        from pytorch_distributed_nn_tpu_torch.serving.artifact import (
            artifact_version,
        )

        t0 = time.perf_counter()
        manifest, model = self._load(artifact_dir)
        self._check_swappable(manifest, model)
        old = self.version
        t1 = time.perf_counter()
        with self._weights_lock:
            self.manifest = manifest
            self.model = model
            self.artifact_dir = artifact_dir
            self.swaps += 1
        t2 = time.perf_counter()
        self.last_swap_ms = {"load": round((t1 - t0) * 1e3, 3),
                             "lock": round((t2 - t1) * 1e3, 6)}
        new = artifact_version(manifest)
        logger.info("engine swap #%d: %s -> %s", self.swaps, old, new)
        return new

    def adopt(self, shadow: "InferenceEngine") -> str:
        """Install a shadow's module as this engine's (the canary's
        promote): its weights are on the device already, so the swap is
        the install alone. Returns the new version."""
        if shadow._warm is not self._warm:
            raise ValueError("refusing adopt: not a shadow of this engine")
        with self._weights_lock:
            self.manifest = shadow.manifest
            self.model = shadow.model
            self.artifact_dir = shadow.artifact_dir
            self.swaps += 1
        logger.info("engine swap #%d: adopted %s", self.swaps, self.version)
        return self.version

    def shadow(self, artifact_dir: str) -> "InferenceEngine":
        """A second engine on ``artifact_dir``'s weights for the canary:
        its own module, counters and swap lock; this engine's buckets,
        device, precision and warm set. The artifact must pass the
        :meth:`swap` contract."""
        manifest, model = self._load(artifact_dir)
        self._check_swappable(manifest, model)
        other = object.__new__(InferenceEngine)
        other.__dict__.update(self.__dict__)
        other.manifest = manifest
        other.artifact_dir = artifact_dir
        other.model = model
        other._stream = (torch.cuda.Stream(self.device)
                         if self.device.type == "cuda" else None)
        other._weights_lock = threading.Lock()
        other.swaps = 0
        other.last_swap_ms = None
        other.infer_batches = 0
        other.flops_total = 0.0
        return other

    def _on_stream(self):
        """Work issued inside runs on this engine's stream (nothing on
        the CPU)."""
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

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

    def _run(self, x: torch.Tensor, n: int, model=None):
        """The device half of a batch: ``model`` (the serving module by
        default; TF32 off on the card), the finiteness of each of the
        first ``n`` rows, and the copy of those rows to the host. Warmup,
        the thread warm pass and :meth:`infer` all run it, so a request
        launches no kernel they did not."""
        model = self.model if model is None else model
        precision = (_no_tf32() if self.device.type == "cuda"
                     else contextlib.nullcontext())
        with torch.inference_mode(), precision, self._on_stream():
            y = model(x.to(self.device))[:n].float()
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
            self._warm.flops[tuple(shape)] = \
                float(counter.get_total_flops()) or None
            self._warm.shapes.add(tuple(shape))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm.events = build_events()
        dt = time.perf_counter() - t0
        logger.info("engine warmup: %d bucket(s) run in %.2fs on %s",
                    len(self._warm.shapes), dt, self.device)
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

        if self._warm.events is None:
            return None
        return build_events() - self._warm.events + self._warm.cold

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
        # the swap barrier: this batch runs on one (module, version)
        # pair, whatever swap() installs meanwhile
        with self._weights_lock:
            model, version = self.model, self.version
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
        if shape not in self._warm.shapes:
            self._warm.cold += 1
        with self._on_stream():
            x = torch.from_numpy(batch).to(self.device)
        if self._stream is not None:
            self._stream.synchronize()
        t1 = time.perf_counter()
        out, finite = self._run(x, n, model)
        t2 = time.perf_counter()
        self.infer_batches += 1
        flops = self._warm.flops.get(shape)
        if flops:
            self.flops_total += flops
        stats = {
            "bucket": bucket,
            "batch": n,
            "pad_ms": round((t1 - t0) * 1000, 3),
            "infer_ms": round((t2 - t1) * 1000, 3),
            "flops": flops,
            "version": version,  # the weights this batch used
            "finite_rows": finite,
            "nonfinite": int(n - int(finite.sum())),
        }
        return [out[i] for i in range(n)], stats
