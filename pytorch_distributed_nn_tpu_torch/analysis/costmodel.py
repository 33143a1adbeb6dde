"""Static FLOPs/bytes accounting of one training step by a walk of its
dispatched operations: the port of ``pytorch_distributed_nn_tpu/
analysis/costmodel.py``.

The JAX package walks XLA's HLO text; the port has no HLO. It runs one
step of the real step function under a ``TorchDispatchMode`` on the
``meta`` device (:func:`step_cost_from_walk`): every tensor has its
shape and dtype and no data, nothing runs on a card, and the run's own
state and random streams are untouched (the walk's model, optimizer and
batch are meta copies: ``training.train_step.dp_audit_bundle``,
``training.spmd.spmd_audit_bundle``). Each dispatched operation is
counted by the JAX accounting rules:

- a GEMM or a convolution (the ``aten`` ops ``torch.utils.flop_counter``
  knows: ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``convolution``,
  ``convolution_backward``...): 2 FLOPs per multiply-accumulate;
- an elementwise op (``pointwise`` tag, random draws, ``_foreach_*``):
  1 FLOP per output element; a reduction (``reduction`` tag, softmax,
  sorts, scatters into a gradient): 1 FLOP per input element; pooling:
  1 per output element per window tap (XLA's ``reduce-window``); the
  library LayerNorm and BatchNorm: :data:`NORM_FLOPS` per element;
- copies, casts, fills, gathers and factories move bytes and do no
  FLOPs (``convert`` and ``copy`` are not FLOP ops in the JAX rules);
- view, metadata and plumbing ops (``t``, ``view``, ``expand``,
  ``detach``, ``as_strided``, ``empty``...: every op whose result is a
  view, and :data:`_FREE`) are free.

HBM bytes are each launching op's input plus output bytes. Eager PyTorch
fuses nothing, so every op counts, where the JAX rule counts only the
top-level instructions of its fused program: ``StepCost.source`` is
``"walk"`` (JAX: ``"optimized"`` or ``"lowered"``), ``hlo_flops`` holds
the walk's total and ``xla_flops`` is null.

Families: one rule with the trace summaries, :func:`..utils.profiling.
family`. A GEMM or convolution is ``multiply_add_fusion`` when the walk
is inside autograd's backward, else ``convert_reduce_fusion``;
collectives are ``other``; the port's kernels take their family from the
prefix of their CUDA kernels' names (:data:`KERNEL_CHARGES`); the rest is
``elementwise``.

The port's kernels are bound with ctypes, so the dispatch mode never sees
them: on meta tensors each wrapper reports its call instead
(:func:`..ops.kernels.charging`). A kernel is charged the work of the
FUNCTION it computes (:data:`KERNEL_CHARGES`), not of the kernel's own
algorithm: the flash forward's two products (QKᵀ and PV) and its
backward's four, with no recomputation and no TF32 hi/lo splits; its
softmax work as the plain attention (``models.transformer.
full_attention``) does it, so the flash path and the plain path walk to
the same FLOPs. Its bytes are its inputs read once and its outputs
written once. A step's cost then reads the same whatever implements it:
it is the numerator of MFU, not the bound of PERF.md's kernel table
(which costs each kernel's own products).

Collectives: ``c10d`` ops reach the dispatch mode. Each is a
:class:`WalkCollective` (the JAX kind names, dtype, shape, group size),
and its ICI bytes are the ring estimates of the JAX ``analysis/hlo.py``:
an all-reduce 2P(n-1)/n, a send or a receive P (``collective-permute``),
the others P(n-1)/n, for a payload of P bytes over a group of n. A walk
of a mesh of n > 1 ranks (:func:`walk_step`) runs rank 0's step over a
fake process group of n ranks (:func:`..parallel.mesh.fake_group`, a
``ProcessGroup`` over ``FakeProcessGroup``: no default group, so a
process that has one walks too), with the collectives the port really
posts.

What cannot run on ``meta``, and what the walk does with it:

- a host read of a device value (``.item()``, ``float(t)``,
  ``.tolist()``: ``aten._local_scalar_dense``) raises :class:`WalkError`
  (the training steps read none: the non-finite guard's flag is one, so a
  ``skip_nonfinite`` step is walked without its guard);
- ops on CPU tensors (the optimizer's host-side bias corrections, the PS
  arrival order's ``randperm`` on a CPU generator, the straggler
  simulator's draws) run on the host for real: they are counted in
  ``StepCost.host_ops`` and charged nothing on the device;
- random draws on the device use a CPU ``torch.Generator`` (the meta
  device has none) and are charged as elementwise ops;
- any other op with no rule here raises :class:`WalkError`, naming it:
  the walk never skips an op silently.

``DecodeCost`` and ``decode_phase_cost`` are the JAX package's, copied.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from pytorch_distributed_nn_tpu_torch.utils import profiling
from pytorch_distributed_nn_tpu_torch.utils.profiling import (  # noqa: F401
    FAMILIES,
    op_family,
)

__all__ = [
    "FAMILIES",
    "op_family",
    "FamilyCost",
    "StepCost",
    "WalkCollective",
    "WalkError",
    "KERNEL_CHARGES",
    "step_cost_from_walk",
    "walk_step",
    "DecodeCost",
    "decode_phase_cost",
]


class WalkError(RuntimeError):
    """An op the cost walk cannot run or has no rule for."""


@dataclasses.dataclass
class FamilyCost:
    """Per-family accumulator of the static step cost."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    count: int = 0

    def to_dict(self) -> dict:
        return {
            "flops": round(self.flops, 1),
            "hbm_bytes": round(self.hbm_bytes, 1),
            "count": self.count,
        }


@dataclasses.dataclass
class StepCost:
    """Static cost of one step of one rank (the JAX ``StepCost``, its
    ``to_dict`` keys; ``host_ops`` is the port's own and not in the
    dict)."""

    families: Dict[str, FamilyCost]
    flops: float
    hlo_flops: float                 # the walk's total
    hbm_bytes: float
    ici_bytes: float
    xla_flops: Optional[float] = None
    xla_bytes: Optional[float] = None
    loop_flops: float = 0.0
    source: str = "walk"
    collectives: List["WalkCollective"] = dataclasses.field(
        default_factory=list)
    host_ops: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "flops": round(self.flops, 1),
            "hlo_flops": round(self.hlo_flops, 1),
            "xla_flops": self.xla_flops,
            "hbm_bytes": round(self.hbm_bytes, 1),
            "xla_bytes": self.xla_bytes,
            "ici_bytes": round(self.ici_bytes, 1),
            "loop_flops": round(self.loop_flops, 1),
            "source": self.source,
            "families": {
                f: fc.to_dict() for f, fc in sorted(self.families.items())
            },
        }

    def to_text(self) -> str:
        lines = [
            "step cost (walk of the dispatched ops):",
            f"  FLOPs: {self.flops / 1e9:.3f} GFLOP",
            f"  HBM bytes: {self.hbm_bytes / 1e6:.2f} MB (operand+result)",
            f"  ICI bytes: {self.ici_bytes / 1e6:.3f} MB (ring estimate)",
            "  per family:",
        ]
        for fam in FAMILIES:
            fc = self.families.get(fam, FamilyCost())
            lines.append(
                f"    {fam:<24} {fc.flops / 1e9:>10.3f} GFLOP  "
                f"{fc.hbm_bytes / 1e6:>9.2f} MB  x{fc.count}"
            )
        if self.host_ops:
            lines.append("  host ops (not charged): " + ", ".join(
                f"{k} x{v}" for k, v in sorted(self.host_ops.items())))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The port's kernels: charged the work of the function each computes
# ---------------------------------------------------------------------------


def _flash_units(inputs, attrs):
    """(B * H, L, D, extra elementwise per score, extra once) of an
    attention call: the pad mask adds one fill per score (and one
    negation per (B, L) element), the causal mask one fill per score (and
    a comparison and a negation per (L, L) element), as the plain
    attention does them."""
    q, mask = inputs[0], (inputs[3] if len(inputs) > 3 else None)
    B, L, H, D = q.shape
    per_score, once = 0, 0
    if mask is not None and mask.dim() == 2:
        per_score += 1
        once += B * L
    if attrs.get("causal"):
        per_score += 1
        once += 2 * L * L
    return B * H, L, D, per_score, once


def _flash_fwd(inputs, outputs, attrs) -> float:
    # QKᵀ and PV; the scale and the softmax on every score
    bh, L, D, per_score, once = _flash_units(inputs, attrs)
    return 4.0 * bh * L * L * D + bh * L * L * (2 + per_score) + once


def _flash_dq(inputs, outputs, attrs) -> float:
    # dP = dO Vᵀ and dQ = dS K; the softmax backward and the scale's
    # (and each mask fill's) backward on every score
    bh, L, D, per_score, _ = _flash_units(inputs, attrs)
    return 4.0 * bh * L * L * D + bh * L * L * (2 + per_score)


def _flash_dkv(inputs, outputs, attrs) -> float:
    # dV = Pᵀ dO and dK = dSᵀ Q
    bh, L, D, _, _ = _flash_units(inputs, attrs)
    return 4.0 * bh * L * L * D


def _ln_fwd(inputs, outputs, attrs) -> float:
    # the mean and the variance (centring, squaring and two sums), the
    # normalisation and the affine: 7 an element; eps and rsqrt a row
    x = inputs[0]
    n = x.numel()
    return 7.0 * n + 2.0 * (n // max(x.shape[-1], 1))


def _ln_bwd(inputs, outputs, attrs) -> float:
    # x̂ (2), dβ (1), dγ (2), g = dy·γ (1), the two row means of g and
    # g·x̂ (3), dx (4): 13 an element
    return 13.0 * inputs[0].numel()


def _quant_scaled(inputs, outputs, attrs) -> float:
    # the draw, x / scale, + u, floor, clip: 5 an element
    return 5.0 * sum(o.numel() for o in outputs)


def _quant_own(inputs, outputs, attrs) -> float:
    # the amax reduction, then the scaled rounding
    return 6.0 * inputs[0].numel()


def _dequant(inputs, outputs, attrs) -> float:
    return float(outputs[0].numel())


def _decode(inputs, outputs, attrs) -> float:
    # one query against its cache: q·Kᵀ and p·V, the scale and softmax
    B, S, H, D = inputs[1].shape
    return 4.0 * B * H * S * D + 2.0 * B * H * S


#: count name (``ops.kernels.LAUNCHES``) -> (the prefix of its CUDA
#: kernels' names, which gives its family; its FLOPs as a function of
#: (inputs, outputs, attrs)). Bytes are the inputs once plus the outputs
#: once, for every kernel.
KERNEL_CHARGES = {
    "flash_attention_fwd": ("flash_fwd_", _flash_fwd),
    "flash_attention_dq": ("flash_dq_", _flash_dq),
    "flash_attention_dkv": ("flash_dkv_", _flash_dkv),
    "layer_norm": ("ln_fwd_", _ln_fwd),
    "layer_norm_bwd": ("ln_bwd_", _ln_bwd),
    "quantize_int8_scaled": ("quant_group_", _quant_scaled),
    "quantize_int8": ("quant_own_", _quant_own),
    "dequantize_int8": ("dequant_", _dequant),
    "decode_attention": ("decode_attn_", _decode),
}

#: FLOPs an element of the library normalisations (the plain LayerNorm
#: of a ``use_kernels=False`` model, BatchNorm): the LayerNorm kernel's
#: charges
NORM_FLOPS = {"forward": 7.0, "backward": 13.0}

# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------

#: c10d op -> the JAX collective kind
_C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "gather_": "all-gather",
    "broadcast_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "scatter_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "barrier": "all-reduce",
}
#: no bytes, no FLOPs: allocation and metadata (every op whose result is
#: a view, ``t``, ``view``, ``expand``, ``detach``, ``as_strided``..., is
#: free as well: :func:`_is_view`)
_FREE = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach_", "_unsafe_view", "set_", "resize_",
    "split", "record_stream", "is_same_size",
))

#: bytes and no FLOPs: copies, casts, fills, gathers and factories
_MOVE = frozenset((
    "_to_copy", "copy_", "clone", "contiguous", "cat", "stack", "fill_",
    "zero_", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "new_zeros", "new_ones", "new_full", "scalar_tensor",
    "arange", "embedding", "index", "index_select", "gather",
    "lift_fresh_copy", "slice_scatter", "select_scatter",
    "as_strided_scatter", "constant_pad_nd", "_copy_from",
    "_copy_from_and_resize", "masked_select", "repeat", "flip", "roll",
    "eye", "tril", "triu", "one_hot", "slice_backward", "select_backward",
    "diagonal_backward", "unfold_backward", "new_empty_strided_copy",
))

#: one FLOP per output element (beyond the ``pointwise`` tag)
_PER_OUTPUT = frozenset((
    "bernoulli", "bernoulli_", "uniform_", "normal_", "rand", "randn",
    "rand_like", "randn_like", "randint", "random_", "native_dropout",
    "native_dropout_backward", "_softmax_backward_data",
    "_log_softmax_backward_data", "nll_loss_backward",
    "max_pool2d_with_indices_backward", "avg_pool2d_backward",
    "_adaptive_avg_pool2d_backward", "adaptive_avg_pool2d_backward",
    "threshold_backward", "masked_fill_", "index_put_", "index_put",
))

#: one FLOP per input element (beyond the ``reduction`` tag)
_PER_INPUT = frozenset((
    "_softmax", "_log_softmax", "nll_loss_forward", "topk", "sort",
    "embedding_dense_backward", "scatter_add", "scatter_add_", "index_add",
    "index_add_", "scatter", "scatter_", "_adaptive_avg_pool2d",
    "adaptive_avg_pool2d", "cumsum", "kthvalue", "median", "mode",
))

#: pooling windows: output elements x window taps
_WINDOW = frozenset(("max_pool2d_with_indices", "avg_pool2d",
                     "max_pool2d"))

#: the library normalisations, forward and backward
_NORM = {
    "native_layer_norm": "forward", "native_batch_norm": "forward",
    "_native_batch_norm_legit": "forward",
    "_native_batch_norm_legit_functional": "forward",
    "_native_batch_norm_legit_no_training": "forward",
    "native_layer_norm_backward": "backward",
    "native_batch_norm_backward": "backward",
}

_HOST_READ = frozenset(("_local_scalar_dense",))


@dataclasses.dataclass
class WalkCollective:
    """One collective the walk saw (the JAX ``hlo.CollectiveOp``'s
    fields that a walk can know)."""

    kind: str
    dtype: str
    shape: Tuple[int, ...]
    group_size: int
    payload_bytes: int
    in_loop: bool = False

    @property
    def est_ici_bytes(self) -> int:
        """The ring estimate of the JAX ``CollectiveOp.est_ici_bytes``."""
        n = max(self.group_size, 1)
        p = self.payload_bytes
        if n == 1:
            return 0
        if self.kind == "all-reduce":
            return int(2 * p * (n - 1) / n)
        if self.kind == "collective-permute":
            return p
        return int(p * (n - 1) / n)


_DTYPE_NAMES = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.bool: "pred",
}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


def _written(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an in-place op writes (its mutated arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            out += _tensors(v)
    return out


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class _Walk(TorchDispatchMode):
    """The dispatch mode of :func:`step_cost_from_walk`."""

    def __init__(self):
        super().__init__()
        self.families = {f: FamilyCost() for f in FAMILIES}
        self.collectives: List[WalkCollective] = []
        self.host_ops: Dict[str, int] = collections.Counter()

    def _add(self, fam: str, flops: float, nbytes: float) -> None:
        fc = self.families[fam]
        fc.flops += flops
        fc.hbm_bytes += nbytes
        fc.count += 1

    def charge_kernel(self, name: str, inputs, outputs, **attrs) -> None:
        """The hook of :func:`..ops.kernels.charging`."""
        try:
            prefix, flops = KERNEL_CHARGES[name]
        except KeyError:
            raise WalkError(f"cost walk: no charge for kernel {name!r}") \
                from None
        self._add(profiling.family(profiling.KERNEL, kernel=prefix),
                  flops(inputs, outputs, attrs),
                  _nbytes(inputs) + _nbytes(outputs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        on_meta = any(t.device.type == "meta" for t in ins)
        if name in _HOST_READ and on_meta:
            raise WalkError(
                f"cost walk: {func} reads a device value on the host "
                "(.item(), float(t), .tolist()): a meta tensor has no "
                "value (module doc)")
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not (on_meta or any(t.device.type == "meta" for t in outs)):
            self.host_ops[name] += 1
            return out
        if func.namespace == "c10d":
            self._collective(func, name, args, kwargs, ins)
            return out
        if name in _FREE or _is_view(func):
            return out
        if not outs:
            outs = _written(func, args, kwargs)
        self._add(*self._rule(func, name, args, kwargs, ins, outs, out),
                  _nbytes(ins) + _nbytes(outs))
        return out

    def _rule(self, func, name, args, kwargs, ins, outs, out):
        """(family, FLOPs) of one launching op."""
        from torch.utils.flop_counter import flop_registry

        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            return (profiling.family(profiling.COMPUTE,
                                     backward=_in_backward()),
                    float(fn(*args, **kwargs, out_val=out)))
        ew = profiling.family(profiling.ELEMENTWISE)
        tags = func.tags
        n_out = float(sum(t.numel() for t in outs))
        n_in = float(ins[0].numel()) if ins else 0.0
        if name.startswith("_foreach_"):
            return ew, float(sum(t.numel() for t in _tensors(args[0])))
        if name in _MOVE:
            return ew, 0.0
        if torch.Tag.pointwise in tags or name in _PER_OUTPUT:
            return ew, n_out
        if torch.Tag.reduction in tags or name in _PER_INPUT:
            return ew, n_in
        if name in _WINDOW:
            taps = math.prod(int(k) for k in args[1]) if len(args) > 1 \
                else 1
            return ew, float(outs[0].numel()) * taps
        if name in _NORM:
            return ew, NORM_FLOPS[_NORM[name]] * n_in
        raise WalkError(f"cost walk: no rule for {func} (module doc)")

    def _collective(self, func, name, args, kwargs, ins) -> None:
        import torch.distributed as dist

        kind = _C10D_KINDS.get(name)
        if kind is None:
            raise WalkError(f"cost walk: no rule for collective {func}")
        group = None
        for i, a in enumerate(func._schema.arguments):
            if "ProcessGroup" in str(a.type) and i < len(args):
                group = dist.ProcessGroup.unbox(args[i])
        # the first argument: the reduced tensors in place, the sent or
        # received ones, or the out-of-place forms' results (a barrier's
        # is a placeholder)
        payload = [] if name == "barrier" else _tensors(args[0])
        first = payload[0] if payload else None
        rec = WalkCollective(
            kind=kind,
            dtype=_DTYPE_NAMES.get(first.dtype, str(first.dtype))
            if first is not None else "?",
            shape=tuple(first.shape) if first is not None else (),
            group_size=group.size() if group is not None else 1,
            payload_bytes=_nbytes(payload))
        self.collectives.append(rec)
        self._add(profiling.family(profiling.OTHER), 0.0, _nbytes(ins))


def step_cost_from_walk(step_fn, args=(), kwargs=None,
                        ici_bytes: Optional[float] = None) -> StepCost:
    """Run ``step_fn(*args, **kwargs)`` once under the walk (its tensors
    on the meta device) and return its :class:`StepCost`: per rank, as
    the walked step is one rank's. ``ici_bytes`` overrides the ring
    estimate over the collectives the walk saw (the trainer passes its
    sync payload's)."""
    from pytorch_distributed_nn_tpu_torch.ops import kernels

    walk = _Walk()
    with walk, kernels.charging(walk.charge_kernel):
        step_fn(*args, **(kwargs or {}))
    fams = walk.families
    total = sum(fc.flops for fc in fams.values())
    if ici_bytes is None:
        ici_bytes = float(sum(c.est_ici_bytes for c in walk.collectives))
    return StepCost(
        families=fams,
        flops=total,
        hlo_flops=total,
        hbm_bytes=sum(fc.hbm_bytes for fc in fams.values()),
        ici_bytes=float(ici_bytes),
        source="walk",
        collectives=walk.collectives,
        host_ops=dict(walk.host_ops),
    )


def _optimizer(name: str):
    """The walk's optimizer factory: ``name`` over a constant schedule."""
    from pytorch_distributed_nn_tpu_torch.optim import (
        build_optimizer,
        make_schedule,
    )

    return lambda params: build_optimizer(name, params, make_schedule(1e-3))


def walk_step(model_name: str, mesh_dims, batch: int,
              optimizer: str = "adam", seq_len: Optional[int] = None,
              model_kw: Optional[dict] = None, seq_attn: str = "ring",
              compression: str = "none",
              grad_accum: int = 1) -> Tuple[StepCost, list]:
    """The walk of rank 0's step of ``model_name`` (the zoo's, with
    ``model_kw``) over a ``(dp, tp, sp)`` mesh at the global ``batch``:
    ``(StepCost, the walked parameters)``. The mesh's ranks are a fake
    group (:func:`..parallel.mesh.fake_group`): its collectives move
    nothing and reach the walk. Text models take the flash kernels (ring
    or Ulysses attention under sp, the tp head shards under tp) and the
    kernel LayerNorm; image models train data parallel only. Raises
    ``ValueError`` for a mesh the model's shapes reject."""
    from pytorch_distributed_nn_tpu_torch.models import (
        build_model,
        input_spec,
        is_text_model,
    )
    from pytorch_distributed_nn_tpu_torch.ops import kernels
    from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
        fake_group,
        make_mesh,
    )

    dp, tp, sp = mesh_dims
    model_kw = dict(model_kw or {})
    if batch % dp:
        raise ValueError(f"global batch {batch} not divisible by dp={dp}")
    world = fake_group(0, dp * tp * sp)
    if is_text_model(model_name):
        from pytorch_distributed_nn_tpu_torch.parallel.ring_attention import (
            make_mesh_attn,
            make_tp_flash_attn,
        )
        from pytorch_distributed_nn_tpu_torch.training.spmd import (
            spmd_audit_bundle,
        )

        mesh = make_mesh(world, dp, tp, sp)
        attn_fn = (make_mesh_attn(mesh, seq_attn) if sp > 1 else
                   make_tp_flash_attn(mesh) if tp > 1 else
                   kernels.flash_attention)
        with torch.device("meta"):
            model = build_model(model_name, mesh=mesh, attn_fn=attn_fn,
                                fused_ln=True, **model_kw)
        L = seq_len or model.config.max_len
        if L % sp:
            raise ValueError(f"seq_len={L} not divisible by sp={sp}")
        bundle = spmd_audit_bundle(
            model, _optimizer(optimizer), mesh, (batch, L),
            compression=compression, grad_accum=grad_accum)
    else:
        from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
            make_grad_sync,
        )
        from pytorch_distributed_nn_tpu_torch.training.train_step import (
            dp_audit_bundle,
        )

        if tp > 1 or sp > 1:
            raise ValueError(f"{model_name} trains data-parallel; use a "
                             f"pure-data mesh (e.g. --mesh {dp * tp * sp})")
        with torch.device("meta"):
            model = build_model(model_name, 10, **model_kw)
        bundle = dp_audit_bundle(
            model, _optimizer(optimizer),
            make_grad_sync(world, "allreduce", compression=compression),
            input_spec(model_name), batch, grad_accum=grad_accum)
    cost = step_cost_from_walk(bundle["step_fn"], bundle["args"])
    return cost, bundle["params"]


# ---------------------------------------------------------------------------
# Decode (copied from the JAX package)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeCost:
    """Static per-token cost of one autoregressive decode step
    (docs/analysis.md "Decode roofline").

    Decode is the serving path where the roofline's BANDWIDTH term
    finally bites: each generated token re-reads every weight byte
    (amortized over the decode batch) plus the sequence's whole KV
    cache, against a few FLOPs per weight — arithmetic intensity of
    O(batch) FLOP/byte, far left of any ridge point. The model here is
    the planning twin of :class:`StepCost`: closed-form from the decoder
    config, checkable against measured tokens/s
    (``bench.py --only decode``, PERF.md round 13).
    """

    flops_per_token: float          # matmul + attention FLOPs, one token
    attn_flops_per_token: float     # the cache-length-dependent share
    weight_bytes: float             # params read per decode STEP (batch)
    kv_read_bytes_per_token: float  # cache panel read, one token
    kv_write_bytes_per_token: float
    batch: int
    cache_len: int

    @property
    def hbm_bytes_per_token(self) -> float:
        """HBM traffic billed to ONE token: its KV traffic plus its
        1/batch share of the weight read."""
        return (
            self.weight_bytes / max(1, self.batch)
            + self.kv_read_bytes_per_token
            + self.kv_write_bytes_per_token
        )

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops_per_token / max(1.0, self.hbm_bytes_per_token)

    def predicted_tokens_per_s(
        self, peak_flops_per_s: float, hbm_peak_bytes_per_s: float
    ) -> float:
        """Roofline-predicted per-sequence rate: each token pays the
        LARGER of its compute time and its HBM time (the classic
        max(flops/peak, bytes/bw) step model)."""
        t_flops = self.flops_per_token / max(1.0, peak_flops_per_s)
        t_hbm = self.hbm_bytes_per_token / max(1.0, hbm_peak_bytes_per_s)
        return 1.0 / max(t_flops, t_hbm, 1e-12)

    def to_dict(self) -> dict:
        return {
            "flops_per_token": round(self.flops_per_token, 1),
            "attn_flops_per_token": round(self.attn_flops_per_token, 1),
            "weight_bytes": round(self.weight_bytes, 1),
            "kv_read_bytes_per_token": round(
                self.kv_read_bytes_per_token, 1
            ),
            "kv_write_bytes_per_token": round(
                self.kv_write_bytes_per_token, 1
            ),
            "hbm_bytes_per_token": round(self.hbm_bytes_per_token, 1),
            "arithmetic_intensity": round(self.arithmetic_intensity, 3),
            "batch": self.batch,
            "cache_len": self.cache_len,
        }

    def to_text(self) -> str:
        return "\n".join([
            f"decode cost (batch {self.batch}, cache length "
            f"{self.cache_len}):",
            f"  FLOPs/token: {self.flops_per_token / 1e6:.3f} MFLOP "
            f"({self.attn_flops_per_token / 1e6:.3f} attention)",
            f"  HBM bytes/token: {self.hbm_bytes_per_token / 1e6:.3f} MB "
            f"(weights {self.weight_bytes / max(1, self.batch) / 1e6:.3f}"
            f" + KV read {self.kv_read_bytes_per_token / 1e6:.3f}"
            f" + KV write {self.kv_write_bytes_per_token / 1e6:.4f})",
            f"  arithmetic intensity: {self.arithmetic_intensity:.2f} "
            "FLOP/byte (decode is HBM-bound left of any ridge point)",
        ])


def decode_phase_cost(
    num_layers: int,
    d_model: int,
    d_ff: int,
    vocab_size: int,
    cache_len: int,
    batch: int = 1,
    weight_bytes_per_param: int = 4,
    kv_bytes_per_elem: int = 4,
) -> DecodeCost:
    """Closed-form per-token decode cost of a standard pre-LN decoder.

    Per layer, one token: QKV + output projections (4·d²) and the two
    MLP matmuls (2·d·d_ff), 2 FLOPs per MAC; attention reads the
    ``cache_len`` K/V panel twice (scores + weighted sum, 4·d·S). The
    tied LM head adds 2·d·vocab. Weight traffic per decode STEP is the
    full matmul parameter set (amortized over ``batch`` sequences); KV
    traffic is per token and does NOT amortize — which is why decode
    throughput scales with batch until the KV term dominates.
    """
    d, L = float(d_model), int(num_layers)
    matmul_params = L * (4 * d * d + 2 * d * d_ff) + d * vocab_size
    mm_flops = 2.0 * matmul_params
    attn_flops = 4.0 * d * float(cache_len) * L
    kv_read = 2.0 * float(cache_len) * d * L * kv_bytes_per_elem
    kv_write = 2.0 * d * L * kv_bytes_per_elem
    return DecodeCost(
        flops_per_token=mm_flops + attn_flops,
        attn_flops_per_token=attn_flops,
        weight_bytes=matmul_params * weight_bytes_per_param,
        kv_read_bytes_per_token=kv_read,
        kv_write_bytes_per_token=kv_write,
        batch=int(batch),
        cache_len=int(cache_len),
    )
