"""The dp x tp x sp training step of the transformer family: the port of
``pytorch_distributed_nn_tpu/training/spmd.py``.

The JAX package compiles this step with ``jax.jit`` over a (data, seq,
model) mesh and lets GSPMD insert the collectives; here every rank runs
its part by hand over the mesh's process groups
(:class:`..parallel.mesh.Mesh`):

- the model holds the rank's regions of the split leaves and runs the
  tp sums itself (:mod:`..models.transformer`); attention under sp is
  ring or Ulysses attention over the seq group;
- the batch: ranks that share ``d`` read the same rows (the data
  loader's rank ``d`` of ``dp``), and seq rank ``s`` keeps chunk ``s`` of
  the sequence (:func:`seq_chunk`: the JAX ``text_batch_sharding``);
- the objective is the global masked mean, the sum of the masked
  cross-entropy over the masked count over data x seq, with the
  vocab-parallel loss (:func:`..ops.metrics.vocab_parallel_sums`, no
  gathered logits);
- gradients are summed over the seq group and then the data group; each
  rank's split leaves are its own (the tp sums in the model's backward
  already made the replicated leaves whole on every model rank).

Three bodies, as in the JAX ``build_spmd_train_step``:

- dense (``compression="none"``, ``grad_accum=1``): the gradient of
  ``sum / global count``, summed;
- ``accum_step`` (``grad_accum > 1``): each microbatch of the rank's rows
  differentiates the unnormalised sum; one division by the global count
  at the end;
- int8 (``compression="int8"``): the gradient of the unnormalised sum,
  summed densely over seq, then through the int8 codec over data
  (:func:`..ops.compression.int8_psum_mean` with each leaf's
  :class:`..ops.compression.LeafRegion`: the scale is the whole leaf's
  amax, a MAX over the model and data groups, and each region's noise the
  whole leaf's draw at its elements, so a leaf's result does not depend
  on tp; the quantize is ``quant_group_kernel`` on the card), divided by
  the global count. At dp = 1 it is the codec's single-contributor mode.

The JAX step's refusals stand: compression other than none or int8, and
int8 with ``grad_accum > 1``.

:func:`spmd_audit_bundle` builds the step of the cost walk
(:mod:`..analysis.costmodel`) on the meta device, over a mesh of fake
groups; ``abstract_spmd_state`` feeds only the JAX package's HLO auditor
(the shardings it lints) and has no counterpart.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from pytorch_distributed_nn_tpu_torch.models.convert import (
    local_heads,
    local_state_dict,
    state_dict_to_flax,
)
from pytorch_distributed_nn_tpu_torch.ops.compression import (
    LeafRegion,
    int8_psum_mean,
    psum,
)
from pytorch_distributed_nn_tpu_torch.ops.metrics import vocab_parallel_sums
from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    all_reduce,
)
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    TrainState,
    _seed_dropout,
    create_train_state,
)

_SUMS = ("loss_sum", "count", "acc1", "acc5")


def seq_chunk(x: torch.Tensor, mesh) -> torch.Tensor:
    """Seq rank ``s``'s chunk of a (B, L) batch: columns
    ``[s * L / sp, (s + 1) * L / sp)``."""
    sp, s = mesh.shape[SEQ_AXIS], mesh.coords[SEQ_AXIS]
    L = x.shape[1]
    if L % sp:
        raise ValueError(f"seq_len {L} not divisible by seq_parallel={sp}")
    c = L // sp
    return x[:, s * c:(s + 1) * c]


def shard_model(full_model: torch.nn.Module,
                local_model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Load into ``local_model`` (built with ``mesh``) this rank's regions
    of ``full_model``'s weights: every rank holds its part of the same
    logical model."""
    tree = state_dict_to_flax(full_model.state_dict(),
                              full_model.config.num_heads)
    local_model.load_state_dict(
        local_state_dict(tree, mesh.shape, mesh.coords), strict=True)
    return local_model


def data_seq_rank(mesh) -> int:
    """The rank's index over data x seq (``d * sp + s``): its dropout
    stream. The ranks of one model group share it, so their replicated
    residual streams draw the same masks."""
    return mesh.coords[DATA_AXIS] * mesh.shape[SEQ_AXIS] \
        + mesh.coords[SEQ_AXIS]


def create_spmd_state(model: torch.nn.Module, build_opt: Callable, mesh,
                      device, seed: int = 0) -> TrainState:
    """The rank's ``TrainState``: ``model`` (its regions, built with
    ``mesh``) on ``device``, its optimizer over the local parameters (Adam
    and SGD are elementwise: a split optimizer is the local one), and the
    dropout generator re-seeded each step from (seed, d * sp + s, step)."""
    state = create_train_state(model, build_opt, device, seed=seed,
                               rank=data_seq_rank(mesh))
    state.mesh = mesh
    state.replicas = mesh.shape[DATA_AXIS]
    return state


def param_regions(model) -> List[LeafRegion]:
    """Each parameter's :class:`LeafRegion` in ``model.parameters()``
    order: the heads, mlp and vocab splits (a weight split on its input
    dimension, ``attn.out`` and ``mlp_out``, transposed), everything
    else one region of all its rows."""
    cfg, par = model.config, model.par
    Dh = cfg.d_model // cfg.num_heads
    head_rows = local_heads(model) * Dh
    mlp0, _ = par.split(cfg.d_ff)
    out = []
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 2)
        mod, kind = (leaf[-2] if len(leaf) > 1 else ""), leaf[-1]
        if mod in ("query", "key", "value"):
            out.append(LeafRegion(cfg.num_heads * Dh, par.m * head_rows))
        elif mod == "out" and kind == "weight":
            out.append(LeafRegion(cfg.num_heads * Dh, par.m * head_rows,
                                  transpose=True))
        elif mod == "mlp_in":
            out.append(LeafRegion(cfg.d_ff, mlp0))
        elif mod == "mlp_out" and kind == "weight":
            out.append(LeafRegion(cfg.d_ff, mlp0, transpose=True))
        elif name.endswith("token_embed.weight") or kind in ("mlm_bias",
                                                             "lm_bias"):
            out.append(LeafRegion(cfg.vocab_size, model.vocab_start))
        else:
            out.append(LeafRegion(p.shape[0]))
    return out


def _reduce_over(t: torch.Tensor, mesh, axes=(SEQ_AXIS, DATA_AXIS)):
    for axis in axes:
        g = mesh.group(axis)
        if g is not None:
            all_reduce(t, "sum", g)
    return t


def _sums(model, tokens, labels) -> Dict[str, torch.Tensor]:
    return vocab_parallel_sums(model(tokens), labels, model.vocab_start,
                               model.par.model_group)


def _metrics(totals: torch.Tensor) -> Dict[str, torch.Tensor]:
    """loss/acc1/acc5 from the summed (loss_sum, count, acc1, acc5)."""
    loss_sum, count, acc1, acc5 = totals.unbind()
    denom = count.clamp_min(1.0)
    return {"loss": loss_sum / denom, "acc1": acc1 / denom,
            "acc5": acc5 / denom}


def _pack(sums) -> torch.Tensor:
    return torch.stack([sums[k].detach().float() for k in _SUMS])


def build_spmd_train_step(mesh, compression: str = "none",
                          grad_accum: int = 1):
    """``step(state, batch, seed) -> metrics``: one update of the rank's
    ``state`` in place from its data rank's rows ``batch = (tokens,
    labels)`` (full length; the step keeps its seq chunk), with the step's
    sync ``seed`` (the int8 noise; the same on every rank)."""
    if compression not in ("none", "int8"):
        raise ValueError(
            f"GSPMD path supports compression 'none'|'int8', got "
            f"{compression!r} (topk needs per-replica EF state — a "
            "shard_map-DP feature)")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if compression == "int8" and grad_accum > 1:
        raise ValueError(
            "grad_accum>1 with compression='int8' on the GSPMD path is not "
            "implemented (the quantized dp sync would need the microbatch "
            "scan inside its manual region); use one or the other")
    seq_g, data_g = mesh.group(SEQ_AXIS), mesh.group(DATA_AXIS)
    model_g = mesh.group(MODEL_AXIS)

    def sum_grads(params, groups) -> None:
        live = [p for p in params if p.grad is not None]
        for g in groups:
            if g is not None and live:
                for p, t in zip(live, psum([p.grad for p in live], g)):
                    p.grad = t

    def step(state: TrainState, batch, seed: int = 0
             ) -> Dict[str, torch.Tensor]:
        tokens, labels = (seq_chunk(t, mesh) for t in batch)
        model, opt = state.model, state.optimizer
        params = list(model.parameters())
        model.train()
        _seed_dropout(state)
        opt.zero_grad()
        if compression == "int8":
            sums = _sums(model, tokens, labels)
            totals = _reduce_over(_pack(sums), mesh)
            sums["loss_sum"].backward()
            sum_grads(params, (seq_g,))
            synced = int8_psum_mean(
                [p.grad for p in params], seed, data_g,
                denom=totals[1].clamp_min(1.0),
                regions=param_regions(model), amax_groups=(model_g,))
            for p, g in zip(params, synced):
                p.grad = g
        elif grad_accum == 1:
            sums = _sums(model, tokens, labels)
            totals = _reduce_over(_pack(sums), mesh)
            (sums["loss_sum"] / totals[1].clamp_min(1.0)).backward()
            sum_grads(params, (seq_g, data_g))
        else:
            n = tokens.shape[0]
            if n % grad_accum:
                raise ValueError(f"per-replica batch {n} not divisible by "
                                 f"grad_accum={grad_accum}")
            local = None
            for tok, lab in zip(tokens.chunk(grad_accum),
                                labels.chunk(grad_accum)):
                sums = _sums(model, tok, lab)
                sums["loss_sum"].backward()
                local = _pack(sums) if local is None else local + _pack(sums)
            totals = _reduce_over(local, mesh)
            sum_grads(params, (seq_g, data_g))
            denom = totals[1].clamp_min(1.0)
            for p in params:
                if p.grad is not None:
                    p.grad.div_(denom)
        opt.step()
        state.step += 1
        return _metrics(totals)

    return step


def build_spmd_eval_step(mesh):
    """``eval_step(state, batch) -> metrics`` without gradients: the
    global masked mean over the data rank's rows, the seq chunk kept as in
    training."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        tokens, labels = (seq_chunk(t, mesh) for t in batch)
        state.model.eval()
        return _metrics(_reduce_over(
            _pack(_sums(state.model, tokens, labels)), mesh))

    return eval_step


def spmd_audit_bundle(model: torch.nn.Module, build_opt: Callable, mesh,
                      tokens_shape, compression: str = "none",
                      grad_accum: int = 1, seed: int = 0) -> dict:
    """The dp x tp x sp step of the cost walk (the JAX
    ``spmd_audit_bundle``): ``model`` built with ``mesh`` (a mesh of fake
    groups, :func:`..parallel.mesh.fake_group`) on the meta device,
    its optimizer from ``build_opt`` and :func:`build_spmd_train_step`,
    on this rank's data rows of a global ``tokens_shape`` = (B, L) batch.
    Returns ``{"step_fn", "args", "mesh", "params"}``."""
    B, L = tokens_shape
    dp = mesh.shape[DATA_AXIS]
    if B % dp:
        raise ValueError(f"global batch {B} not divisible by dp={dp}")
    state = create_spmd_state(model, build_opt, mesh, "meta", seed=seed)
    step = build_spmd_train_step(mesh, compression=compression,
                                 grad_accum=grad_accum)
    tok = torch.zeros((B // dp, L), dtype=torch.int64, device="meta")
    return {"step_fn": step, "args": (state, (tok, tok), seed + 1),
            "mesh": mesh, "params": list(state.model.parameters())}
