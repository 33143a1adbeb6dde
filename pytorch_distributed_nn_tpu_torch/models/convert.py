"""Weight converter between the JAX package's flax params trees and the
port's state_dicts, for ``CausalLM`` and ``BertMLM``
(:func:`flax_to_state_dict`) and for the CNN zoo (:func:`cnn_to_state_dict`,
at the end of the module).

The flax trees (nested dicts of numpy arrays, as an artifact's or a
checkpoint's params load) and the port's layouts:

===============================  ======================  ==========================
flax leaf                        flax shape              port parameter
===============================  ======================  ==========================
token_embed/embedding            (vocab, d)              token_embed.weight (same)
pos_embed, lm_bias               (max_len, d), (vocab,)  same name, same shape
block_i/ln_*/scale, bias         (d,)                    blocks.i.ln_*.scale, bias
block_i/attn/{query,key,value}   kernel (d, H, Dh),      weight (H*Dh, d),
                                 bias (H, Dh)            bias (H*Dh,)
block_i/attn/out                 kernel (H, Dh, d)       weight (d, H*Dh)
block_i/{mlp_in,mlp_out}         kernel (in, out)        weight (out, in)
ln_final/scale, bias             (d,)                    ln_final.scale, bias
===============================  ======================  ==========================

``BertMLM``: the decoder's trunk sits under ``encoder/`` (port prefix
``encoder.``, without ``lm_bias``), and the head adds ``mlm_transform``
(kernel (d, d) -> weight transposed, bias), ``mlm_ln`` (scale, bias),
``mlm_bias`` (vocab,) and, untied, ``mlm_out`` (kernel (d, vocab), bias).
Both directions copy values exactly (transposes and reshapes only).
"""

from __future__ import annotations

import logging
import re
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)

_QKV = ("query", "key", "value")
_LNS = ("ln_attn", "ln_mlp")


def _blocks_to_sd(tree: dict, sd: dict, pre: str) -> None:
    """The trunk (embeddings, blocks, ln_final) of a flax tree into ``sd``
    under the port prefix ``pre``."""
    sd[pre + "token_embed.weight"] = tree["token_embed"]["embedding"]
    sd[pre + "pos_embed"] = tree["pos_embed"]
    sd[pre + "ln_final.scale"] = tree["ln_final"]["scale"]
    sd[pre + "ln_final.bias"] = tree["ln_final"]["bias"]
    blocks = sorted(
        (int(m.group(1)), k) for k in tree
        if (m := re.fullmatch(r"block_(\d+)", k))
    )
    for i, key in blocks:
        blk, bp = tree[key], f"{pre}blocks.{i}."
        for ln in _LNS:
            sd[bp + ln + ".scale"] = blk[ln]["scale"]
            sd[bp + ln + ".bias"] = blk[ln]["bias"]
        attn = blk["attn"]
        for name in _QKV:
            kern = np.asarray(attn[name]["kernel"])  # (d, H, Dh)
            sd[f"{bp}attn.{name}.weight"] = kern.reshape(kern.shape[0], -1).T
            sd[f"{bp}attn.{name}.bias"] = np.asarray(
                attn[name]["bias"]).reshape(-1)
        kern = np.asarray(attn["out"]["kernel"])  # (H, Dh, d)
        sd[bp + "attn.out.weight"] = kern.reshape(-1, kern.shape[-1]).T
        sd[bp + "attn.out.bias"] = attn["out"]["bias"]
        for name in ("mlp_in", "mlp_out"):
            sd[f"{bp}{name}.weight"] = np.asarray(blk[name]["kernel"]).T
            sd[f"{bp}{name}.bias"] = blk[name]["bias"]


def _blocks_to_flax(sd: dict, pre: str, num_heads: int) -> dict:
    """The inverse of :func:`_blocks_to_sd`: a flax trunk tree."""
    tree = {
        "token_embed": {"embedding": sd[pre + "token_embed.weight"]},
        "pos_embed": sd[pre + "pos_embed"],
        "ln_final": {"scale": sd[pre + "ln_final.scale"],
                     "bias": sd[pre + "ln_final.bias"]},
    }
    layers = sorted({int(m.group(1)) for k in sd
                     if (m := re.match(re.escape(pre) + r"blocks\.(\d+)\.",
                                       k))})
    for i in layers:
        bp = f"{pre}blocks.{i}."
        blk = {ln: {"scale": sd[bp + ln + ".scale"],
                    "bias": sd[bp + ln + ".bias"]} for ln in _LNS}
        attn = {}
        for name in _QKV:
            w = sd[f"{bp}attn.{name}.weight"]  # (H*Dh, d)
            attn[name] = {
                "kernel": w.T.reshape(w.shape[1], num_heads, -1),
                "bias": sd[f"{bp}attn.{name}.bias"].reshape(num_heads, -1),
            }
        w = sd[bp + "attn.out.weight"]  # (d, H*Dh)
        attn["out"] = {"kernel": w.T.reshape(num_heads, -1, w.shape[0]),
                       "bias": sd[bp + "attn.out.bias"]}
        blk["attn"] = attn
        for name in ("mlp_in", "mlp_out"):
            blk[name] = {"kernel": sd[f"{bp}{name}.weight"].T,
                         "bias": sd[f"{bp}{name}.bias"]}
        tree[f"block_{i}"] = blk
    return tree


def flax_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """Flax params tree (decoder or BertMLM) -> the port's state_dict."""
    sd: dict = {}
    if "encoder" in params:
        _blocks_to_sd(params["encoder"], sd, "encoder.")
        for name in ("mlm_transform", "mlm_out"):
            if name in params:
                sd[name + ".weight"] = np.asarray(params[name]["kernel"]).T
                sd[name + ".bias"] = params[name]["bias"]
        sd["mlm_ln.scale"] = params["mlm_ln"]["scale"]
        sd["mlm_ln.bias"] = params["mlm_ln"]["bias"]
        sd["mlm_bias"] = params["mlm_bias"]
    else:
        _blocks_to_sd(params, sd, "")
        sd["lm_bias"] = params["lm_bias"]
    # np.array copies: artifact leaves are read-only views of the blob
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor],
                       num_heads: int) -> dict:
    """The port's state_dict -> a flax params tree of numpy arrays (the
    inverse of :func:`flax_to_state_dict`)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    if "mlm_bias" not in sd:
        params = _blocks_to_flax(sd, "", num_heads)
        params["lm_bias"] = sd["lm_bias"]
        return params
    params = {"encoder": _blocks_to_flax(sd, "encoder.", num_heads)}
    for name in ("mlm_transform", "mlm_out"):
        if name + ".weight" in sd:
            params[name] = {"kernel": sd[name + ".weight"].T,
                            "bias": sd[name + ".bias"]}
    params["mlm_ln"] = {"scale": sd["mlm_ln.scale"],
                        "bias": sd["mlm_ln.bias"]}
    params["mlm_bias"] = sd["mlm_bias"]
    return params


# -- the CNN zoo -----------------------------------------------------------
#
# flax ``params`` and ``batch_stats`` trees <-> the port's state_dict. Module
# names are the flax tree's, except the auto-named ``Conv_j``/``BatchNorm_j``
# inside a block, which are ``conv_j``/``bn_j`` in the port:
#
#   Conv kernel (kh, kw, in, out) HWIO    -> <conv>.weight (out, in, kh, kw)
#   Dense kernel (in, out)                -> <dense>.weight (out, in)
#   BatchNorm scale, bias                 -> <bn>.weight, <bn>.bias
#   batch_stats mean, var                 -> <bn>.running_mean, running_var
#   every bias                            -> <module>.bias
#
# BatchNorm modules are those whose port name starts with "bn".

_AUTO = (("Conv_", "conv_"), ("BatchNorm_", "bn_"))


def _rename(name: str, to_port: bool) -> str:
    for flax_pre, port_pre in _AUTO:
        src, dst = (flax_pre, port_pre) if to_port else (port_pre, flax_pre)
        if name.startswith(src) and name[len(src):].isdigit():
            return dst + name[len(src):]
    return name


def _leaves(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def cnn_to_state_dict(params: dict, batch_stats: dict = None
                      ) -> Dict[str, torch.Tensor]:
    """Flax CNN ``params`` (and ``batch_stats``) -> the port's state_dict."""
    sd = {}
    for path, a in _leaves(params):
        mod = ".".join(_rename(m, True) for m in path[:-1])
        leaf = path[-1]
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            sd[mod + ".weight"] = a
        elif leaf == "scale":
            sd[mod + ".weight"] = a
        else:
            sd[mod + "." + leaf] = a
    names = {"mean": "running_mean", "var": "running_var"}
    for path, a in _leaves(batch_stats or {}):
        mod = ".".join(_rename(m, True) for m in path[:-1])
        sd[mod + "." + names[path[-1]]] = a
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def state_dict_to_cnn(state_dict: Dict[str, torch.Tensor]):
    """The port's CNN state_dict -> (flax params, flax batch_stats), numpy
    leaves (the inverse of :func:`cnn_to_state_dict`)."""
    params: dict = {}
    stats: dict = {}
    names = {"running_mean": "mean", "running_var": "var"}
    for key, t in state_dict.items():
        mod, leaf = key.rsplit(".", 1)
        parts = mod.split(".")
        a = t.detach().cpu().numpy()
        tree = stats if leaf in names else params
        for p in parts:
            tree = tree.setdefault(_rename(p, False), {})
        if leaf in names:
            tree[names[leaf]] = a
        elif leaf == "weight" and parts[-1].startswith("bn"):
            tree["scale"] = a
        elif leaf == "weight":
            tree["kernel"] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        else:
            tree[leaf] = a
    return params, stats


# -- the training state ----------------------------------------------------
#
# The JAX ``TrainState`` as ``flax.serialization.to_state_dict`` lays it out
# (fields in declaration order, the model trees' keys sorted) against the
# port's ``TrainState`` (``training/train_step.py``):
#
#   step        int32 ()                    TrainState.step
#   params      the model's flax tree       model parameters (above)
#   opt_state   SGDState: count int32 (),   ScheduledOptimizer.count;
#                 momentum_buf tree | None  torch.optim.SGD momentum_buffer
#               AdamState: count, mu, nu,   optim.Adam's m, v, v_max
#                 nu_max tree | None          (amsgrad)
#   batch_stats {<bn>: {mean, var}} | {}    BatchNorm running_mean/var
#   ef_state    params tree, each leaf      TrainState.ef_state: this rank's
#               (n, *shape): every          row (topk error feedback), or
#               replica's residual | None   None without topk
#
# The optimizer's trees and each ef_state row have the params tree's
# structure. Before an optimizer's first update the JAX state holds zeros
# and the torch one nothing; both start the same way from either. A save
# over several ranks stacks every rank's residuals (``ef_rows``, gathered
# by the trainer); a restore takes this rank's row, resets the residuals
# to zero (with a warning) for a file of another replica count when asked
# to, and otherwise raises naming both geometries, as the JAX
# ``restore_resharded`` and ``_check_ef_geometry`` do. A file without
# residuals restores zero ones.


def _sorted(tree):
    """``tree`` with every dict's keys in order, as flax's trees are."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def is_cnn(model) -> bool:
    """Whether ``model`` is of the CNN zoo (else a transformer)."""
    from pytorch_distributed_nn_tpu_torch.models.layers import CNN

    return isinstance(model, CNN)


def _named_to_tree(layout: dict, named: dict) -> dict:
    """Parameter-named tensors -> a flax params-shaped tree."""
    if layout["cnn"]:
        return _sorted(state_dict_to_cnn(named)[0])
    return _sorted(state_dict_to_flax(named, layout["num_heads"]))


def _tree_to_named(model, tree: dict) -> Dict[str, torch.Tensor]:
    if is_cnn(model):
        return cnn_to_state_dict(tree)
    return flax_to_state_dict(tree)


def _opt_kind(optimizer) -> str:
    from pytorch_distributed_nn_tpu_torch.optim.adam import Adam

    if isinstance(optimizer, Adam):
        return "adam"
    if isinstance(optimizer, torch.optim.SGD):
        return "sgd"
    raise TypeError(f"no JAX optimizer state for {type(optimizer).__name__}")


def train_state_tensors(state, ef_rows=None):
    """``(layout, tensors)`` of a port ``TrainState``: its live tensors,
    flat, keyed ``params/<name>``, ``batch_stats/<name>``,
    ``<momentum_buf|mu|nu|nu_max>/<name>`` for the optimizer's state and
    ``ef_state/<name>`` for the residuals, (n, *shape) with every
    replica's row, and the small facts :func:`train_state_to_flax` needs
    besides them. ``ef_rows`` (one (n, *shape) tensor per parameter) is
    the residuals gathered from every rank; without it a state of one
    replica gives its own, and one of several raises; an empty sequence
    leaves them out. The tensors are the
    state's own (a caller that keeps them past the next step clones
    them)."""
    model, sched = state.model, state.optimizer
    opt = sched.optimizer
    kind = _opt_kind(opt)
    group = opt.param_groups[0]
    layout = {"step": int(state.step), "count": int(sched.count),
              "kind": kind}
    tensors: Dict[str, torch.Tensor] = {}
    named = list(model.named_parameters())
    for n, p in named:
        tensors["params/" + n] = p.detach()
    for n, b in model.named_buffers():
        tensors["batch_stats/" + n] = b

    def slot(role, key):
        for n, p in named:
            st = opt.state.get(p, {})
            t = st.get(key) if sched.count else None
            tensors[f"{role}/{n}"] = (t.detach() if t is not None
                                      else torch.zeros_like(p.detach()))

    if kind == "sgd":
        layout["momentum"] = bool(group["momentum"])
        if layout["momentum"]:
            slot("momentum_buf", "momentum_buffer")
    else:
        layout["amsgrad"] = bool(group["amsgrad"])
        slot("mu", "m")
        slot("nu", "v")
        if layout["amsgrad"]:
            slot("nu_max", "v_max")
    layout["cnn"] = is_cnn(model)
    layout["num_heads"] = None if layout["cnn"] else local_heads(model)
    layout["ef"] = None
    mesh = getattr(state, "mesh", None)
    if mesh is not None:  # a tp/sp state: what its regions need
        layout["mesh"] = mesh
        layout["config"] = model.config
        layout["tp"] = model.config.num_heads // layout["num_heads"]
    ef = getattr(state, "ef_state", None)
    if ef is not None:
        if ef_rows is None:
            if state.replicas != 1:
                raise ValueError(
                    f"a state of {state.replicas} replicas saves the "
                    "residuals of every rank: pass the gathered ef_rows")
            ef_rows = [e.detach()[None] for e in ef]
        if len(ef_rows):  # an empty sequence leaves the residuals out
            for (n, _), rows in zip(named, ef_rows):
                tensors["ef_state/" + n] = rows
            layout["ef"] = int(ef_rows[0].shape[0])
    return layout, tensors


def train_state_to_flax(layout: dict, tensors: dict) -> dict:
    """The JAX ``TrainState`` state dict of :func:`train_state_tensors`'s
    output (``tensors`` on the host: CPU tensors), numpy leaves in flax's
    order: what ``flax.serialization.to_bytes`` of the JAX state writes."""
    def role(name):
        pre = name + "/"
        return {k[len(pre):]: v for k, v in tensors.items()
                if k.startswith(pre)}

    params = role("params")
    if layout["cnn"]:
        p_tree, stats = state_dict_to_cnn({**params, **role("batch_stats")})
        p_tree, stats = _sorted(p_tree), _sorted(stats)
    else:
        p_tree, stats = _named_to_tree(layout, params), {}
    count = np.asarray(layout["count"], np.int32)
    if layout["kind"] == "sgd":
        opt_state = {"count": count, "momentum_buf":
                     _named_to_tree(layout, role("momentum_buf"))
                     if layout["momentum"] else None}
    else:
        opt_state = {"count": count,
                     "mu": _named_to_tree(layout, role("mu")),
                     "nu": _named_to_tree(layout, role("nu")),
                     "nu_max": _named_to_tree(layout, role("nu_max"))
                     if layout["amsgrad"] else None}
    ef_state = None
    if layout.get("ef") is not None:
        rows = role("ef_state")
        ef_state = _stack_trees([
            _named_to_tree(layout, {k: v[r] for k, v in rows.items()})
            for r in range(layout["ef"])])
    return {"step": np.asarray(layout["step"], np.int32), "params": p_tree,
            "opt_state": opt_state, "batch_stats": stats,
            "ef_state": ef_state}


def _stack_trees(trees):
    """One tree whose leaves stack the trees' leaves on a new first axis
    (a view for one tree)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if len(trees) == 1:
        return np.asarray(first)[None]
    return np.stack([np.asarray(t) for t in trees])


def _unstack_tree(tree, r: int):
    """Row ``r`` of every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _unstack_tree(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


class GeometryMismatch(ValueError):
    """A checkpoint's error-feedback residuals are of another replica
    count than the live run's: a run geometry to fix, not a corrupt
    file."""


def _ef_mismatch(where: str, got, replicas: int) -> str:
    """The JAX ``_check_ef_geometry`` message."""
    rs = [tuple(np.shape(a)) for _, a in _leaves(got)][:1]
    ts = [(replicas, *rs[0][1:])] if rs else []
    return (f"{where}: checkpoint geometry mismatch — the error-feedback "
            f"state was saved with per-replica shapes {rs}... but the live "
            f"mesh expects {ts}... (checkpoint written on "
            f"{{'data-parallel replicas': {rs[0][0] if rs else '?'}}}; see "
            "the live run's mesh). Resume on the original geometry "
            "(--strict-geometry documents this contract), or let elastic "
            "resume reshard-on-load: --resume without --strict-geometry")


def ef_rows_of(model, raw_ef) -> list:
    """A checkpoint's ``ef_state`` tree as every replica's residuals in
    the port's layout: a list over replicas of ``{parameter name:
    tensor}``."""
    n = next(iter(_leaves(raw_ef)))[1].shape[0]
    return [_tree_to_named(model, _unstack_tree(raw_ef, r))
            for r in range(n)]


def _expect_keys(what: str, got: dict, want) -> None:
    if set(got) != set(want):
        raise ValueError(f"{what}: the checkpoint has keys {sorted(got)}, "
                         f"this state expects {sorted(want)}")


def _check_shapes(what: str, got: dict, want: dict) -> None:
    _expect_keys(what, got, want)
    bad = [k for k in want if tuple(got[k].shape) != tuple(want[k].shape)]
    if bad:
        raise ValueError(f"{what}: shapes differ at {bad[:4]}: checkpoint "
                         f"{[tuple(got[k].shape) for k in bad[:4]]}, state "
                         f"{[tuple(want[k].shape) for k in bad[:4]]}")


@torch.no_grad()
def load_train_state(state, tree: dict, params_only: bool = False,
                     ef: str = "raise", ef_rows: list = None,
                     where: str = "checkpoint") -> None:
    """Copy a JAX ``TrainState`` state dict (numpy leaves) into the port's
    ``state`` in place: parameters, BatchNorm statistics and the step,
    and, unless ``params_only``, the optimizer's state and count, and
    this rank's row of the error-feedback residuals (a state with topk).
    ``ef`` says what a file of another replica count does: ``"raise"``
    (the JAX ``_check_ef_geometry``), ``"reset"`` (zero residuals and a
    warning, the JAX ``restore_resharded``), or ``"skip"`` (the residuals
    are left alone: another rank scatters them). A list given as
    ``ef_rows`` receives every replica's residuals (:func:`ef_rows_of`).
    Raises, before changing anything, on a key the state does not have or
    lacks and on a shape it does not have, as flax's ``from_state_dict``
    refuses a tree that is not its template's."""
    _expect_keys("state", tree, ("step", "params", "opt_state",
                                 "batch_stats", "ef_state"))
    if ef not in ("raise", "reset", "skip"):
        raise ValueError(f"unknown ef mode {ef!r}")
    model, sched = state.model, state.optimizer
    if is_cnn(model):
        sd = cnn_to_state_dict(tree["params"], tree["batch_stats"])
    else:
        if tree["batch_stats"]:
            raise ValueError("batch_stats in a transformer's checkpoint")
        sd = flax_to_state_dict(tree["params"])
    _check_shapes("params and batch_stats", sd, model.state_dict())
    named = dict(model.named_parameters())
    new_opt_state, count = None, None
    if not params_only:
        opt = sched.optimizer
        kind = _opt_kind(opt)
        group = opt.param_groups[0]
        ost = tree["opt_state"]
        _expect_keys(f"opt_state ({kind})", ost,
                     ("count", "momentum_buf") if kind == "sgd"
                     else ("count", "mu", "nu", "nu_max"))
        count = int(ost["count"])

        def slots(role):
            got = _tree_to_named(model, ost[role])
            _check_shapes(f"opt_state.{role}", got, named)
            return {n: got[n].to(named[n].device) for n in named}

        if kind == "sgd":
            if (ost["momentum_buf"] is None) != (not group["momentum"]):
                raise ValueError("momentum buffers in the checkpoint and "
                                 f"momentum={group['momentum']} disagree")
            roles = {"momentum_buffer": "momentum_buf"} \
                if group["momentum"] else {}
            extra = {}
        else:
            if (ost["nu_max"] is None) == bool(group["amsgrad"]):
                raise ValueError("the checkpoint's nu_max and amsgrad="
                                 f"{group['amsgrad']} disagree")
            roles = {"m": "mu", "v": "nu"}
            if group["amsgrad"]:
                roles["v_max"] = "nu_max"
            extra = {"step": count}
        got = {k: slots(r) for k, r in roles.items()}
        new_opt_state = {
            named[n]: ({**extra, **{k: got[k][n] for k in roles}}
                       if count and roles else {})
            for n in named}
    new_ef = None
    live_ef = getattr(state, "ef_state", None)
    if not params_only and live_ef is not None and ef != "skip":
        new_ef = [torch.zeros_like(e) for e in live_ef]
        raw = tree["ef_state"]
        if raw is not None:
            rows = ef_rows_of(model, raw)
            if len(rows) == state.replicas:
                for row in rows:
                    _check_shapes("ef_state", row, named)
                mine = rows[state.rank]
                new_ef = [mine[n].to(e.device, e.dtype)
                          for n, e in zip(named, live_ef)]
                if ef_rows is not None:
                    ef_rows.extend(rows)
            elif ef == "raise":
                raise GeometryMismatch(_ef_mismatch(where, raw,
                                                    state.replicas))
            else:
                logger.warning("%s: EF residuals reset — saved for a "
                               "different data-parallel degree (%d vs live "
                               "%d)", where, len(rows), state.replicas)
    model.load_state_dict(sd, strict=True)
    state.step = int(tree["step"])
    if new_ef is not None:
        state.ef_state = new_ef
    if new_opt_state is not None:
        opt.state.clear()
        opt.state.update(new_opt_state)
        sched.count = count



# -- tensor-parallel shards ------------------------------------------------
#
# Under tensor parallelism a rank's model holds its region of each split
# leaf (``parallel.partitioning.leaf_region``, on the JAX shape). The
# converters above are shape-generic: with the rank's number of heads they
# map its state_dict onto the regions of the JAX tree, leaf for leaf, and
# back. These functions carry whole JAX trees (params, or a whole
# ``TrainState`` state dict of numpy leaves) to one rank's regions, and
# give each leaf's JAX key and full shape.


def local_heads(model) -> int:
    """The attention heads this rank's transformer holds."""
    par = getattr(model, "par", None)
    return model.config.num_heads // (par.tp if par is not None else 1)


def tree_leaves(tree, path=()):
    """(path, leaf) of a nested dict of arrays in key order (``None``
    subtrees have none)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def _set_path(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _slots(opt_state: dict):
    """The optimizer state's per-parameter trees, by name."""
    return [(k, v) for k, v in opt_state.items()
            if k != "count" and v is not None]


def full_leaf_shape(path, shape, config, tp: int):
    """The JAX leaf's whole shape from a rank's region ``shape`` of it:
    each axis split over the model group takes its full extent from the
    config (vocab, heads, mlp)."""
    from pytorch_distributed_nn_tpu_torch.parallel.partitioning import (
        HEADS,
        MLP,
        VOCAB,
        logical_axes,
    )

    if tp == 1:
        return tuple(int(n) for n in shape)
    full = {VOCAB: config.vocab_size, HEADS: config.num_heads,
            MLP: config.d_ff}
    axes = logical_axes(path)
    return tuple(full.get(axes[i], int(n)) if i < len(axes) else int(n)
                 for i, n in enumerate(shape))


def region_of(path, arr, mesh_shape, coords):
    """Rank ``coords``'s region of the whole JAX leaf ``arr`` at ``path``
    (numpy, a view)."""
    from pytorch_distributed_nn_tpu_torch.parallel.partitioning import (
        leaf_region,
    )

    arr = np.asarray(arr)
    region = leaf_region(path, arr.shape, mesh_shape, coords)
    return arr[tuple(slice(a, b) for a, b in region)]


def shard_params(params: dict, mesh_shape, coords) -> dict:
    """A whole JAX params tree -> rank ``coords``'s region tree."""
    out: dict = {}
    for path, a in tree_leaves(params):
        _set_path(out, path, region_of(path, a, mesh_shape, coords))
    return out


def shard_state_tree(tree: dict, mesh_shape, coords) -> dict:
    """A whole JAX ``TrainState`` state dict (a FILE checkpoint's tree,
    or a sharded directory's, assembled) -> rank ``coords``'s regions:
    the params and every optimizer slot tree split, the step and the
    optimizer count as they are."""
    opt = dict(tree["opt_state"])
    for role, sub in _slots(opt):
        opt[role] = shard_params(sub, mesh_shape, coords)
    return {**tree, "params": shard_params(tree["params"], mesh_shape,
                                           coords),
            "opt_state": opt}


def local_state_dict(params: dict, mesh_shape, coords
                     ) -> Dict[str, torch.Tensor]:
    """A whole JAX params tree (a transformer's) -> the state_dict of the
    rank at ``coords``'s model."""
    return flax_to_state_dict(shard_params(params, mesh_shape, coords))


def jax_key(field: str, path=()) -> str:
    """The JAX ``keystr`` of a ``TrainState`` leaf: ``.params['a']['b']``,
    ``.opt_state.mu['a']``, ``.step``."""
    return "." + field + "".join(f"['{k}']" for k in path)


def state_leaves(tree: dict):
    """(JAX key, params path or ``None``, array) of every leaf of a
    ``TrainState`` state dict in the JAX flatten order, the residuals left
    out (sharded checkpoints carry none): ``path`` places a leaf of the
    params or of an optimizer slot in the params tree."""
    yield jax_key("step"), None, tree["step"]
    for path, a in tree_leaves(tree["params"]):
        yield jax_key("params", path), path, a
    opt = tree["opt_state"]
    yield jax_key("opt_state.count"), None, opt["count"]
    for role, sub in _slots(opt):
        for path, a in tree_leaves(sub):
            yield jax_key("opt_state." + role, path), path, a
    for path, a in tree_leaves(tree["batch_stats"]):
        yield jax_key("batch_stats", path), path, a


_KEY_TOKEN = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def parse_jax_key(key: str):
    """The inverse of :func:`jax_key`: the tuple of names."""
    out, pos = [], 0
    while pos < len(key):
        m = _KEY_TOKEN.match(key, pos)
        if m is None:
            raise ValueError(f"unparseable checkpoint key {key!r}")
        out.append(next(g for g in m.groups() if g is not None))
        pos = m.end()
    return tuple(out)


def state_tree_from_leaves(leaves: dict) -> dict:
    """``{JAX key: array}`` of a ``TrainState`` -> its state dict, with
    the empty fields filled as a FILE checkpoint holds them (no
    ``batch_stats``: ``{}``; no residuals, ``nu_max`` or momentum:
    ``None``)."""
    tree: dict = {}
    for key, a in leaves.items():
        _set_path(tree, parse_jax_key(key), a)
    tree.setdefault("batch_stats", {})
    tree.setdefault("ef_state", None)
    opt = tree.setdefault("opt_state", {})
    if "mu" in opt:
        opt.setdefault("nu_max", None)
    else:
        opt.setdefault("momentum_buf", None)
    return tree
