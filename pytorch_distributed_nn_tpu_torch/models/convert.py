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

import re
from typing import Dict

import numpy as np
import torch

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
#   ef_state    None                        (topk error feedback: not ported)
#
# The optimizer's trees have the params tree's structure. Before an
# optimizer's first update the JAX state holds zeros and the torch one
# nothing; both start the same way from either.


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


def train_state_tensors(state):
    """``(layout, tensors)`` of a port ``TrainState``: its live tensors,
    flat, keyed ``params/<name>``, ``batch_stats/<name>``, and
    ``<momentum_buf|mu|nu|nu_max>/<name>`` for the optimizer's state, and
    the small facts :func:`train_state_to_flax` needs besides them. The
    tensors are the state's own (a caller that keeps them past the next
    step clones them)."""
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
    layout["num_heads"] = None if layout["cnn"] else model.config.num_heads
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
    return {"step": np.asarray(layout["step"], np.int32), "params": p_tree,
            "opt_state": opt_state, "batch_stats": stats, "ef_state": None}


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
def load_train_state(state, tree: dict, params_only: bool = False) -> None:
    """Copy a JAX ``TrainState`` state dict (numpy leaves) into the port's
    ``state`` in place: parameters, BatchNorm statistics and the step,
    and, unless ``params_only``, the optimizer's state and count. Raises,
    before changing anything, on a key the state does not have or lacks
    and on a shape it does not have, as flax's ``from_state_dict``
    refuses a tree that is not its template's."""
    _expect_keys("state", tree, ("step", "params", "opt_state",
                                 "batch_stats", "ef_state"))
    if tree["ef_state"] is not None:
        raise ValueError("the checkpoint holds topk error-feedback state, "
                         "which the port does not run (ROADMAP Queue 1 "
                         "item 2)")
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
    model.load_state_dict(sd, strict=True)
    state.step = int(tree["step"])
    if new_opt_state is not None:
        opt.state.clear()
        opt.state.update(new_opt_state)
        sched.count = count
