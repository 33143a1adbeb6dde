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
