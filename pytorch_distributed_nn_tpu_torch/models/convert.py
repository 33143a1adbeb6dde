"""Weight converter between the JAX package's flax params tree and the
port's ``CausalLM`` state_dict.

The flax tree (a nested dict of numpy arrays, as an artifact's params
load) and the port's layouts:

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

Both directions copy values exactly (transposes and reshapes only).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_QKV = ("query", "key", "value")


def flax_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """Flax decoder params tree -> the port's ``CausalLM`` state_dict."""
    sd = {
        "token_embed.weight": params["token_embed"]["embedding"],
        "pos_embed": params["pos_embed"],
        "lm_bias": params["lm_bias"],
        "ln_final.scale": params["ln_final"]["scale"],
        "ln_final.bias": params["ln_final"]["bias"],
    }
    blocks = sorted(
        (int(m.group(1)), k) for k in params
        if (m := re.fullmatch(r"block_(\d+)", k))
    )
    for i, key in blocks:
        blk, pre = params[key], f"blocks.{i}."
        for ln in ("ln_attn", "ln_mlp"):
            sd[pre + ln + ".scale"] = blk[ln]["scale"]
            sd[pre + ln + ".bias"] = blk[ln]["bias"]
        attn = blk["attn"]
        for name in _QKV:
            kern = np.asarray(attn[name]["kernel"])  # (d, H, Dh)
            sd[f"{pre}attn.{name}.weight"] = kern.reshape(kern.shape[0], -1).T
            sd[f"{pre}attn.{name}.bias"] = np.asarray(
                attn[name]["bias"]).reshape(-1)
        kern = np.asarray(attn["out"]["kernel"])  # (H, Dh, d)
        sd[pre + "attn.out.weight"] = kern.reshape(-1, kern.shape[-1]).T
        sd[pre + "attn.out.bias"] = attn["out"]["bias"]
        for name in ("mlp_in", "mlp_out"):
            sd[f"{pre}{name}.weight"] = np.asarray(blk[name]["kernel"]).T
            sd[f"{pre}{name}.bias"] = blk[name]["bias"]
    # np.array copies: artifact leaves are read-only views of the blob
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor],
                       num_heads: int) -> dict:
    """The port's ``CausalLM`` state_dict -> a flax decoder params tree of
    numpy arrays (the inverse of :func:`flax_to_state_dict`)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    params = {
        "token_embed": {"embedding": sd["token_embed.weight"]},
        "pos_embed": sd["pos_embed"],
        "lm_bias": sd["lm_bias"],
        "ln_final": {"scale": sd["ln_final.scale"],
                     "bias": sd["ln_final.bias"]},
    }
    layers = sorted({int(k.split(".")[1]) for k in sd
                     if k.startswith("blocks.")})
    for i in layers:
        pre = f"blocks.{i}."
        blk = {
            ln: {"scale": sd[pre + ln + ".scale"], "bias": sd[pre + ln + ".bias"]}
            for ln in ("ln_attn", "ln_mlp")
        }
        attn = {}
        for name in _QKV:
            w = sd[f"{pre}attn.{name}.weight"]  # (H*Dh, d)
            attn[name] = {
                "kernel": w.T.reshape(w.shape[1], num_heads, -1),
                "bias": sd[f"{pre}attn.{name}.bias"].reshape(num_heads, -1),
            }
        w = sd[pre + "attn.out.weight"]  # (d, H*Dh)
        attn["out"] = {"kernel": w.T.reshape(num_heads, -1, w.shape[0]),
                       "bias": sd[pre + "attn.out.bias"]}
        blk["attn"] = attn
        for name in ("mlp_in", "mlp_out"):
            blk[name] = {"kernel": sd[f"{pre}{name}.weight"].T,
                         "bias": sd[f"{pre}{name}.bias"]}
        params[f"block_{i}"] = blk
    return params
