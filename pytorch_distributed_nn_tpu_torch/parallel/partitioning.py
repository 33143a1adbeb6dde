"""Logical-axis -> mesh-axis partition rules and the shard arithmetic of
tensor parallelism: the port of ``pytorch_distributed_nn_tpu/parallel/
partitioning.py``.

The flax transformer annotates every weight with logical axes (embed,
heads, kv, mlp, vocab); the rule table maps them onto mesh axes, the
Megatron split:

- q/k/v projections: column-parallel (``heads`` -> model);
- the attention output and the second MLP matmul: row-parallel (their
  ``heads``/``mlp`` input dimension split; a sum over the model group
  follows);
- the first MLP matmul: column-parallel (``mlp`` -> model);
- the token embedding, the tied head and the head bias: vocab-parallel
  (``vocab`` -> model);
- everything ``embed``-shaped (LayerNorms, biases of row-parallel
  layers, positions, ``mlm_transform``): replicated.

:func:`logical_axes` gives each leaf of the JAX params tree the logical
axes the flax model annotates (``nn.get_partition_spec`` of the abstract
state: ``()`` for an unannotated leaf), from its path alone.
:func:`leaf_region` gives rank ``(d, s, m)``'s region of a leaf **in the
JAX leaf's own shape and axis order** (the port's ``nn.Linear`` weights
are transposed: regions are always computed on the JAX shape), and
:func:`owns_region` whether that rank writes it to a sharded checkpoint
(the JAX ``replica_id == 0``: the lowest rank holding the region).
Uneven splits follow GSPMD's: blocks of ``ceil(n / k)``, the last one
shorter (BertBase's vocabulary 30522 over tp = 4: 7631, 7631, 7631, 7629).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
)

# (logical axis, mesh axis). None = replicated.
DEFAULT_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", DATA_AXIS),
    ("length", SEQ_AXIS),
    ("embed", None),
    ("heads", MODEL_AXIS),
    ("kv", None),
    ("mlp", MODEL_AXIS),
    ("vocab", MODEL_AXIS),
)

EMBED, HEADS, KV, MLP, VOCAB = "embed", "heads", "kv", "mlp", "vocab"

#: (module name, leaf name) -> the leaf's logical axes, as the flax modules
#: annotate them (``models/transformer.py``); a leaf not listed is
#: unannotated (``()``: replicated)
_LEAF_AXES: Dict[Tuple[str, str], Tuple[Optional[str], ...]] = {
    ("token_embed", "embedding"): (VOCAB, EMBED),
    ("query", "kernel"): (EMBED, HEADS, KV),
    ("key", "kernel"): (EMBED, HEADS, KV),
    ("value", "kernel"): (EMBED, HEADS, KV),
    ("query", "bias"): (HEADS, KV),
    ("key", "bias"): (HEADS, KV),
    ("value", "bias"): (HEADS, KV),
    ("out", "kernel"): (HEADS, KV, EMBED),
    ("out", "bias"): (EMBED,),
    ("mlp_in", "kernel"): (EMBED, MLP),
    ("mlp_in", "bias"): (MLP,),
    ("mlp_out", "kernel"): (MLP, EMBED),
    ("mlp_out", "bias"): (EMBED,),
    ("mlm_transform", "kernel"): (None, EMBED),
    ("mlm_out", "kernel"): (EMBED, VOCAB),
}
#: top-level leaves (a parameter of the model itself)
_TOP_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "pos_embed": (None, EMBED),
    "mlm_bias": (VOCAB,),
    "lm_bias": (VOCAB,),
}


def rules_dict(rules: Sequence[Tuple[str, Optional[str]]] = DEFAULT_RULES
               ) -> dict:
    """Logical-axis -> mesh-axis mapping as a plain dict (None =
    replicated)."""
    return dict(rules)


def drop_rule(rules: Sequence[Tuple[str, Optional[str]]], logical_axis: str
              ) -> Tuple[Tuple[str, Optional[str]], ...]:
    """``rules`` with ``logical_axis`` forced to replicated."""
    return tuple((name, None if name == logical_axis else axis)
                 for name, axis in rules)


def override_rule(rules: Sequence[Tuple[str, Optional[str]]],
                  logical_axis: str, mesh_axis: Optional[str]
                  ) -> Tuple[Tuple[str, Optional[str]], ...]:
    """``rules`` with ``logical_axis`` remapped to ``mesh_axis``."""
    return tuple((name, mesh_axis if name == logical_axis else axis)
                 for name, axis in rules)


def tp_degree(mesh) -> int:
    return mesh.shape[MODEL_AXIS]


def sp_degree(mesh) -> int:
    return mesh.shape[SEQ_AXIS]


def logical_axes(path: Sequence[str]) -> Tuple[Optional[str], ...]:
    """The logical axes of the JAX params leaf at ``path`` (its keys,
    e.g. ``("encoder", "block_0", "attn", "query", "kernel")``)."""
    path = tuple(path)
    if len(path) >= 2 and (path[-2], path[-1]) in _LEAF_AXES:
        return _LEAF_AXES[(path[-2], path[-1])]
    return _TOP_AXES.get(path[-1], ())


def mesh_axes(axes: Sequence[Optional[str]],
              rules=DEFAULT_RULES) -> Tuple[Optional[str], ...]:
    """Each logical axis's mesh axis under ``rules``."""
    table = rules_dict(rules)
    return tuple(None if a is None else table.get(a) for a in axes)


def block(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of block ``index`` of ``n`` split in ``parts``:
    ceil-sized blocks, the last one shorter (GSPMD's uneven split)."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, min(start + size, n)


def leaf_region(path: Sequence[str], shape: Sequence[int],
                mesh_shape: Dict[str, int], coords: Dict[str, int],
                rules=DEFAULT_RULES) -> Tuple[Tuple[int, int], ...]:
    """Rank ``coords``'s region of the JAX leaf at ``path`` of ``shape``:
    one [start, stop) per axis of the JAX shape."""
    axes = mesh_axes(logical_axes(path), rules)
    out = []
    for i, n in enumerate(shape):
        axis = axes[i] if i < len(axes) else None
        if axis is None or mesh_shape[axis] == 1:
            out.append((0, int(n)))
        else:
            out.append(block(int(n), mesh_shape[axis], coords[axis]))
    return tuple(out)


def sharded_axes(path: Sequence[str], rules=DEFAULT_RULES) -> set:
    """The mesh axes the leaf at ``path`` is split over."""
    return {a for a in mesh_axes(logical_axes(path), rules) if a is not None}


def owns_region(path: Sequence[str], coords: Dict[str, int],
                rules=DEFAULT_RULES) -> bool:
    """Whether rank ``coords`` holds replica 0 of its region of the leaf
    at ``path``: the lowest rank holding the region, i.e. coordinate 0 on
    every mesh axis the leaf is not split over."""
    split = sharded_axes(path, rules)
    return all(coords[a] == 0 for a in (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
               if a not in split)


def index_key(region: Sequence[Tuple[int, int]]) -> str:
    """The JAX checkpoint's key of a region: ``"0:4,8:16"`` (``""`` for
    a scalar)."""
    return ",".join(f"{a}:{b}" for a, b in region)


def parse_index_key(key: str) -> Tuple[slice, ...]:
    if not key:
        return ()
    return tuple(slice(int(a), int(b))
                 for a, b in (part.split(":") for part in key.split(",")))
