"""Data of the port: the image datasets (``datasets``), the image loaders
(``loader``), the synthetic masked-LM corpus (``text``) and sharded
streaming input (``streaming``), with the JAX package's ``data``
exports.

The exports load on first use: a loader worker process imports
``data._pool`` and, through it, ``datasets``, and must not import torch
on the way (the loaders and the corpus's device wrapper do).
"""

import importlib

_EXPORTS = {
    "DATASETS": "datasets",
    "Dataset": "datasets",
    "augment_batch": "datasets",
    "load_dataset": "datasets",
    "DataLoader": "loader",
    "StreamingLoader": "streaming",
    "export_image_dataset": "streaming",
    "export_text_corpus": "streaming",
    "BigramCorpus": "text",
    "MLMBatches": "text",
    "mask_tokens": "text",
    "IGNORE_INDEX": "text",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
