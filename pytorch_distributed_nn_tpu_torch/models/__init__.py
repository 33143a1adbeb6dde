"""Model zoo + factory of the port: the causal decoders the generative
serving path runs (the CNNs and the BERT encoder wait for the training
slice)."""

from __future__ import annotations

from pytorch_distributed_nn_tpu_torch.models.transformer import (
    CausalLM,
    TransformerConfig,
    full_attention,
    gpt_mini,
    gpt_tiny,
)
from pytorch_distributed_nn_tpu_torch.ops.reference import (
    decode_attention,
)

_REGISTRY = {
    "GptTiny": gpt_tiny,
    "GptMini": gpt_mini,
}

INPUT_SPECS = {"GptTiny": (64,), "GptMini": (128,)}

#: causal decoders: their artifacts serve POST /v1/generate
GENERATIVE_MODELS = {"GptTiny", "GptMini"}


def is_generative_model(model_name: str) -> bool:
    return model_name in GENERATIVE_MODELS


def model_names():
    return sorted(_REGISTRY)


def input_spec(model_name: str):
    return INPUT_SPECS[model_name]


def build_model(model_name: str, num_classes: int = 0, **kwargs):
    """Instantiate a model by its CLI name; unknown names raise."""
    try:
        factory = _REGISTRY[model_name]
    except KeyError:
        raise ValueError(
            f"unknown model {model_name!r}; the port has: {model_names()}"
        ) from None
    return factory(num_classes=num_classes, **kwargs)


__all__ = [
    "CausalLM", "TransformerConfig", "build_model", "decode_attention",
    "full_attention", "gpt_mini", "gpt_tiny", "input_spec",
    "is_generative_model", "GENERATIVE_MODELS",
]
