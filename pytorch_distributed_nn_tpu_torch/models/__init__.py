"""Model zoo + factory of the port: the transformer family — the BERT
encoder with its masked-LM head and the causal decoders (the CNNs wait
for the ResNet training slice)."""

from __future__ import annotations

from pytorch_distributed_nn_tpu_torch.models.transformer import (
    BertMLM,
    CausalLM,
    TransformerConfig,
    bert_base,
    bert_tiny,
    full_attention,
    gpt_mini,
    gpt_tiny,
)
from pytorch_distributed_nn_tpu_torch.ops.reference import (
    decode_attention,
)

_REGISTRY = {
    "BertBase": bert_base,
    "BertTiny": bert_tiny,
    "GptTiny": gpt_tiny,
    "GptMini": gpt_mini,
}

#: text models take (L,) int tokens; their spec is the sequence length
TEXT_MODELS = {"BertBase", "BertTiny", "GptTiny", "GptMini"}
INPUT_SPECS = {"BertBase": (512,), "BertTiny": (128,), "GptTiny": (64,),
               "GptMini": (128,)}

#: causal decoders: their artifacts serve POST /v1/generate
GENERATIVE_MODELS = {"GptTiny", "GptMini"}


def is_text_model(model_name: str) -> bool:
    return model_name in TEXT_MODELS


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
    "BertMLM", "CausalLM", "TransformerConfig", "bert_base", "bert_tiny",
    "build_model", "decode_attention", "full_attention", "gpt_mini",
    "gpt_tiny", "input_spec", "is_generative_model", "is_text_model",
    "GENERATIVE_MODELS", "TEXT_MODELS",
]
