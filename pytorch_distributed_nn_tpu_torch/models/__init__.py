"""Model zoo + factory of the port: the CNN zoo (LeNet, the CIFAR ResNets,
VGG) and the transformer family (the BERT encoder with its masked-LM head
and the causal decoders), registered under the JAX package's names."""

from __future__ import annotations

from typing import Any, Dict

import torch

from pytorch_distributed_nn_tpu_torch.models.lenet import LeNet
from pytorch_distributed_nn_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    CifarResNet,
    ResNet,
    ResNet18,
    ResNet20,
    ResNet32,
    ResNet34,
    ResNet50,
    ResNet56,
    ResNet101,
    ResNet110,
    ResNet152,
)
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
from pytorch_distributed_nn_tpu_torch.models.vgg import (
    VGG,
    vgg11,
    vgg11_bn,
    vgg13,
    vgg13_bn,
    vgg16,
    vgg16_bn,
    vgg19,
    vgg19_bn,
)
from pytorch_distributed_nn_tpu_torch.ops.reference import (
    decode_attention,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cnn(factory):
    """A CNN factory that also takes the dtype by name, as the CLI gives it."""
    def build(num_classes: int = 10, dtype=torch.float32, **kw):
        return factory(num_classes=num_classes,
                       dtype=_DTYPES.get(dtype, dtype), **kw)
    return build


_REGISTRY = {
    "LeNet": _cnn(LeNet),
    "ResNet18": _cnn(ResNet18),
    "ResNet34": _cnn(ResNet34),
    "ResNet50": _cnn(ResNet50),
    "ResNet101": _cnn(ResNet101),
    "ResNet152": _cnn(ResNet152),
    "ResNet20": _cnn(ResNet20),
    "ResNet32": _cnn(ResNet32),
    "ResNet56": _cnn(ResNet56),
    "ResNet110": _cnn(ResNet110),
    # the reference's "VGG11" is vgg11_bn
    "VGG11": _cnn(vgg11_bn),
    "VGG13": _cnn(vgg13_bn),
    "VGG16": _cnn(vgg16_bn),
    "VGG19": _cnn(vgg19_bn),
    "VGG11NoBN": _cnn(vgg11),
    "VGG13NoBN": _cnn(vgg13),
    "VGG16NoBN": _cnn(vgg16),
    "VGG19NoBN": _cnn(vgg19),
    "BertBase": bert_base,
    "BertTiny": bert_tiny,
    "GptTiny": gpt_tiny,
    "GptMini": gpt_mini,
}

#: (H, W, C) of the canonical dataset per image model (MNIST for LeNet,
#: 32x32 RGB otherwise); text models take (L,) int tokens
INPUT_SPECS: Dict[str, Any] = {"LeNet": (28, 28, 1), "BertBase": (512,),
                               "BertTiny": (128,), "GptTiny": (64,),
                               "GptMini": (128,)}
_DEFAULT_INPUT_SPEC = (32, 32, 3)
TEXT_MODELS = {"BertBase", "BertTiny", "GptTiny", "GptMini"}

#: causal decoders: their artifacts serve POST /v1/generate
GENERATIVE_MODELS = {"GptTiny", "GptMini"}


def is_text_model(model_name: str) -> bool:
    return model_name in TEXT_MODELS


def is_generative_model(model_name: str) -> bool:
    return model_name in GENERATIVE_MODELS


def model_names():
    return sorted(_REGISTRY)


def input_spec(model_name: str):
    return INPUT_SPECS.get(model_name, _DEFAULT_INPUT_SPEC)


def build_model(model_name: str, num_classes: int = 10, **kwargs):
    """Instantiate a model by its CLI name; unknown names raise."""
    try:
        factory = _REGISTRY[model_name]
    except KeyError:
        raise ValueError(
            f"unknown model {model_name!r}; the port has: {model_names()}"
        ) from None
    return factory(num_classes=num_classes, **kwargs)


__all__ = [
    "BasicBlock", "Bottleneck", "CifarResNet", "LeNet", "ResNet", "VGG",
    "BertMLM", "CausalLM", "TransformerConfig", "bert_base", "bert_tiny",
    "build_model", "decode_attention", "full_attention", "gpt_mini",
    "gpt_tiny", "input_spec", "is_generative_model", "is_text_model",
    "GENERATIVE_MODELS", "TEXT_MODELS",
]
