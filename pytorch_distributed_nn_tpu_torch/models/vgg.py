"""The CIFAR VGG family: the port of ``pytorch_distributed_nn_tpu/models/
vgg.py``: configs A/B/D/E (VGG-11/13/16/19), optional BatchNorm after
each conv, and a 512 -> 512 -> 512 -> num_classes head with dropout 0.5
(drawn from the model's dropout generator, like the transformers')."""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_nn_tpu_torch.models.layers import CNN, BatchNorm, Conv
from pytorch_distributed_nn_tpu_torch.models.transformer import Dropout, dense

CFG = {
    "A": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "B": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"),
    "D": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"),
    "E": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"),
}


class VGG(CNN):
    def __init__(self, cfg: Sequence[Union[int, str]], num_classes: int = 10,
                 batch_norm: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype, self.cfg, self.batch_norm = dtype, tuple(cfg), batch_norm
        cin, i = 3, 0
        for v in self.cfg:
            if v == "M":
                continue
            self.add_module(f"conv{i}", Conv(cin, int(v), 3, dtype=dtype))
            if batch_norm:
                self.add_module(f"bn{i}", BatchNorm(int(v), dtype))
            cin, i = int(v), i + 1
        self.dropout = Dropout(0.5)
        self.fc1 = nn.Linear(512, 512)
        self.fc2 = nn.Linear(512, 512)
        self.classifier = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 32, 32, 3) images -> (B, num_classes) f32 logits."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2)
                continue
            x = getattr(self, f"conv{i}")(x)
            if self.batch_norm:
                x = getattr(self, f"bn{i}")(x)
            x = F.relu(x)
            i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (B, 512)
        x = F.relu(dense(self.dropout(x), self.fc1, self.dtype))
        x = F.relu(dense(self.dropout(x), self.fc2, self.dtype))
        return dense(x, self.classifier, self.dtype).float()


def _vgg(key: str, batch_norm: bool):
    def build(num_classes: int = 10, **kw):
        return VGG(CFG[key], num_classes, batch_norm, **kw)
    return build


vgg11, vgg11_bn = _vgg("A", False), _vgg("A", True)
vgg13, vgg13_bn = _vgg("B", False), _vgg("B", True)
vgg16, vgg16_bn = _vgg("D", False), _vgg("D", True)
vgg19, vgg19_bn = _vgg("E", False), _vgg("E", True)
