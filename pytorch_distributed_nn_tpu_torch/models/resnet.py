"""The CIFAR ResNet family: the port of ``pytorch_distributed_nn_tpu/
models/resnet.py`` (``ResNet`` 18/34/50/101/152 and the thin
``CifarResNet`` 20/32/56/110), with flax's convolutions and BatchNorm
(:mod:`.layers`).

``ResNet``: 3x3 stem (no max-pool), four stages at 64/128/256/512 planes
with strides 1/2/2/2, ``BasicBlock`` (expansion 1) or ``Bottleneck``
(expansion 4), global average pool, linear classifier. ``CifarResNet``:
6n + 2 layers, three stages at 16/32/64 planes of n BasicBlocks. Images
come in NHWC; logits leave as f32. Module names follow the flax tree
(``conv_stem``, ``bn_stem``, ``stage{s}_block{i}``, ``classifier``; a
block's ``Conv_j``/``BatchNorm_j`` are ``conv_j``/``bn_j``), so the
converter (:mod:`.convert`) only renames and transposes.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_nn_tpu_torch.models.layers import CNN, BatchNorm, Conv
from pytorch_distributed_nn_tpu_torch.models.transformer import dense


class BasicBlock(nn.Module):
    """Two 3x3 convs plus the identity or a 1x1 projection shortcut."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int, dtype):
        super().__init__()
        self.conv_0 = Conv(cin, planes, 3, stride, bias=False, dtype=dtype)
        self.bn_0 = BatchNorm(planes, dtype)
        self.conv_1 = Conv(planes, planes, 3, bias=False, dtype=dtype)
        self.bn_1 = BatchNorm(planes, dtype)
        self.project = stride != 1 or cin != planes
        if self.project:
            self.conv_2 = Conv(cin, planes, 1, stride, bias=False, dtype=dtype)
            self.bn_2 = BatchNorm(planes, dtype)

    def forward(self, x):
        y = F.relu(self.bn_0(self.conv_0(x)))
        y = self.bn_1(self.conv_1(y))
        res = self.bn_2(self.conv_2(x)) if self.project else x
        return F.relu(y + res)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (expansion 4) plus the shortcut."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, dtype):
        super().__init__()
        out = planes * 4
        self.conv_0 = Conv(cin, planes, 1, bias=False, dtype=dtype)
        self.bn_0 = BatchNorm(planes, dtype)
        self.conv_1 = Conv(planes, planes, 3, stride, bias=False, dtype=dtype)
        self.bn_1 = BatchNorm(planes, dtype)
        self.conv_2 = Conv(planes, out, 1, bias=False, dtype=dtype)
        self.bn_2 = BatchNorm(out, dtype)
        self.project = stride != 1 or cin != out
        if self.project:
            self.conv_3 = Conv(cin, out, 1, stride, bias=False, dtype=dtype)
            self.bn_3 = BatchNorm(out, dtype)

    def forward(self, x):
        y = F.relu(self.bn_0(self.conv_0(x)))
        y = F.relu(self.bn_1(self.conv_1(y)))
        y = self.bn_2(self.conv_2(y))
        res = self.bn_3(self.conv_3(x)) if self.project else x
        return F.relu(y + res)


class ResNet(CNN):
    """The CIFAR ResNet of ``planes`` stages of ``num_blocks`` blocks."""

    def __init__(self, block, num_blocks: Sequence[int],
                 num_classes: int = 10, dtype=torch.float32,
                 planes: Sequence[int] = (64, 128, 256, 512), in_ch: int = 3):
        super().__init__()
        self.dtype = dtype
        self.conv_stem = Conv(in_ch, planes[0], 3, bias=False, dtype=dtype)
        self.bn_stem = BatchNorm(planes[0], dtype)
        cin, self.block_names = planes[0], []
        for stage, (p, n) in enumerate(zip(planes, num_blocks)):
            for i in range(n):
                stride = (2 if stage > 0 else 1) if i == 0 else 1
                name = f"stage{stage + 1}_block{i}"
                self.add_module(name, block(cin, p, stride, dtype))
                self.block_names.append(name)
                cin = p * block.expansion
        self.classifier = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> (B, num_classes) f32 logits."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn_stem(self.conv_stem(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return dense(x, self.classifier, self.dtype).float()


def CifarResNet(n: int, num_classes: int = 10, dtype=torch.float32):
    """Thin CIFAR ResNet (6n + 2 layers): stages 16/32/64 of n blocks."""
    return ResNet(BasicBlock, (n, n, n), num_classes, dtype,
                  planes=(16, 32, 64))


def _resnet(block, blocks):
    def build(num_classes: int = 10, **kw):
        return ResNet(block, blocks, num_classes, **kw)
    return build


ResNet18 = _resnet(BasicBlock, (2, 2, 2, 2))
ResNet34 = _resnet(BasicBlock, (3, 4, 6, 3))
ResNet50 = _resnet(Bottleneck, (3, 4, 6, 3))
ResNet101 = _resnet(Bottleneck, (3, 4, 23, 3))
ResNet152 = _resnet(Bottleneck, (3, 8, 36, 3))


def _cifar(n):
    def build(num_classes: int = 10, **kw):
        return CifarResNet(n, num_classes, **kw)
    return build


ResNet20, ResNet32, ResNet56, ResNet110 = (_cifar(n) for n in (3, 5, 9, 18))
