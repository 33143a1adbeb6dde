"""Layers of the port's CNN zoo with flax's arithmetic.

- :class:`Conv`: ``flax.linen.Conv`` with ``padding="SAME"`` or
  ``"VALID"`` and a compute ``dtype``: input and kernel cast to ``dtype``.
  SAME pads ``max((ceil(in / s) - 1) * s + k - in, 0)`` in total, the
  smaller half before: a 3x3 stride-2 conv on an even input pads (0, 1),
  where ``nn.Conv2d(padding=1)`` would pad (1, 1) and sample other pixels.
- :class:`BatchNorm`: ``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)``.
  In training mode the batch statistics are f32 (``mean(x)`` and the
  biased ``max(mean(x^2) - mean(x)^2, 0)``, flax's fast variance), the
  running statistics move as ``ra = 0.9 ra + 0.1 batch`` with that biased
  variance (``F.batch_norm`` would use the unbiased one), and the output
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` is computed in f32
  and cast to ``dtype``, as flax does. Explicit casts, not autocast,
  keep the rounding points where flax has them.

Activations are NCHW inside the models; the models take NHWC images, the
JAX package's layout, and permute once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_nn_tpu_torch.models.transformer import Dropout

#: flax's truncated-normal correction: the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init (variance scaling 1, fan-in, truncated
    normal): its scheme, drawn from a torch generator."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def _same_pads(size: int, k: int, s: int):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """``flax.linen.Conv`` (weights OIHW, the PyTorch layout)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: str = "SAME", bias: bool = True,
                 dtype=torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}")
        self.same = padding == "SAME"
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        pad = 0
        if self.same:
            (top, bottom), (left, right) = (_same_pads(x.shape[2], k, s),
                                            _same_pads(x.shape[3], k, s))
            if top == bottom and left == right:
                pad = (top, left)
            else:
                x = F.pad(x, (left, right, top, bottom))
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, pad)

    def init_weights(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2] \
            * self.weight.shape[3]
        lecun_normal_(self.weight, fan_in, generator)
        if self.bias is not None:
            self.bias.zero_()


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the channels of NCHW activations
    (module docstring). ``weight``/``bias`` are flax's scale/bias,
    ``running_mean``/``running_var`` its batch_stats mean/var."""

    def __init__(self, features: int, dtype=torch.float32,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dtype, self.momentum, self.eps = dtype, momentum, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            xf, mean, var = x.float(), self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


def init_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    lecun_normal_(layer.weight, layer.weight.shape[1], generator)
    layer.bias.zero_()


class CNN(nn.Module):
    """What the zoo's models share: flax's initialisation from a torch
    generator, and the dropout generator hook of the training state."""

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, Conv):
                m.init_weights(generator)
            elif isinstance(m, nn.Linear):
                init_linear(m, generator)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        return self

    def set_dropout_generator(self, generator):
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator
        return self
