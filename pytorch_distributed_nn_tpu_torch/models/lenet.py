"""LeNet for MNIST: the port of ``pytorch_distributed_nn_tpu/models/
lenet.py``: conv(1->20, 5x5) -> maxpool 2 -> relu -> conv(20->50, 5x5) ->
maxpool 2 -> relu -> flatten -> fc(500) -> fc(num_classes).

The flatten is in NHWC order, as flax flattens, so ``fc1``'s input rows
run over (h, w, c): the converter only transposes the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_nn_tpu_torch.models.layers import CNN, Conv
from pytorch_distributed_nn_tpu_torch.models.transformer import dense


class LeNet(CNN):
    def __init__(self, num_classes: int = 10, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(1, 20, 5, padding="VALID", dtype=dtype)
        self.conv2 = Conv(20, 50, 5, padding="VALID", dtype=dtype)
        self.fc1 = nn.Linear(4 * 4 * 50, 500)
        self.fc2 = nn.Linear(500, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 28, 28, 1) images -> (B, num_classes) f32 logits."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = dense(x, self.fc1, self.dtype)
        return dense(x, self.fc2, self.dtype).float()
