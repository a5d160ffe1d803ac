"""IDC identity encoder trunk: from-scratch bottleneck ResNet-50, NCHW
(counterpart of hifidiff_tpu/nn/resnet.py; reference
`models/idc/model.py:102-166`). 7x7/s2 stem conv without bias + BN + ReLU +
3x3/s2 max-pool (padding 1); bottleneck stages [3,4,6,3] at planes
64/128/256/512 whose 1x1/3x3/1x1 convs carry biases; no classifier; the
global average pool gives the (B, 2048) identity embedding. BatchNorm is
`nn.layers.BatchNorm2d` (eps 1e-5): running statistics in eval mode, batch
statistics in training mode (IDC pretraining)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from hifidiff_tpu_torch.nn.layers import BatchNorm2d


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 project_identity: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(in_ch, planes, 1)
        self.batch_norm1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1)
        self.batch_norm2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1)
        self.batch_norm3 = BatchNorm2d(out_ch)
        self.i_downsample = (
            nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride=stride),
                          BatchNorm2d(out_ch))
            if project_identity else None)
        self.relu = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu(self.batch_norm1(self.conv1(x)))
        out = self.relu(self.batch_norm2(self.conv2(out)))
        out = self.batch_norm3(self.conv3(out))
        identity = x if self.i_downsample is None else self.i_downsample(x)
        return self.relu(out + identity)


class ResNet50(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.batch_norm1 = BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.max_pool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for stage, (blocks, planes) in enumerate(
                zip(stage_sizes, (64, 128, 256, 512))):
            stride = 1 if stage == 0 else 2
            layer = []
            for b in range(blocks):
                project = b == 0 and (stride != 1 or in_ch != planes * 4)
                layer.append(Bottleneck(in_ch, planes,
                                        stride=stride if b == 0 else 1,
                                        project_identity=project))
                in_ch = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) in [0, 1] -> (B, 2048) identity embedding."""
        x = x.to(self.conv1.weight.dtype)
        x = self.max_pool(self.relu(self.batch_norm1(self.conv1(x))))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3))
