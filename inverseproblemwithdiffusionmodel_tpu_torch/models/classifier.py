"""ResNet-18 noise-robust classifier of the classifier-guided samplers.

Port of `BasicBlock` (:21), `ResNet18` (:45) and `ResNetClf` (:65) from
inverseproblemwithdiffusionmodel_tpu/models/classifier.py (reference:
ncsn/models/classifiers.py:5-23, a 1 -> 3 channel pre-conv in front of a
torchvision resnet18 with a fresh fc head). As in the JAX package, the
norms are GroupNorm(min(32, C)) where torchvision has BatchNorm, with
Flax's epsilon 1e-6. Submodules carry the Flax names (`pre_conv`,
`resnet.stem`, `resnet.stem_norm`, `resnet.stage{i}_block{j}.conv1` ...,
`resnet.fc`), so utils/convert.flax_to_torch_clf maps a Flax tree onto the
state dict. `forward` takes NCHW; models/registry.make_clf_fn adapts the
net to the channel-last tensors of the samplers and the training step.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, max_pool


def _norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, ch), ch, eps=1e-6)


class BasicBlock(nn.Module):
    """Two 3 x 3 convolutions with norms, the identity (or a strided 1 x 1
    convolution and a norm where the shape changes) added before the last
    ReLU."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_features, features, 3, stride=stride,
                          use_bias=False)
        self.norm1 = _norm(features)
        self.conv2 = Conv(features, features, 3, use_bias=False)
        self.norm2 = _norm(features)
        self.downsample = self.downsample_norm = None
        if stride != 1 or in_features != features:
            self.downsample = Conv(in_features, features, 1, stride=stride,
                                   padding=0, use_bias=False)
            self.downsample_norm = _norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        identity = x
        if self.downsample is not None:
            identity = self.downsample_norm(self.downsample(x))
        return F.relu(out + identity)


class ResNet18(nn.Module):
    """The 7 x 7 stride-2 stem, a 3 x 3 stride-2 max pool, four stages of
    two BasicBlocks (stride 2 at the first block of stages 1-3), the mean
    over H and W, a Dense head."""

    def __init__(self, num_classes: int, in_features: int = 3,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.stem = Conv(in_features, 64, 7, stride=2, padding=3,
                         use_bias=False)
        self.stem_norm = nn.GroupNorm(32, 64, eps=1e-6)
        self.blocks = []
        width = 64
        for i, (blocks, features) in enumerate(zip(stage_sizes, widths)):
            for j in range(blocks):
                stride = 2 if (j == 0 and i > 0) else 1
                name = f"stage{i}_block{j}"
                self.add_module(name, BasicBlock(width, features, stride))
                self.blocks.append(name)
                width = features
        self.fc = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.stem_norm(self.stem(x)))
        h = max_pool(h, window=3, stride=2, padding=1)
        for name in self.blocks:
            h = getattr(self, name)(h)
        return self.fc(h.mean(dim=(2, 3)))


class ResNetClf(nn.Module):
    """A 3 x 3 pre-conv to 3 channels, then the ResNet-18 trunk and a
    `config.Clf.num_cls` head (reference: classifiers.py:5-23). `config` is
    the general config (its Clf section); `in_channels` defaults to
    Clf.in_channels. x: (B, C, H, W) -> logits (B, num_cls)."""

    def __init__(self, config, in_channels: Optional[int] = None):
        super().__init__()
        self.config = config
        in_channels = in_channels or config.Clf.in_channels
        self.pre_conv = Conv(in_channels, 3, 3)
        self.resnet = ResNet18(num_classes=config.Clf.num_cls)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnet(self.pre_conv(x))
