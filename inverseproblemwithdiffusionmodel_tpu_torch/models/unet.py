"""Encoder-decoder UNet, rank-generic (NCT, NCHW or NCDHW).

Port of `PReLU` and `UNet` from inverseproblemwithdiffusionmodel_tpu/
models/unet.py, the reference's MONAI UNet with num_res_units=0: the
segmentation net (2-D, helpers/load_model.py:28-31) and the body of the
1-D score net UNET1D (models/ncsn1d.py). Strided convolutions down, transposed
convolutions up with the skip concatenated before each, instance norm and
PReLU after every layer but the last. Submodules carry the Flax names
(`down_{i}`, `prelu_down_{i}`, `bottom`, `prelu_bottom`, `up_{i}`,
`prelu_up_{i}`), so utils/convert.flax_to_torch_unet maps a Flax tree onto
the state dict. `forward` takes channels first; models/registry.
make_seg_fn adapts the seg net to the channel-last tensors of the
samplers. A map of one element normalizes to zeros, as in the JAX norm.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .layers import Conv, ConvTranspose
from .normalization import _instance_norm


class PReLU(nn.Module):
    """PReLU with one learned slope shared by all channels (torch's and
    MONAI's default, initial value 0.25)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class UNet(nn.Module):
    def __init__(self, out_channels: int,
                 features: Sequence[int] = (64, 128, 256, 512, 1024),
                 strides: Sequence[int] = (2, 2, 2, 2),
                 in_channels: int = 1, norm: Optional[str] = "instance",
                 kernel_size: int = 3, ndim: int = 2):
        super().__init__()
        if len(features) != len(strides) + 1:
            raise ValueError(f"{len(features)} features need "
                             f"{len(features) - 1} strides, got {strides}")
        self.norm = norm
        self.n_levels = len(strides)
        k = kernel_size
        width = in_channels
        skips = []
        for i, (f, s) in enumerate(zip(features[:-1], strides)):
            self.add_module(f"down_{i}", Conv(width, f, k, stride=s,
                                              ndim=ndim))
            self.add_module(f"prelu_down_{i}", PReLU())
            width = f
            skips.append(f)
        self.bottom = Conv(width, features[-1], k, ndim=ndim)
        self.prelu_bottom = PReLU()
        width = features[-1]
        for i, (f, s) in enumerate(zip(reversed(features[:-1]),
                                       reversed(strides))):
            last = i == len(strides) - 1
            out = out_channels if last else f
            self.add_module(f"up_{i}", ConvTranspose(
                width + skips[-(i + 1)], out, k, stride=s, padding=k // 2,
                output_padding=s - 1, ndim=ndim))
            if not last:
                self.add_module(f"prelu_up_{i}", PReLU())
            width = out

    def _act_norm(self, h: torch.Tensor, name: str) -> torch.Tensor:
        if self.norm == "instance":
            h = _instance_norm(h)
        return getattr(self, f"prelu_{name}")(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        h = x
        for i in range(self.n_levels):
            h = self._act_norm(getattr(self, f"down_{i}")(h), f"down_{i}")
            skips.append(h)
        h = self._act_norm(self.bottom(h), "bottom")
        for i in range(self.n_levels):
            h = torch.cat([h, skips[-(i + 1)]], dim=1)
            h = getattr(self, f"up_{i}")(h)
            if i < self.n_levels - 1:
                h = self._act_norm(h, f"up_{i}")
        return h
