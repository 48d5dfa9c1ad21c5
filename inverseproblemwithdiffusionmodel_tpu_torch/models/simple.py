"""A small time-conditioned score UNet for tutorials and smoke tests.

Port of inverseproblemwithdiffusionmodel_tpu/models/simple.py (reference:
models/simple_model.py:9-130): a Gaussian Fourier embedding of t, a
4-level conv encoder and decoder with Dense time injections and GroupNorm,
the output divided by the marginal std of p_t.

Like the port's NCSN++ it takes channel-last x (B, H, W, C), as the
continuous stack's score function hands it over, and runs NCHW inside.
The JAX net's Flax layers are matched exactly: `nn.Conv` with 'SAME'
padding (for stride 2 the extra row and column go on the high side), and
`nn.ConvTranspose` with 'SAME' padding and an unflipped kernel (a
correlation of the zero-dilated input, padded (2, 1) at stride 2: torch's
conv_transpose2d with padding 0, its last row and column dropped, on the
kernel flipped by utils/convert.flax_to_torch_scorenet). GroupNorm eps is
Flax's 1e-6 (torch's default is 1e-5). Submodules carry the Flax names.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layerspp import GaussianFourierProjection


def _same_pad(n: int, k: int, s: int) -> tuple:
    """Flax 'SAME' padding (lo, hi) of one axis of size n."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class FlaxConv(nn.Module):
    """Flax `nn.Conv` with 'SAME' padding and no bias: weight (O, I, k,
    k)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        self.k, self.stride = kernel_size, stride
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               kernel_size, kernel_size))
        self.bias = None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h0, h1), (w0, w1) = (_same_pad(n, self.k, self.stride)
                              for n in x.shape[2:])
        return F.conv2d(F.pad(x, (w0, w1, h0, h1)), self.weight,
                        stride=self.stride)


class FlaxConvTranspose(nn.Module):
    """Flax `nn.ConvTranspose` with 'SAME' padding (out = in * stride):
    weight (I, O, k, k), torch's conv_transpose2d layout, holding the Flax
    kernel flipped."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, use_bias: bool = False):
        super().__init__()
        self.k, self.stride = kernel_size, stride
        self.weight = nn.Parameter(torch.empty(in_features, features,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.k, self.stride
        # lax.conv_transpose's 'SAME' pads the dilated input (lo, hi) with
        # hi <= lo here (k 3, s 1 or 2): pad lo on both sides, then crop
        lo = k - 1 if s > k - 1 else math.ceil((k + s - 2) / 2)
        out = F.conv_transpose2d(x, self.weight, self.bias, s, k - 1 - lo)
        H, W = (n * s for n in x.shape[2:])
        return out[..., :H, :W]


class ScoreNet(nn.Module):
    """Simple score model s(x, t) (reference: models/simple_model.py:
    25-130). `marginal_prob_std`: t (B,) -> the std of p_t (B,), e.g. a VE
    SDE's sigma(t). x (B, H, W, C) channel-last, H and W divisible by 8;
    returns the score channel-last."""

    def __init__(self, marginal_prob_std: Callable[[torch.Tensor],
                                                   torch.Tensor],
                 channels: Sequence[int] = (32, 64, 128, 256),
                 embed_dim: int = 256, in_channels: int = 1):
        super().__init__()
        self.marginal_prob_std = marginal_prob_std
        c1, c2, c3, c4 = channels
        self.embed = GaussianFourierProjection(embed_dim // 2)
        self.embed_dense = nn.Linear(embed_dim, embed_dim)
        self.conv1 = FlaxConv(in_channels, c1)
        self.conv2 = FlaxConv(c1, c2, stride=2)
        self.conv3 = FlaxConv(c2, c3, stride=2)
        self.conv4 = FlaxConv(c3, c4, stride=2)
        self.tconv4 = FlaxConvTranspose(c4, c3, stride=2)
        self.tconv3 = FlaxConvTranspose(2 * c3, c2, stride=2)
        self.tconv2 = FlaxConvTranspose(2 * c2, c1, stride=2)
        self.tconv1 = FlaxConvTranspose(2 * c1, in_channels, use_bias=True)
        for name, c, groups in (("1", c1, 4), ("2", c2, None),
                                ("3", c3, None), ("4", c4, None)):
            self.add_module(f"d{name}", nn.Linear(embed_dim, c))
            self.add_module(f"gn{name}", nn.GroupNorm(groups or min(32, c),
                                                      c, eps=1e-6))
        for name, c in (("4", c3), ("3", c2), ("2", c1)):
            self.add_module(f"td{name}", nn.Linear(embed_dim, c))
            self.add_module(f"tgn{name}", nn.GroupNorm(min(32, c), c,
                                                       eps=1e-6))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        act = F.silu
        embed = act(self.embed_dense(self.embed(t)))

        def inject(h, dense, gn):
            return act(gn(h + dense(embed)[:, :, None, None]))

        h1 = inject(self.conv1(x.movedim(-1, 1)), self.d1, self.gn1)
        h2 = inject(self.conv2(h1), self.d2, self.gn2)
        h3 = inject(self.conv3(h2), self.d3, self.gn3)
        h4 = inject(self.conv4(h3), self.d4, self.gn4)
        h = inject(self.tconv4(h4), self.td4, self.tgn4)
        h = inject(self.tconv3(torch.cat([h, h3], 1)), self.td3, self.tgn3)
        h = inject(self.tconv2(torch.cat([h, h2], 1)), self.td2, self.tgn2)
        h = self.tconv1(torch.cat([h, h1], 1))
        std = self.marginal_prob_std(t)
        return (h / std.reshape(-1, 1, 1, 1)).movedim(1, -1)
