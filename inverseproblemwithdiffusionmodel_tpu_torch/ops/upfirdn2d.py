"""upfirdn2d (upsample -> FIR filter -> downsample) in plain PyTorch.

Port of inverseproblemwithdiffusionmodel_tpu/ops/upfirdn2d.py. These are the
plain versions behind the FIR kernels (ops/fir_kernels.py), the general
path the dispatchers take for shapes or filters the kernels do not handle,
and the resamplers that fuse a convolution (`upsample_conv_2d`,
`conv_downsample_2d`), which the JAX package leaves to XLA.

Arrays are channel-last, as in the JAX package: x (N, H, W, C); filter
k (kh, kw), applied to each channel.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def _setup_kernel(k) -> np.ndarray:
    """Normalise a FIR filter; a 1-D filter becomes its separable outer
    product."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    if not (k.ndim == 2 and k.shape[0] == k.shape[1]):
        raise ValueError(f"FIR filter must be square, got shape {k.shape}")
    return k


def upfirdn2d(x: torch.Tensor, kernel, up: Union[int, Tuple[int, int]] = 1,
              down: Union[int, Tuple[int, int]] = 1,
              pad: Sequence[int] = (0, 0)) -> torch.Tensor:
    """Zero-insert by `up`, pad, convolve with `kernel`, keep every
    `down`-th sample. pad is (p0, p1) for both axes or (px0, px1, py0, py1);
    a negative pad crops. out_h = (H * up + py0 + py1 - kh) // down + 1.

    The filter is flipped: this is a true convolution, as in the reference.
    """
    up_y, up_x = (up, up) if isinstance(up, int) else up
    down_y, down_x = (down, down) if isinstance(down, int) else down
    if len(pad) == 2:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad[0], pad[1], pad[0], pad[1]
    else:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad

    N, H, W, C = x.shape
    k = torch.as_tensor(np.asarray(kernel), dtype=x.dtype, device=x.device)
    kh, kw = k.shape
    t = x.permute(0, 3, 1, 2)                                  # N C H W
    if up_y > 1 or up_x > 1:
        t = t.reshape(N, C, H, 1, W, 1)
        t = F.pad(t, [0, up_x - 1, 0, 0, 0, up_y - 1])
        t = t.reshape(N, C, H * up_y, W * up_x)
    t = F.pad(t, [max(pad_x0, 0), max(pad_x1, 0),
                  max(pad_y0, 0), max(pad_y1, 0)])
    t = t[:, :, max(-pad_y0, 0):t.shape[2] - max(-pad_y1, 0),
          max(-pad_x0, 0):t.shape[3] - max(-pad_x1, 0)]
    w = torch.flip(k, (0, 1)).expand(C, 1, kh, kw).contiguous()
    out = F.conv2d(t, w, stride=(down_y, down_x), groups=C)
    return out.permute(0, 2, 3, 1).contiguous()


def upsample_2d(x: torch.Tensor, k: Optional[Sequence[float]] = None,
                factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR upsampling, (N, H, W, C) -> (N, factor H, factor W, C)."""
    if not (isinstance(factor, int) and factor >= 1):
        raise ValueError(f"factor must be a positive int, got {factor!r}")
    kern = _setup_kernel([1.0] * factor if k is None else k) \
        * (gain * factor ** 2)
    p = kern.shape[0] - factor
    return upfirdn2d(x, kern, up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k: Optional[Sequence[float]] = None,
                  factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR downsampling, (N, H, W, C) -> (N, H / factor, W / factor, C)."""
    if not (isinstance(factor, int) and factor >= 1):
        raise ValueError(f"factor must be a positive int, got {factor!r}")
    kern = _setup_kernel([1.0] * factor if k is None else k) * gain
    p = kern.shape[0] - factor
    return upfirdn2d(x, kern, down=factor, pad=((p + 1) // 2, p // 2))


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor,
                     k: Optional[Sequence[float]] = None, factor: int = 2,
                     gain: float = 1.0) -> torch.Tensor:
    """Fused 2x transposed-conv upsample + FIR (N, H, W, C_in) ->
    (N, factor H, factor W, C_out); w is (kh, kw, C_in, C_out), HWIO.

    The JAX package correlates w with the zero-dilated, fully padded input
    in one XLA convolution; conv_transpose2d with w flipped computes the
    same. Plain PyTorch on every device: this path reaches no kernel.
    """
    if not (isinstance(factor, int) and factor >= 1):
        raise ValueError(f"factor must be a positive int, got {factor!r}")
    kh, kw = w.shape[0], w.shape[1]
    if kh != kw:
        raise ValueError(f"conv kernel must be square, got {kh}x{kw}")
    kern = _setup_kernel([1.0] * factor if k is None else k) \
        * (gain * factor ** 2)
    p = (kern.shape[0] - factor) - (kw - 1)
    weight = torch.flip(w.permute(2, 3, 0, 1), (2, 3))       # I O kh kw
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, stride=factor)
    return upfirdn2d(out.permute(0, 2, 3, 1), kern,
                     pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor,
                       k: Optional[Sequence[float]] = None, factor: int = 2,
                       gain: float = 1.0) -> torch.Tensor:
    """Fused FIR + strided-conv downsample (N, H, W, C_in) ->
    (N, H / factor, W / factor, C_out); w is (kh, kw, C_in, C_out), HWIO.
    Plain PyTorch on every device, as the JAX package leaves it to XLA."""
    if not (isinstance(factor, int) and factor >= 1):
        raise ValueError(f"factor must be a positive int, got {factor!r}")
    kh, kw = w.shape[0], w.shape[1]
    if kh != kw:
        raise ValueError(f"conv kernel must be square, got {kh}x{kw}")
    kern = _setup_kernel([1.0] * factor if k is None else k) * gain
    p = (kern.shape[0] - factor) + (kw - 1)
    x = upfirdn2d(x, kern, pad=((p + 1) // 2, p // 2))
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=factor)
    return out.permute(0, 2, 3, 1).contiguous()
