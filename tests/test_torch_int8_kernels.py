"""K5-K7 (ops/int8_kernels.py, ops/csrc/int8conv.cu) and their plain
versions, in the port alone: this file imports no jax, so it also runs on
the GPU machine, where the `gpu` test holds each kernel to its plain
version bit for bit (python -m pytest tests/test_torch_int8_kernels.py -m
gpu). On the CPU the kernels' plain versions, chained as int8_conv chains
them, equal the whole op's plain version at the score nets' geometries,
and a tensor on any other device than the CPU is refused, never run on
the plain version. tests/test_torch_int8.py holds both to JAX.
"""
import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.models import layers
from inverseproblemwithdiffusionmodel_tpu_torch.ops import (
    int8_kernels as ik, quant)

torch.set_num_threads(1)

# (N, C, spatial, O, kernel size, dilation, pre_pad, ndim): the score
# nets' geometries at small widths, C and O off the kernel's tile sizes
CASES = [(2, 40, (9, 9), 16, 3, 1, None, 2),
         (2, 40, (9, 9), 70, 3, 2, None, 2),
         (3, 33, (7, 11), 65, 3, 4, None, 2),
         (2, 40, (9, 9), 16, 1, 1, (1, 0), 2),
         (2, 16, (14, 14), 16, 3, 1, (1, 0), 2),
         (2, 1, (16, 16), 24, 3, 1, None, 2),
         (2, 24, (16, 16), 1, 3, 1, None, 2),
         (9, 64, (24,), 32, 3, 1, None, 1),
         (9, 16, (12,), 16, 3, 4, None, 1),
         (9, 64, (24,), 16, 1, 1, None, 1)]


def _inputs(case, dtype, device="cpu", seed=0):
    N, C, spatial, O, k, dil, pre, ndim = case
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((N, C) + spatial, generator=gen) * 3).to(device, dtype)
    w = torch.randn((O, C) + (k,) * ndim, generator=gen).to(device, dtype)
    return x, w, dict(padding=(k // 2) * dil, dilation=dil, ndim=ndim,
                      pre_pad=pre)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(
    CASES))])
def test_plain_chain_equals_the_whole_op(case, dtype):
    """absmax -> quantize_s8 -> conv_s8s8s32 (channels-last codes padded
    to 32 channels, K7's weight layout) equals int8_conv_plain bit for
    bit, and launches nothing on the CPU."""
    x, w, kw = _inputs(case, dtype)
    ik.LAUNCHES.clear()
    out = quant.int8_conv(x, w, **kw)
    assert torch.equal(out, quant.int8_conv_plain(x, w, **kw))
    assert out.dtype == dtype and not ik.LAUNCHES
    qw = quant.QuantWeight.of(w)
    assert qw.kernel.shape[-1] % 32 == 0 and qw.kernel.is_contiguous()
    assert not qw.kernel[..., w.shape[1]:].any()


def test_sums_are_exact_past_float32():
    """127 x 127 x 1152 = 18.6 M > 2^24: the float64 plain convolution
    keeps every integer, where a float32 sum would round."""
    g = ik.ConvGeometry(N=1, C=128, H=3, W=3, O=1, KH=3, KW=3, pad_h=0,
                        pad_h_hi=0, pad_w=0, pad_w_hi=0, dil=1)
    codes = torch.full((1, 3, 3, 128), 127, dtype=torch.int8)
    codes[0, 0, 0, 0] = 126
    kernel = torch.full((1, 3, 3, 128), 127, dtype=torch.int8)
    one = torch.ones(1)
    _, sums = ik.conv_s8s8s32(codes, one, kernel, one, g, torch.float32,
                              with_sums=True)
    assert sums.item() == 127 * 127 * 1152 - 127
    assert float(np.float32(sums.item())) != sums.item()


def test_other_devices_are_refused_not_run_plain():
    """A tensor on another device than the CPU (meta here) gets no plain
    fall-back: a geometry K7 does not take raises NotImplementedError
    naming it, and the kernels' wrappers refuse what they cannot launch."""
    x, w, kw = _inputs(CASES[0], torch.float32, device="meta")
    for extra, what in ((dict(stride=2), "stride 2"),
                        (dict(dilation=3, padding=3), "dilation 3")):
        with pytest.raises(NotImplementedError, match=what):
            quant.int8_conv(x, w, **{**kw, **extra})
    with pytest.raises(NotImplementedError, match="kernel size"):
        quant.int8_conv(x, torch.zeros(4, 40, 5, 5, device="meta"),
                        padding=2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ik.absmax(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ik.absmax(x.to(torch.float16))
    qw = quant.QuantWeight.of(torch.ones(w.shape))
    assert quant.kernel_refusal(x, qw, 1, 2, 2) is None


def test_enable_int8_switches_every_conv_once():
    net = torch.nn.Sequential(layers.Conv(3, 8, 3), torch.nn.ELU(),
                              layers.Conv(8, 4, 1, use_bias=False))
    x = torch.randn(2, 3, 8, 8)
    with torch.no_grad():
        ref = net(x)
        quant.enable_int8(net)
        out = net(x)
    convs = [m for m in net if isinstance(m, layers.Conv)]
    assert all(m.quant is not None for m in convs)
    assert not torch.equal(out, ref)
    assert ((out - ref).norm() / ref.norm()).item() < 0.05
    assert set(dict(net.named_parameters())) == {"0.weight", "0.bias",
                                                 "2.weight"}


@pytest.mark.gpu
def test_cuda_kernels_equal_their_plain_versions():
    """K5, K6 and K7 on the card against their plain versions, bit for
    bit (amax, scale, codes, int32 sums, dequantized output), float32 and
    bf16, one launch of each per int8_conv."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for case in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, kw = _inputs(case, dtype, device="cuda")
            qw = quant.QuantWeight.of(w)
            g = quant.geometry(x, qw, kw["padding"], kw["dilation"],
                               kw["ndim"], kw["pre_pad"])
            amax = ik.absmax(x)
            codes, sx = ik.quantize_s8(x, amax, g.Cp)
            codes = codes.reshape(g.N, g.H, g.W, g.Cp)
            out, sums = ik.conv_s8s8s32(codes, sx, qw.kernel, qw.scale, g,
                                        dtype, with_sums=True)
            amax_p = ik.absmax_plain(x)
            codes_p, sx_p = ik.quantize_s8_plain(x, amax_p, g.Cp)
            out_p, sums_p = ik.conv_s8s8s32_plain(
                codes_p.reshape(codes.shape), sx_p, qw.kernel, qw.scale, g,
                dtype, with_sums=True)
            assert torch.equal(amax, amax_p) and torch.equal(sx, sx_p)
            assert torch.equal(codes, codes_p.reshape(codes.shape))
            assert torch.equal(sums, sums_p)
            assert torch.equal(out, out_p)
            ik.LAUNCHES.clear()
            whole = quant.int8_conv(x, qw, **kw)
            torch.cuda.synchronize()
            assert dict(ik.LAUNCHES) == {"absmax": 1, "quantize_s8": 1,
                                         "conv_s8s8s32": 1}
            assert torch.equal(whole, quant.int8_conv_plain(x, qw, **kw))
