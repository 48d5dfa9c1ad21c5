"""The K3 backward of the port (ops/fir_kernels.py): the transpose rule of
its autograd Functions, and gradients against the JAX dispatchers.

Both FIR passes are linear, so their backward is their exact transpose,
which the port computes by the other direction's pass with the taps
reversed. Here on the CPU that backward runs the plain versions; the CUDA
kernels are held against them on the card by the `gpu` test at the end and
by chip_smoke.py. The dot-product identity runs in float64, where it holds
to rounding (rtol 1e-12). Gradients against jax.grad of the JAX
dispatchers, whose Pallas forward runs in interpret mode and whose backward
is jax.linear_transpose of the XLA form, are float32 at 1e-5: the same few
multiply-adds per element in another order, behind a sin().
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import inverseproblemwithdiffusionmodel_tpu.ops.pallas_kernels as pk
from inverseproblemwithdiffusionmodel_tpu_torch.ops import fir_kernels as fk

torch.set_num_threads(1)

KERNELS = [None, (1, 3, 3, 1), (1, 2, 1), (1, 1)]
GAINS = [1.0, 2.0]
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _x(shape, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _ops(direction):
    if direction == "up":
        return fk.upsample2x, (2, 8, 6, 3), (2, 16, 12, 3)
    return fk.downsample2x, (2, 8, 6, 3), (2, 4, 3, 3)


@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("gain", GAINS)
def test_backward_is_the_exact_transpose(direction, k, gain):
    # <A x, y> = <x, A^T y>, with A^T y from the Function's backward.
    op, in_shape, out_shape = _ops(direction)
    x = torch.from_numpy(_x(in_shape, 1, np.float64)).requires_grad_()
    y = torch.from_numpy(_x(out_shape, 2, np.float64))
    ax = op(x, k, gain)
    (aty,) = torch.autograd.grad(ax, x, y)
    lhs = float((ax.detach() * y).sum())
    rhs = float((x.detach() * aty).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("k", KERNELS)
def test_transpose_is_the_other_pass_with_reversed_taps(k):
    # The rule the CUDA backward relies on, stated on the plain versions:
    # up's taps keep their 2 sqrt(gain) scale, reversed, in a down pass.
    x = torch.from_numpy(_x((1, 6, 4, 2), 3, np.float64)).requires_grad_()
    up_taps = fk._sep_kernel_1d(k, 2.0)
    g_up = torch.from_numpy(_x((1, 12, 8, 2), 4, np.float64))
    (dx,) = torch.autograd.grad(fk.upsample2x_plain(x, up_taps), x, g_up)
    torch.testing.assert_close(
        dx, fk.downsample2x_plain(g_up, up_taps[::-1].copy()),
        rtol=1e-12, atol=1e-12)
    down_taps = fk._sep_kernel_1d(k, 1.0)
    g_dn = torch.from_numpy(_x((1, 3, 2, 2), 5, np.float64))
    (dx,) = torch.autograd.grad(fk.downsample2x_plain(x, down_taps), x, g_dn)
    torch.testing.assert_close(
        dx, fk.upsample2x_plain(g_dn, down_taps[::-1].copy()),
        rtol=1e-12, atol=1e-12)


def _port_grad(fn, x, k, gain=1.0):
    xt = torch.from_numpy(x).requires_grad_()
    torch.sin(fn(xt, k, gain)).sum().backward()
    return xt.grad.numpy()


def _jax_grad(fn, x, k, gain=1.0):
    return np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.sin(fn(v, k, gain))))(jnp.asarray(x)))


@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("gain", GAINS)
def test_dispatcher_gradients_match_jax(k, gain):
    # mirrors tests/test_pallas_kernels.py:67-88 for the port's dispatchers
    x = _x((2, 8, 8, 4), 6)
    np.testing.assert_allclose(
        _port_grad(fk.fir_upsample_2x, x, k, gain),
        _jax_grad(pk.fir_upsample_2x, x, k, gain), **GRAD_TOL)
    np.testing.assert_allclose(
        _port_grad(fk.fir_downsample_2x, x, k, gain),
        _jax_grad(pk.fir_downsample_2x, x, k, gain), **GRAD_TOL)


@pytest.mark.parametrize("shape,k", [
    ((2, 7, 5, 3), (1, 3, 3, 1)),      # odd H and W: general upfirdn2d
    ((1, 8, 8, 2), (1, 4, 6, 4, 1)),   # 5 taps
])
def test_plain_branch_gradients_match_jax(shape, k):
    x = _x(shape, 7)
    np.testing.assert_allclose(_port_grad(fk.fir_upsample_2x, x, k),
                               _jax_grad(pk.fir_upsample_2x, x, k),
                               **GRAD_TOL)
    np.testing.assert_allclose(_port_grad(fk.fir_downsample_2x, x, k),
                               _jax_grad(pk.fir_downsample_2x, x, k),
                               **GRAD_TOL)


def test_backward_accepts_strided_gradients_and_is_differentiable():
    x = torch.from_numpy(_x((1, 4, 4, 3), 8, np.float64)).requires_grad_()
    # a permuted (non-contiguous) upstream gradient
    y = fk.upsample2x(x, (1, 3, 3, 1)).permute(0, 3, 1, 2)
    (gx,) = torch.autograd.grad((y ** 2).sum(), x, create_graph=True)
    assert torch.autograd.gradgradcheck(
        lambda v: fk.downsample2x(v, (1, 3, 3, 1)), (x,))
    (ggx,) = torch.autograd.grad(gx.sum(), x)
    assert torch.isfinite(ggx).all()


def test_cpu_backward_launches_nothing_and_routes_by_direction(monkeypatch):
    seen = []

    def spy(fn):
        return lambda x, taps, tag: seen.append(tag) or fn(x, taps, tag)

    monkeypatch.setattr(fk, "_up", spy(fk._up))
    monkeypatch.setattr(fk, "_down", spy(fk._down))
    fk.LAUNCHES.clear()
    x = torch.zeros(1, 4, 4, 2, requires_grad=True)
    fk.fir_downsample_2x(fk.fir_upsample_2x(x)).sum().backward()
    assert seen == ["up2x", "down2x", "up2x.bwd", "down2x.bwd"]
    assert sum(fk.LAUNCHES.values()) == 0


@pytest.mark.gpu
def test_cuda_backward_matches_plain_transpose():
    # The kernels on reversed taps through the autograd Functions, at the
    # edges of their tiling (test_torch_fir.CARD_SHAPES).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from test_torch_fir import CARD_SHAPES, card_close
    gen = torch.Generator().manual_seed(0)
    for N, H, W, C in CARD_SHAPES:
        for k in KERNELS:
            for gain in GAINS:
                x = torch.randn(N, H, W, C, generator=gen).cuda()
                x.requires_grad_()
                g_up = torch.randn(N, 2 * H, 2 * W, C, generator=gen).cuda()
                g_dn = torch.randn(N, H // 2, W // 2, C,
                                   generator=gen).cuda()
                fk.LAUNCHES.clear()
                (dx_up,) = torch.autograd.grad(fk.upsample2x(x, k, gain), x,
                                               g_up)
                (dx_dn,) = torch.autograd.grad(fk.downsample2x(x, k, gain),
                                               x, g_dn)
                torch.cuda.synchronize()
                assert fk.LAUNCHES == {"up2x": 1, "down2x": 1,
                                       "up2x.bwd": 1, "down2x.bwd": 1}
                up_taps = fk._sep_kernel_1d(k, 2.0 * gain ** 0.5)
                dn_taps = fk._sep_kernel_1d(k, gain ** 0.5)
                card_close(dx_up, fk.downsample2x_plain(
                    g_up, up_taps[::-1].copy()))
                card_close(dx_dn, fk.upsample2x_plain(
                    g_dn, dn_taps[::-1].copy()))
