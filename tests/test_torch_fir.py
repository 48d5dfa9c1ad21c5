"""The port's FIR resampling (ops/fir_kernels.py, ops/upfirdn2d.py) against
the JAX package's Pallas kernels (interpret mode) and XLA references.

The kernels' plain versions run here on the CPU; the CUDA kernels are held
against them on the card by the `gpu` test at the end and by chip_smoke.py.
Tolerance 1e-6: both sides compute the same few float32 multiply-adds per
output, in orders that differ by at most a rounding.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import inverseproblemwithdiffusionmodel_tpu.ops.pallas_kernels as pk
from inverseproblemwithdiffusionmodel_tpu.ops.upfirdn2d import (
    downsample_2d as jax_downsample_2d, upsample_2d as jax_upsample_2d,
    upfirdn2d as jax_upfirdn2d)
from inverseproblemwithdiffusionmodel_tpu_torch.ops import fir_kernels as fk
from inverseproblemwithdiffusionmodel_tpu_torch.ops import upfirdn2d as tu

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
KERNELS = [None, (1, 3, 3, 1), (1, 2, 1), (1, 1)]
GAINS = [1.0, 2.0]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("gain", GAINS)
def test_upsample2x_matches_pallas_and_xla(k, gain):
    x = _x((2, 8, 6, 3))
    out = fk.upsample2x(torch.from_numpy(x), k, gain)
    assert out.shape == (2, 16, 12, 3)
    _close(out, pk.upsample2x_pallas(jnp.asarray(x), k, gain))
    _close(out, jax_upsample_2d(jnp.asarray(x), k, 2, gain))
    _close(tu.upsample_2d(torch.from_numpy(x), k, 2, gain),
           jax_upsample_2d(jnp.asarray(x), k, 2, gain))


@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("gain", GAINS)
def test_downsample2x_matches_pallas_and_xla(k, gain):
    x = _x((2, 8, 6, 5), seed=1)
    out = fk.downsample2x(torch.from_numpy(x), k, gain)
    assert out.shape == (2, 4, 3, 5)
    _close(out, pk.downsample2x_pallas(jnp.asarray(x), k, gain))
    _close(out, jax_downsample_2d(jnp.asarray(x), k, 2, gain))
    _close(tu.downsample_2d(torch.from_numpy(x), k, 2, gain),
           jax_downsample_2d(jnp.asarray(x), k, 2, gain))


@pytest.mark.parametrize("shape,k", [
    ((2, 7, 5, 3), (1, 3, 3, 1)),      # odd H and W: general upfirdn2d
    ((1, 6, 9, 2), (1, 2, 1)),         # odd W only
    ((1, 8, 8, 2), np.outer([1, 3, 3, 1], [1, 3, 3, 1])),  # 2-D filter
    ((1, 8, 8, 2), (1, 4, 6, 4, 1)),   # 5 taps
])
def test_dispatchers_match_jax_on_shapes_the_kernels_do_not_take(shape, k):
    # The JAX dispatchers send these to upsample_2d / downsample_2d.
    x = _x(shape, seed=2)
    _close(fk.fir_upsample_2x(torch.from_numpy(x), k),
           jax_upsample_2d(jnp.asarray(x), k, 2))
    _close(fk.fir_downsample_2x(torch.from_numpy(x), k),
           jax_downsample_2d(jnp.asarray(x), k, 2))


@pytest.mark.parametrize("up,down,pad", [
    (2, 1, (2, 1)), (1, 2, (1, 1)), (3, 1, (0, 0)), (1, 1, (-1, 2, 1, -2)),
])
def test_upfirdn2d_matches_jax(up, down, pad):
    x = _x((2, 6, 7, 3), seed=3)
    k = np.random.RandomState(4).rand(3, 4).astype(np.float32)
    _close(tu.upfirdn2d(torch.from_numpy(x), k, up=up, down=down, pad=pad),
           jax_upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down,
                         pad=pad))


def test_dispatchers_route_by_the_jax_rule():
    even, odd = torch.zeros(1, 4, 4, 2), torch.zeros(1, 5, 4, 2)
    assert fk._takes_kernel(even, None)
    assert fk._takes_kernel(even, (1, 3, 3, 1))
    assert not fk._takes_kernel(odd, (1, 3, 3, 1))
    assert not fk._takes_kernel(even, (1, 4, 6, 4, 1))
    assert not fk._takes_kernel(even, np.ones((4, 4)))
    assert not fk._takes_kernel(torch.zeros(4, 4, 2), None)


def test_kernel_wrappers_validate_input():
    with pytest.raises(ValueError, match="even"):
        fk.downsample2x(torch.zeros(1, 5, 4, 2))
    with pytest.raises(ValueError, match="N, H, W, C"):
        fk.upsample2x(torch.zeros(4, 4, 2))
    with pytest.raises(ValueError, match="length"):
        fk.upsample2x(torch.zeros(1, 4, 4, 2), (1, 4, 6, 4, 1))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    fk.LAUNCHES.clear()
    fk.fir_upsample_2x(torch.zeros(1, 4, 4, 2), (1, 3, 3, 1))
    fk.fir_downsample_2x(torch.zeros(1, 4, 4, 2), (1, 3, 3, 1))
    assert sum(fk.LAUNCHES.values()) == 0


# (N, H, W, C) for the card tests: the main path's widths, C % 4 != 0
# (the kernels' scalar variant), C not a multiple of the 8 channel vectors
# a block takes (132), H != W, sizes that are no multiple of the 32-column
# tile or of the row chunk, R = 1 (up only), N = 1 and 3.
CARD_SHAPES = [(2, 64, 64, 128), (2, 8, 8, 3), (2, 4, 4, 256), (2, 6, 6, 5),
               (1, 6, 10, 6), (3, 10, 6, 12), (1, 2, 2, 132),
               (3, 34, 66, 132), (1, 70, 2, 8), (3, 12, 36, 3)]
UP_ONLY_SHAPES = [(1, 1, 1, 4), (3, 1, 5, 3), (1, 7, 3, 12)]


def card_close(out, ref):
    """The kernel's output against its plain version: within 1e-5 of the
    largest |value| (float32 sums in another order, fused multiply-adds)."""
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator().manual_seed(0)
    for shape in CARD_SHAPES + UP_ONLY_SHAPES:
        x = torch.randn(*shape, generator=gen).cuda()
        for k in KERNELS:
            for gain in GAINS:
                fk.LAUNCHES.clear()
                card_close(fk.upsample2x(x, k, gain), fk.upsample2x_plain(
                    x, fk._sep_kernel_1d(k, 2.0 * gain ** 0.5)))
                if shape in UP_ONLY_SHAPES:
                    assert fk.LAUNCHES == {"up2x": 1}
                    continue
                card_close(fk.downsample2x(x, k, gain),
                           fk.downsample2x_plain(
                               x, fk._sep_kernel_1d(k, gain ** 0.5)))
                assert fk.LAUNCHES == {"up2x": 1, "down2x": 1}


@pytest.mark.gpu
def test_cuda_kernels_take_unaligned_tensors():
    # A view 4 bytes into its storage: C % 4 == 0, but the float4 loads
    # would be misaligned, so the launcher picks the scalar variant.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator().manual_seed(1)
    for N, H, W, C in [(2, 8, 8, 128), (1, 6, 10, 12)]:
        flat = torch.randn(N * H * W * C + 1, generator=gen).cuda()
        x = flat[1:].view(N, H, W, C)
        assert x.data_ptr() % 16 != 0
        card_close(fk.upsample2x(x, (1, 3, 3, 1)),
                   fk.upsample2x_plain(x, fk._sep_kernel_1d((1, 3, 3, 1),
                                                            2.0)))
        card_close(fk.downsample2x(x, (1, 3, 3, 1)),
                   fk.downsample2x_plain(x, fk._sep_kernel_1d((1, 3, 3, 1),
                                                              1.0)))
