"""The port's fused bias + leaky ReLU (K4: ops/flr_kernels.py, its plain
version ops/fused_act.py) against the JAX package's Pallas kernel in
interpret mode and its XLA form, mirroring tests/test_pallas_kernels.py:18-42.

Here on the CPU the kernel wrapper runs its plain versions; the CUDA kernels
are held against them on the card by the `gpu` test at the end and by
chip_smoke.py. Forward at rtol 1e-6 (one add and two multiplies per
element); dx at rtol 1e-5 and db, a sum over rows in another order, at
rtol 1e-5 / atol 1e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import inverseproblemwithdiffusionmodel_tpu.ops.pallas_kernels as pk
from inverseproblemwithdiffusionmodel_tpu.ops.fused_act import (
    fused_leaky_relu as jax_fused_leaky_relu)
from inverseproblemwithdiffusionmodel_tpu_torch.ops import flr_kernels as fl
from inverseproblemwithdiffusionmodel_tpu_torch.ops.fused_act import (
    fused_leaky_relu)

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(4, 8, 8, 16), (2, 4, 4, 8), (7, 5, 5, 3), (6, 12)]
PARAMS = [(0.2, 2 ** 0.5), (0.1, 1.0)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(shape[-1]).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("slope,scale", PARAMS)
def test_forward_matches_pallas_and_xla(shape, slope, scale):
    x, b = _inputs(shape)
    out = fl.fused_leaky_relu_kernel(torch.from_numpy(x), torch.from_numpy(b),
                                     slope, scale).numpy()
    ref = np.asarray(pk.fused_leaky_relu_pallas(jnp.asarray(x),
                                                jnp.asarray(b), slope, scale))
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    np.testing.assert_allclose(
        out, np.asarray(jax_fused_leaky_relu(jnp.asarray(x), jnp.asarray(b),
                                             slope, scale)), **FWD_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("slope,scale", PARAMS)
def test_gradients_match_pallas_vjp(shape, slope, scale):
    x, b = _inputs(shape, seed=1)
    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    (fl.fused_leaky_relu_kernel(xt, bt, slope, scale) ** 2).sum().backward()
    gx, gb = jax.grad(
        lambda v, c: jnp.sum(pk.fused_leaky_relu_pallas(v, c, slope,
                                                        scale) ** 2),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), **GRAD_TOL)


def test_plain_version_matches_jax_with_and_without_bias():
    x, b = _inputs((3, 5, 7), seed=2)
    for bias in (b, None):
        out = fused_leaky_relu(torch.from_numpy(x), None if bias is None
                               else torch.from_numpy(bias))
        ref = jax_fused_leaky_relu(jnp.asarray(x), None if bias is None
                                   else jnp.asarray(bias))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


def test_backward_plain_version_is_the_vjp_of_the_forward():
    x, b = _inputs((5, 6), seed=3)
    g = np.random.RandomState(4).randn(5, 6).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (dx,) = torch.autograd.grad(fused_leaky_relu(xt, torch.from_numpy(b)),
                                xt, torch.from_numpy(g))
    torch.testing.assert_close(fl.fused_leaky_relu_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(g), 0.2,
        2 ** 0.5), dx, rtol=1e-6, atol=1e-6)


def test_wrapper_validates_input_and_launches_nothing_on_the_cpu():
    fl.LAUNCHES.clear()
    with pytest.raises(ValueError, match="shape"):
        fl.fused_leaky_relu_kernel(torch.zeros(2, 4), torch.zeros(3))
    with pytest.raises(TypeError, match="float32"):
        fl.fused_leaky_relu_kernel(torch.zeros(2, 4, dtype=torch.float64),
                                   torch.zeros(4, dtype=torch.float64))
    x = torch.zeros(2, 4, requires_grad=True)
    fl.fused_leaky_relu_kernel(x, torch.zeros(4)).sum().backward()
    assert sum(fl.LAUNCHES.values()) == 0


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator().manual_seed(0)
    for shape in [(2 * 64 * 64, 128), (2 * 16 * 16, 256), (7 * 5 * 5, 3),
                  (3, 4, 5, 12)]:
        x = torch.randn(*shape, generator=gen).cuda().requires_grad_()
        b = torch.randn(shape[-1], generator=gen).cuda().requires_grad_()
        g = torch.randn(*shape, generator=gen).cuda()
        fl.LAUNCHES.clear()
        y = fl.fused_leaky_relu_kernel(x, b)
        dx, db = torch.autograd.grad(y, (x, b), g)
        torch.cuda.synchronize()
        assert fl.LAUNCHES == {"flr_fwd": 1, "flr_bwd": 1}
        xd, bd = x.detach(), b.detach()
        torch.testing.assert_close(y, fused_leaky_relu(xd, bd), rtol=1e-6,
                                   atol=1e-6)
        ref_dx = fl.fused_leaky_relu_bwd_plain(xd, bd, g, 0.2, 2 ** 0.5)
        torch.testing.assert_close(dx, ref_dx, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(db, ref_dx.reshape(-1, shape[-1]).sum(0),
                                   rtol=1e-5, atol=1e-5)


# -- bf16 -------------------------------------------------------------------
# The port's bf16 forms compute in float32 and round once; the Pallas kernel
# computes in bf16 (x + b, slope * v and scale * ... each rounded). The two
# agree within 1 bf16 ulp of the largest |value|; db, a sum over rows of
# the rounded dx in another order, within 2.

def _bf16_ulp(ref: np.ndarray) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _bf16(a: np.ndarray):
    """(the torch bf16 tensor, the jnp bf16 array) of the same values."""
    t = torch.from_numpy(a).bfloat16()
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("slope,scale", PARAMS)
def test_bf16_forward_and_gradients_hold_to_pallas(shape, slope, scale):
    x, b = _inputs(shape, seed=5)
    g = np.random.RandomState(6).randn(*shape).astype(np.float32)
    (xt, xj), (bt, bj), (gt, gj) = _bf16(x), _bf16(b), _bf16(g)
    xt.requires_grad_()
    bt.requires_grad_()
    y = fl.fused_leaky_relu_kernel(xt, bt, slope, scale)
    dx, db = torch.autograd.grad(y, (xt, bt), gt)
    assert y.dtype == dx.dtype == db.dtype == torch.bfloat16
    y_j, vjp = jax.vjp(lambda v, c: pk.fused_leaky_relu_pallas(v, c, slope,
                                                               scale), xj, bj)
    dx_j, db_j = vjp(gj)
    assert y_j.dtype == dx_j.dtype == db_j.dtype == jnp.bfloat16
    for ours, ref, ulps in ((y, y_j, 1), (dx, dx_j, 1), (db, db_j, 2)):
        ref = np.asarray(ref, np.float32)
        err = np.abs(ours.detach().float().numpy() - ref).max()
        assert err <= ulps * _bf16_ulp(ref), (err, _bf16_ulp(ref))


def test_bf16_plain_versions_round_the_float32_result_once():
    x, b = _inputs((6, 16), seed=7)
    g = np.random.RandomState(8).randn(6, 16).astype(np.float32)
    xt, bt, gt = (torch.from_numpy(a).bfloat16() for a in (x, b, g))
    for ours, ref in (
            (fused_leaky_relu(xt, bt),
             fused_leaky_relu(xt.float(), bt.float())),
            (fl.fused_leaky_relu_bwd_plain(xt, bt, gt, 0.2, 2 ** 0.5),
             fl.fused_leaky_relu_bwd_plain(xt.float(), bt.float(), gt.float(),
                                           0.2, 2 ** 0.5))):
        assert ours.dtype == torch.bfloat16
        assert torch.equal(ours, ref.bfloat16())


def test_wrapper_refuses_mixed_dtypes():
    with pytest.raises(TypeError, match="same dtype"):
        fl.fused_leaky_relu_kernel(torch.zeros(2, 4, dtype=torch.bfloat16),
                                   torch.zeros(4))


@pytest.mark.gpu
def test_cuda_bf16_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator().manual_seed(1)
    for shape in [(2 * 64 * 64, 128), (2 * 16 * 16, 256), (7 * 5 * 5, 3),
                  (3, 4, 5, 12)]:
        x = torch.randn(*shape, generator=gen).bfloat16().cuda()
        b = torch.randn(shape[-1], generator=gen).bfloat16().cuda()
        g = torch.randn(*shape, generator=gen).bfloat16().cuda()
        xg, bg = x.clone().requires_grad_(), b.clone().requires_grad_()
        fl.LAUNCHES.clear()
        y = fl.fused_leaky_relu_kernel(xg, bg)
        dx, db = torch.autograd.grad(y, (xg, bg), g)
        torch.cuda.synchronize()
        assert fl.LAUNCHES == {"flr_fwd.bf16": 1, "flr_bwd.bf16": 1}
        assert torch.equal(y, fused_leaky_relu(x, b))
        ref_dx = fl.fused_leaky_relu_bwd_plain(x, b, g, 0.2, 2 ** 0.5)
        assert torch.equal(dx, ref_dx)
        assert torch.equal(db, ref_dx.reshape(-1, shape[-1]).sum(0))
