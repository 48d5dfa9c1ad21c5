"""The port's complex64 operators, proximal solvers, metrics and ensemble
helpers against the JAX package's, on the same numpy inputs.

Operators (the centered FFT pair, SkipLines, the undersampled Fourier
operators, SENSE) hold at relative L2 1e-6: float32 FFTs of 16 points in
another order. make_sense's mask and coil maps are bit-equal. The CG solve
and the proximals hold at 1e-5 (8 CG iterations of float32 sums in another
order), and a CG or closed-form solution leaves a normal-equation residual
below 1e-8. NRMSE and SSIM hold at 1e-6. repeat_measurement and the
ensemble mean of real chains are bit-equal; the ensemble std and complex
magnitudes hold at 2 float32 ulps of the largest value (XLA's fused
reduction and complex abs round apart from torch's).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.operators import fourier as jfourier
from inverseproblemwithdiffusionmodel_tpu.operators import masking as jmasking
from inverseproblemwithdiffusionmodel_tpu.operators import proximal as jprox
from inverseproblemwithdiffusionmodel_tpu.ops import fft as jfft
from inverseproblemwithdiffusionmodel_tpu.parallel import ensemble as jens
from inverseproblemwithdiffusionmodel_tpu.utils import metrics as jmetrics
from inverseproblemwithdiffusionmodel_tpu_torch import operators
from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
    fourier, masking, proximal)
from inverseproblemwithdiffusionmodel_tpu_torch.ops import fft
from inverseproblemwithdiffusionmodel_tpu_torch.parallel import ensemble
from inverseproblemwithdiffusionmodel_tpu_torch.utils import metrics
from inverseproblemwithdiffusionmodel_tpu_torch.utils.misc import (
    undersample_seg_mask)

torch.set_num_threads(1)

S = 16
COILS = 3
OP_REL = 1e-6
PROX_REL = 1e-5


def rel_l2(a, b):
    a, b = np.asarray(a).astype(np.complex128), np.asarray(b).astype(
        np.complex128)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def crand(rs, *shape):
    return (rs.randn(*shape) + 1j * rs.randn(*shape)).astype(np.complex64)


def both(a):
    """(the torch tensor, the jnp array) of one numpy array."""
    return torch.from_numpy(np.ascontiguousarray(a)), jnp.asarray(a)


def assert_close(ours, ref, rel=OP_REL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    assert ours.shape == np.asarray(ref).shape
    assert rel_l2(ours, ref) <= rel, rel_l2(ours, ref)


def assert_ulps(ours, ref, n=2):
    """Within n float32 ulps of the largest |value| of ref."""
    ref = np.asarray(ref)
    err = np.abs(ours.numpy() - ref).max()
    assert err <= n * np.spacing(np.abs(ref).max()), err


def sense_pair(seed=0, frames=1, mask_type="vd"):
    """make_sense of both packages at one seed."""
    args = ("exp", COILS, 8, 0.125, (S, S, 1))
    kw = dict(seed=seed, num_frames=frames, mask_type=mask_type)
    return fourier.make_sense(*args, **kw), jfourier.make_sense(*args, **kw)


# -- FFT and operators -------------------------------------------------------

def test_fft_pair_matches_jax_and_round_trips():
    x, xj = both(crand(np.random.RandomState(0), 2, S, S, 1))
    k = fft.i2k_complex(x)
    assert k.dtype == torch.complex64
    assert_close(k, jfft.i2k_complex(xj))
    assert_close(fft.k2i_complex(k), jfft.k2i_complex(jnp.asarray(k.numpy())))
    assert_close(fft.k2i_complex(k), x.numpy())
    # a real input is taken as complex, along other axes too
    r = np.random.RandomState(1).randn(3, S, 8).astype(np.float32)
    assert_close(fft.i2k_complex(torch.from_numpy(r), axes=(-2, -1)),
                 jfft.i2k_complex(jnp.asarray(r), axes=(-2, -1)))


def test_skip_lines_matches_jax_and_leaves_x_alone():
    ours = masking.SkipLines(num_skip_lines=3, height=S)
    ref = jmasking.SkipLines(num_skip_lines=3, height=S)
    rs = np.random.RandomState(2)
    x, xj = both(crand(rs, 2, S, S, 1))
    s, sj = both(crand(rs, 2, (S + 2) // 3, S, 1))
    assert_close(ours(x), ref(xj))
    assert_close(ours.conj_op(s), ref.conj_op(sj))
    before = x.clone()
    assert_close(ours.projection(x, s, 0.3), ref.projection(xj, sj, 0.3))
    assert torch.equal(x, before)
    assert_close(ours.log_lh_grad(x, s, 0.5), ref.log_lh_grad(xj, sj, 0.5))


def test_undersampling_fourier_matches_jax():
    ours = fourier.UndersamplingFourier.create(2, S)
    ref = jfourier.UndersamplingFourier.create(2, S)
    rs = np.random.RandomState(3)
    x, xj = both(crand(rs, 2, S, S, 1))
    s, sj = both(crand(rs, 2, S // 2, S, 1))
    assert_close(ours(x), ref(xj))
    assert_close(ours.conj_op(s), ref.conj_op(sj))


@pytest.mark.parametrize("mask_type", ["vd", "uniform"])
def test_random_undersampling_fourier_matches_jax(mask_type):
    kw = dict(seed=4, num_frames=1, mask_type=mask_type)
    ours = fourier.RandomUndersamplingFourier.create(8, 0.125, (S, S, 1),
                                                     **kw)
    ref = jfourier.RandomUndersamplingFourier.create(8, 0.125, (S, S, 1),
                                                     **kw)
    assert ours.mask.dtype == torch.float32 and ours.mask.shape == (1, 1, S, 1)
    assert np.array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    rs = np.random.RandomState(5)
    x, xj = both(crand(rs, 2, S, S, 1))
    s, sj = both(crand(rs, 2, S, S, 1) * np.asarray(ref.mask))
    assert_close(ours(x), ref(xj))
    assert_close(ours.conj_op(s), ref.conj_op(sj))
    assert_close(ours.projection(x, s, 0.7), ref.projection(xj, sj, 0.7))


def test_random_undersampling_fourier_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="no VD mask preset"):
        fourier.RandomUndersamplingFourier.create(4, 0.1, (S, S, 1))
    with pytest.raises(ValueError, match="mask_type"):
        fourier.RandomUndersamplingFourier.create(8, 0.1, (S, S, 1),
                                                  mask_type="radial")


@pytest.mark.parametrize("seed", [0, 3])
def test_make_sense_is_bit_equal_to_jax(seed):
    ours, ref = sense_pair(seed=seed, frames=2)
    assert ours.num_sens == ref.num_sens == COILS
    assert ours.sens_maps.dtype == torch.complex64
    assert np.array_equal(ours.sens_maps.numpy(), np.asarray(ref.sens_maps))
    assert np.array_equal(ours.base.mask.numpy(), np.asarray(ref.base.mask))


def test_sense_forward_adjoint_and_ssos_match_jax():
    ours, ref = sense_pair(seed=1)
    rs = np.random.RandomState(6)
    x, xj = both(crand(rs, 2, S, S, 1))
    y = ours(x)
    assert y.shape == (COILS, 2, S, S, 1) and y.dtype == torch.complex64
    assert_close(y, ref(xj))
    s, sj = both(crand(rs, COILS, 2, S, S, 1))
    assert_close(ours.conj_op(s), ref.conj_op(sj))
    assert_close(ours.ssos(s), ref.ssos(sj))


def test_sense_is_adjoint_on_the_mask_support():
    """<A x, y> == <x, A^H y> for y on the mask's support."""
    op, _ = sense_pair(seed=2)
    rs = np.random.RandomState(7)
    x = torch.from_numpy(crand(rs, 1, S, S, 1))
    y = op.base.mask * torch.from_numpy(crand(rs, COILS, 1, S, S, 1))
    lhs = torch.sum(op(x).conj().cdouble() * y.cdouble())
    rhs = torch.sum(x.conj().cdouble() * op.conj_op(y).cdouble())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_operators_move_and_replace():
    op, _ = sense_pair()
    prox = proximal.L2Penalty(lin_tfm=op)
    meta = prox.to("meta")
    assert meta.lin_tfm.sens_maps.is_meta and meta.lin_tfm.base.mask.is_meta
    assert not op.sens_maps.is_meta                   # a copy, not in place
    assert prox.replace(num_iters=2).num_iters == 2 and prox.num_iters == 8


def test_the_package_exports_the_jax_names_and_the_pair_forms():
    import inspect
    import inverseproblemwithdiffusionmodel_tpu.operators as jops
    names = {n for n, v in vars(jops).items()
             if not n.startswith("_") and not inspect.ismodule(v)}
    assert "make_sense" in names
    assert not names - set(dir(operators))
    for n in ("PairSENSE", "PairL2Penalty", "PairRandomUndersamplingFourier",
              "line_mask_normal_kernel"):
        assert hasattr(operators, n)


# -- CG and the proximals -----------------------------------------------------

def prox_problem(seed=8):
    """A SENSE problem of 2 chains: (port op, JAX op, z pair, y pair)."""
    ours, ref = sense_pair(seed=seed)
    rs = np.random.RandomState(seed)
    z = crand(rs, 2, S, S, 1)
    y = crand(rs, COILS, 2, S, S, 1) * np.asarray(ref.base.mask)
    return ours, ref, both(z), both(y)


def test_cg_solve_matches_jax():
    ours, ref, (z, zj), (y, yj) = prox_problem()
    c = 2.0
    b = z + c * ours.conj_op(y)
    bj = zj + c * ref.conj_op(yj)
    x = proximal.cg_solve(lambda v: v + c * ours.conj_op(ours(v)), b, z, 5)
    xj = jprox.cg_solve(lambda v: v + c * ref.conj_op(ref(v)), bj, zj, 5)
    assert_close(x, xj, PROX_REL)


def test_cdot_sums_over_the_whole_batch():
    rs = np.random.RandomState(9)
    a, aj = both(crand(rs, 3, 4, 5, 1))
    b, bj = both(crand(rs, 3, 4, 5, 1))
    got = proximal._cdot(a, b)
    assert got.ndim == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(jprox._cdot(aj, bj)),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["cg", "sgd"])
def test_l2_penalty_matches_jax(mode):
    ours, ref, (z, zj), (y, yj) = prox_problem()
    p = proximal.L2Penalty(lin_tfm=ours, mode=mode)
    pj = jprox.L2Penalty(lin_tfm=ref, mode=mode)
    x = p(z, y, 4.5e-6 if mode == "sgd" else 2.0, 1.0)
    assert_close(x, pj(zj, yj, 4.5e-6 if mode == "sgd" else 2.0, 1.0),
                 PROX_REL)
    if mode == "cg":
        assert p.num_iters == 8
        assert p.check_solution(x, z, y, 2.0, 1.0).item() < 1e-8
        # the residual of a point that is no solution: z itself
        np.testing.assert_allclose(
            p.check_solution(z, z, y, 2.0, 1.0).item(),
            float(pj.check_solution(zj, zj, yj, 2.0, 1.0)), rtol=PROX_REL)


def test_l2_penalty_refuses_an_unknown_mode():
    ours, _, (z, _), (y, _) = prox_problem()
    with pytest.raises(ValueError, match="mode"):
        proximal.L2Penalty(lin_tfm=ours, mode="adam")(z, y, 1.0, 1.0)


def single_coil_problem():
    kw = dict(seed=10, num_frames=1)
    ours = fourier.RandomUndersamplingFourier.create(8, 0.125, (S, S, 1),
                                                     **kw)
    ref = jfourier.RandomUndersamplingFourier.create(8, 0.125, (S, S, 1),
                                                     **kw)
    rs = np.random.RandomState(11)
    z = crand(rs, 2, S, S, 1)
    y = crand(rs, 2, S, S, 1) * np.asarray(ref.mask)
    return ours, ref, both(z), both(y)


@pytest.mark.parametrize("name", ["SingleCoil", "Constrained", "L2Penalty"])
def test_single_coil_proximals_match_jax(name):
    ours, ref, (z, zj), (y, yj) = single_coil_problem()
    p = proximal.get_proximal(name)(lin_tfm=ours)
    pj = jprox.get_proximal(name)(lin_tfm=ref)
    alpha = 0.6 if name == "Constrained" else 2.0
    x = p(z, y, alpha, 1.0)
    assert x.dtype == torch.complex64
    assert_close(x, pj(zj, yj, alpha, 1.0), PROX_REL)
    if name != "Constrained":           # a projection solves no normal eq.
        assert p.check_solution(x, z, y, alpha, 1.0).item() < 1e-8


def test_get_proximal_refuses_an_unknown_name():
    with pytest.raises(NotImplementedError, match="unknown proximal"):
        proximal.get_proximal("TV")


# -- metrics and ensembles ------------------------------------------------------

def images(seed=12, shape=(S + 4, S)):
    rs = np.random.RandomState(seed)
    truth = rs.rand(*shape).astype(np.float32)
    noisy = (truth + 0.1 * rs.randn(*shape)).astype(np.float32)
    return both(noisy), both(truth)


def test_nrmse_and_ssim_match_jax():
    (a, aj), (b, bj) = images()
    for ours, ref in ((metrics.nrmse, jmetrics.nrmse),
                      (metrics.ssim, jmetrics.ssim),
                      (metrics.mse, jmetrics.mse), (metrics.mae,
                                                    jmetrics.mae)):
        np.testing.assert_allclose(ours(a, b).item(), float(ref(aj, bj)),
                                   rtol=1e-6)
    np.testing.assert_allclose(metrics.ssim(a, b, data_range=2.0).item(),
                               float(jmetrics.ssim(aj, bj, data_range=2.0)),
                               rtol=1e-6)
    assert abs(metrics.ssim(b, b).item() - 1.0) < 1e-6
    np.testing.assert_allclose(metrics.nrmse_np(a.numpy(), b.numpy()),
                               jmetrics.nrmse_np(aj, bj), rtol=1e-6)
    np.testing.assert_allclose(metrics.ssim_np(a.numpy(), b.numpy()),
                               jmetrics.ssim_np(aj, bj), rtol=1e-6)


def test_compute_metrics_and_snr_match_jax():
    rs = np.random.RandomState(13)
    truth = rs.rand(S, S, 2).astype(np.float32)
    batch = (truth + 0.1 * rs.randn(3, S, S, 2)).astype(np.float32)
    names = ["L2", "L1", "SSIM", "NRMSE"]
    for reduce in (None, "mean"):
        ours = metrics.compute_metrics(names, torch.from_numpy(batch),
                                       torch.from_numpy(truth), reduce)
        ref = jmetrics.compute_metrics(names, jnp.asarray(batch),
                                       jnp.asarray(truth), reduce)
        for n in names:
            np.testing.assert_allclose(ours[n].numpy(), np.asarray(ref[n]),
                                       rtol=1e-6)
    z, zj = both(crand(rs, 2, S, S, 1))
    np.testing.assert_allclose(metrics.compute_snr(z).numpy(),
                               np.asarray(jmetrics.compute_snr(zj)),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics.compute_snr_np(z.numpy()[0]),
                               jmetrics.compute_snr_np(zj[0]), rtol=1e-6)
    for ours, ref in zip(metrics.compute_mean_and_std(z),
                         jmetrics.compute_mean_and_std(zj)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_ensemble_helpers_equal_jax():
    rs = np.random.RandomState(14)
    y, yj = both(crand(rs, COILS, 1, S, S, 1))
    for axis in (0, 1):
        assert np.array_equal(ensemble.repeat_measurement(y, 4, axis).numpy(),
                              np.asarray(jens.repeat_measurement(yj, 4,
                                                                 axis)))
    # Real chains: the mean is bit-equal; the std within 2 float32 ulps of
    # the largest value
    # (XLA's CPU reduction fuses the squares into its sum). Complex chains
    # add the magnitude, which XLA's complex abs and torch's round apart
    # by up to 1 ulp.
    real, realj = both(rs.randn(4, S, S, 1).astype(np.float32))
    mean, std = ensemble.ensemble_mean_std(real)
    mean_j, std_j = jens.ensemble_mean_std(realj)
    assert np.array_equal(mean.numpy(), np.asarray(mean_j))
    assert_ulps(std, std_j)
    r, rj = both(crand(rs, 4, S, S, 1))
    for ours, ref in zip(ensemble.ensemble_mean_std(r),
                         jens.ensemble_mean_std(rj)):
        assert_ulps(ours, ref)


@pytest.mark.parametrize("fraction", [0.0, 0.3, 1.0])
def test_undersample_seg_mask_keeps_the_fraction_of_the_foreground(fraction):
    label = torch.zeros(2, S, S, dtype=torch.long)
    label[0, 3:9, 4:10] = 1
    label[1, 2:5, 2:5] = 1
    n_fg = int((label > 0).sum())
    kept = undersample_seg_mask(label, fraction,
                                torch.Generator().manual_seed(0))
    assert kept.shape == label.shape and kept.dtype == label.dtype
    assert int(kept.sum()) == max(1, int(n_fg * fraction))
    assert bool(((kept > 0) <= (label > 0)).all())          # a subset
    with pytest.raises(ValueError, match="fraction"):
        undersample_seg_mask(label, 1.5)
