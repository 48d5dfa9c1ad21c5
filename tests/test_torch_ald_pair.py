"""The port's ACDC SENSE ALD reconstruction against the JAX package's: the
matmul DFT, the pair operators, the line-mask normal kernel, the CG
proximal, the Langevin update, and the whole slice,
make_stepped_pair_reconstructor with a tiny NCSNv2Deepest, fed the JAX
sampler's own noise (its key schedule replayed with jax.random).

Operators hold at atol 2e-5, as tests/test_pair_ops.py holds the JAX pair
operators to the complex ones: float32 DFT matmuls over 32 points. The CG
proximal and the chain hold at relative L2 1e-4: float32 sums in another
order, through 4 CG iterations per step and about 60 net layers.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2Deepest as JaxNCSNv2Deepest)
from inverseproblemwithdiffusionmodel_tpu.ops import fft_pair as jfft
from inverseproblemwithdiffusionmodel_tpu.operators import pair as jpair
from inverseproblemwithdiffusionmodel_tpu.samplers import ald as jald
from inverseproblemwithdiffusionmodel_tpu.samplers import (
    ald_pair as jald_pair)
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    sigma_ladder as jax_sigma_ladder)
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.models import make_score_fn
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import (
    NCSNv2Deepest)
from inverseproblemwithdiffusionmodel_tpu_torch.operators import pair
from inverseproblemwithdiffusionmodel_tpu_torch.operators.fourier import (
    MASK_PRESETS, _exp_sens_map)
from inverseproblemwithdiffusionmodel_tpu_torch.operators.masks import (
    generate_mask)
from inverseproblemwithdiffusionmodel_tpu_torch.ops import fft_pair
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
    ald_inverse_proximal_pair, make_stepped_pair_reconstructor)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnv2)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
    gaussian_noise)
from tests.test_torch_ncsnv2 import init_flax

torch.set_num_threads(1)

S = 32              # image size
COILS = 4
OP_TOL = dict(rtol=0, atol=2e-5)
REL_L2 = 1e-4


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(_np(x).copy())


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def coil_maps(complex_maps: bool):
    """Four SOS-normalized exponential coil maps (bench.py's form), with a
    smooth phase where `complex_maps`: (re, im), each (COILS, S, S, 1)."""
    maps = np.stack([_exp_sens_map(S, S, i) for i in range(COILS)])
    maps = maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))
    phase = np.zeros_like(maps)
    if complex_maps:
        hh, ww = np.mgrid[0:S, 0:S] / S
        phase = np.stack([np.pi * (k + 1) * (hh - ww) / COILS
                          for k in range(COILS)])
    return (_np(maps * np.cos(phase))[..., None],
            _np(maps * np.sin(phase))[..., None])


def both_sense(mask, complex_maps=True):
    sr, si = coil_maps(complex_maps)
    m = _np(mask).reshape(-1, 1, S, 1)
    return (jpair.PairSENSE(mask=jnp.asarray(m), sens_re=jnp.asarray(sr),
                            sens_im=jnp.asarray(si)),
            pair.PairSENSE(mask=_t(m), sens_re=_t(sr), sens_im=_t(si)))


def r8_mask(seed=0, frames=1):
    """(frames, S) variable-density R = 8 line masks."""
    return generate_mask(frames, S, seed=seed,
                         **MASK_PRESETS[8]).reshape(frames, S)


def rand_pair(rs, shape):
    return _np(rs.randn(*shape)), _np(rs.randn(*shape))


# -- DFT and operators -----------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
def test_dft_matrices_equal(inverse):
    ours = fft_pair.dft_matrix(S, inverse)
    ref = jfft.dft_matrix(S, inverse)
    for a, b in zip(ours, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_i2k_k2i_match_jax():
    xr, xi = rand_pair(np.random.RandomState(0), (2, S, S, 1))
    kr, ki = fft_pair.i2k_pair(_t(xr), _t(xi))
    jr, ji = jfft.i2k_pair(jnp.asarray(xr), jnp.asarray(xi))
    np.testing.assert_allclose(kr.numpy(), np.asarray(jr), **OP_TOL)
    np.testing.assert_allclose(ki.numpy(), np.asarray(ji), **OP_TOL)
    br, bi = fft_pair.k2i_pair(kr, ki)
    jbr, jbi = jfft.k2i_pair(jr, ji)
    np.testing.assert_allclose(br.numpy(), np.asarray(jbr), **OP_TOL)
    np.testing.assert_allclose(bi.numpy(), np.asarray(jbi), **OP_TOL)
    np.testing.assert_allclose(br.numpy(), xr, **OP_TOL)   # round trip
    np.testing.assert_allclose(bi.numpy(), xi, **OP_TOL)


def test_complex_products_match_jax():
    rs = np.random.RandomState(1)
    args = [_np(rs.randn(5)) for _ in range(4)]
    for ours, ref in ((fft_pair.cmul, jfft.cmul),
                      (fft_pair.cconj_mul, jfft.cconj_mul)):
        for a, b in zip(ours(*map(_t, args)), ref(*map(jnp.asarray, args))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_pair_sense_and_its_adjoint_match_jax():
    jop, op = both_sense(r8_mask())
    rs = np.random.RandomState(2)
    xr, xi = rand_pair(rs, (2, S, S, 1))
    fr, fi = op(_t(xr), _t(xi))
    jfr, jfi = jop(jnp.asarray(xr), jnp.asarray(xi))
    assert fr.shape == (COILS, 2, S, S, 1)
    np.testing.assert_allclose(fr.numpy(), np.asarray(jfr), **OP_TOL)
    np.testing.assert_allclose(fi.numpy(), np.asarray(jfi), **OP_TOL)
    yr, yi = rand_pair(rs, (COILS, 2, S, S, 1))
    ar, ai = op.conj_op(_t(yr), _t(yi))
    jar, jai = jop.conj_op(jnp.asarray(yr), jnp.asarray(yi))
    np.testing.assert_allclose(ar.numpy(), np.asarray(jar), **OP_TOL)
    np.testing.assert_allclose(ai.numpy(), np.asarray(jai), **OP_TOL)


def test_single_coil_matches_jax():
    m = _np(r8_mask()).reshape(1, 1, S, 1)
    op = pair.PairRandomUndersamplingFourier(mask=_t(m))
    jop = jpair.PairRandomUndersamplingFourier(mask=jnp.asarray(m))
    xr, xi = rand_pair(np.random.RandomState(3), (2, S, S, 1))
    for a, b in zip(op(_t(xr), _t(xi)), jop(jnp.asarray(xr),
                                            jnp.asarray(xi))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OP_TOL)
    for a, b in zip(op.conj_op(_t(xr), _t(xi)),
                    jop.conj_op(jnp.asarray(xr), jnp.asarray(xi))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OP_TOL)


def test_pair_sense_is_adjoint_on_the_mask_support():
    """<A x, y> == <x, A^H y> for y on the mask's support: conj_op does not
    re-apply the mask."""
    _, op = both_sense(r8_mask())
    rs = np.random.RandomState(4)
    xr, xi = map(_t, rand_pair(rs, (1, S, S, 1)))
    yr, yi = (op.mask * v for v in map(_t, rand_pair(rs, (COILS, 1, S, S,
                                                          1))))
    fr, fi = op(xr, xi)
    ar, ai = op.conj_op(yr, yi)
    lhs = (fr.double() * yr.double() + fi.double() * yi.double()).sum()
    rhs = (xr.double() * ar.double() + xi.double() * ai.double()).sum()
    np.testing.assert_allclose(lhs.item(), rhs.item(), rtol=1e-5)


def test_line_mask_normal_kernel_equals_jax_and_is_hermitian():
    m = _np(r8_mask()).reshape(1, 1, S, 1)
    kr, ki = pair.line_mask_normal_kernel(_t(m))
    jkr, jki = jpair.line_mask_normal_kernel(m)
    assert np.array_equal(kr.numpy(), np.asarray(jkr))
    assert np.array_equal(ki.numpy(), np.asarray(jki))
    np.testing.assert_allclose(kr.numpy(), kr.numpy().swapaxes(-1, -2),
                               atol=1e-6)
    np.testing.assert_allclose(ki.numpy(), -ki.numpy().swapaxes(-1, -2),
                               atol=1e-6)


def _masks():
    """(name, mask rows, rows of the collapsed kernel): one static mask; a
    2-frame mask tiled over 4 chain rows; a mask per row (no period)."""
    two = r8_mask(1, frames=2)
    per_row = r8_mask(3, frames=4)
    return [("static", r8_mask(0), 1), ("tiled", np.tile(two, (2, 1)), 2),
            ("per_row", per_row, 4)]


@pytest.mark.parametrize("name,mask,rows", _masks(),
                         ids=[m[0] for m in _masks()])
def test_normal_kernel_equals_the_operator_composition(name, mask, rows):
    _, op = both_sense(mask)
    xr, xi = map(_t, rand_pair(np.random.RandomState(5), (4, S, S, 1)))
    prox = pair.PairL2Penalty.with_normal_kernel(op)
    assert prox.kernel_re.shape == (rows, S, S)
    nr, ni = prox._normal(xr, xi)
    gr, gi = op.conj_op(*op(xr, xi))
    np.testing.assert_allclose(nr.numpy(), gr.numpy(), atol=1e-5)
    np.testing.assert_allclose(ni.numpy(), gi.numpy(), atol=1e-5)
    single = pair.PairRandomUndersamplingFourier(mask=op.mask)
    nr, ni = pair.PairL2Penalty.with_normal_kernel(single)._normal(xr, xi)
    gr, gi = single.conj_op(*single(xr, xi))
    np.testing.assert_allclose(nr.numpy(), gr.numpy(), atol=1e-5)
    np.testing.assert_allclose(ni.numpy(), gi.numpy(), atol=1e-5)


def test_a_kernel_that_does_not_tile_the_rows_raises():
    _, op = both_sense(r8_mask(1, frames=3))
    xr, xi = map(_t, rand_pair(np.random.RandomState(6), (4, S, S, 1)))
    with pytest.raises(ValueError, match="tile"):
        pair.PairL2Penalty.with_normal_kernel(op)._normal(xr, xi)


@pytest.mark.parametrize("kind", ["operator", "kernel", "kernel_and_ahy"])
def test_l2_penalty_matches_jax(kind):
    jop, op = both_sense(r8_mask())
    rs = np.random.RandomState(7)
    zr, zi = rand_pair(rs, (2, S, S, 1))
    yr, yi = (np.asarray(v) for v in jop(*map(jnp.asarray, rand_pair(
        rs, (2, S, S, 1)))))
    if kind == "operator":
        prox = pair.PairL2Penalty(lin_tfm=op, num_iters=4)
        jprox = jpair.PairL2Penalty(lin_tfm=jop, num_iters=4)
    else:
        meas = (_t(yr), _t(yi)) if kind == "kernel_and_ahy" else None
        jmeas = (jnp.asarray(yr), jnp.asarray(yi)) if meas else None
        prox = pair.PairL2Penalty.with_normal_kernel(op, 4, meas)
        jprox = jpair.PairL2Penalty.with_normal_kernel(jop, 4, jmeas)
    # alpha as the sampler passes it: step_lr * lr_scaled, at a weight that
    # makes the data term count
    ours = prox(_t(zr), _t(zi), _t(yr), _t(yi), torch.tensor(0.3), 1.0)
    ref = jprox(jnp.asarray(zr), jnp.asarray(zi), jnp.asarray(yr),
                jnp.asarray(yi), jnp.float32(0.3), 1.0)
    for a, b in zip(ours, ref):
        assert rel_l2(a.numpy(), b) <= REL_L2
    moved = rel_l2(ours[0].numpy(), zr)
    assert moved > 1e-2      # the data term moved the solution


def test_operators_move_and_replace():
    _, op = both_sense(r8_mask())
    prox = pair.PairL2Penalty.with_normal_kernel(op, 4)
    meta = prox.to("meta")
    assert meta.kernel_re.is_meta and meta.lin_tfm.sens_re.is_meta
    assert not prox.kernel_re.is_meta                  # a copy, not in place
    baked = prox.replace(ahy_re=torch.zeros(1))
    assert baked.ahy_re is not None and prox.ahy_re is None


# -- the Langevin update and the chain -------------------------------------

def test_langevin_update_matches_jax():
    rs = np.random.RandomState(8)
    x, g = _np(rs.randn(2, S, S, 1)), _np(rs.randn(2, S, S, 1))
    key = jax.random.PRNGKey(3)
    step = jnp.float32(9e-7) * (jnp.float32(348.0) / jnp.float32(0.01)) ** 2
    ref = jald._langevin_update(jnp.asarray(x), jnp.asarray(g), step, key)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    ours = ald._langevin_update(_t(x), _t(g), torch.tensor(np.asarray(step)),
                                _t(noise))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-5)
    labels = ald._labels(_t(x), 5)
    assert labels.tolist() == [5, 5]


def jax_noise(key, shape, n_inner):
    """The draws of JAX's stepped reconstructor, in order: per inner step
    `key, k_re, k_im = split(key, 3)`, Re then Im (ald_pair.py:314)."""
    out = []
    for _ in range(n_inner):
        key, k_re, k_im = jax.random.split(key, 3)
        out += [np.asarray(jax.random.normal(k_re, shape, jnp.float32)),
                np.asarray(jax.random.normal(k_im, shape, jnp.float32))]
    return out


def replay(draws):
    it = iter(draws)

    def noise(shape):
        value = next(it)
        assert tuple(shape) == value.shape
        return torch.from_numpy(value.copy())

    return noise


CHAINS = 2
CFG = dict(n_steps_each=2, step_lr=9e-7)      # ACDC's step_lr


@pytest.fixture(scope="module")
def slice_setup():
    """A tiny NCSNv2Deepest (32 px, ngf 8) with weights drawn from the JAX
    init's distributions, bench.py's SENSE (4 real coil maps, R = 8 line
    mask), a measurement synthesized as bench.py:258-263 does, and the ACDC
    ladder cut to 2 levels."""
    over = {"data.image_size": S, "model.ngf": 8}
    module = JaxNCSNv2Deepest(config=jax_load_config("ACDC", "real-imag",
                                                     **over))
    params = init_flax(module, jnp.zeros((1, S, S, 1)), jnp.ones((1,)))
    cfg = load_config("ACDC", "real-imag", **over)
    model = NCSNv2Deepest(cfg)
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg,
                                               "ncsnv2_deepest"))
    jop, op = both_sense(r8_mask(), complex_maps=False)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    mag = jax.random.uniform(k1, (CHAINS, S, S, 1))
    phase = jax.random.normal(k2, (CHAINS, S, S, 1))
    yr, yi = (np.asarray(v) for v in jop(mag * jnp.cos(phase),
                                         mag * jnp.sin(phase)))
    return dict(module=module, params=params, model=model, jop=jop, op=op,
                yr=yr, yi=yi, sigmas=jax_sigma_ladder(348, 0.01, 2))


def run_both(setup, levels=2, config=None, lr_scaled=5.0):
    """The JAX stepped reconstructor and the port's, on the same weights,
    measurement and noise. Returns ((xr, xi) of JAX, of the port)."""
    config = config or dict(CFG)
    sigmas = setup["sigmas"][:levels] if levels < 2 else setup["sigmas"]
    jprox = jpair.PairL2Penalty.with_normal_kernel(setup["jop"], num_iters=4)
    jrecon = jald_pair.make_stepped_pair_reconstructor(
        setup["module"], sigmas, setup["jop"], jprox,
        jald.ALDConfig(**config), lr_scaled=lr_scaled)
    key = jax.random.PRNGKey(2)
    ref = jrecon(setup["params"], jnp.asarray(setup["yr"]),
                 jnp.asarray(setup["yi"]), key)
    prox = pair.PairL2Penalty.with_normal_kernel(setup["op"], num_iters=4)
    recon = make_stepped_pair_reconstructor(
        setup["model"], torch.tensor(np.asarray(sigmas)), setup["op"],
        prox, ald.ALDConfig(**config), lr_scaled=lr_scaled, device="cpu")
    n_inner = len(sigmas) * config["n_steps_each"]
    ours = recon(_t(setup["yr"]), _t(setup["yi"]),
                 noise=replay(jax_noise(key, (CHAINS, S, S, 1), n_inner)))
    return [np.asarray(v) for v in ref], [v.numpy() for v in ours]


def test_one_inner_step_matches_jax(slice_setup):
    """One level, one inner step, no denoising: the unit the card-vs-CPU
    check of chip_smoke.py runs."""
    ref, ours = run_both(slice_setup, levels=1, config=dict(
        CFG, n_steps_each=1, denoise=False))
    for a, b in zip(ours, ref):
        assert rel_l2(a, b) <= 1e-5


@pytest.mark.parametrize("lr_scaled", [5.0, [2.0, 5.0]],
                         ids=["scalar", "per_level"])
def test_reconstruction_matches_jax(slice_setup, lr_scaled):
    """The whole slice: 2 chains, 4 coils, R = 8, 2 levels x 2 inner steps
    (sigma 348 then 0.01), CG 4 iterations, lr_scaled 5.0 (bench.py's) or a
    per-level schedule, denoising on, JAX's noise."""
    ref, ours = run_both(slice_setup, lr_scaled=lr_scaled)
    for a, b in zip(ours, ref):
        assert a.shape == (CHAINS, S, S, 1) and np.isfinite(a).all()
        assert rel_l2(a, b) <= REL_L2


def test_scanned_and_stepped_forms_are_equal(slice_setup):
    model, op = slice_setup["model"], slice_setup["op"]
    sigmas = torch.tensor(np.asarray(slice_setup["sigmas"]))
    prox = pair.PairL2Penalty.with_normal_kernel(op, num_iters=4)
    config = ald.ALDConfig(**CFG)
    y = (_t(slice_setup["yr"]), _t(slice_setup["yi"]))
    seen = []
    stepped = make_stepped_pair_reconstructor(
        model, sigmas, op, prox, config, lr_scaled=5.0,
        snapshot_fn=lambda c, s, xr, xi: seen.append((c, s, xr.shape)),
        device="cpu")(*y, seed=3)
    scanned = ald_inverse_proximal_pair(
        make_score_fn(model, sigmas), sigmas, y, op, prox, seed=3,
        config=config, lr_scaled=5.0, device="cpu")
    by_noise = ald_inverse_proximal_pair(
        make_score_fn(model, sigmas), sigmas, y, op, prox, config=config,
        lr_scaled=5.0, noise=gaussian_noise(3, "cpu"), device="cpu")
    for a, b, c in zip(stepped, scanned, by_noise):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert seen == []                  # snapshot_every 0: never called
    snap = ald.ALDConfig(**CFG, snapshot_every=1)
    make_stepped_pair_reconstructor(
        model, sigmas, op, prox, snap,
        snapshot_fn=lambda c, s, xr, xi: seen.append((c, s, xr.shape)),
        device="cpu")(*y)
    assert seen == [(c, float(sigmas[c]), (CHAINS, S, S, 1))
                    for c in range(2)]
