"""The port's 2D+time (cine) path against the JAX package's: the cine
configs, the 1-D NCSN family and its blocks, the converter's 1-D kernels,
the pixel-tube reshapes, FiniteDiff, the 2D+time ladders, one inner step
in each temporal mode, the whole stepped chain and the cine engine fed
JAX's noise and shifts, and serve_recon --workload cine on the CPU; (marked
slow) the trained cine priors of artifacts/.

Geometry of tests/test_serving.py's cine cases: 16 px, a spatial NCSNv2 of
ngf 8, an NCSN1D of ngf 8 on 2x2 tubes (4 channels), T = 3 frames, 2
chains, 2 coils. Reshapes, FiniteDiff and ladders are equal exactly; nets,
inner steps, chains and engines hold at relative L2 1e-5 (float32 sums in
another order), as the 2-D reconstruction does (tests/
test_torch_ald_pair.py).
"""
import functools
import io
import json
import os
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.config import Config as JConfig
from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.models import layers as jlayers
from inverseproblemwithdiffusionmodel_tpu.models import (
    normalization as jnorm)
from inverseproblemwithdiffusionmodel_tpu.models import ncsn1d as jncsn1d
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2 as JaxNCSNv2)
from inverseproblemwithdiffusionmodel_tpu.operators import pair as jpair
from inverseproblemwithdiffusionmodel_tpu.operators.finite_diff import (
    FiniteDiff as JFiniteDiff)
from inverseproblemwithdiffusionmodel_tpu.samplers import ald as jald
from inverseproblemwithdiffusionmodel_tpu.samplers import (
    ald_pair as jald_pair)
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    sigma_ladder as jax_sigma_ladder)
from inverseproblemwithdiffusionmodel_tpu.serving import (
    CineEngineSpec as JCineSpec, CineReconstructionEngine as JCineEngine)
from inverseproblemwithdiffusionmodel_tpu.utils import reshape as jreshape
from inverseproblemwithdiffusionmodel_tpu_torch.config import (
    Config, load_config)
from inverseproblemwithdiffusionmodel_tpu_torch.models import (
    NCSN1D, layers, normalization)
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    example_input, get_model, load_model, make_score_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.operators import pair
from inverseproblemwithdiffusionmodel_tpu_torch.operators.finite_diff import (
    FiniteDiff)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
    Stepped2DTimePairReconstructor, ald_2d_time_pair,
    make_stepped_2d_time_pair_reconstructor)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import serve_recon
from inverseproblemwithdiffusionmodel_tpu_torch.serving import (
    CineEngineSpec, CineReconstructionEngine)
from inverseproblemwithdiffusionmodel_tpu_torch.serving.server import serve
from inverseproblemwithdiffusionmodel_tpu_torch.utils import reshape
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch, flax_to_torch_ncsnv2)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
    random_shift)
from tests.test_torch_ald_pair import replay
from tests.test_torch_ncsnv2 import draw, init_flax, nchw, nhwc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 16
TF, WIN, CHAINS, NSENS, LEVELS, NSTEPS = 3, 2, 2, 2, 3, 2
REL_L2 = 1e-5
MODES = ("diffusion1d", "tv", "none", "diffusion1d-only", "tv-only")
STEP_LR, LR_SCALED, LAMDA_T = 1e-5, 2.0, 0.7


def tiny(channels, size):
    return {"data": {"channels": channels, "image_size": size,
                     "logit_transform": False, "rescaled": False},
            "model": {"ngf": 8, "nonlinearity": "elu",
                      "normalization": "InstanceNorm++"}}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np(x):
    return np.asarray(x, dtype=np.float32)


# JAX's ladders: the spatial one 10 -> 0.1, the temporal one 5 -> 0.1
# (levels 1 and 2 run the temporal step)
SIG = jax_sigma_ladder(10.0, 0.1, LEVELS, "geometric")
SIG_T = jax_sigma_ladder(5.0, 0.1, LEVELS, "geometric")
J_S = JaxNCSNv2(config=JConfig(tiny(1, H)))
J_T = jncsn1d.NCSN1D(JConfig(tiny(WIN * WIN, TF)))


@pytest.fixture(scope="module")
def setup():
    """Both nets in both packages on the same weights, a per-frame line
    mask tiled over the chains, 2 real coil maps, a measurement of TF
    frames and its chain-tiled form."""
    pS = init_flax(J_S, jnp.zeros((1, H, W, 1)), jnp.ones((1,)))
    pT = init_flax(J_T, jnp.zeros((1, TF, WIN * WIN)), jnp.ones((1,)),
                   seed=1)
    netS = NCSNv2(Config(tiny(1, H)))
    netS.load_state_dict(flax_to_torch_ncsnv2(pS, Config(tiny(1, H)),
                                              "ncsnv2"))
    cfg_t = Config(tiny(WIN * WIN, TF))
    netT = NCSN1D(cfg_t)
    netT.load_state_dict(flax_to_torch_ncsnv2(pT, cfg_t, "ncsn1d"))

    rng = np.random.RandomState(3)
    mask = (rng.rand(TF, 1, W, 1) < 0.5).astype(np.float32)
    mask[..., W // 2 - 1:W // 2 + 1, :] = 1.0
    maps = rng.rand(NSENS, H, W, 1).astype(np.float32) + 0.2
    maps = maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))
    y = rng.rand(NSENS, TF, H, W).astype(np.float32)
    yi = 0.5 * rng.rand(NSENS, TF, H, W).astype(np.float32)
    tile = lambda a: np.tile(a[:, None, ..., None], (1, CHAINS, 1, 1, 1, 1)
                             ).reshape(NSENS, CHAINS * TF, H, W, 1)
    mask_bt = np.tile(mask, (CHAINS, 1, 1, 1))
    jlin = jpair.PairSENSE(mask=jnp.asarray(mask_bt),
                           sens_re=jnp.asarray(maps),
                           sens_im=jnp.zeros_like(jnp.asarray(maps)))
    lin = pair.PairSENSE(mask=torch.tensor(mask_bt),
                         sens_re=torch.tensor(maps),
                         sens_im=torch.zeros(maps.shape))
    return dict(pS=pS, pT=pT, netS=netS, netT=netT, mask=mask,
                maps=maps, y=y, yi=yi, yb=tile(y), yib=tile(yi), jlin=jlin,
                jprox=jpair.PairL2Penalty.with_normal_kernel(jlin,
                                                            num_iters=3),
                lin=lin, prox=pair.PairL2Penalty.with_normal_kernel(
                    lin, num_iters=3))


def cine_draws(key, mode, shift_on, levels, n_steps):
    """JAX's draws for the 2D+time chain (samplers/ald_pair.py:139-180),
    in the order the port asks for them: per inner step `key, k_s, k_t =
    split(key, 3)`; the spatial Re and Im from split(k_s); where the
    temporal diffusion step runs, split(k_t, 3) -> (shift, Re, Im) with
    Re and Im of the tube shape. Returns the port's (noise, shift)."""
    _, sig_T, _ = jald.setup_2d_time_ladders(SIG, SIG_T, mode)
    frames = (CHAINS * TF, H, W, 1)
    tubes = (CHAINS * (H // WIN) * (W // WIN), TF, WIN * WIN)
    out, shifts = [], []
    for c in levels:
        for _ in range(n_steps):
            key, k_s, k_t = jax.random.split(key, 3)
            if mode not in ("diffusion1d-only", "tv-only"):
                out += [np.asarray(jax.random.normal(k, frames))
                        for k in jax.random.split(k_s)]
            if "diffusion1d" in mode and float(sig_T[c]) > 0:
                k_sh, k_re, k_im = jax.random.split(k_t, 3)
                shifts.append(tuple(int(v) for v in jax.random.randint(
                    k_sh, (2,), 0, WIN)))
                out += [np.asarray(jax.random.normal(k, tubes))
                        for k in (k_re, k_im)]
    it = iter(shifts)

    def shift(win):
        assert win == WIN
        return next(it)

    return replay(out), (shift if shift_on else None)


# -- configs, models, converter ---------------------------------------------

@pytest.mark.parametrize("name", ["CINE127", "CINE127_1D", "CINE64",
                                  "CINE64_1D"])
def test_cine_configs_equal_the_yaml(name):
    for mode in ("real-imag", "complex"):
        assert load_config(name, mode).to_dict() == \
            jax_load_config(name, mode).to_dict()


@pytest.mark.parametrize("name,T", [("ncsn1d", 3), ("ncsn1d", 24),
                                    ("ncsn1d_deeper", 24),
                                    ("ncsn1d_deepest", 24)])
def test_ncsn1d_matches_jax(name, T):
    """The 1-D family on (B, T, 4) tubes; at T = 3 the deepest stages hold
    one element, where the instance norms give 0."""
    jax_ctor = {"ncsn1d": jncsn1d.NCSN1D, "ncsn1d_deeper":
                jncsn1d.NCSN1DDeeper, "ncsn1d_deepest":
                jncsn1d.NCSN1DDeepest}[name]
    cfg = tiny(4, T)
    module = jax_ctor(JConfig(cfg))
    params = init_flax(module, jnp.zeros((1, T, 4)), jnp.ones((1,)))
    rs = np.random.RandomState(2)
    x, s = _np(rs.randn(5, T, 4)), _np(np.linspace(0.5, 3.0, 5))
    ref = np.asarray(module.apply({"params": params}, x, s))
    net = get_model(name)(Config(cfg))
    net.load_state_dict(flax_to_torch_ncsnv2(params, Config(cfg), name),
                        strict=True)
    assert net.ndim == 1
    out = nhwc(net(nchw(x), torch.tensor(s)))
    assert rel_l2(out, ref) <= REL_L2


def _block_cases():
    elu = (jax.nn.elu, torch.nn.functional.elu)
    IN = (jnorm.InstanceNormPlus, normalization.InstanceNormPlus)
    return {
        "refine_msf": (
            lambda: jlayers.RefineBlock(features=5, act=elu[0], ndim=1),
            lambda: layers.RefineBlock([4, 6], 5, elu[1], ndim=1),
            [(2, 12, 4), (2, 6, 6)], (12,)),
        "refine_start_end": (
            lambda: jlayers.RefineBlock(features=4, act=elu[0], ndim=1,
                                        start=True, end=True),
            lambda: layers.RefineBlock([4], 4, elu[1], start=True, end=True,
                                       ndim=1),
            [(2, 6, 4)], (6,)),
        "msf": (lambda: jlayers.MSFBlock(features=5, ndim=1),
                lambda: layers.MSFBlock([4, 6], 5, ndim=1),
                [(2, 12, 4), (2, 5, 6)], (12,)),
        "res_down": (
            lambda: jlayers.ResidualBlock(output_dim=8, normalization=IN[0],
                                          act=elu[0], resample="down",
                                          ndim=1),
            lambda: layers.ResidualBlock(4, 8, IN[1], elu[1],
                                         resample="down", ndim=1),
            [(2, 12, 4)], None),
        "res_dilated": (
            lambda: jlayers.ResidualBlock(output_dim=6, normalization=IN[0],
                                          act=elu[0], dilation=2, ndim=1),
            lambda: layers.ResidualBlock(4, 6, IN[1], elu[1], dilation=2,
                                         ndim=1),
            [(2, 12, 4)], None),
        "instance_norm_plus": (lambda: IN[0](num_features=4),
                               lambda: IN[1](4), [(3, 7, 4)], None),
    }


@pytest.mark.parametrize("case", sorted(_block_cases()))
def test_1d_blocks_match_jax(case):
    jax_ctor, torch_ctor, shapes, out_shape = _block_cases()[case]
    rs = np.random.RandomState(4)
    xs = [_np(rs.randn(*s)) for s in shapes]
    module = jax_ctor()
    if out_shape is None:
        args = (jnp.asarray(xs[0]),)
        ours_args = (nchw(xs[0]),)
    else:
        args = ([jnp.asarray(x) for x in xs], out_shape)
        ours_args = ([nchw(x) for x in xs], out_shape)
    shapes_ = jax.eval_shape(lambda k: module.init(k, *args),
                             jax.random.PRNGKey(0))["params"]
    params = draw(shapes_, rs)
    ref = np.asarray(module.apply({"params": params}, *args))
    ours = torch_ctor()
    ours.load_state_dict(flax_to_torch(params), strict=True)
    np.testing.assert_allclose(nhwc(ours(*ours_args)), ref, rtol=1e-5,
                               atol=1e-6)


def test_1d_pools_and_resize_match_jax():
    from inverseproblemwithdiffusionmodel_tpu.ops.resize import (
        resize_align_corners as jax_resize)
    from inverseproblemwithdiffusionmodel_tpu_torch.ops.resize import (
        resize_align_corners)
    x = _np(np.random.RandomState(5).randn(2, 9, 3))
    jx, tx = jnp.asarray(x), nchw(x)
    for ours, ref in ((layers.max_pool(tx), jlayers.max_pool(jx, 1)),
                      (layers.avg_pool(tx), jlayers.avg_pool(jx, 1)),
                      (layers.mean_pool_2x(tx), jlayers.mean_pool_2x(jx, 1)),
                      (resize_align_corners(tx, (17,)),
                       jax_resize(jx, (17,), axes=(1,)))):
        np.testing.assert_allclose(nhwc(ours), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    # any list of axes, in order, as the JAX _resize
    y = _np(np.random.RandomState(6).randn(2, 5, 7, 3))
    ours = resize_align_corners(torch.tensor(y), (9, 4), axes=(1, 2))
    ref = jax_resize(jnp.asarray(y), (9, 4), axes=(1, 2))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_converter_maps_1d_kernels_and_load_model_builds_them():
    cfg = tiny(4, 8)
    module = jncsn1d.NCSN1D(JConfig(cfg))
    params = init_flax(module, jnp.zeros((1, 8, 4)), jnp.ones((1,)))
    state = flax_to_torch_ncsnv2(params, Config(cfg), "ncsn1d")
    kernel = params["begin_conv"]["kernel"]                  # (k, I, O)
    assert kernel.shape == (3, 4, 8)
    np.testing.assert_array_equal(state["begin_conv.weight"].numpy(),
                                  kernel.transpose(2, 1, 0))
    with pytest.raises(ValueError, match="shape"):
        flax_to_torch_ncsnv2(params, Config(cfg), "ncsnv2")
    # the Diffusion1D task: NCSN1D, weights from the seed, every parameter
    # drawn; JAX's example shape
    full = load_config("CINE127_1D", "real-imag", **{"model.ngf": 8})
    net, none = load_model(full, "Diffusion1D", seed=3)
    again, _ = load_model(full, "Diffusion1D", seed=3)
    assert none is None and net.ndim == 1
    for (name, a), b in zip(net.named_parameters(), again.parameters()):
        assert torch.equal(a, b) and a.std() > 0 or name.endswith("beta")
    x = example_input(full, "Diffusion1D")
    assert x.shape == (1, 24, 64) == jax.eval_shape(
        lambda: jnp.zeros((1, 24, 64))).shape
    assert net(nchw(x.numpy()), torch.ones(1)).shape == (1, 64, 24)
    # every registry name of the JAX package builds (NCSN v1 too); an
    # unknown name is refused
    assert type(get_model("ncsn")(full)).__name__ == "NCSN"
    with pytest.raises(NotImplementedError, match="unknown model"):
        get_model("ncsnv2_512")


# -- tubes, FiniteDiff, ladders: exact -------------------------------------

def test_reshape_temporal_dim_equals_jax():
    x = _np(np.random.RandomState(7).randn(3, 5, 8, 12))
    ref = np.asarray(jreshape.reshape_temporal_dim(jnp.asarray(x), 4, 2))
    tubes = reshape.reshape_temporal_dim(torch.tensor(x), 4, 2)
    np.testing.assert_array_equal(tubes.numpy(), ref)
    back = reshape.reshape_temporal_dim(tubes, 4, 2, "backward",
                                        img_size=(8, 12))
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="tile"):
        reshape.reshape_temporal_dim(torch.tensor(x), 3, 2)


@pytest.mark.parametrize("shift_on", [False, True], ids=["no_shift",
                                                         "shift"])
def test_apply_in_tube_space_equals_jax(shift_on):
    rs = np.random.RandomState(8)
    a, b = _np(rs.randn(2, 3, 8, 8, 2)), _np(rs.randn(2, 3, 8, 8, 2))
    key = jax.random.PRNGKey(5)
    sh, sw = (int(v) for v in jax.random.randint(key, (2,), 0, 4))
    assert (sh, sw) != (0, 0)
    fn = lambda u, v: (2.0 * u + v, u - 3.0 * v)
    ref = jreshape.apply_in_tube_space(fn, (jnp.asarray(a), jnp.asarray(b)),
                                       4, key=key,
                                       if_random_shift=shift_on)
    ours = reshape.apply_in_tube_space(
        fn, (torch.tensor(a), torch.tensor(b)), 4,
        shift=(lambda win: (sh, sw)) if shift_on else None)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    seen = []
    reshape.apply_in_tube_space(lambda t: (seen.append(t.shape) or t,),
                                (torch.tensor(a),), 4)
    assert seen == [(2 * 2 * 2 * 2, 3, 16)]


def test_finite_diff_equals_jax():
    x = _np(np.random.RandomState(9).randn(2, 5, 4, 4, 1))
    s = _np(np.random.RandomState(10).randn(2, 5, 4, 4, 1))
    for dims in (1, (1, 2)):
        jd, d = JFiniteDiff(dims=dims), FiniteDiff(dims=dims)
        tx, ts = torch.tensor(x), torch.tensor(s)
        np.testing.assert_array_equal(d(tx).numpy(), jd(jnp.asarray(x)))
        np.testing.assert_array_equal(d.conj_op(ts).numpy(),
                                      jd.conj_op(jnp.asarray(s)))
        np.testing.assert_array_equal(
            d.log_lh_grad(tx, lamda=0.3).numpy(),
            jd.log_lh_grad(jnp.asarray(x), lamda=0.3))
        # the adjoint: <D x, s> = <x, D^T s>
        assert np.isclose(float((d(tx) * ts).sum()),
                          float((tx * d.conj_op(ts)).sum()), rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_2d_time_ladders_equal_jax(mode):
    s = jax_sigma_ladder(60, 0.01, 8)
    t = jax_sigma_ladder(40, 0.01, 400)
    for ours, ref in zip(ald.setup_2d_time_ladders(s, t, mode),
                         jald.setup_2d_time_ladders(s, t, mode)):
        ref = np.asarray(ref)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    if mode == "diffusion1d":
        labels = ald.interp_sigma_T_indices(s, t)
        assert labels.tolist() == [0, 0, 57, 114, 171, 228, 285, 342]
        np.testing.assert_array_equal(np.asarray(t)[labels[1:]],
                                      ald.interp_sigmas_T(s, t)[1:])


def test_2d_time_ladders_refuse_no_overlap():
    s, t = np.array([10.0, 5.0], np.float32), np.array([1.0], np.float32)
    for fn in (ald.interp_sigmas_T, ald.interp_sigma_T_indices):
        with pytest.raises(ValueError, match="entirely below"):
            fn(s, t)
    with pytest.raises(ValueError, match="entirely below"):
        ald.setup_2d_time_ladders(s, t, "diffusion1d")
    for mode in ("tv", "none"):          # these never read sigmas_T
        assert (ald.setup_2d_time_ladders(s, t, mode)[1] == -1).all()
    with pytest.raises(ValueError, match="mode_T"):
        ald.setup_2d_time_ladders(s, t, "diffusion2d")


# -- the sampler against JAX, fed its noise -------------------------------

@functools.lru_cache(maxsize=None)
def _jax_inner(mode, shift_on):
    """JAX's _pair_2d_time_inner at level 1 (a temporal level), one step,
    jitted once per static (mode, shift); the params are arguments."""
    def run(pS, pT, prox, xr, xi, yr, yi, key):
        def score_S(x, labels):
            return J_S.apply({"params": pS}, x, SIG[labels])

        def score_T(x, labels):
            return J_T.apply({"params": pT}, x, SIG_T[labels])

        scan, sig_T, labels_T = jald.setup_2d_time_ladders(SIG, SIG_T, mode)
        inner = jald_pair._pair_2d_time_inner(
            score_S, score_T, prox, JFiniteDiff(dims=1),
            jald.ALDConfig(n_steps_each=1, step_lr=STEP_LR), mode, shift_on,
            WIN, scan[-1], sig_T[-1])
        return inner(xr, xi, yr, yi, 1, labels_T[1], scan[1], sig_T[1],
                     jnp.float32(LR_SCALED), jnp.float32(LAMDA_T), key)[:2]
    return jax.jit(run)


def port_recon(s, mode="diffusion1d", shift_on=False, n_steps=NSTEPS,
               lamda_T=LAMDA_T):
    return make_stepped_2d_time_pair_reconstructor(
        s["netS"], s["netT"], torch.tensor(np.asarray(SIG)),
        torch.tensor(np.asarray(SIG_T)), s["lin"], s["prox"],
        ald.ALDConfig(n_steps_each=n_steps, step_lr=STEP_LR),
        lr_scaled=LR_SCALED, mode_T=mode, lamda_T=lamda_T,
        if_random_shift=shift_on, win_size=WIN, num_frames=TF, device="cpu")


@pytest.mark.parametrize("mode,shift_on", [
    ("diffusion1d", False), ("diffusion1d", True), ("tv", False),
    ("none", False), ("diffusion1d-only", False),
    ("diffusion1d-only", True), ("tv-only", False)])
def test_inner_step_matches_jax(setup, mode, shift_on):
    """One inner step at level 1 from the chain's start A^H y, in each
    mode (the shift matters only to the temporal diffusion step)."""
    s = setup
    key = jax.random.PRNGKey(13)
    yb, yib = jnp.asarray(s["yb"]), jnp.asarray(s["yib"])
    xr, xi = s["jlin"].conj_op(yb, yib)
    prox = jald_pair._bake_ahy(s["jprox"], xr, xi)
    shape = (CHAINS, TF, H, W, 1)
    ref = _jax_inner(mode, shift_on)(s["pS"], s["pT"], prox,
                                     xr.reshape(shape), xi.reshape(shape),
                                     yb, yib, key)
    recon = port_recon(s, mode, shift_on, n_steps=1)
    noise, shift = cine_draws(key, mode, shift_on, [1], 1)
    with torch.inference_mode():
        y = torch.tensor(s["yb"]), torch.tensor(s["yib"])
        pr, pi, p = recon.start(*y)
        ours = recon.level_step(p, pr, pi, *y, 1, noise, shift)
    for o, r in zip(ours, ref):
        assert o.shape == shape
        assert rel_l2(o.numpy(), r) <= REL_L2, (mode, rel_l2(o.numpy(), r))


def test_stepped_chain_matches_jax(setup):
    """The whole stepped chain (3 levels x 2 steps, temporal diffusion,
    random shift): JAX's make_stepped_2d_time_pair_reconstructor against
    the port's, fed JAX's noise and shifts."""
    s = setup
    jrecon = jald_pair.make_stepped_2d_time_pair_reconstructor(
        J_S, J_T, SIG, SIG_T, s["jlin"], s["jprox"],
        jald.ALDConfig(n_steps_each=NSTEPS, step_lr=STEP_LR),
        lr_scaled=LR_SCALED, mode_T="diffusion1d", lamda_T=LAMDA_T,
        if_random_shift=True, win_size=WIN, num_frames=TF)
    key = jax.random.PRNGKey(11)
    ref = jrecon(s["pS"], s["pT"], jnp.asarray(s["yb"]),
                 jnp.asarray(s["yib"]), key)
    noise, shift = cine_draws(key, "diffusion1d", True, range(LEVELS),
                              NSTEPS)
    ours = port_recon(s, shift_on=True)(
        torch.tensor(s["yb"]), torch.tensor(s["yib"]), noise=noise,
        shift=shift)
    for o, r in zip(ours, ref):
        assert o.shape == (CHAINS, TF, H, W, 1) and torch.isfinite(o).all()
        assert rel_l2(o.numpy(), r) <= REL_L2


def test_whole_chain_form_is_the_stepped_loop(setup):
    """ald_2d_time_pair (score functions in) equals the stepped
    reconstructor (nets in) on the same seed; the seeded shift and noise
    repeat; tv needs no temporal net, diffusion1d refuses to run without
    one."""
    s = setup
    y = torch.tensor(s["yb"]), torch.tensor(s["yib"])
    score_S = make_score_fn(s["netS"], torch.tensor(np.asarray(SIG)))
    score_T = make_score_fn(s["netT"], torch.tensor(np.asarray(SIG_T)))
    direct = ald_2d_time_pair(
        score_S, score_T, SIG, SIG_T, y, s["lin"], s["prox"], seed=4,
        config=ald.ALDConfig(n_steps_each=NSTEPS, step_lr=STEP_LR),
        lr_scaled=LR_SCALED, lamda_T=LAMDA_T, if_random_shift=True,
        win_size=WIN, num_frames=TF, device="cpu")
    stepped = port_recon(s, shift_on=True)(*y, seed=4)
    for a, b in zip(direct, stepped):
        assert torch.equal(a, b)
    tv = ald_2d_time_pair(score_S, None, SIG, SIG_T, y, s["lin"], s["prox"],
                          seed=4, mode_T="tv", win_size=WIN, num_frames=TF,
                          device="cpu")
    assert all(torch.isfinite(v).all() for v in tv)
    with pytest.raises(ValueError, match="temporal score"):
        Stepped2DTimePairReconstructor(score_S, None, SIG, SIG_T, s["lin"],
                                       s["prox"], device="cpu")
    a, b = random_shift(0), random_shift(0)
    pairs = [a(8) for _ in range(4)]
    assert pairs == [b(8) for _ in range(4)]
    assert all(0 <= v < 8 for p in pairs for v in p)


# -- the engine ------------------------------------------------------------

ENGINE_SPEC = dict(height=H, width=W, frames=TF, channels=1,
                   num_sens=NSENS, chains=CHAINS, n_steps_each=NSTEPS,
                   step_lr=STEP_LR, lr_scaled=LR_SCALED, mode_T="diffusion1d",
                   lamda_T=1.0, win_size=WIN, if_random_shift=True,
                   prox_iters=3, dtype="f32", mode="steps")


def engine(s, **kw):
    return CineReconstructionEngine(
        s["netS"], torch.tensor(np.asarray(SIG)),
        spec=CineEngineSpec(**{**ENGINE_SPEC, **kw}), model_T=s["netT"],
        sigmas_T=torch.tensor(np.asarray(SIG_T)), mask=s["mask"],
        sens_re=s["maps"], device="cpu")


def test_engine_matches_jax_with_an_operator_override(setup):
    """The JAX cine engine (steps mode) and the port's on a request with
    new per-frame masks, new coil maps, lr_scaled and lamda_T; the port
    fed the JAX engine's noise and shifts."""
    s = setup
    jeng = JCineEngine(J_S, s["pS"], SIG, spec=JCineSpec(**ENGINE_SPEC),
                       module_T=J_T, params_T=s["pT"], sigmas_T=SIG_T,
                       mask=s["mask"], sens_re=s["maps"])
    rng = np.random.RandomState(9)
    mask2 = (rng.rand(TF, 1, W, 1) < 0.7).astype(np.float32)
    maps2 = s["maps"][::-1].copy()
    req = dict(mask=mask2, sens_re=maps2, sens_im=0.1 * maps2, seed=6,
               lr_scaled=3.0, lamda_T=0.5)
    ref = jeng.reconstruct(s["y"], s["yi"], **req)
    eng = engine(s)
    noise, shift = cine_draws(jax.random.PRNGKey(6), "diffusion1d", True,
                              range(LEVELS), NSTEPS)
    ours = eng.reconstruct(s["y"], s["yi"], noise=noise, shift=shift, **req)
    for name in ("x_re", "x_im", "mean_mag", "std_mag"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.shape == b.shape and np.isfinite(a).all()
        assert rel_l2(a, b) <= REL_L2, (name, rel_l2(a, b))
    assert ours.x_re.shape == (CHAINS, TF, H, W, 1)
    assert ours.chain_steps_per_s == pytest.approx(
        LEVELS * NSTEPS * CHAINS / ours.latency_s)


def test_engine_requests_and_shapes(setup):
    """Per-frame normal kernel (T, W, W) whatever the chain count; a coil
    override keeps the default per-frame mask; one input signature over
    requests that change operators and weights; the measurement's shape
    rules; the JAX engine's refusals."""
    s = setup
    eng = engine(s, if_random_shift=False)
    prox = eng._build_proximal(eng.default_lin_tfm)
    assert prox.kernel_re.shape == (TF, W, W)
    assert eng.default_lin_tfm.mask.shape == (CHAINS * TF, 1, W, 1)
    r1 = eng.reconstruct(s["y"], s["yi"], seed=1)
    r2 = eng.reconstruct(s["y"][..., None], s["yi"][..., None], seed=1)
    np.testing.assert_array_equal(r1.x_re, r2.x_re)
    r3 = eng.reconstruct(s["y"], s["yi"], seed=1, sens_re=s["maps"])
    np.testing.assert_array_equal(r1.x_re, r3.x_re)     # same operator
    eng.reconstruct(2 * s["y"], s["yi"], seed=2, lr_scaled=7.0,
                    lamda_T=0.5, mask=s["mask"][::-1])
    stats = eng.stats()
    assert stats["requests"] == 4 and stats["input_signatures"] == 1
    with pytest.raises(ValueError, match="measurement shape"):
        eng.reconstruct(s["y"][:, :2], s["yi"][:, :2])
    with pytest.raises(ValueError, match="frames"):
        eng.reconstruct(s["y"], s["yi"], mask=np.ones((2, 1, W, 1)))
    base = dict(spec=CineEngineSpec(**ENGINE_SPEC), device="cpu")
    sig = torch.tensor(np.asarray(SIG))
    with pytest.raises(ValueError, match="temporal score model"):
        CineReconstructionEngine(s["netS"], sig, **base)
    with pytest.raises(ValueError, match="mode"):
        CineReconstructionEngine(
            s["netS"], sig, model_T=s["netT"], sigmas_T=SIG_T,
            spec=CineEngineSpec(**{**ENGINE_SPEC, "mode": "graph"}),
            device="cpu")
    # dtype int8 (refused before it was ported): both nets' copies on the
    # int8 path, the 1-D temporal net's convolutions too; finite chains
    q8 = CineReconstructionEngine(
        s["netS"], sig, model_T=s["netT"], sigmas_T=SIG_T,
        spec=CineEngineSpec(**{**ENGINE_SPEC, "dtype": "int8"}),
        device="cpu")
    res8 = q8.reconstruct(s["y"], s["yi"], seed=1)
    assert np.isfinite(res8.x_re).all() and res8.x_re.dtype == np.float32
    with pytest.raises(ValueError, match="'data' axis"):
        CineReconstructionEngine(s["netS"], sig, model_T=s["netT"],
                                 sigmas_T=SIG_T, mesh=object(), **base)
    tv = CineReconstructionEngine(
        s["netS"], sig, spec=CineEngineSpec(**{**ENGINE_SPEC, "mode_T": "tv",
                                             "num_sens": 0}),
        mask=s["mask"], device="cpu")
    res = tv.reconstruct(s["y"][0], s["yi"][0])
    assert res.x_re.shape == (CHAINS, TF, H, W, 1)
    assert np.isfinite(res.mean_mag).all()


# -- serve_recon --workload cine -------------------------------------------

CLI = ["--workload", "cine", "--device", "cpu", "--ds_name", "CINE127",
       "--chains", "2", "--levels", "2", "--frames", str(TF), "--num_sens",
       "2", "--dtype", "f32", "--R", "8", "--synth_sens", "--win_size", "8",
       "--override", "data.image_size=16", "--override", "model.ngf=8"]


def test_cli_cine_serves_a_request_over_http(capsys):
    """serve_recon builds the cine engine (the spatial net overridden
    tiny, the CINE127_1D temporal net at full width, both from seed 0,
    per-frame R = 8 masks, synthetic coil maps) and answers POST
    /reconstruct with a per-frame mask and ?lr_scaled over HTTP."""
    eng = serve_recon.build_engine(serve_recon.parse_args(CLI))
    out = capsys.readouterr().out
    assert "WARNING: no checkpoint for Diffusion1D" in out
    assert type(eng).__name__ == "CineReconstructionEngine"
    assert eng.spec.frames == TF and eng.spec.height == 16 and eng.L == 2
    assert eng.model_T.ndim == 1 and eng.model_T.begin_conv.out_channels \
        == 128
    mask = eng.default_lin_tfm.mask[:TF, 0, :, 0]
    assert (mask.sum(-1) < 16).all() and not torch.equal(mask[0], mask[1])
    assert eng.default_lin_tfm.sens_re.std() > 0
    httpd = serve(eng, "127.0.0.1", 0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        buf = io.BytesIO()
        y = np.random.RandomState(0).rand(2, TF, 16, 16).astype(np.float32)
        np.savez(buf, y_re=y, y_im=0 * y, mask=np.ones((TF, 1, 16, 1)))
        req = urllib.request.Request(
            f"{base}/reconstruct?seed=3&lr_scaled=2.0",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req) as r:
            body = np.load(io.BytesIO(r.read()))
            assert float(r.headers["X-Chain-Steps-Per-S"]) > 0
        assert body["x_re"].shape == (2, TF, 16, 16, 1)
        assert body["mean_mag"].shape == (TF, 16, 16, 1)
        assert np.isfinite(body["x_re"]).all()
        with urllib.request.urlopen(f"{base}/healthz") as r:
            health = json.loads(r.read())
        assert health["requests"] == 1 and health["spec"]["frames"] == TF
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_cli_cine_tv_mode_builds_no_temporal_net():
    eng = serve_recon.build_engine(serve_recon.parse_args(
        CLI + ["--mode_T", "tv", "--R", "0", "--ds_name", "CINE64"]))
    assert eng.model_T is None and eng.spec.mode_T == "tv"
    assert eng.default_lin_tfm.mask.min() == 1.0          # R = 0
    y = np.zeros((2, TF, 16, 16), np.float32)
    assert np.isfinite(eng.reconstruct(y, y).mean_mag).all()


# -- the trained cine priors (artifacts/, this checkout only) ---------------

@pytest.mark.slow
@pytest.mark.parametrize("which", ["spatial", "temporal"])
def test_trained_cine_priors_match_jax(which):
    """artifacts/cine_priors_128: the spatial NCSNv2 (ngf 64, 128 px
    frames) and the temporal NCSN1D (ngf 128, CINE127_1D tubes) through
    the converter, full-size forwards against JAX on the CPU."""
    from flax import serialization
    path = os.path.join(ROOT, "artifacts", "cine_priors_128",
                        f"{which}.msgpack")
    with open(path, "rb") as f:
        params = jax.tree_util.tree_map(
            _np, serialization.msgpack_restore(f.read()))
    if which == "spatial":
        over = {"model.ngf": 64}
        jcfg = jax_load_config("CINE127", "real-imag", **over)
        cfg = load_config("CINE127", "real-imag", **over)
        module, name, shape = JaxNCSNv2(config=jcfg), "ncsnv2", (2, 128, 128,
                                                                  1)
    else:
        jcfg = jax_load_config("CINE127_1D", "real-imag")
        cfg = load_config("CINE127_1D", "real-imag")
        module, name, shape = jncsn1d.NCSN1D(jcfg), "ncsn1d", (8, 24, 64)
    net = get_model(name)(cfg)
    net.load_state_dict(flax_to_torch_ncsnv2(params, cfg, name),
                        strict=True)
    x = _np(np.random.RandomState(0).rand(*shape))
    s = _np([40.0, 0.05] * (shape[0] // 2))
    ref = np.asarray(module.apply({"params": params}, x, s))
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        with torch.inference_mode():
            out = nhwc(net(nchw(x), torch.tensor(s)))
    finally:
        torch.set_num_threads(1)
    assert rel_l2(out, ref) <= 1e-5
