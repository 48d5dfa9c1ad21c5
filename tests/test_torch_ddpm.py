"""The port's DDPM and DDPM++ nets and the naive resamplers (models/) against
the JAX package's, with the JAX parameters drawn with numpy at the shapes
jax.eval_shape gives and converted by utils/convert.py; every continuous
leaf builds and runs; whole PC runs of a DDPM and
a DDPM++ net, and of the ve/ncsnv2 leaf through the channel-last adapter,
fed the JAX sampler's noise.

Tiny nets: 16 x 16, nf 32 (DDPM's GroupNorm has 32 groups at every width),
ch_mult (1, 2), one res block, attention at 8 x 8, dropout 0. Tolerances:
a forward at rtol 1e-5 with atol 1e-5 of the output's largest |value|
(float32 sums over a few hundred terms in another order, through about 20
layers); a single layer at rtol 1e-5, atol 1e-6; whole chains at rtol
1e-5, atol 1e-5 of the largest |value|.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from inverseproblemwithdiffusionmodel_tpu.configs_continuous import (
    get_continuous_config as jax_get_config, make_sde as jax_make_sde)
from inverseproblemwithdiffusionmodel_tpu.models import layerspp as jlpp
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    create_model as jax_create_model)
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    sigma_ladder as jax_sigma_ladder)
from inverseproblemwithdiffusionmodel_tpu.sde import sampling as jsampling
from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
    get_continuous_config, list_continuous_configs, make_sde)
from inverseproblemwithdiffusionmodel_tpu_torch.models import create_model
from inverseproblemwithdiffusionmodel_tpu_torch.models import layerspp
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    continuous_model_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import pc_sampling
from inverseproblemwithdiffusionmodel_tpu_torch.sde import (
    get_pc_sampler, get_score_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch, flax_to_torch_ddpm, flax_to_torch_ncsnpp,
    flax_to_torch_ncsnv2, seeded_weights)
from test_torch_sde_sampling import jax_pc_noise

torch.set_num_threads(2)

TINY = {"data.image_size": 16, "model.nf": 32, "model.ch_mult": (1, 2),
        "model.num_res_blocks": 1, "model.attn_resolutions": (8,),
        "model.dropout": 0.0}


def draw(shapes, rs, path=()):
    """Params at the shapes of a jax.eval_shape tree: kernels at fan-in
    scale, GroupNorm scales 1 + 0.1 z, biases 0.1 z."""
    out = {}
    for key, value in shapes.items():
        if hasattr(value, "items"):
            out[key] = draw(value, rs, path + (key,))
            continue
        z = rs.randn(*value.shape).astype(np.float32)
        if key == "scale":
            out[key] = 1.0 + 0.1 * z
        elif len(value.shape) == 1:
            out[key] = 0.1 * z
        else:
            out[key] = z / np.sqrt(np.prod(value.shape[:-1]))
    return out


def pair(leaf, seed=0, **over):
    """The leaf at the tiny override in both packages, with the same
    weights: (jax apply, jax module, params, port model, port config)."""
    over = dict(TINY, **over)
    jcfg = jax_get_config(leaf).replace(**over)
    cfg = get_continuous_config(leaf).replace(**over)
    module = jax_create_model(jcfg)
    C = cfg.data.num_channels
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, C)), jnp.ones((1,)))
    params = draw(shapes["params"], np.random.RandomState(seed))
    convert = (flax_to_torch_ddpm if cfg.model.name == "ddpm"
               else flax_to_torch_ncsnpp)
    model = create_model(cfg).eval()
    model.load_state_dict(convert(params, cfg), strict=True)
    apply = jax.jit(lambda x, c: module.apply({"params": params}, x, c))
    return apply, module, params, model, cfg, jcfg


def _np(x):
    return np.asarray(x, dtype=np.float32)


def close(out, ref, rtol=1e-5, scale=1e-5):
    ref = _np(ref)
    np.testing.assert_allclose(_np(out), ref, rtol=rtol,
                               atol=scale * np.abs(ref).max())


@pytest.mark.parametrize("leaf,labels,over", [
    ("vp/ddpm/cifar10", [0.0, 517.3], {}),      # conditional, t * 999
    ("vp/ddpm/cifar10_unconditional", [3.0, 40.0], {}),
    ("ve/cifar10_ddpm", [0.0, 999.0], {}),      # scale_by_sigma, centered off
    ("vp/cifar10_ddpmpp_continuous", [0.5, 998.0], {}),   # DDPM++ (ncsnpp)
    ("subvp/cifar10_ddpmpp_continuous", [12.0, 600.0], {}),
    # NCSN++'s DDPM blocks with the naive resamplers' Conv_0
    ("vp/cifar10_ddpmpp_continuous", [7.0, 300.0],
     {"model.resblock_type": "ddpm"})])
def test_tiny_net_matches_jax(leaf, labels, over):
    apply, _, _, model, cfg, _ = pair(leaf, **over)
    x = np.random.RandomState(1).rand(2, 16, 16, 3).astype(np.float32)
    c = np.asarray(labels, np.float32)
    ref = apply(jnp.asarray(x), jnp.asarray(c))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(c))
    assert out.shape == (2, 16, 16, 3)
    assert np.abs(_np(ref)).max() > 1e-2    # the weights make it count
    close(out, ref)


@pytest.mark.parametrize("leaf", ["vp/ddpm/cifar10",
                                  "vp/cifar10_ddpmpp_continuous"])
def test_full_width_nets_have_the_jax_parameter_count(leaf):
    jcfg = jax_get_config(leaf)
    shapes = jax.eval_shape(jax_create_model(jcfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)), jnp.ones((1,)))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        model = create_model(get_continuous_config(leaf))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_flax_to_torch_ddpm_checks_names_and_model():
    _, _, params, _, cfg, _ = pair("vp/ddpm/cifar10")
    state = flax_to_torch_ddpm(params, cfg)
    assert "down_0.Conv_0.weight" in state and "up_1.Conv_0.weight" in state
    with pytest.raises(ValueError, match="not 'ddpm'"):
        flax_to_torch_ddpm(params, get_continuous_config(
            "vp/cifar10_ddpmpp_continuous").replace(**TINY))
    del params["res_0"]
    with pytest.raises(KeyError, match="missing"):
        flax_to_torch_ddpm(params, cfg)


def _layer(jmod, tmod, x, extra=()):
    """Init the Flax layer at numpy-drawn params, load them into the torch
    layer, compare one call."""
    jin = [jnp.asarray(x)] + [jnp.asarray(e) for e in extra]
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *jin)
    params = draw(shapes.get("params", {}), np.random.RandomState(2))
    ref = jmod.apply({"params": params}, *jin)
    if params:
        tmod.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), *[torch.from_numpy(e)
                                          for e in extra])
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-6)


def _rand(*shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_naive_resamplers_match_jax():
    x = _rand(2, 6, 4, 5)
    np.testing.assert_array_equal(
        layerspp.naive_upsample_2d(torch.from_numpy(x)).numpy(),
        _np(jlpp.naive_upsample_2d(jnp.asarray(x))))
    np.testing.assert_allclose(
        layerspp.naive_downsample_2d(torch.from_numpy(x)).numpy(),
        _np(jlpp.naive_downsample_2d(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("with_conv,out_ch", [(False, None), (True, None),
                                              (True, 8)])
@pytest.mark.parametrize("up", [True, False])
def test_resamplers_without_fir_match_jax(up, with_conv, out_ch):
    jcls, tcls = ((jlpp.Upsample, layerspp.Upsample) if up
                  else (jlpp.Downsample, layerspp.Downsample))
    _layer(jcls(out_ch=out_ch, with_conv=with_conv, fir=False),
           tcls(in_ch=4, out_ch=out_ch, with_conv=with_conv, fir=False),
           _rand(2, 6, 6, 4))


@pytest.mark.parametrize("up,down", [(True, False), (False, True)])
def test_biggan_block_without_fir_matches_jax(up, down):
    jmod = jlpp.ResnetBlockBigGANpp(act=jax.nn.silu, out_ch=8, up=up,
                                    down=down, fir=False, dropout=0.0)
    tmod = layerspp.ResnetBlockBigGANpp(act=F.silu, in_ch=8, out_ch=8,
                                        up=up, down=down, fir=False,
                                        dropout=0.0, temb_dim=12).eval()
    _layer(jmod, tmod, _rand(2, 8, 8, 8), (_rand(2, 12, seed=4),))


LEAVES = list_continuous_configs()


@pytest.mark.parametrize("leaf", LEAVES)
def test_every_leaf_builds_and_runs_a_forward(leaf):
    # all 39 leaves (the eight ve/ncsn/* on NCSN v1), at the tiny
    # override, through the score function pc_sampling builds
    cfg = get_continuous_config(leaf).replace(**TINY, **{"model.ngf": 8})
    model = seeded_weights(create_model(cfg), 0).eval()
    cond = pc_sampling.first_cond(cfg)
    sde = make_sde(cfg)
    score_fn = get_score_fn(sde, continuous_model_fn(model, cfg),
                            continuous=cfg.training.continuous)
    with torch.no_grad():
        first = continuous_model_fn(model, cfg)(torch.zeros(1, 16, 16, 3),
                                                cond)
        out = score_fn(torch.rand(2, 16, 16, 3), torch.tensor([0.9, 0.1]))
    assert first.shape == (1, 16, 16, 3)
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out).all()


def test_there_are_31_such_leaves():
    # 31 leaves before NCSN v1 was ported; all 39 now
    assert len(LEAVES) == len(list_continuous_configs()) == 39


@pytest.mark.parametrize("leaf", ["vp/ddpm/cifar10",
                                  "vp/cifar10_ddpmpp_continuous"])
def test_pc_run_of_a_net_matches_jax_fed_its_noise(leaf):
    N, shape, key = 3, (2, 16, 16, 3), jax.random.PRNGKey(7)
    _, module, params, model, cfg, jcfg = pair(leaf)
    over = {"model.num_scales": N}
    jcfg, cfg = jcfg.replace(**over), cfg.replace(**over)
    jsde, sde = jax_make_sde(jcfg), make_sde(cfg)
    s, continuous = jcfg.sampling, jcfg.training.continuous
    kw = dict(predictor=s.predictor, corrector=s.corrector, snr=s.snr)
    jscore = jsampling.get_score_fn(
        jsde, lambda x, c: module.apply({"params": params}, x, c),
        continuous)
    ref, ref_nfe = jax.jit(lambda k: jsampling.get_pc_sampler(
        jsde, shape, **kw)(jscore, k))(key)
    draws = iter(jax_pc_noise(key, shape, N, s.predictor, s.corrector))
    with torch.no_grad():
        out, nfe = get_pc_sampler(sde, shape, device="cpu", **kw)(
            get_score_fn(sde, model, continuous),
            noise=lambda sh: torch.tensor(_np(next(draws))))
    assert nfe == int(ref_nfe) and next(draws, None) is None
    close(out, ref)


def test_ncsnv2_leaf_samples_through_the_adapter():
    """ve/ncsnv2/cifar10 (discrete VE, no predictor, the `ald` corrector):
    the port's NCSNv2 takes NCHW x and sigma values, and the adapter hands
    it to_nchw(x) and the config's descending ladder at the label. Held to
    JAX's pc sampler running JAX's NCSNv2 on sigmas[label] (JAX's own
    pc_sampling hands the net the label, which it divides by: NaN)."""
    from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
        NCSNv2 as JaxNCSNv2)
    N, shape, key = 3, (2, 16, 16, 3), jax.random.PRNGKey(8)
    over = {"data.image_size": 16, "model.ngf": 8, "model.num_scales": N,
            "sampling.n_steps_each": 2}
    jcfg = jax_get_config("ve/ncsnv2/cifar10").replace(**over)
    cfg = get_continuous_config("ve/ncsnv2/cifar10").replace(**over)
    module = JaxNCSNv2(config=jcfg)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)))
    rs = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda s: (rs.rand(*s.shape).astype(np.float32) - 0.5) * 0.6,
        shapes["params"])
    model = create_model(cfg).eval()
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg), strict=True)
    m = jcfg.model
    sigmas = jnp.asarray(jax_sigma_ladder(m.sigma_max, m.sigma_min, N,
                                          "geometric"))
    jsde, sde = jax_make_sde(jcfg), make_sde(cfg)
    s = jcfg.sampling
    kw = dict(predictor=s.predictor, corrector=s.corrector, snr=s.snr,
              n_steps=s.n_steps_each)
    jscore = jsampling.get_score_fn(
        jsde, lambda x, c: module.apply({"params": params}, x, sigmas[c]),
        continuous=False)
    ref, ref_nfe = jax.jit(lambda k: jsampling.get_pc_sampler(
        jsde, shape, **kw)(jscore, k))(key)
    draws = iter(jax_pc_noise(key, shape, N, s.predictor, s.corrector,
                              n_steps=s.n_steps_each))
    with torch.no_grad():
        out, nfe = get_pc_sampler(sde, shape, device="cpu", **kw)(
            get_score_fn(sde, continuous_model_fn(model, cfg),
                         continuous=False),
            noise=lambda sh: torch.tensor(_np(next(draws))))
    assert nfe == int(ref_nfe) == 3 * N and next(draws, None) is None
    assert np.isfinite(_np(ref)).all()
    close(out, ref)
