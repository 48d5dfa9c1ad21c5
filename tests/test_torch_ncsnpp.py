"""The port's NCSN++ (models/) against the JAX package's, layer by layer and
whole, with the JAX parameters converted by utils/convert.py; and the whole
slice, NCSN++ under the PC sampler, fed the JAX sampler's noise.

The tiny model is the FFHQ-256 leaf cut to 16x16, nf 16, ch_mult (1, 2, 2),
one res block and attention at 8x8: every FIR, pyramid and attention branch
stays on. The JAX init has init_scale 0 on the last conv of each block,
which leaves outputs near 1e-6 and a comparison blind, so the JAX params are
redrawn with numpy at fan-in scale before the comparison. Tolerance rtol
1e-4 / atol 1e-5: float32 sums over up to a few hundred terms in another
order, through about 30 layers.
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
from inverseproblemwithdiffusionmodel_tpu.models.ncsnpp import (
    NCSNpp as JaxNCSNpp)
from inverseproblemwithdiffusionmodel_tpu.sde import (
    get_pc_sampler as jax_get_pc_sampler, get_score_fn as jax_get_score_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
    get_continuous_config, make_sde)
from inverseproblemwithdiffusionmodel_tpu_torch.models import create_model
from inverseproblemwithdiffusionmodel_tpu_torch.models import layerspp
from inverseproblemwithdiffusionmodel_tpu_torch.ops import fir_kernels as fk
from inverseproblemwithdiffusionmodel_tpu_torch.sde import (
    get_pc_sampler, get_score_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch, flax_to_torch_ncsnpp, seeded_weights)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
TINY = {"data.image_size": 16, "model.nf": 16, "model.ch_mult": (1, 2, 2),
        "model.num_res_blocks": 1, "model.attn_resolutions": (8,)}
LEAF = "ve/ffhq_256_ncsnpp_continuous"


def perturb(tree, rs, path=()):
    """Redraw Flax params with numpy: kernels at fan-in scale, GroupNorm
    scales 1 + 0.1 z, biases 0.1 z; the Fourier projection is kept."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out[key] = perturb(value, rs, path + (key,))
            continue
        value = np.asarray(value)
        z = rs.randn(*value.shape).astype(np.float32)
        if "fourier_proj" in path:
            out[key] = value
        elif key == "scale":
            out[key] = 1.0 + 0.1 * z
        elif value.ndim == 1:
            out[key] = 0.1 * z
        else:
            out[key] = z / np.sqrt(np.prod(value.shape[:-1]))
    return out


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def tiny():
    """The tiny NCSN++ in both packages with the same perturbed weights."""
    jcfg = jax_get_config(LEAF).replace(**TINY)
    module = JaxNCSNpp(config=jcfg)
    x0 = jnp.zeros((1, 16, 16, 3))
    params = jax.jit(module.init)(jax.random.PRNGKey(0), x0,
                                  jnp.ones((1,)))["params"]
    params = perturb(params, np.random.RandomState(0))
    apply = jax.jit(lambda x, s: module.apply({"params": params}, x, s))

    cfg = get_continuous_config(LEAF).replace(**TINY)
    model = create_model(cfg).eval()
    model.load_state_dict(flax_to_torch_ncsnpp(params, cfg), strict=True)
    return dict(jcfg=jcfg, cfg=cfg, module=module, params=params,
                apply=apply, model=model)


def test_config_registry_matches_jax():
    from inverseproblemwithdiffusionmodel_tpu import configs_continuous as jc
    from inverseproblemwithdiffusionmodel_tpu_torch import (
        configs_continuous as tc)
    assert tc.list_continuous_configs() == jc.list_continuous_configs()
    for name in jc.list_continuous_configs():
        assert tc.get_continuous_config(name).to_dict() == \
            jc.get_continuous_config(name).to_dict(), name


def test_full_width_ffhq_256_has_the_jax_parameter_count():
    cfg = get_continuous_config(LEAF)
    with torch.device("meta"):
        model = create_model(cfg)
    jcfg = jax_get_config(LEAF)
    shapes = jax.eval_shape(JaxNCSNpp(config=jcfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 3)), jnp.ones((1,)))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 65574549


def test_tiny_ncsnpp_matches_jax(tiny):
    rs = np.random.RandomState(1)
    x = rs.rand(2, 16, 16, 3).astype(np.float32)
    sigma = np.array([0.7, 40.0], np.float32)
    ref = _np(tiny["apply"](jnp.asarray(x), jnp.asarray(sigma)))
    with torch.no_grad():
        out = tiny["model"](torch.from_numpy(x), torch.from_numpy(sigma))
    assert out.shape == (2, 16, 16, 3)
    assert np.abs(ref).max() > 1e-2   # the weights make the output count
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_tiny_ncsnpp_launches_each_fir_once_per_call_site(tiny):
    # 2 levels down: BigGAN down (h and x) + input pyramid = 3 per level;
    # the same going up. On the CPU the count is of dispatches, read here
    # through the plain versions' callers.
    calls = {"up": 0, "down": 0}
    orig_up, orig_down = fk.upsample2x, fk.downsample2x

    def up(*a, **k):
        calls["up"] += 1
        return orig_up(*a, **k)

    def down(*a, **k):
        calls["down"] += 1
        return orig_down(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fk, "upsample2x", up)
        mp.setattr(fk, "downsample2x", down)
        with torch.no_grad():
            tiny["model"](torch.zeros(1, 16, 16, 3), torch.ones(1))
    assert calls == {"up": 6, "down": 6}


def _layer_pair(jmod, tmod, *inputs, rngs=None):
    """Init the Flax layer, perturb, load into the torch layer, compare."""
    jin = [jnp.asarray(v) if v is not None else None for v in inputs]
    params = jmod.init(jax.random.PRNGKey(0), *jin)["params"]
    params = perturb(params, np.random.RandomState(2))
    ref = _np(jmod.apply({"params": params}, *jin))
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        out = tmod(*[torch.from_numpy(v) if v is not None else None
                     for v in inputs])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def _rand(*shape, seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_attn_block_matches_jax():
    _layer_pair(jlpp.AttnBlockpp(skip_rescale=True),
                layerspp.AttnBlockpp(8, skip_rescale=True),
                _rand(2, 4, 4, 8))


@pytest.mark.parametrize("up,down,out_ch", [
    (True, False, 8), (False, True, 8), (False, True, 16),
    (False, False, 16)])
def test_biggan_block_matches_jax(up, down, out_ch):
    jmod = jlpp.ResnetBlockBigGANpp(act=jax.nn.silu, out_ch=out_ch, up=up,
                                    down=down, fir=True,
                                    fir_kernel=(1, 3, 3, 1), dropout=0.0)
    tmod = layerspp.ResnetBlockBigGANpp(act=F.silu, in_ch=8, out_ch=out_ch,
                                        up=up, down=down, fir=True,
                                        fir_kernel=(1, 3, 3, 1), dropout=0.0,
                                        temb_dim=12).eval()
    _layer_pair(jmod, tmod, _rand(2, 8, 8, 8), _rand(2, 12, seed=4))


@pytest.mark.parametrize("out_ch,conv_shortcut", [
    (8, False), (16, False), (16, True)])
def test_ddpm_block_matches_jax(out_ch, conv_shortcut):
    jmod = jlpp.ResnetBlockDDPMpp(act=jax.nn.silu, out_ch=out_ch,
                                  conv_shortcut=conv_shortcut, dropout=0.0,
                                  skip_rescale=True)
    tmod = layerspp.ResnetBlockDDPMpp(act=F.silu, in_ch=8, out_ch=out_ch,
                                      conv_shortcut=conv_shortcut,
                                      dropout=0.0, skip_rescale=True,
                                      temb_dim=12).eval()
    _layer_pair(jmod, tmod, _rand(2, 8, 8, 8), _rand(2, 12, seed=4))


@pytest.mark.parametrize("method", ["sum", "cat"])
def test_combine_matches_jax(method):
    _layer_pair(jlpp.Combine(features=8, method=method),
                layerspp.Combine(3, 8, method=method),
                _rand(2, 4, 4, 3), _rand(2, 4, 4, 8, seed=5))


def test_fourier_projection_matches_jax():
    jmod = jlpp.GaussianFourierProjection(embedding_size=16, scale=16.0)
    tmod = layerspp.GaussianFourierProjection(embedding_size=16, scale=16.0)
    _layer_pair(jmod, tmod, np.log(np.array([0.5, 30.0], np.float32)))


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 3.0, 999.0], np.float32)
    for dim in (16, 17):
        np.testing.assert_allclose(
            layerspp.get_timestep_embedding(torch.from_numpy(t), dim).numpy(),
            _np(jlpp.get_timestep_embedding(jnp.asarray(t), dim)), **TOL)


def test_resamplers_with_conv_are_not_ported():
    # Every resampler is ported now, FIR or naive, alone or with a conv
    # (the naive ones held to JAX in tests/test_torch_ddpm.py); those with
    # a conv still need the input channels.
    for cls in (layerspp.Upsample, layerspp.Downsample):
        for fir in (False, True):
            with pytest.raises(ValueError, match="in_ch"):
                cls(with_conv=True, fir=fir)
            for with_conv in (False, True):
                layer = cls(in_ch=4, with_conv=with_conv, fir=fir)
                assert layer(torch.zeros(1, 4, 4, 4)).shape[-1] == 4


def test_seeded_weights_are_deterministic_and_not_vanishing():
    cfg = get_continuous_config(LEAF).replace(**TINY)
    a = seeded_weights(create_model(cfg), seed=3).eval()
    b = seeded_weights(create_model(cfg), seed=3).eval()
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb), na
    with torch.no_grad():
        out = a(torch.rand(1, 16, 16, 3), torch.ones(1))
    assert out.abs().mean() > 1e-2


def test_pc_sampling_slice_matches_jax(tiny):
    """NCSN++ under the PC sampler (reverse diffusion + Langevin), N = 3,
    batch 2, the port fed the noise the JAX sampler draws."""
    N, shape, key = 3, (2, 16, 16, 3), jax.random.PRNGKey(7)
    jcfg = tiny["jcfg"].replace(**{"model.num_scales": N})
    jsde = jax_make_sde(jcfg)
    jscore = jax_get_score_fn(
        jsde, lambda x, c: tiny["module"].apply({"params": tiny["params"]},
                                                x, c))
    ref, ref_nfe = jax.jit(lambda k: jax_get_pc_sampler(
        jsde, shape, snr=jcfg.sampling.snr)(jscore, k))(key)

    draws = iter(jax_pc_noise(key, shape, N, n_steps=1))
    sde = make_sde(tiny["cfg"].replace(**{"model.num_scales": N}))
    sampler = get_pc_sampler(sde, shape, snr=jcfg.sampling.snr, device="cpu")
    with torch.no_grad():
        out, nfe = sampler(get_score_fn(sde, tiny["model"]),
                           noise=lambda s: torch.tensor(_np(next(draws))))
    assert nfe == int(ref_nfe) == 6
    # The chain's values are of order sigma_max (348): float32 rounding of
    # order 1e-7 of that scale sits on every element, small ones included.
    ref = _np(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-6 * np.abs(ref).max())


def jax_pc_noise(key, shape, N, n_steps):
    """The standard normal draws of the JAX PC sampler, in the order it makes
    them (sde/sampling.py:283-290, Langevin split :210)."""
    key, k_init = jax.random.split(key)
    draws = [jax.random.normal(k_init, shape)]
    for _ in range(N):
        key, k_c, k_p = jax.random.split(key, 3)
        for _ in range(n_steps):
            k_c, kn = jax.random.split(k_c)
            draws.append(jax.random.normal(kn, shape))
        draws.append(jax.random.normal(k_p, shape))
    return draws
