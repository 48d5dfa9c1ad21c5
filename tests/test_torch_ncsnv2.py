"""The port's NCSNv2 stack against the JAX package's: the ACDC config, the
numpy helpers of the reconstruction (masks, coil maps, ladders), the
Re/Im interleave, every layer block, InstanceNorm++, the three NCSNv2 nets
with the JAX parameters converted by utils/convert.flax_to_torch_ncsnv2,
the bf16 score adapter, and (marked slow) the trained ACDC prior.

The port's nets are NCHW, the JAX package's channel-last: inputs and
outputs are transposed here, weights by the converter. Layer blocks hold
at rtol 1e-5 (float32 sums over a few hundred terms in another order);
whole nets at rtol 1e-4 / atol 1e-5 (the same, through about 60 convs and
norms).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.models import layers as jlayers
from inverseproblemwithdiffusionmodel_tpu.models import (
    normalization as jnorm)
from inverseproblemwithdiffusionmodel_tpu.models import ncsnv2 as jncsnv2
from inverseproblemwithdiffusionmodel_tpu.operators import masks as jmasks
from inverseproblemwithdiffusionmodel_tpu.operators import (
    fourier as jfourier)
from inverseproblemwithdiffusionmodel_tpu.ops.resize import (
    resize_align_corners as jax_resize)
from inverseproblemwithdiffusionmodel_tpu.samplers import sigmas as jsigmas
from inverseproblemwithdiffusionmodel_tpu.utils import misc as jmisc
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.models import (
    get_model, get_network, layers, make_score_fn, normalization)
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import (
    NCSNv2, NCSNv2Deeper, NCSNv2Deepest)
from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
    fourier, masks)
from inverseproblemwithdiffusionmodel_tpu_torch.ops.resize import (
    resize_align_corners)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import sigmas
from inverseproblemwithdiffusionmodel_tpu_torch.utils import misc
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch, flax_to_torch_ncsnv2, seeded_weights)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)
NET_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(_np(x), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def draw(tree, rs, fan_in=None):
    """Params for a tree of shapes, drawn with numpy from the JAX init's
    distributions (kernels and biases U(+-1/sqrt(fan_in)), alpha and gamma
    N(1, 0.02)), except beta (init 0): 0.1 z, so that every parameter of a
    comparison is non-trivial."""
    if "kernel" in tree:
        fan_in = int(np.prod(tree["kernel"].shape[:-1]))
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = draw(value, rs)
            continue
        shape = tuple(value.shape)
        if key in ("kernel", "bias"):
            bound = 1 / np.sqrt(fan_in)
            out[key] = rs.uniform(-bound, bound, shape)
        elif key in ("alpha", "gamma"):
            out[key] = 1 + 0.02 * rs.randn(*shape)
        else:
            out[key] = 0.1 * rs.randn(*shape)
        out[key] = _np(out[key])
    return out


def init_flax(module, *args, seed=0):
    """Params of a Flax module for these example inputs, without compiling
    its init: shapes from jax.eval_shape, values from `draw`."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return draw(shapes["params"], np.random.RandomState(seed))


# -- config and numpy helpers --------------------------------------------

@pytest.mark.parametrize("mode", ["real-valued", "real-imag", "complex"])
def test_acdc_config_equals_the_yaml(mode):
    assert load_config("ACDC", mode).to_dict() == \
        jax_load_config("ACDC", mode).to_dict()


def test_load_config_overrides_and_refusals():
    over = {"model.ngf": 32, "data.image_size": 64}
    assert load_config("ACDC", "real-imag", **over).to_dict() == \
        jax_load_config("ACDC", "real-imag", **over).to_dict()
    with pytest.raises(KeyError, match="unknown dataset"):
        load_config("IMAGENET")
    with pytest.raises(ValueError, match="data mode"):
        load_config("ACDC", "polar")


@pytest.mark.parametrize("T,N,R,seed", [(1, 64, 8, 0), (1, 256, 8, 0),
                                        (4, 64, 16, 3), (1, 128, 20, 7)])
def test_generate_mask_is_bit_identical(T, N, R, seed):
    preset = fourier.MASK_PRESETS[R]
    ours = masks.generate_mask(T, N, seed=seed, **preset)
    ref = jmasks.generate_mask(T, N, seed=seed, **jfourier.MASK_PRESETS[R])
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


def test_random_cartesian_mask_and_presets_are_identical():
    assert fourier.MASK_PRESETS == jfourier.MASK_PRESETS
    for seed in (0, 5):
        assert np.array_equal(masks.random_cartesian_mask(64, 4, 0.08, seed),
                              jmasks.random_cartesian_mask(64, 4, 0.08, seed))


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_exp_sens_map_is_bit_identical(seed):
    ours = fourier._exp_sens_map(48, 64, seed)
    ref = jfourier._exp_sens_map(48, 64, seed)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize("mode", ["unconditioned", "recons"])
def test_get_sigmas_equals(mode):
    cfg = load_config("ACDC", "real-imag")
    ours = sigmas.get_sigmas(cfg, mode)
    ref = jsigmas.get_sigmas(jax_load_config("ACDC", "real-imag"), mode)
    assert ours.dtype == torch.float32 and ours.shape == (2311,)
    assert np.array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("start", [0.0, 0.3, 0.75, 1.0])
def test_get_lh_weights_equals(start):
    ladder = jsigmas.sigma_ladder(348, 0.01, 11)
    ours = sigmas.get_lh_weights(torch.tensor(np.asarray(ladder)), start)
    assert np.array_equal(ours.numpy(), np.asarray(
        jsigmas.get_lh_weights(ladder, start)))


def test_check_ladder_stability_equals():
    for L, steps, lr in ((2311, 3, 9e-7), (8, 3, 9e-7), (100, 5, 6.2e-6)):
        ladder = sigmas.sigma_ladder(348, 0.01, L)
        ours = sigmas.check_ladder_stability(ladder, steps, lr, warn=False)
        ref = jsigmas.check_ladder_stability(np.asarray(ladder), steps, lr,
                                             warn=False)
        assert ours == ref
    with pytest.warns(UserWarning, match="under-relaxed"):
        sigmas.check_ladder_stability(sigmas.sigma_ladder(348, 0.01, 8), 3,
                                      9e-7)


def test_stack_parts_interleaves_like_jax():
    rs = np.random.RandomState(0)
    a, b = _np(rs.randn(3, 4, 5, 1)), _np(rs.randn(3, 4, 5, 1))
    ours = misc.stack_parts(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(jmisc.stack_parts(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(ours.numpy(), ref)
    assert np.array_equal(ours[1].numpy(), b[0])       # row 2i+1 = b[i]
    ra, rb = misc.unstack_parts(ours)
    assert np.array_equal(ra.numpy(), a) and np.array_equal(rb.numpy(), b)


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((32, 32), (64, 64)),
                                     ((5, 7), (9, 4)), ((6, 6), (6, 6))])
def test_resize_align_corners_matches_the_interpolation_matrix(src, dst):
    x = _np(np.random.RandomState(1).randn(2, *src, 3))
    ref = np.asarray(jax_resize(jnp.asarray(x), dst, axes=(1, 2)))
    ours = nhwc(resize_align_corners(nchw(x), dst))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_resize_tracks_gradients_after_an_inference_mode_call():
    """The interpolation matrices are cached: one first made under
    torch.inference_mode (an unguided ALD chain) must still serve a later
    call whose backward saves it."""
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import resize
    resize._interp_tensor.cache_clear()
    with torch.inference_mode():
        resize_align_corners(torch.rand(1, 2, 5, 5), (9, 9))
    x = torch.rand(1, 2, 5, 5, requires_grad=True)
    resize_align_corners(x, (9, 9)).sum().backward()
    assert x.grad.shape == x.shape


# -- normalization and layer blocks ----------------------------------------

NORMS = [("InstanceNorm++", jnorm.InstanceNormPlus,
          normalization.InstanceNormPlus),
         ("InstanceNorm", jnorm.InstanceNorm, normalization.InstanceNorm),
         ("VarianceNorm", jnorm.VarianceNorm, normalization.VarianceNorm),
         ("NoneNorm", jnorm.NoneNorm, normalization.NoneNorm)]


@pytest.mark.parametrize("name,jcls,cls", NORMS, ids=[n[0] for n in NORMS])
def test_normalization_matches(name, jcls, cls):
    C = 6
    x = _np(np.random.RandomState(2).randn(3, 9, 7, C) * 2 + 0.5)
    module = jcls(num_features=C)
    params = init_flax(module, jnp.asarray(x)) if name in (
        "InstanceNorm++", "VarianceNorm") else {}
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    ours = cls(C)
    ours.load_state_dict(flax_to_torch(params), strict=True)
    cfg = load_config("ACDC").replace(**{"model.normalization": name})
    assert normalization.get_normalization(cfg) is cls
    np.testing.assert_allclose(nhwc(ours(nchw(x))), ref, **BLOCK_TOL)


def test_conditional_norms_raise():
    # the conditional norms are ported (tests/test_torch_ncsn.py); a name
    # with no conditional form raises
    assert normalization.get_normalization(
        load_config("ACDC"), conditional=True) is \
        normalization.ConditionalInstanceNormPlus
    with pytest.raises(NotImplementedError, match="does not exist"):
        normalization.get_normalization(load_config("ACDC").replace(
            **{"model.normalization": "BatchNorm"}), conditional=True)


def _block_cases():
    elu = (jax.nn.elu, torch.nn.functional.elu)
    IN = (jnorm.InstanceNormPlus, normalization.InstanceNormPlus)
    return {
        "conv_dilated_prepad": (
            lambda: jlayers.Conv(features=5, kernel_size=3, dilation=2,
                                 pre_pad=(1, 0)),
            lambda: layers.Conv(4, 5, 3, dilation=2, pre_pad=(1, 0)), 4, 12),
        "conv1x1_stride2": (
            lambda: jlayers.conv1x1(5, stride=2),
            lambda: layers.conv1x1(4, 5, stride=2), 4, 12),
        "crp": (lambda: jlayers.CRPBlock(features=6, n_stages=2, act=elu[0]),
                lambda: layers.CRPBlock(6, 2, elu[1]), 6, 12),
        "crp_avgpool": (
            lambda: jlayers.CRPBlock(features=6, n_stages=2, act=elu[0],
                                     maxpool=False),
            lambda: layers.CRPBlock(6, 2, elu[1], maxpool=False), 6, 12),
        "rcu": (lambda: jlayers.RCUBlock(features=6, n_blocks=3, n_stages=2,
                                         act=elu[0]),
                lambda: layers.RCUBlock(6, 3, 2, elu[1]), 6, 12),
        "conv_mean_pool": (
            lambda: jlayers.ConvMeanPool(features=8),
            lambda: layers.ConvMeanPool(4, 8), 4, 12),
        "conv_mean_pool_adjust": (
            lambda: jlayers.ConvMeanPool(features=8, kernel_size=1,
                                         adjust_padding=True),
            lambda: layers.ConvMeanPool(4, 8, kernel_size=1,
                                        adjust_padding=True), 4, 14),
        "res_down": (
            lambda: jlayers.ResidualBlock(output_dim=8, normalization=IN[0],
                                          act=elu[0], resample="down"),
            lambda: layers.ResidualBlock(4, 8, IN[1], elu[1],
                                         resample="down"), 4, 12),
        "res_down_dilated": (
            lambda: jlayers.ResidualBlock(output_dim=8, normalization=IN[0],
                                          act=elu[0], resample="down",
                                          dilation=2),
            lambda: layers.ResidualBlock(4, 8, IN[1], elu[1],
                                         resample="down", dilation=2), 4, 12),
        "res_same": (
            lambda: jlayers.ResidualBlock(output_dim=4, normalization=IN[0],
                                          act=elu[0]),
            lambda: layers.ResidualBlock(4, 4, IN[1], elu[1]), 4, 12),
        "res_wider": (
            lambda: jlayers.ResidualBlock(output_dim=6, normalization=IN[0],
                                          act=elu[0]),
            lambda: layers.ResidualBlock(4, 6, IN[1], elu[1]), 4, 12),
        "res_dilated_same": (
            lambda: jlayers.ResidualBlock(output_dim=4, normalization=IN[0],
                                          act=elu[0], dilation=4),
            lambda: layers.ResidualBlock(4, 4, IN[1], elu[1], dilation=4),
            4, 12),
        "res_dilated_wider": (
            lambda: jlayers.ResidualBlock(output_dim=6, normalization=IN[0],
                                          act=elu[0], dilation=2),
            lambda: layers.ResidualBlock(4, 6, IN[1], elu[1], dilation=2),
            4, 12),
    }


BLOCKS = _block_cases()


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_layer_block_matches(case):
    make_jax, make_torch, C, R = BLOCKS[case]
    x = _np(np.random.RandomState(3).randn(2, R, R, C))
    module = make_jax()
    params = init_flax(module, jnp.asarray(x))
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    ours = make_torch()
    ours.load_state_dict(flax_to_torch(params), strict=True)
    np.testing.assert_allclose(nhwc(ours(nchw(x))), ref, **BLOCK_TOL)


@pytest.mark.parametrize("start,end", [(True, False), (False, False),
                                       (False, True)])
def test_msf_and_refine_blocks_match(start, end):
    rs = np.random.RandomState(4)
    big, small = _np(rs.randn(2, 16, 16, 4)), _np(rs.randn(2, 8, 8, 6))
    xs = [big] if start else [big, small]
    jxs = [jnp.asarray(x) for x in xs]
    module = jlayers.RefineBlock(features=4, act=jax.nn.elu, start=start,
                                 end=end)
    params = draw(jax.eval_shape(lambda k: module.init(k, jxs, (16, 16)),
                                 jax.random.PRNGKey(0))["params"], rs)
    ref = np.asarray(module.apply({"params": params}, jxs, (16, 16)))
    ours = layers.RefineBlock([x.shape[-1] for x in xs], 4,
                              torch.nn.functional.elu, start=start, end=end)
    ours.load_state_dict(flax_to_torch(params), strict=True)
    out = ours([nchw(x) for x in xs], (16, 16))
    np.testing.assert_allclose(nhwc(out), ref, **BLOCK_TOL)
    if not start:
        msf = jlayers.MSFBlock(features=5)
        mp = draw(jax.eval_shape(lambda k: msf.init(k, jxs, (16, 16)),
                                 jax.random.PRNGKey(1))["params"], rs)
        mref = np.asarray(msf.apply({"params": mp}, jxs, (16, 16)))
        mours = layers.MSFBlock([4, 6], 5)
        mours.load_state_dict(flax_to_torch(mp), strict=True)
        np.testing.assert_allclose(
            nhwc(mours([nchw(x) for x in xs], (16, 16))), mref, **BLOCK_TOL)


def test_pools_match():
    x = _np(np.random.RandomState(5).randn(2, 9, 9, 3))
    jx, tx = jnp.asarray(x), nchw(x)
    for ours, ref in ((layers.max_pool(tx), jlayers.max_pool(jx, 2)),
                      (layers.avg_pool(tx), jlayers.avg_pool(jx, 2)),
                      (layers.mean_pool_2x(tx), jlayers.mean_pool_2x(jx, 2))):
        np.testing.assert_allclose(nhwc(ours), np.asarray(ref), **BLOCK_TOL)


# -- whole nets ------------------------------------------------------------

NETS = {"ncsnv2": (jncsnv2.NCSNv2, NCSNv2, 32),
        "ncsnv2_deeper": (jncsnv2.NCSNv2Deeper, NCSNv2Deeper, 32),
        "ncsnv2_deepest": (jncsnv2.NCSNv2Deepest, NCSNv2Deepest, 64)}
OVER = {"model.ngf": 32}


@pytest.fixture(scope="module")
def nets():
    """Each net at batch 2, ngf 32 (the entry() shape for NCSNv2Deepest,
    64 px; 32 px for the shallower two), the JAX output and the params."""
    rs = np.random.RandomState(6)
    out = {}
    for name, (jcls, _, size) in NETS.items():
        over = dict(OVER, **{"data.image_size": size})
        module = jcls(config=jax_load_config("ACDC", "real-imag", **over))
        x = _np(rs.rand(2, size, size, 1))
        s = np.array([348.0, 0.37], np.float32)
        params = init_flax(module, jnp.zeros((1, size, size, 1)),
                           jnp.ones((1,)))
        ref = np.asarray(jax.jit(module.apply)({"params": params}, x, s))
        out[name] = (params, x, s, ref, over)
    return out


@pytest.mark.parametrize("name", sorted(NETS))
def test_ncsnv2_forward_matches(nets, name):
    params, x, s, ref, over = nets[name]
    cfg = load_config("ACDC", "real-imag", **over)
    model = get_model(name)(cfg)
    assert type(model) is NETS[name][1]
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg, name),
                          strict=True)
    with torch.no_grad():
        out = nhwc(model(nchw(x), torch.from_numpy(s)))
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(out, ref, **NET_TOL)


def test_converter_raises_on_a_missing_or_extra_name(nets):
    params, _, _, _, over = nets["ncsnv2_deepest"]
    cfg = load_config("ACDC", "real-imag", **over)
    assert len(flax_to_torch_ncsnv2(params, cfg, "ncsnv2_deepest")) == 229
    missing = dict(params)
    del missing["end_conv"]
    with pytest.raises(KeyError, match="missing"):
        flax_to_torch_ncsnv2(missing, cfg, "ncsnv2_deepest")
    extra = dict(params, extra_conv={"kernel": np.zeros((3, 3, 1, 1))})
    with pytest.raises(KeyError, match="extra_conv"):
        flax_to_torch_ncsnv2(extra, cfg, "ncsnv2_deepest")
    with pytest.raises(ValueError, match="shape"):      # NCSNv2 at 64 px
        flax_to_torch_ncsnv2(params, cfg)


def test_registry_names_and_size_dispatch():
    for alias, cls in (("ncsnv2_64", NCSNv2), ("ncsnv2_128", NCSNv2Deeper),
                       ("ncsnv2_256", NCSNv2Deepest)):
        assert get_model(alias) is cls
    cfg = load_config("ACDC", "real-imag", **{"model.ngf": 4})
    for size, cls in ((64, NCSNv2), (128, NCSNv2Deeper),
                      (256, NCSNv2Deepest)):
        with torch.device("meta"):
            net = get_network(cfg.replace(**{"data.image_size": size}))
        assert type(net) is cls
    with pytest.raises(NotImplementedError):
        get_network(cfg.replace(**{"data.image_size": 512}))


def test_seeded_weights_draw_the_jax_init_distributions():
    cfg = load_config("ACDC", "real-imag",
                      **{"data.image_size": 32, "model.ngf": 16})
    a = seeded_weights(NCSNv2Deepest(cfg), seed=0).state_dict()
    b = seeded_weights(NCSNv2Deepest(cfg), seed=0).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["res1_0.Conv_0.weight"]
    bound = 1 / np.sqrt(w[0].numel())
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert abs(a["res1_0.norm1.gamma"].mean() - 1) < 0.02
    assert a["res1_0.norm1.gamma"].std() > 0.005
    assert not a["res1_0.norm1.beta"].any()


@pytest.mark.parametrize("channels", [1, 2])
def test_make_score_fn_hands_the_net_contiguous_nchw(channels):
    """The net receives contiguous NCHW whatever the channel count: for
    C = 1 the permute of channel-last x alone carries channels-last
    strides, and torch would run the net's convolutions in NHWC. For C = 1
    the NCHW input is a view of x; the score comes back channel-last."""
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, x, used_sigmas):
            seen.append(x)
            return x * self.w / used_sigmas.reshape(-1, 1, 1, 1)

    x = torch.from_numpy(
        np.random.RandomState(0).rand(3, 4, 5, channels).astype(np.float32))
    score = make_score_fn(Probe(), torch.tensor([2.0, 4.0]))
    out = score(x, torch.tensor([0, 1, 1]))
    (h,) = seen
    assert h.shape == (3, channels, 4, 5)
    assert h.stride() == (channels * 20, 20, 5, 1)
    assert (h.data_ptr() == x.data_ptr()) == (channels == 1)
    ref = x / torch.tensor([2.0, 4.0, 4.0]).reshape(-1, 1, 1, 1)
    assert out.shape == x.shape and torch.equal(out, ref)


def test_make_score_fn_bf16_holds_to_float32(nets):
    """The bf16 net (weights, input and sigmas in bf16, score cast back)
    against float32 on the same weights: bf16 keeps 8 significant bits, so
    the score holds at rel L2 3e-2 over about 60 layers (1.4e-2 measured
    on this input)."""
    params, x, s, ref, over = nets["ncsnv2_deepest"]
    cfg = load_config("ACDC", "real-imag", **over)
    model = NCSNv2Deepest(cfg)
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg, "ncsnv2_deepest"))
    ladder = torch.tensor([348.0, 0.37])
    labels = torch.tensor([0, 1])
    f32 = make_score_fn(model, ladder)
    bf16 = make_score_fn(model, ladder, torch.bfloat16)
    with torch.no_grad():
        a = f32(torch.from_numpy(x), labels)
        b = bf16(torch.from_numpy(x), labels)
    assert a.shape == b.shape == (2, 64, 64, 1) and b.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), ref, **NET_TOL)
    rel = ((b - a).norm() / a.norm()).item()
    assert rel <= 3e-2, rel
    assert next(model.parameters()).dtype == torch.float32
    # "int8" (refused before it was ported): float32 out, within the JAX
    # test's bound of the float32 score, and not the bf16 score
    # (tests/test_torch_int8.py holds it to JAX's int8 score)
    with torch.no_grad():
        q = make_score_fn(model, ladder, "int8")(torch.from_numpy(x), labels)
    assert q.dtype == torch.float32 and q.shape == a.shape
    assert ((q - a).norm() / a.norm()).item() <= 0.15
    assert not torch.equal(q, b)


@pytest.mark.slow
def test_trained_acdc_prior_matches_jax():
    """The trained ACDC prior (EMA weights, stored in bf16) through the
    converter: the 256 px, ngf 128 NCSNv2Deepest forward at batch 1 in
    both packages, float32, on the CPU."""
    from flax import serialization
    path = os.path.join(ROOT, "artifacts", "acdc_prior", "ema_bf16.msgpack")
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    params = jax.tree_util.tree_map(_np, tree)
    jcfg = jax_load_config("ACDC", "real-imag")
    module = jncsnv2.NCSNv2Deepest(config=jcfg)
    x = _np(np.random.RandomState(7).rand(1, 256, 256, 1))
    s = np.array([1.5], np.float32)
    ref = np.asarray(jax.jit(module.apply)({"params": params}, x, s))
    cfg = load_config("ACDC", "real-imag")
    model = NCSNv2Deepest(cfg)
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg), strict=True)
    torch.set_num_threads(os.cpu_count() or 1)
    with torch.no_grad():
        out = nhwc(model(nchw(x), torch.from_numpy(s)))
    torch.set_num_threads(1)
    np.testing.assert_allclose(out, ref, **NET_TOL)
