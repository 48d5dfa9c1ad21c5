"""The port's 3-D (2D + time) score nets and UNET1D against the JAX
package's: the rank-3 layer blocks, the per-axis ConvTranspose, the
temporal down convolution, NCSN3D and NCSN3DShallow on volumes and on
pixel tubes, the ndim-generic UNet, UNET1D, the converters and the tube
score adapter's window check.

The JAX package is channel-last, the port channels-first: a JAX volume (B,
kx, ky, T, C) is the port's (B, C, kx, ky, T); a JAX tube batch (B, T, k^2)
is the port's (B, k^2, T). Blocks hold at BLOCK_TOL, whole nets at NET_TOL
(tests/test_torch_ncsnv2.py): 3-D convolutions sum 27 I terms a voxel in
another order on oneDNN than on XLA's CPU backend, as the 2-D ones sum 9 I.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.models import layers as jlayers
from inverseproblemwithdiffusionmodel_tpu.models import ncsn1d as jncsn1d
from inverseproblemwithdiffusionmodel_tpu.models import ncsn3d as jncsn3d
from inverseproblemwithdiffusionmodel_tpu.models import (
    normalization as jnorm)
from inverseproblemwithdiffusionmodel_tpu.models import unet as junet
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    make_tube_score_fn_3d as jax_tube_score_fn)
from inverseproblemwithdiffusionmodel_tpu.ops.resize import (
    resize_align_corners as jax_resize)
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.models import (
    layers, ncsn1d, ncsn3d, normalization, registry, unet)
from inverseproblemwithdiffusionmodel_tpu_torch.ops.resize import (
    resize_align_corners)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch, flax_to_torch_ncsn3d, flax_to_torch_unet1d,
    seeded_weights)
from tests.test_torch_ncsnv2 import (BLOCK_TOL, NET_TOL, _np, draw,
                                     init_flax, nchw, nhwc)

torch.set_num_threads(1)

WIN, T, NGF = 4, 8, 8
OVER = {"model.ngf": NGF, "data.channels": WIN * WIN, "data.image_size": T}
ELU = (jax.nn.elu, F.elu)
IN = (jnorm.InstanceNormPlus, normalization.InstanceNormPlus)


def _apply(module, params, *args):
    return np.asarray(module.apply({"params": params}, *args))


def _check_block(make_jax, make_torch, shape, seed=0,
                 transposed=frozenset()):
    x = _np(np.random.RandomState(seed).randn(*shape))
    module = make_jax()
    params = init_flax(module, jnp.asarray(x))
    ref = _apply(module, params, jnp.asarray(x))
    ours = make_torch()
    ours.load_state_dict(flax_to_torch(params, transposed), strict=True)
    with torch.no_grad():
        out = nhwc(ours(nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **BLOCK_TOL)


# -- rank-3 layers ---------------------------------------------------------

BLOCKS3 = {
    "conv_dilated_prepad": (
        lambda: jlayers.Conv(features=5, kernel_size=3, ndim=3, dilation=2,
                             pre_pad=(1, 0)),
        lambda: layers.Conv(3, 5, 3, dilation=2, pre_pad=(1, 0), ndim=3), 3),
    "conv1x1_stride2": (
        lambda: jlayers.conv1x1(5, ndim=3, stride=2),
        lambda: layers.conv1x1(3, 5, stride=2, ndim=3), 3),
    "crp": (lambda: jlayers.CRPBlock(features=4, n_stages=2, act=ELU[0],
                                     ndim=3),
            lambda: layers.CRPBlock(4, 2, ELU[1], ndim=3), 4),
    "crp_avgpool": (
        lambda: jlayers.CRPBlock(features=4, n_stages=2, act=ELU[0], ndim=3,
                                 maxpool=False),
        lambda: layers.CRPBlock(4, 2, ELU[1], maxpool=False, ndim=3), 4),
    "rcu": (lambda: jlayers.RCUBlock(features=4, n_blocks=2, n_stages=2,
                                     act=ELU[0], ndim=3),
            lambda: layers.RCUBlock(4, 2, 2, ELU[1], ndim=3), 4),
    "conv_mean_pool_adjust": (
        lambda: jlayers.ConvMeanPool(features=6, ndim=3, adjust_padding=True),
        lambda: layers.ConvMeanPool(3, 6, adjust_padding=True, ndim=3), 3),
    "res_down": (
        lambda: jlayers.ResidualBlock(output_dim=6, normalization=IN[0],
                                      act=ELU[0], ndim=3, resample="down"),
        lambda: layers.ResidualBlock(4, 6, IN[1], ELU[1], resample="down",
                                     ndim=3), 4),
    "res_down_dilated": (
        lambda: jlayers.ResidualBlock(output_dim=6, normalization=IN[0],
                                      act=ELU[0], ndim=3, resample="down",
                                      dilation=2),
        lambda: layers.ResidualBlock(4, 6, IN[1], ELU[1], resample="down",
                                     dilation=2, ndim=3), 4),
    "res_dilated_same": (
        lambda: jlayers.ResidualBlock(output_dim=4, normalization=IN[0],
                                      act=ELU[0], ndim=3, dilation=4),
        lambda: layers.ResidualBlock(4, 4, IN[1], ELU[1], dilation=4,
                                     ndim=3), 4),
    "res_wider": (
        lambda: jlayers.ResidualBlock(output_dim=6, normalization=IN[0],
                                      act=ELU[0], ndim=3),
        lambda: layers.ResidualBlock(4, 6, IN[1], ELU[1], ndim=3), 4),
    "instance_norm_plus": (lambda: jnorm.InstanceNormPlus(num_features=4),
                           lambda: normalization.InstanceNormPlus(4), 4),
}


@pytest.mark.parametrize("case", sorted(BLOCKS3))
def test_rank3_block_matches(case):
    make_jax, make_torch, C = BLOCKS3[case]
    _check_block(make_jax, make_torch, (2, 6, 5, 8, C))


@pytest.mark.parametrize("start,end", [(True, False), (False, False),
                                       (False, True)])
def test_rank3_refine_block_matches(start, end):
    rs = np.random.RandomState(1)
    big, small = _np(rs.randn(2, 4, 4, 8, 4)), _np(rs.randn(2, 4, 4, 4, 6))
    xs = [big] if start else [big, small]
    jxs = [jnp.asarray(x) for x in xs]
    out_shape = (4, 4, 8)
    module = jlayers.RefineBlock(features=4, act=jax.nn.elu, ndim=3,
                                 start=start, end=end)
    params = draw(jax.eval_shape(lambda k: module.init(k, jxs, out_shape),
                                 jax.random.PRNGKey(0))["params"], rs)
    ref = np.asarray(module.apply({"params": params}, jxs, out_shape))
    ours = layers.RefineBlock([x.shape[-1] for x in xs], 4, F.elu,
                              start=start, end=end, ndim=3)
    ours.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        out = nhwc(ours([nchw(x) for x in xs], out_shape))
    np.testing.assert_allclose(out, ref, **BLOCK_TOL)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_pools_and_nearest_up_match_at_every_rank(ndim):
    x = _np(np.random.RandomState(2).randn(2, *(6, 5, 7)[:ndim], 3))
    jx, tx = jnp.asarray(x), nchw(x)
    for ours, ref in (
            (layers.max_pool(tx), jlayers.max_pool(jx, ndim)),
            (layers.avg_pool(tx), jlayers.avg_pool(jx, ndim)),
            (layers.mean_pool_2x(tx), jlayers.mean_pool_2x(jx, ndim)),
            (layers.nearest_up_2x(tx), jlayers.nearest_up_2x(jx, ndim))):
        np.testing.assert_allclose(nhwc(ours), np.asarray(ref), **BLOCK_TOL)


def test_resize_over_three_axes_matches():
    x = _np(np.random.RandomState(3).randn(2, 3, 5, 6, 4))
    dst = (4, 7, 12)
    ref = np.asarray(jax_resize(jnp.asarray(x), dst, axes=(1, 2, 3)))
    np.testing.assert_allclose(nhwc(resize_align_corners(nchw(x), dst)),
                               ref, rtol=1e-6, atol=1e-6)


CONV_T = {
    "temporal_up": dict(kernel_size=(1, 1, 4), stride=(1, 1, 2),
                        padding=(0, 0, 1), ndim=3, shape=(2, 3, 4, 5, 6)),
    "unet_up_3d": dict(kernel_size=(3, 3, 3), stride=(2, 2, 2),
                       padding=(1, 1, 1), output_padding=(1, 1, 1), ndim=3,
                       shape=(2, 3, 4, 3, 6)),
    "unet_up_1d": dict(kernel_size=(3,), stride=(2,), padding=(1,),
                       output_padding=(1,), ndim=1, shape=(2, 6, 6)),
    "unet_up_2d": dict(kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
                       output_padding=(1, 1), ndim=2, shape=(2, 5, 4, 6)),
}


@pytest.mark.parametrize("case", sorted(CONV_T))
def test_conv_transpose_per_axis_matches(case):
    kw = dict(CONV_T[case])
    shape = kw.pop("shape")
    _check_block(
        lambda: jlayers.ConvTranspose(features=5, **kw),
        lambda: layers.ConvTranspose(
            shape[-1], 5, kw["kernel_size"], kw["stride"], kw["padding"],
            kw.get("output_padding", 0), ndim=kw["ndim"]), shape, seed=4,
        transposed={""})


def test_temporal_down_conv_matches():
    _check_block(lambda: jncsn3d.TemporalDownConv(features=5),
                 lambda: ncsn3d.TemporalDownConv(3, 5), (2, 4, 3, 8, 3),
                 seed=5)
    conv = ncsn3d.TemporalDownConv(3, 5)
    assert conv.weight.shape == (5, 3, 1, 1, 4)
    assert conv(torch.zeros(1, 3, 2, 2, 8)).shape == (1, 5, 2, 2, 4)


# -- whole nets --------------------------------------------------------------

NETS = {"ncsn3d": (jncsn3d.NCSN3D, ncsn3d.NCSN3D),
        "ncsn3d_shallow": (jncsn3d.NCSN3DShallow, ncsn3d.NCSN3DShallow)}


@pytest.fixture(scope="module")
def nets():
    """Both nets at ngf 8, 4 x 4 windows of 8 frames, batch 2: params,
    the volume input and sigmas, JAX's output on the volume and on the
    same data as tubes."""
    rs = np.random.RandomState(6)
    out = {}
    for name, (jcls, _) in NETS.items():
        module = jcls(config=jax_load_config("CINE127_1D", "real-imag",
                                             **OVER))
        params = init_flax(module, jnp.zeros((1, WIN, WIN, T, 1)),
                           jnp.ones((1,)))
        vol = _np(rs.rand(2, WIN, WIN, T, 1))
        tubes = _np(rs.rand(2, T, WIN * WIN))
        s = np.array([40.0, 0.37], np.float32)
        apply = jax.jit(module.apply)
        out[name] = (params, vol, tubes, s,
                     np.asarray(apply({"params": params}, vol, s)),
                     np.asarray(apply({"params": params}, tubes, s)))
    return out


@pytest.mark.parametrize("name", sorted(NETS))
def test_3d_net_forward_matches_on_volumes_and_tubes(nets, name):
    params, vol, tubes, s, ref_vol, ref_tubes = nets[name]
    cfg = load_config("CINE127_1D", "real-imag", **OVER)
    model = registry.get_model(name)(cfg)
    assert type(model) is NETS[name][1]
    model.load_state_dict(flax_to_torch_ncsn3d(params, cfg, name),
                          strict=True)
    with torch.no_grad():
        out_vol = nhwc(model(nchw(vol), torch.from_numpy(s)))
        out_tubes = model(torch.from_numpy(
            np.ascontiguousarray(tubes.transpose(0, 2, 1))),
            torch.from_numpy(s)).numpy().transpose(0, 2, 1)
    assert np.abs(ref_vol).max() > 1e-3
    np.testing.assert_allclose(out_vol, ref_vol, **NET_TOL)
    np.testing.assert_allclose(out_tubes, ref_tubes, **NET_TOL)


def test_converter_names_layouts_and_refusals(nets):
    params = nets["ncsn3d_shallow"][0]
    cfg = load_config("CINE127_1D", "real-imag", **OVER)
    state = flax_to_torch_ncsn3d(params, cfg)
    assert len(state) == len(ncsn3d.NCSN3DShallow(cfg).state_dict())
    up = params["conv_temporal_up"]["kernel"]            # (1, 1, 4, I, O)
    assert up.shape == (1, 1, 4, 2 * NGF, NGF)
    np.testing.assert_array_equal(state["conv_temporal_up.weight"].numpy(),
                                  up.transpose(3, 4, 0, 1, 2))
    down = params["conv_temporal_down"]["kernel"]
    np.testing.assert_array_equal(
        state["conv_temporal_down.weight"].numpy(),
        down.transpose(4, 3, 0, 1, 2))
    missing = dict(params)
    del missing["conv_temporal_up"]
    with pytest.raises(KeyError, match="missing"):
        flax_to_torch_ncsn3d(missing, cfg)
    with pytest.raises(KeyError, match="conv_temporal_down"):
        flax_to_torch_ncsn3d(params, cfg, "ncsn3d")
    with pytest.raises(ValueError, match="not a 3-D net"):
        flax_to_torch_ncsn3d(params, cfg, "ncsn1d")


def test_tube_score_fn_checks_the_window_and_matches_jax(nets):
    params, _, tubes, s, _, _ = nets["ncsn3d_shallow"]
    cfg = load_config("CINE127_1D", "real-imag", **OVER)
    model = ncsn3d.NCSN3DShallow(cfg)
    model.load_state_dict(flax_to_torch_ncsn3d(params, cfg))
    module = jncsn3d.NCSN3DShallow(
        config=jax_load_config("CINE127_1D", "real-imag", **OVER))
    labels = np.array([0, 1], np.int32)
    ref = np.asarray(jax_tube_score_fn(module, params, s, WIN)(
        jnp.asarray(tubes), jnp.asarray(labels)))
    score = registry.make_tube_score_fn_3d(model, torch.from_numpy(s), WIN)
    with torch.no_grad():
        out = score(torch.from_numpy(tubes), torch.from_numpy(labels))
    assert out.shape == tubes.shape
    np.testing.assert_allclose(out.numpy(), ref, **NET_TOL)
    for win in (2, 8):
        with pytest.raises(ValueError, match="win_size"):
            registry.make_tube_score_fn_3d(model, torch.from_numpy(s), win)
        with pytest.raises(ValueError, match="win_size"):
            jax_tube_score_fn(module, params, s, win)


def test_registry_builds_the_3d_task_and_its_example_input():
    cfg = load_config("CINE127_1D", "real-imag", **{"model.ngf": 4})
    net, none = registry.load_model(cfg, "Diffusion3D", seed=2)
    again, _ = registry.load_model(cfg, "Diffusion3D", seed=2)
    assert none is None and type(net) is ncsn3d.NCSN3DShallow
    for (name, a), b in zip(net.named_parameters(), again.parameters()):
        assert torch.equal(a, b)
        assert a.abs().max() > 0 or name.endswith("beta")
    x = registry.example_input(cfg, "Diffusion3D")
    assert x.shape == (1, 8, 8, 24, 1)
    with torch.no_grad():
        out = net(registry.to_nchw(x), torch.ones(1))
    assert out.shape == (1, 1, 8, 8, 24)
    w = net.conv_temporal_down.weight
    assert w.abs().max() <= 1 / np.sqrt(w[0].numel())
    assert registry.get_model("ncsn3d") is ncsn3d.NCSN3D


# -- UNet at every rank, UNET1D --------------------------------------------

@pytest.mark.parametrize("ndim", [1, 3])
def test_unet_at_other_ranks_matches(ndim):
    shape = (2,) + (8, 8, 8)[:ndim] + (2,)
    _check_block(
        lambda: junet.UNet(out_channels=3, features=(4, 6, 8),
                           strides=(2, 2), ndim=ndim),
        lambda: unet.UNet(3, features=(4, 6, 8), strides=(2, 2),
                          in_channels=2, ndim=ndim), shape, seed=7,
        transposed={"up_0", "up_1"})


def test_build_seg_unet_takes_spatial_dims():
    from inverseproblemwithdiffusionmodel_tpu_torch.config import (
        load_general_config)
    gc = load_general_config()
    gc.Seg.spatial_dims = 3
    with torch.device("meta"):
        net = registry.build_seg_unet(gc)
    assert net.down_0.weight.shape == (64, 1, 3, 3, 3)
    assert net.up_3.weight.shape == (192, 2, 3, 3, 3)


@pytest.mark.parametrize("use_in", [True, False])
def test_unet1d_matches_at_its_own_width(use_in):
    """UNET1D at its features (64, 256, 1024, 4196) on 64-channel tubes of
    24 frames, batch 2: the JAX net and the port on converted weights."""
    over = {"training.use_IN": use_in}
    module = jncsn1d.UNET1D(config=jax_load_config("CINE127_1D", "real-imag",
                                                   **over))
    rs = np.random.RandomState(8)
    x = _np(rs.rand(2, 24, 64))
    s = np.array([40.0, 0.5], np.float32)
    params = init_flax(module, jnp.zeros((1, 24, 64)), jnp.ones((1,)),
                       seed=8)
    ref = np.asarray(jax.jit(module.apply)({"params": params}, x, s))
    cfg = load_config("CINE127_1D", "real-imag", **over)
    model = registry.get_model("unet1d")(cfg)
    model.load_state_dict(flax_to_torch_unet1d(params, cfg), strict=True)
    assert model.UNet_0.bottom.weight.shape == (4196, 1024, 3)
    with torch.no_grad():
        out = nhwc(model(nchw(x), torch.from_numpy(s)))
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(out, ref, **NET_TOL)
    seeded = seeded_weights(ncsn1d.UNET1D(cfg), 0)
    assert seeded.UNet_0.up_2.weight.shape == (320, 64, 3)
