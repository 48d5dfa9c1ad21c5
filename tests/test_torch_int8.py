"""The port's int8 convolution mode against the JAX package's
(ops/quant.py, models/layers.Conv under quantized_convs("int8"),
models/registry.make_score_fn(..., "int8")), on the CPU, where the port
runs the plain versions of K5-K7 (ops/int8_kernels.py).

The quantizers, the int8 convolution and the int8 Conv layer equal JAX's
bit for bit: the same float32 scale, the same round-half-even of a true
division, exact integer sums (a float64 convolution of the codes here,
int32 in XLA) and one rounding of the dequantized product. Whole nets
differ: their bf16 glue (norms, activations, resampling) rounds in other
places in the two packages, so an activation code can flip at a rounding
boundary; they hold at a measured relative L2 (the constants below).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.models import layers as jlayers
from inverseproblemwithdiffusionmodel_tpu.models import ncsn1d as jncsn1d
from inverseproblemwithdiffusionmodel_tpu.models import ncsnv2 as jncsnv2
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    make_score_fn as jax_make_score_fn)
from inverseproblemwithdiffusionmodel_tpu.ops import quant as jquant
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.models import layers
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsn1d import NCSN1D
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import (
    NCSNv2Deepest)
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    make_score_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.ops import (
    int8_kernels as ik, quant)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnv2)
from tests.test_torch_ncsnv2 import init_flax

torch.set_num_threads(1)

# int8 score of the port against JAX's on the same weights and batch.
# The int8 nets are chaotic: a code that flips at a rounding boundary
# moves the next layers' codes, and an input moved by one float32 ulp moves
# the port's own int8 score (float32 glue) by 3.5e-2 at NCSNv2Deepest (64
# px, ngf 16) and 1.7e-2 at NCSN1D (ngf 16), as much as the int8 error
# itself. The two packages' bf16 glue rounds in other places, so their
# int8 scores part by about the int8 error: read here 5.2e-2 and 3.2e-2
# (the bf16 scores part by 2.0e-2 and 1.3e-2). The gate sits twice above.
SCORE_VS_JAX = 0.1
# int8 against the float32 score: the JAX test's bound
# (tests/test_quant.py, test_int8_score_fn_accuracy_and_dtype); read here
# 4.1e-2 and 2.9e-2 (JAX's 4.4e-2 and 3.0e-2).
INT8_VS_F32 = 0.15
# The port's int8 error against JAX's, both to float32: within this
# factor either way (read 0.94 and 0.95).
ERROR_RATIO = 4 / 3


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def bits(a):
    """An array's bit pattern, so that equality is bit for bit (a bf16 or
    float32 tensor or array)."""
    if isinstance(a, torch.Tensor):
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a.astype(np.float32) if a.dtype != np.float32 else a)
    return a.view(np.int32)


DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def ties(rs, shape):
    """Values whose codes land on .5 ties: one entry 127 makes the scale
    exactly 1, and every other entry is an integer plus one half."""
    v = rs.randint(-126, 126, size=shape) + 0.5
    v.flat[0] = 127.0
    return v.astype(np.float32)


# -- the quantizers -------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_quantize_per_tensor_equals_jax(dtype, kind):
    rs = np.random.RandomState(0)
    x = (ties(rs, (3, 5, 7, 4)) if kind == "ties"
         else (rs.randn(3, 5, 7, 4) * 4).astype(np.float32))
    tdt, jdt = DTYPES[dtype]
    jq, js = jquant.quantize_per_tensor(jnp.asarray(x, jdt))
    q, s = quant.quantize_per_tensor(torch.from_numpy(x).to(tdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s.item()) == np.float32(js)
    if kind == "ties":
        assert s.item() == 1.0
        half = x[np.abs(x) < 127]
        # round half to even, both ways
        np.testing.assert_array_equal(
            q.numpy()[np.abs(x) < 127], np.round(half).astype(np.int8))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_quantize_per_channel_equals_jax(dtype, kind):
    """JAX kernels are (*k, I, O), the port's (O, I, *k)."""
    rs = np.random.RandomState(1)
    w = (ties(rs, (6, 5, 3, 3)) if kind == "ties"
         else (rs.randn(6, 5, 3, 3) * 0.1).astype(np.float32))
    w[2] *= 50.0
    if kind == "ties":
        w[:, 0, 0, 0] = 127.0         # every output channel's scale is 1
    tdt, jdt = DTYPES[dtype]
    jk = jnp.asarray(np.transpose(w, (2, 3, 1, 0)), jdt)
    jq, js = jquant.quantize_per_channel(jk)
    q, s = quant.quantize_per_channel(torch.from_numpy(w).to(tdt))
    np.testing.assert_array_equal(q.numpy(),
                                  np.transpose(np.asarray(jq), (3, 2, 0, 1)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_kernel_plain_versions_compose_to_the_quantizers():
    """K5's and K6's plain versions give quantize_per_tensor's scale and
    codes, channels-last, padded with zero codes to a multiple of 32."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 40, 5, 3)
                         .astype(np.float32))
    q, s = quant.quantize_per_tensor(x)
    amax = ik.absmax(x)
    codes, scale = ik.quantize_s8(x, amax, 64)
    assert codes.shape == (2, 5, 3, 64) and codes.dtype == torch.int8
    assert torch.equal(scale, s.reshape(1))
    assert torch.equal(codes[..., :40], q.movedim(1, -1))
    assert not codes[..., 40:].any()
    assert ik.LAUNCHES["absmax"] == 0      # the CPU runs no kernel


# -- the convolution ------------------------------------------------------

# (ndim, kernel size, dilation, pre_pad, input channels, output channels):
# the nets' geometries (3x3 dilated 1, 2 and 4, 1x1 shortcuts, the
# (1, 0) pre-pad of ConvMeanPool at 28 px, the 1-channel begin conv and
# end conv, 1-D at 64 channels)
GEOMETRIES = [
    (2, 3, 1, None, 16, 24), (2, 3, 2, None, 16, 16),
    (2, 3, 4, None, 40, 8), (2, 1, 1, None, 16, 32),
    (2, 3, 1, (1, 0), 16, 16), (2, 1, 1, (1, 0), 16, 8),
    (2, 3, 1, None, 1, 16), (2, 3, 1, None, 16, 1),
    (1, 3, 1, None, 64, 16), (1, 3, 2, None, 16, 16),
    (1, 3, 4, None, 16, 16), (1, 1, 1, None, 64, 16),
    (1, 3, 1, (1, 0), 16, 16)]


def _conv_inputs(ndim, k, cin, cout, seed):
    rs = np.random.RandomState(seed)
    size = (9, 11) if ndim == 2 else (24,)
    x = (rs.randn(3, cin, *size) * 2).astype(np.float32)
    w = (rs.randn(cout, cin, *(k,) * ndim) / np.sqrt(cin * k ** ndim)
         ).astype(np.float32)
    return x, w


def _jax_int8_conv(x, w, ndim, k, dil, pre_pad, jdt):
    pad = (k // 2) * dil
    pads = [(pad + (pre_pad or (0, 0))[0], pad + (pre_pad or (0, 0))[1])
            ] * ndim
    jx = jnp.asarray(np.moveaxis(x, 1, -1), jdt)
    jw = jnp.asarray(np.transpose(w, tuple(range(2, 2 + ndim)) + (1, 0)), jdt)
    out = jquant.int8_conv(jx, jw, window_strides=(1,) * ndim, padding=pads,
                           rhs_dilation=(dil,) * ndim,
                           dimension_numbers=jlayers._dim_numbers(ndim))
    return np.moveaxis(np.asarray(out.astype(jnp.float32)), -1, 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("geom", GEOMETRIES, ids=[
    f"{n}d-k{k}-d{d}-{'pre' if p else 'sym'}-{i}x{o}"
    for n, k, d, p, i, o in GEOMETRIES])
def test_int8_conv_equals_jax(geom, dtype):
    ndim, k, dil, pre_pad, cin, cout = geom
    x, w = _conv_inputs(ndim, k, cin, cout, seed=cin + cout + dil)
    tdt, jdt = DTYPES[dtype]
    ref = _jax_int8_conv(x, w, ndim, k, dil, pre_pad, jdt)
    tw = torch.from_numpy(w).to(tdt)
    out = quant.int8_conv(torch.from_numpy(x).to(tdt), tw,
                          padding=(k // 2) * dil, dilation=dil, ndim=ndim,
                          pre_pad=pre_pad)
    assert out.dtype == tdt and out.shape == ref.shape
    np.testing.assert_array_equal(bits(out), bits(ref))
    assert np.abs(ref).max() > 0.1
    # the whole op's plain version, and the weight quantized once
    plain = quant.int8_conv_plain(torch.from_numpy(x).to(tdt), tw,
                                  padding=(k // 2) * dil, dilation=dil,
                                  ndim=ndim, pre_pad=pre_pad)
    assert torch.equal(plain, out)
    again = quant.int8_conv(torch.from_numpy(x).to(tdt),
                            quant.QuantWeight.of(tw), padding=(k // 2) * dil,
                            dilation=dil, ndim=ndim, pre_pad=pre_pad)
    assert torch.equal(again, out)


def test_int8_conv_sums_are_the_exact_integer_sums():
    """K7's plain version: int32 sums equal a direct int64 sum of the
    codes' products, beside the dequantized output."""
    x, w = _conv_inputs(2, 3, 16, 8, seed=3)
    qw = quant.QuantWeight.of(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    g = quant.geometry(xt, qw, 1, 1, 2)
    codes, sx = ik.quantize_s8(xt, ik.absmax(xt), g.Cp)
    out, sums = ik.conv_s8s8s32(codes, sx, qw.kernel, qw.scale, g,
                                torch.float32, with_sums=True)
    q = torch.nn.functional.pad(codes.long(), (0, 0, 1, 1, 1, 1))
    ref = torch.zeros(sums.shape, dtype=torch.long)
    for ky in range(3):
        for kx in range(3):
            patch = q[:, ky:ky + g.Ho, kx:kx + g.Wo, :]
            ref += torch.einsum("nhwc,oc->nohw", patch,
                                qw.kernel[:, ky, kx].long())
    assert sums.dtype == torch.int32 and torch.equal(sums.long(), ref)
    assert torch.equal(out, sums.float() * (sx * qw.scale).reshape(1, -1, 1,
                                                                   1))


def test_int8_conv_outside_the_kernel_geometry():
    """Stride 2 and rank 3 are not K7's: on the CPU the whole op's plain
    version runs them (equal to JAX); on any other device int8_conv
    raises NotImplementedError naming the geometry, and nothing falls
    back to the plain version."""
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 8, 6, 6, 6)).astype(np.float32)
    w = (rs.randn(4, 8, 3, 3, 3) * 0.2).astype(np.float32)
    jx = jnp.asarray(np.moveaxis(x, 1, -1))
    jw = jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0)))
    ref = jquant.int8_conv(jx, jw, window_strides=(1, 1, 1),
                           padding=[(1, 1)] * 3, rhs_dilation=(1, 1, 1),
                           dimension_numbers=jlayers._dim_numbers(3))
    out = quant.int8_conv(torch.from_numpy(x), torch.from_numpy(w),
                          padding=1, ndim=3)
    np.testing.assert_array_equal(bits(out),
                                  bits(np.moveaxis(np.asarray(ref), -1, 1)))
    x2 = torch.from_numpy(x[:, :, 0])
    w2 = torch.from_numpy(w[:, :, 0])
    ref2 = jquant.int8_conv(jnp.asarray(np.moveaxis(x[:, :, 0], 1, -1)),
                            jnp.asarray(np.transpose(w[:, :, 0],
                                                     (2, 3, 1, 0))),
                            window_strides=(2, 2), padding=[(1, 1)] * 2,
                            rhs_dilation=(1, 1),
                            dimension_numbers=jlayers._dim_numbers(2))
    out2 = quant.int8_conv(x2, w2, stride=2, padding=1)
    np.testing.assert_array_equal(bits(out2),
                                  bits(np.moveaxis(np.asarray(ref2), -1, 1)))
    for kw, what in ((dict(stride=2, padding=1), "stride 2"),
                     (dict(padding=3, dilation=3), "dilation 3")):
        with pytest.raises(NotImplementedError, match=what):
            quant.int8_conv(x2.to("meta"), w2.to("meta"), **kw)
    with pytest.raises(NotImplementedError, match="kernel size"):
        quant.int8_conv(x2.to("meta"), torch.zeros(4, 8, 5, 5,
                                                   device="meta"), padding=2)
    with pytest.raises(NotImplementedError, match="ndim 3"):
        quant.int8_conv(torch.from_numpy(x).to("meta"),
                        torch.from_numpy(w).to("meta"), padding=1, ndim=3)


# -- the Conv layer ---------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ndim,dil,pre_pad", [(2, 1, None), (2, 2, None),
                                              (2, 1, (1, 0)), (1, 4, None)])
def test_int8_conv_layer_equals_jax(ndim, dil, pre_pad, dtype):
    """layers.Conv with its weight quantized (enable_int8) against the JAX
    Conv under quantized_convs("int8"), both with the params cast to the
    dtype: the bias is added after the dequantization, in that dtype."""
    rs = np.random.RandomState(5 + dil)
    size = (12, 10) if ndim == 2 else (24,)
    x = (rs.randn(2, *size, 16) * 3).astype(np.float32)
    jconv = jlayers.Conv(features=12, kernel_size=3, ndim=ndim, dilation=dil,
                         pre_pad=pre_pad)
    params = init_flax(jconv, jnp.zeros((1, *size, 16)), seed=8)
    tdt, jdt = DTYPES[dtype]
    cast = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jdt), params)
    with jquant.quantized_convs("int8"):
        ref = jconv.apply({"params": cast}, jnp.asarray(x, jdt))
    conv = layers.Conv(16, 12, 3, dilation=dil, pre_pad=pre_pad, ndim=ndim)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.transpose(
            params["kernel"], (ndim + 1, ndim) + tuple(range(ndim)))))
        conv.bias.copy_(torch.from_numpy(params["bias"]))
    conv = quant.enable_int8(conv.to(tdt))
    assert conv.quant is not None
    with torch.no_grad():
        out = conv(torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(x, -1, 1))).to(tdt))
    assert out.dtype == tdt
    np.testing.assert_array_equal(
        bits(out.movedim(1, -1).contiguous()),
        bits(np.asarray(ref.astype(jnp.float32))))


# -- whole score nets -------------------------------------------------------

OVER_V2 = {"data.image_size": 64, "model.ngf": 16}
OVER_1D = {"model.ngf": 16}


@pytest.fixture(scope="module")
def ncsnv2():
    module = jncsnv2.NCSNv2Deepest(
        config=jax_load_config("ACDC", "real-imag", **OVER_V2))
    params = init_flax(module, jnp.zeros((1, 64, 64, 1)), jnp.ones((1,)))
    cfg = load_config("ACDC", "real-imag", **OVER_V2)
    model = NCSNv2Deepest(cfg)
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg,
                                               "ncsnv2_deepest"))
    x = np.random.RandomState(9).rand(4, 64, 64, 1).astype(np.float32)
    return module, params, model, x


@pytest.fixture(scope="module")
def ncsn1d():
    jcfg = jax_load_config("CINE127_1D", "real-imag", **OVER_1D)
    module = jncsn1d.NCSN1D(config=jcfg)
    T, C = jcfg.data.image_size, jcfg.data.channels
    params = init_flax(module, jnp.zeros((1, T, C)), jnp.ones((1,)))
    cfg = load_config("CINE127_1D", "real-imag", **OVER_1D)
    model = NCSN1D(cfg)
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg, "ncsn1d"))
    x = np.random.RandomState(10).randn(6, T, C).astype(np.float32)
    return module, params, model, x


def int8_readings(module, params, model, x, labels, ladder) -> dict:
    """make_score_fn(..., "int8") in both packages on the same weights and
    batch (the activation scale spans the whole batch), beside the port's
    float32 and bf16 scores: the relative L2 of the port's int8 score to
    JAX's, of each to float32, and the scores themselves."""
    jscore = jax_make_score_fn(module, params, jnp.asarray(ladder),
                               compute_dtype="int8")
    ref = np.asarray(jax.jit(jscore)(jnp.asarray(x), jnp.asarray(labels)))
    tl, tx, tlab = (torch.from_numpy(v) for v in (ladder, x, labels))
    with torch.no_grad():
        q = make_score_fn(model, tl, "int8")(tx, tlab)
        f32 = make_score_fn(model, tl)(tx, tlab)
        b16 = make_score_fn(model, tl, torch.bfloat16)(tx, tlab)
    return dict(port_vs_jax=rel_l2(q, ref), port_vs_f32=rel_l2(q, f32),
                jax_vs_f32=rel_l2(ref, f32), q=q, b16=b16)


@pytest.mark.parametrize("net", ["ncsnv2", "ncsn1d"])
def test_int8_score_fn_holds_to_jax(net, request):
    """The int8 score in both packages, and against the port's float32
    and bf16 scores."""
    module, params, model, x = request.getfixturevalue(net)
    ladder = np.array([348.0, 2.0, 0.37], np.float32)
    labels = np.arange(x.shape[0]) % 3
    r = int8_readings(module, params, model, x, labels, ladder)
    q = r["q"]
    assert q.dtype == torch.float32 and q.shape == x.shape
    assert r["port_vs_jax"] <= SCORE_VS_JAX, r["port_vs_jax"]
    assert r["port_vs_f32"] <= INT8_VS_F32, r["port_vs_f32"]
    ratio = r["port_vs_f32"] / r["jax_vs_f32"]
    assert 1 / ERROR_RATIO <= ratio <= ERROR_RATIO, ratio
    assert not torch.equal(q, r["b16"])
    # the switch is on the score function's copy only
    assert all(m.quant is None for m in model.modules()
               if isinstance(m, layers.Conv))
    assert next(model.parameters()).dtype == torch.float32


@pytest.mark.slow
def test_trained_acdc_prior_int8_holds_to_jax():
    """The trained ACDC prior (EMA weights, stored in bf16;
    artifacts/acdc_prior, which only this checkout has) through both
    packages' int8 make_score_fn at 256 px, batch 2 (the first and last
    level of the recon ladder): the int8 error on realistic activations,
    not only on seeded weights. Prints the relative L2 of the two int8
    scores to each other and to float32; holds them at the bounds above.
    Full size on the CPU: tier-1 deselects it."""
    import os
    from flax import serialization
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "artifacts", "acdc_prior", "ema_bf16.msgpack")
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32), tree)
    module = jncsnv2.NCSNv2Deepest(config=jax_load_config("ACDC",
                                                          "real-imag"))
    cfg = load_config("ACDC", "real-imag")
    model = NCSNv2Deepest(cfg)
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg), strict=True)
    x = np.random.RandomState(11).rand(2, 256, 256, 1).astype(np.float32)
    ladder = np.array([348.0, 0.01], np.float32)
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        r = int8_readings(module, params, model, x, np.array([0, 1]),
                          ladder)
    finally:
        torch.set_num_threads(1)
    print(f"trained ACDC prior, int8 at 256 px, batch 2: port vs JAX "
          f"{r['port_vs_jax']:.4g}, port vs f32 {r['port_vs_f32']:.4g}, "
          f"JAX vs f32 {r['jax_vs_f32']:.4g}")
    assert r["port_vs_f32"] <= INT8_VS_F32 and r["jax_vs_f32"] <= INT8_VS_F32
    assert r["port_vs_jax"] <= INT8_VS_F32
