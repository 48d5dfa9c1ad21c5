"""The port's serving path against the JAX package's: the reconstruction
engine (f32, steps mode) fed the JAX engine's own noise, with operator
overrides, single-coil and with segmentation guidance; the seg UNet, its
transposed convolution and the guidance gradients; the HTTP server; the
serve_recon's build_engine and model reload; the JAX engine's error paths
(tests/test_serving.py, the cases that apply to one device).

Geometry of tests/test_serving.py: 16 px, NCSNv2 ngf 8, 3 levels x 2 inner
steps, 4 chains, 2 coils. The engine holds at relative L2 1e-5 (float32
sums in another order through the chain, as tests/test_torch_ald_pair.py
holds one inner step); the UNet at 1e-5, the transposed convolution at
1e-6, the guidance gradients at 1e-5.
"""
import contextlib
import io
import json
import os
import urllib.error
import urllib.request
import unittest.mock as mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.config import Config as JConfig
from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config, load_general_config as jax_general)
from inverseproblemwithdiffusionmodel_tpu.models import layers as jlayers
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2 as JaxNCSNv2)
from inverseproblemwithdiffusionmodel_tpu.models.unet import UNet as JaxUNet
from inverseproblemwithdiffusionmodel_tpu.operators import pair as jpair
from inverseproblemwithdiffusionmodel_tpu.samplers import ald as jald
from inverseproblemwithdiffusionmodel_tpu.samplers import (
    ald_pair as jald_pair)
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    sigma_ladder as jax_sigma_ladder)
from inverseproblemwithdiffusionmodel_tpu.serving import (
    EngineSpec as JEngineSpec, ReconstructionEngine as JEngine)
from inverseproblemwithdiffusionmodel_tpu_torch.config import (
    Config, load_config, load_general_config)
from inverseproblemwithdiffusionmodel_tpu_torch.models import layers
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    build_seg_unet, load_model, make_seg_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.operators import pair
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
    make_stepped_pair_reconstructor)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import _common
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import serve_recon
from inverseproblemwithdiffusionmodel_tpu_torch.serving import (
    EngineSpec, ReconstructionEngine)
from inverseproblemwithdiffusionmodel_tpu_torch.serving.server import serve
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    Checkpointer, TrainState)
from inverseproblemwithdiffusionmodel_tpu_torch.training.state import (
    Optimizer)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch, flax_to_torch_ncsnv2, flax_to_torch_unet)
from tests.test_torch_ald_pair import jax_noise, replay
from tests.test_torch_ncsnv2 import draw, init_flax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 16
LEVELS, NSTEPS, CHAINS, NSENS = 3, 2, 4, 2
SEED = 7
REL_L2 = 1e-5
TINY = {
    "data": {"channels": 1, "image_size": H, "logit_transform": False,
             "rescaled": False},
    "model": {"ngf": 8, "nonlinearity": "elu",
              "normalization": "InstanceNorm++", "sigma_begin": 10.0,
              "sigma_end": 0.1, "num_classes": LEVELS,
              "sigma_dist": "geometric"},
}
SEG = {"spatial_dims": 2, "in_channels": 1, "out_channels": 2,
       "channels": [4, 8], "strides": [2]}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def seg_params(rs):
    """Flax params of the tiny seg UNet drawn with numpy; the PReLU slopes
    0.25 + 0.1 z, so that both of their sides count."""
    module = JaxUNet(out_channels=2, features=(4, 8), strides=(2,), ndim=2)
    params = init_flax(module, jnp.zeros((1, H, W, 1)))
    for name in params:
        if name.startswith("prelu"):
            params[name]["alpha"] = _np(0.25 + 0.1 * rs.randn())
    return module, params


def port_unet(params):
    gc = Config({"Seg": dict(SEG)})
    unet = build_seg_unet(gc)
    unet.load_state_dict(flax_to_torch_unet(params, gc))
    return unet


@pytest.fixture(scope="module")
def setup():
    """tests/test_serving.py's geometry: the tiny NCSNv2 in both packages
    on the same weights, a random line mask, 2 real coil maps, one
    measurement; the tiny seg UNet and a random label."""
    module = JaxNCSNv2(config=JConfig(TINY))
    params = init_flax(module, jnp.zeros((1, H, W, 1)), jnp.ones((1,)))
    cfg = Config(TINY)
    model = NCSNv2(cfg)
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg, "ncsnv2"))
    sigmas = jax_sigma_ladder(10.0, 0.1, LEVELS, "geometric")

    rng = np.random.RandomState(0)
    mask = (rng.rand(1, 1, W, 1) < 0.4).astype(np.float32)
    mask[..., W // 2 - 1:W // 2 + 1, :] = 1.0
    maps = rng.rand(NSENS, H, W, 1).astype(np.float32) + 0.2
    maps = maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))
    x = rng.rand(H, W).astype(np.float32)
    lin = jpair.PairSENSE(mask=jnp.asarray(mask), sens_re=jnp.asarray(maps),
                          sens_im=jnp.zeros_like(jnp.asarray(maps)))
    yr, yi = lin(jnp.asarray(x)[None, ..., None], jnp.zeros((1, H, W, 1)))
    seg_module, sparams = seg_params(np.random.RandomState(5))
    label = (np.random.RandomState(6).rand(H, W) > 0.5).astype(np.int32)
    return dict(module=module, params=params, model=model, sigmas=sigmas,
                mask=mask, maps=maps, yr=np.asarray(yr)[:, 0],
                yi=np.asarray(yi)[:, 0], seg_module=seg_module,
                seg_params=sparams, seg_model=port_unet(sparams),
                label=label)


SPEC = dict(height=H, width=W, channels=1, num_sens=NSENS, chains=CHAINS,
            levels=LEVELS, n_steps_each=NSTEPS, step_lr=1e-5, lr_scaled=2.0,
            prox_iters=3, dtype="f32", mode="steps")


def jengine(s, seg=False, **kw):
    spec = JEngineSpec(**{**SPEC, **kw})
    extra = dict(seg_module=s["seg_module"], seg_params=s["seg_params"]
                 ) if seg else {}
    return JEngine(s["module"], s["params"], s["sigmas"], spec=spec,
                   mask=s["mask"],
                   sens_re=s["maps"] if spec.num_sens else None, **extra)


def engine(s, seg=False, **kw):
    spec = EngineSpec(**{**SPEC, **kw})
    return ReconstructionEngine(
        s["model"], torch.tensor(np.asarray(s["sigmas"])), spec=spec,
        mask=s["mask"], sens_re=s["maps"] if spec.num_sens else None,
        seg_model=s["seg_model"] if seg else None, device="cpu")


def jax_draws(seed):
    return replay(jax_noise(jax.random.PRNGKey(seed), (CHAINS, H, W, 1),
                            LEVELS * NSTEPS))


def assert_results_match(ours, ref):
    for name in ("x_re", "x_im", "mean_mag", "std_mag"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.shape == b.shape and np.isfinite(a).all()
        assert rel_l2(a, b) <= REL_L2, (name, rel_l2(a, b))


@pytest.fixture(scope="module")
def plain_pair(setup):
    """One JAX engine and one port engine, shared by the tests that hold
    requests to JAX (one compiled JAX program for all of them)."""
    return jengine(setup), engine(setup)


# -- the engine against the JAX engine -------------------------------------

def test_engine_matches_jax(setup, plain_pair):
    jeng, eng = plain_pair
    ref = jeng.reconstruct(setup["yr"], setup["yi"], seed=SEED)
    ours = eng.reconstruct(setup["yr"], setup["yi"], seed=SEED,
                           noise=jax_draws(SEED))
    assert_results_match(ours, ref)
    assert ours.x_re.shape == (CHAINS, H, W, 1)
    # chains see different noise: a real ensemble, not CHAINS copies
    assert np.std(ours.x_re, axis=0).max() > 0
    np.testing.assert_allclose(ours.mean_re, ours.x_re.mean(axis=0))


def test_engine_overrides_match_jax(setup, plain_pair):
    """A new measurement, mask, coil maps and data-consistency weight per
    request: the same results as JAX, and one input signature."""
    jeng, eng = plain_pair
    rng = np.random.RandomState(1)
    mask2 = (rng.rand(1, 1, W, 1) < 0.6).astype(np.float32)
    maps2 = rng.rand(NSENS, H, W, 1).astype(np.float32) + 0.1
    maps2 = maps2 / np.sqrt((maps2 ** 2).sum(axis=0, keepdims=True))
    kw = dict(mask=mask2, sens_re=maps2, sens_im=None, lr_scaled=9.0,
              seed=1)
    ref = jeng.reconstruct(setup["yr"] * 2, setup["yi"], **kw)
    before = eng.stats()["requests"]
    eng.warmup()
    ours = eng.reconstruct(setup["yr"] * 2, setup["yi"], **kw,
                           noise=jax_draws(1))
    assert_results_match(ours, ref)
    plain = eng.reconstruct(setup["yr"], setup["yi"], seed=1)
    assert not np.allclose(plain.x_re, ours.x_re)
    stats = eng.stats()
    assert stats["input_signatures"] == 1
    assert stats["requests"] == before + 2
    assert stats["compile_s"] > 0 and stats["mean_latency_s"] > 0
    assert stats["mesh"] is None and stats["spec"]["chains"] == CHAINS


def test_single_coil_engine_matches_jax(setup):
    y = setup["mask"][0] * np.random.RandomState(2).rand(H, W, 1)
    y = y.astype(np.float32)
    ref = jengine(setup, num_sens=0).reconstruct(y, np.zeros_like(y),
                                                 seed=3)
    eng = engine(setup, num_sens=0)
    ours = eng.reconstruct(y, np.zeros_like(y), seed=3, noise=jax_draws(3))
    assert_results_match(ours, ref)
    with pytest.raises(ValueError, match="single-coil"):
        ReconstructionEngine(setup["model"], setup["sigmas"],
                             spec=EngineSpec(**{**SPEC, "num_sens": 0}),
                             sens_re=setup["maps"], device="cpu")


@pytest.mark.parametrize("seg_mode", ["full", "FG"])
def test_guided_engine_matches_jax(setup, seg_mode):
    kw = dict(seed=SEED, seg_label=setup["label"], seg_lamda=3.0)
    ref = jengine(setup, seg=True, seg_mode=seg_mode).reconstruct(
        setup["yr"], setup["yi"], **kw)
    eng = engine(setup, seg=True, seg_mode=seg_mode)
    ours = eng.reconstruct(setup["yr"], setup["yi"], **kw,
                           noise=jax_draws(SEED))
    assert_results_match(ours, ref)
    # the guidance moves the chain
    plain = engine(setup).reconstruct(setup["yr"], setup["yi"],
                                      noise=jax_draws(SEED))
    assert not np.allclose(plain.x_re, ours.x_re)
    # a new label and weight: one input signature still
    eng.reconstruct(setup["yr"], setup["yi"], seed=4,
                    seg_label=1 - setup["label"], seg_lamda=0.25)
    assert eng.stats()["input_signatures"] == 1
    assert not any(p.requires_grad for p in eng.seg_model.parameters())


def test_guided_reconstructor_matches_jax(setup):
    """make_stepped_pair_reconstructor with seg_fn(seg_params, x), as the
    JAX form takes the seg weights, against JAX's, fed its noise."""
    s = setup
    yr = np.broadcast_to(s["yr"][:, None], (NSENS, CHAINS, H, W, 1))
    yi = np.broadcast_to(s["yi"][:, None], (NSENS, CHAINS, H, W, 1))
    labels = np.broadcast_to(s["label"], (CHAINS, H, W))
    jlin = jpair.PairSENSE(mask=jnp.asarray(s["mask"]),
                           sens_re=jnp.asarray(s["maps"]),
                           sens_im=jnp.zeros((NSENS, H, W, 1)))
    config = dict(n_steps_each=NSTEPS, step_lr=1e-5)
    seg = dict(seg_lamda=2.0, seg_start_time=0.0, seg_mode="full")
    jrecon = jald_pair.make_stepped_pair_reconstructor(
        s["module"], s["sigmas"], jlin,
        jpair.PairL2Penalty.with_normal_kernel(jlin, num_iters=3),
        jald.ALDConfig(**config), lr_scaled=2.0,
        seg_fn=lambda p, x: s["seg_module"].apply({"params": p}, x),
        seg_label=jnp.asarray(labels), seg_params=s["seg_params"], **seg)
    key = jax.random.PRNGKey(2)
    ref = jrecon(s["params"], jnp.asarray(yr), jnp.asarray(yi), key)
    lin = pair.PairSENSE(mask=torch.tensor(s["mask"]),
                         sens_re=torch.tensor(s["maps"]),
                         sens_im=torch.zeros(NSENS, H, W, 1))
    unet = s["seg_model"]
    recon = make_stepped_pair_reconstructor(
        s["model"], torch.tensor(np.asarray(s["sigmas"])), lin,
        pair.PairL2Penalty.with_normal_kernel(lin, num_iters=3),
        ald.ALDConfig(**config), lr_scaled=2.0,
        seg_fn=lambda net, x: make_seg_fn(net)(x),
        seg_label=torch.tensor(labels.copy()), seg_params=unet,
        device="cpu", **seg)
    ours = recon(torch.tensor(yr.copy()), torch.tensor(yi.copy()),
                 noise=replay(jax_noise(key, (CHAINS, H, W, 1),
                                        LEVELS * NSTEPS)))
    for a, b in zip(ours, ref):
        assert rel_l2(a.numpy(), b) <= REL_L2


def test_guided_chain_needs_autograd_the_plain_one_does_not(setup):
    """The unguided chain runs under inference_mode (its outputs are
    inference tensors); the guided one under no_grad. A caller of the
    parts who wraps a guided step in inference_mode gets a clear error."""
    s = setup
    lin = pair.PairSENSE(mask=torch.tensor(s["mask"]),
                         sens_re=torch.tensor(s["maps"]),
                         sens_im=torch.zeros(NSENS, H, W, 1))
    prox = pair.PairL2Penalty.with_normal_kernel(lin, num_iters=3)
    y = lin(torch.rand(CHAINS, H, W, 1), torch.zeros(CHAINS, H, W, 1))
    sigmas = torch.tensor(np.asarray(s["sigmas"]))
    cfg = ald.ALDConfig(n_steps_each=1, step_lr=1e-5)
    plain = make_stepped_pair_reconstructor(s["model"], sigmas, lin, prox,
                                            cfg, device="cpu")
    assert plain(*y)[0].is_inference()
    guided = make_stepped_pair_reconstructor(
        s["model"], sigmas, lin, prox, cfg, device="cpu",
        seg_fn=make_seg_fn(s["seg_model"]),
        seg_label=torch.tensor(np.broadcast_to(s["label"], (CHAINS, H, W))))
    xr, xi = guided(*y)
    assert not xr.is_inference() and not xr.requires_grad
    assert torch.isfinite(xr).all()
    with torch.inference_mode():
        x0r, x0i, p0 = guided.start(*y)
        with pytest.raises(RuntimeError, match="inference_mode"):
            guided.level_step(p0, x0r, x0i, *y, 0,
                              lambda shape: torch.zeros(shape))
    with pytest.raises(ValueError, match="seg_label"):
        make_stepped_pair_reconstructor(
            s["model"], sigmas, lin, prox, cfg, device="cpu",
            seg_fn=make_seg_fn(s["seg_model"]))


# -- the seg UNet, its layers and the guidance gradients -------------------

@pytest.mark.parametrize("size", [(8, 8), (7, 9)], ids=["even", "odd"])
def test_conv_transpose_matches_jax(size):
    rs = np.random.RandomState(11)
    x = _np(rs.randn(2, *size, 6))
    module = jlayers.ConvTranspose(features=4, kernel_size=(3, 3),
                                   stride=(2, 2), padding=(1, 1),
                                   output_padding=(1, 1), ndim=2)
    params = draw(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                 jnp.asarray(x))["params"], rs)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    conv = layers.ConvTranspose(6, 4, 3, stride=2, padding=1,
                                output_padding=1)
    conv.load_state_dict(flax_to_torch(params, transposed={""}))
    with torch.no_grad():
        out = conv(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (2, 2 * size[0], 2 * size[1], 4)
    assert rel_l2(out.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("size", [(8, 8), (7, 9)], ids=["even", "odd"])
def test_stride2_conv_matches_jax(size):
    """The UNet encoder's stride-2 convolution (explicit padding k // 2)."""
    rs = np.random.RandomState(12)
    x = _np(rs.randn(2, *size, 3))
    module = jlayers.Conv(features=5, kernel_size=3, ndim=2, stride=2)
    params = draw(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                 jnp.asarray(x))["params"], rs)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    conv = layers.Conv(3, 5, 3, stride=2)
    conv.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        out = conv(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    assert rel_l2(out.numpy(), ref) <= 1e-6


def test_unet_matches_jax(setup):
    x = _np(np.random.RandomState(13).randn(3, H, W, 1))
    ref = np.asarray(setup["seg_module"].apply(
        {"params": setup["seg_params"]}, jnp.asarray(x)))
    with torch.no_grad():
        out = make_seg_fn(setup["seg_model"])(torch.tensor(x)).numpy()
    assert out.shape == ref.shape == (3, H, W, 2)
    assert rel_l2(out, ref) <= 1e-5


def test_unet_converter_refuses_a_wrong_tree(setup):
    params = dict(setup["seg_params"])
    params["up_9"] = params.pop("up_0")
    with pytest.raises(KeyError):
        flax_to_torch_unet(params, Config({"Seg": dict(SEG)}))


@pytest.mark.parametrize("mode", ["full", "FG"])
def test_compute_seg_grad_matches_jax(setup, mode):
    rs = np.random.RandomState(14)
    x = _np(rs.randn(4, H, W, 1))
    label = (rs.rand(4, H, W) > 0.5).astype(np.int32)
    ref = jald.compute_seg_grad(
        lambda v: setup["seg_module"].apply({"params": setup["seg_params"]},
                                            v),
        jnp.asarray(x), jnp.asarray(label), mode)
    with torch.no_grad():                  # the chain's own grad mode
        out = ald.compute_seg_grad(make_seg_fn(setup["seg_model"]),
                                   torch.tensor(x), torch.tensor(label),
                                   mode)
    assert rel_l2(out.numpy(), ref) <= 1e-5
    if mode == "FG":
        assert (out.numpy()[label == 0] == 0).all()
    with pytest.raises(ValueError, match="mode"):
        ald.compute_seg_grad(make_seg_fn(setup["seg_model"]),
                             torch.tensor(x), torch.tensor(label), "BG")


def test_compute_clf_grad_matches_jax():
    rs = np.random.RandomState(15)
    x = _np(rs.randn(3, 4, 4, 1))
    w = _np(rs.randn(16, 5))
    cls = np.array([0, 3, 4], np.int32)
    ref = jald.compute_clf_grad(
        lambda v: jnp.tanh(v.reshape(3, -1) @ jnp.asarray(w)),
        jnp.asarray(x), jnp.asarray(cls))
    out = ald.compute_clf_grad(
        lambda v: torch.tanh(v.reshape(3, -1) @ torch.tensor(w)),
        torch.tensor(x), torch.tensor(cls))
    assert rel_l2(out.numpy(), ref) <= 1e-5


def test_general_config_equals_the_yaml():
    assert load_general_config().to_dict() == jax_general().to_dict()


def test_load_model_builds_the_ported_tasks():
    cfg = load_config("ACDC", "real-imag",
                      **{"data.image_size": 16, "model.ngf": 4})
    seg, params = load_model(cfg, "Seg")
    assert params is None
    assert seg.up_3.out_channels == 2 and seg.down_0.out_channels == 64
    assert seg.prelu_bottom.alpha.item() == 0.25
    net, _ = load_model(cfg, "Diffusion", seed=1)
    again, _ = load_model(cfg, "Diffusion", seed=1)
    assert type(net).__name__ == "NCSNv2Deepest"
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)
    temporal, _ = load_model(load_config("CINE127_1D", "real-imag",
                                         **{"model.ngf": 4}), "Diffusion1D")
    assert type(temporal).__name__ == "NCSNv2" and temporal.ndim == 1
    volumes, _ = load_model(load_config("CINE127_1D", "real-imag",
                                        **{"model.ngf": 4}), "Diffusion3D")
    assert type(volumes).__name__ == "NCSN3DShallow"
    clf, params = load_model(cfg, "Clf")
    assert params is None and type(clf).__name__ == "ResNetClf"
    assert clf.pre_conv.in_channels == cfg.data.channels
    assert clf.resnet.fc.out_features == 10
    with pytest.raises(ValueError, match="unknown task"):
        load_model(cfg, "Denoise")


# -- the JAX engine's error paths and shape rules --------------------------

def test_measurement_shape_handling(setup, plain_pair):
    _, eng = plain_pair
    r1 = eng.reconstruct(setup["yr"][..., 0], setup["yi"][..., 0], seed=0)
    r2 = eng.reconstruct(setup["yr"], setup["yi"], seed=0)
    np.testing.assert_array_equal(r1.x_re, r2.x_re)
    with pytest.raises(ValueError, match="measurement shape"):
        eng.reconstruct(setup["yr"][:, :8], setup["yi"][:, :8])


def test_spec_validation(setup):
    sigmas = setup["sigmas"]
    for kw, err, match in (
            (dict(levels=LEVELS + 1), ValueError, "len"),
            (dict(mode="graph"), ValueError, "mode"),
            (dict(dtype="f16"), ValueError, "dtype")):
        with pytest.raises(err, match=match):
            ReconstructionEngine(setup["model"], sigmas,
                                 spec=EngineSpec(**{**SPEC, **kw}),
                                 device="cpu")
    # dtype int8 builds and serves: finite float32 chains, and the
    # engine's net itself keeps its float32 convolutions
    eng = ReconstructionEngine(setup["model"], sigmas,
                               spec=EngineSpec(**{**SPEC, "dtype": "int8"}),
                               device="cpu")
    res = eng.reconstruct(setup["yr"], setup["yi"], seed=0)
    assert res.x_re.dtype == np.float32 and np.isfinite(res.x_re).all()
    assert all(m.quant is None for m in eng.model.modules()
               if isinstance(m, layers.Conv))
    # a mesh without a data axis (tests/test_torch_parallel.py runs the
    # engine on one)
    with pytest.raises(ValueError, match="'data' axis"):
        ReconstructionEngine(setup["model"], sigmas,
                             spec=EngineSpec(**SPEC), mesh=object(),
                             device="cpu")


def test_bf16_engine_keeps_float32_state(setup):
    res = engine(setup, dtype="bf16").reconstruct(setup["yr"], setup["yi"])
    assert np.isfinite(res.x_re).all() and res.x_re.dtype == np.float32


def test_seg_engine_error_paths(setup, plain_pair):
    _, plain = plain_pair
    with pytest.raises(ValueError, match="without a seg model"):
        plain.reconstruct(setup["yr"], setup["yi"],
                          seg_label=setup["label"])
    guided = engine(setup, seg=True)
    with pytest.raises(ValueError, match="needs seg_label"):
        guided.reconstruct(setup["yr"], setup["yi"])
    with pytest.raises(ValueError):
        guided.reconstruct(setup["yr"], setup["yi"],
                           seg_label=setup["label"][:8])
    # the construction-time default label serves label-less requests
    eng = ReconstructionEngine(
        setup["model"], setup["sigmas"], spec=EngineSpec(**SPEC),
        mask=setup["mask"], sens_re=setup["maps"],
        seg_model=setup["seg_model"], seg_label=setup["label"],
        device="cpu")
    res = eng.reconstruct(setup["yr"], setup["yi"])
    assert np.isfinite(res.mean_mag).all()


# -- the HTTP server -------------------------------------------------------

def _post(url, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req) as r:
        return np.load(io.BytesIO(r.read())), r.headers


@contextlib.contextmanager
def running(eng):
    httpd = serve(eng, port=0, background=True)
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_server_roundtrip(setup):
    eng = engine(setup)
    with running(eng) as base:
        with urllib.request.urlopen(f"{base}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["requests"] == 0
        assert health["spec"]["chains"] == CHAINS
        with urllib.request.urlopen(f"{base}/spec") as r:
            assert json.loads(r.read()) == health["spec"]

        out, headers = _post(f"{base}/reconstruct?seed=5&lr_scaled=2.0",
                             y_re=setup["yr"], y_im=setup["yi"])
        assert float(headers["X-Latency-S"]) > 0
        assert float(headers["X-Chain-Steps-Per-S"]) > 0
        assert out["mean_mag"].shape == (H, W, 1)
        assert out["x_re"].shape == (CHAINS, H, W, 1)
        direct = eng.reconstruct(setup["yr"], setup["yi"], seed=5,
                                 lr_scaled=2.0)
        np.testing.assert_array_equal(out["x_re"], direct.x_re)

        for data in (b"not-an-npz", None):       # malformed; no y_im
            if data is None:
                buf = io.BytesIO()
                np.savez(buf, y_re=setup["yr"])
                data = buf.getvalue()
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    f"{base}/reconstruct", data=data))
            assert ei.value.code == 400
        for req in (f"{base}/nowhere", urllib.request.Request(
                f"{base}/nowhere", data=b"")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req)
            assert ei.value.code == 404
        with urllib.request.urlopen(f"{base}/healthz") as r:
            assert json.loads(r.read())["requests"] == 2


def test_concurrent_requests_serialize(setup):
    """More client threads than cores, the interpreter switching often:
    every request is counted and each equals the sequential result for its
    seed (the lock keeps one request at a time on the engine)."""
    import sys
    import threading
    eng = ReconstructionEngine(
        setup["model"], torch.tensor(np.asarray(setup["sigmas"]))[:1],
        spec=EngineSpec(**{**SPEC, "levels": 1, "n_steps_each": 1}),
        mask=setup["mask"], sens_re=setup["maps"], device="cpu")
    n = 2 * (os.cpu_count() or 1) + 1
    want = {seed: eng.reconstruct(setup["yr"], setup["yi"], seed=seed).x_re
            for seed in range(3)}
    got, errors = [None] * n, []

    def client(i):
        try:
            got[i] = eng.reconstruct(setup["yr"], setup["yi"],
                                     seed=i % 3).x_re
        except Exception as e:          # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i, x in enumerate(got):
        np.testing.assert_array_equal(x, want[i % 3])
    assert eng.stats()["requests"] == 3 + n


def test_seg_label_over_the_wire(setup):
    eng = engine(setup, seg=True)
    with running(eng) as base:
        out, _ = _post(f"{base}/reconstruct?seed=7&seg_lamda=3.0",
                       y_re=setup["yr"], y_im=setup["yi"],
                       seg_label=setup["label"])
    direct = eng.reconstruct(setup["yr"], setup["yi"], seed=7,
                             seg_label=setup["label"], seg_lamda=3.0)
    np.testing.assert_array_equal(out["mean_mag"], direct.mean_mag)


# -- serve_recon and model reload ------------------------------------------

CLI = ["--device", "cpu", "--chains", "2", "--levels", "2", "--num_sens",
       "2", "--dtype", "f32", "--R", "8", "--synth_sens",
       "--override", "data.image_size=32", "--override", "model.ngf=8"]


def _save(model, ckpt_dir, step=3):
    state = TrainState.create(
        model, lambda ps: Optimizer(ps, torch.optim.Adam), ema_decay=0.9)
    state.step = step
    Checkpointer(ckpt_dir).save(step, state)
    return state


def test_cli_builds_engine(tmp_path):
    """serve_recon.build_engine wires config, checkpoints, mask and coil maps
    into an engine; --seg_ckpt_dir makes it guided (the full-width seg
    UNet of the general config, from a checkpoint the port wrote)."""
    seg, _ = load_model(None, "Seg", seed=3)
    state = _save(seg, str(tmp_path / "seg"))
    args = serve_recon.parse_args(
        CLI + ["--seg_ckpt_dir", str(tmp_path / "seg"), "--seg_mode", "FG"])
    assert args.device == "cpu" and args.mode == "steps"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng = serve_recon.build_engine(args)
    assert "Seg: restored step 3" in out.getvalue()
    assert "WARNING: no checkpoint for Diffusion" in out.getvalue()
    assert eng.spec.height == 32 and eng.spec.levels == 2
    assert eng.spec.seg_mode == "FG" and eng.seg_model is not None
    for name, value in eng.seg_model.state_dict().items():
        assert torch.equal(value, state.ema.params[name])
    assert eng.default_lin_tfm.mask.sum() < 32           # R = 8
    assert eng.default_lin_tfm.sens_re.std() > 0         # synthetic maps
    label = np.zeros((32, 32), np.int64)
    label[8:24, 8:24] = 1
    res = eng.reconstruct(np.zeros((2, 32, 32), np.float32),
                          np.zeros((2, 32, 32), np.float32),
                          seg_label=label)
    assert np.isfinite(res.mean_mag).all()


@pytest.mark.parametrize("flags,match", [
    (["--workload", "cine", "--dtype", "int8", "--ds_name", "CINE127",
      "--frames", "3", "--override", "data.image_size=16"], None),
    (["--data_shards", "2"], "exceeds the 1 available"),
    (["--dtype", "int8"], None)], ids=["cine", "data_shards", "int8"])
def test_cli_refuses_what_is_not_ported(flags, match):
    """--data_shards (chain sharding), refused before it was ported, now
    exits where it asks for more devices than there are (the CPU counts
    as one; tests/test_torch_parallel.py shards the engines). --dtype
    int8, refused before it was ported, now builds both workloads' engines
    with int8 score nets (tests/test_torch_int8_serving.py holds them to
    JAX), and one request comes back finite."""
    args = serve_recon.parse_args(CLI + flags)
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            serve_recon.build_engine(args)
        return
    eng = serve_recon.build_engine(args)
    assert eng.spec.dtype == "int8"
    s = eng.spec
    shape = (2,) + ((s.frames,) if hasattr(s, "frames") else ()) + (
        s.height, s.width)
    y = np.random.RandomState(0).rand(*shape).astype(np.float32)
    res = eng.reconstruct(y, np.zeros_like(y), seed=0)
    assert np.isfinite(res.mean_mag).all()


def test_main_warms_up_and_serves():
    served = {}
    with mock.patch.object(serve_recon, "serve",
                           lambda eng, host, port: served.update(
                               eng=eng, host=host, port=port)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve_recon.main(CLI + ["--port", "0"])
    assert "[serve] warm in" in out.getvalue()
    assert served["port"] == 0 and served["host"] == "127.0.0.1"
    assert served["eng"].stats()["compile_s"] > 0


def test_reload_model_restores_a_port_checkpoint(tmp_path):
    cfg = load_config("ACDC", "real-imag",
                      **{"data.image_size": 16, "model.ngf": 4})
    trained, _ = load_model(cfg, "Diffusion", seed=9)
    state = _save(trained, str(tmp_path))
    with torch.no_grad():
        for p in state.ema.params.values():
            p.add_(1.0)                     # EMA and raw weights differ
    Checkpointer(str(tmp_path)).save(4, state)
    ema, _ = _common.reload_model(cfg, "Diffusion", str(tmp_path))
    raw, _ = _common.reload_model(cfg, "Diffusion", str(tmp_path),
                                  use_ema=False)
    for name, value in ema.state_dict().items():
        assert torch.equal(value, state.ema.params[name])
        assert torch.equal(raw.state_dict()[name], state.params[name])
    fresh, _ = _common.reload_model(cfg, "Diffusion", None, seed=9)
    for a, b in zip(fresh.parameters(), trained.parameters()):
        assert torch.equal(a, b)
    (tmp_path / "orbax" / "5" / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="convert_orbax_checkpoint"):
        _common.reload_model(cfg, "Diffusion", str(tmp_path / "orbax"))


def test_add_common_args():
    import argparse
    p = _common.add_common_args(argparse.ArgumentParser(), ckpt=False)
    args = p.parse_args(["--override", "model.ngf=8"])
    assert args.device == "cuda" and args.num_samples == 1
    assert not hasattr(args, "ckpt_dir")


def test_seg_grad_precision_script_runs_on_the_cpu():
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        seg_grad_precision)
    with contextlib.redirect_stdout(io.StringIO()):
        out = seg_grad_precision.main(["--device", "cpu", "--size", "32",
                                       "--batch", "1"])
    assert out["f64_vs_cpu_f64"] == 0.0
    assert 0 < out["cpu_f32_vs_cpu_f64"] < 1e-4
    layers_ = {name for name, _ in load_model(None, "Seg")[0]
               .named_children()}
    assert set(out["cpu_f32_per_layer"]) == layers_
    assert out["f32_exact_per_layer"] == out["cpu_f32_per_layer"]


@pytest.mark.slow
def test_trained_prior_engine_matches_jax():
    """The trained ACDC prior (artifacts/, this checkout only) in both
    engines at 256 px: 1 chain, 4 coils, R = 8, 2 levels x 1 step, f32,
    JAX's noise."""
    from flax import serialization
    path = os.path.join(ROOT, "artifacts", "acdc_prior", "ema_bf16.msgpack")
    with open(path, "rb") as f:
        params = jax.tree_util.tree_map(
            _np, serialization.msgpack_restore(f.read()))
    from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
        NCSNv2Deepest as JaxNCSNv2Deepest)
    from inverseproblemwithdiffusionmodel_tpu.operators.fourier import (
        MASK_PRESETS, _exp_sens_map)
    from inverseproblemwithdiffusionmodel_tpu.operators.masks import (
        generate_mask)
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        NCSNv2Deepest)
    size, coils = 256, 4
    sigmas = jax_sigma_ladder(348, 0.01, 2)
    mask = generate_mask(1, size, seed=0, **MASK_PRESETS[8])
    maps = np.stack([_exp_sens_map(size, size, i) for i in range(coils)])
    maps = (maps / np.sqrt((maps ** 2).sum(0, keepdims=True)))[..., None]
    spec = dict(height=size, width=size, num_sens=coils, chains=1,
                levels=2, n_steps_each=1, dtype="f32", mode="steps")
    y = _np(np.random.RandomState(0).randn(coils, size, size) * 0.1)
    y = y * mask.reshape(1, 1, size)
    ref = JEngine(JaxNCSNv2Deepest(config=jax_load_config("ACDC",
                                                          "real-imag")),
                  params, sigmas, spec=JEngineSpec(**spec), mask=mask,
                  sens_re=maps).reconstruct(y, np.zeros_like(y), seed=1)
    cfg = load_config("ACDC", "real-imag")
    model = NCSNv2Deepest(cfg)
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg), strict=True)
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        ours = ReconstructionEngine(
            model, torch.tensor(np.asarray(sigmas)), spec=EngineSpec(**spec),
            mask=mask, sens_re=maps, device="cpu").reconstruct(
                y, np.zeros_like(y), noise=replay(jax_noise(
                    jax.random.PRNGKey(1), (1, size, size, 1), 2)))
    finally:
        torch.set_num_threads(1)
    for name in ("x_re", "x_im"):
        assert rel_l2(getattr(ours, name), getattr(ref, name)) <= 1e-4
