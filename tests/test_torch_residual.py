"""The residual pyramids of the port's NCSN++ and the FIR resamplers that fuse
a convolution, against the JAX package; and the sampling entry point with no
--config, which builds ve/cifar10_ncsnpp_continuous (residual input
pyramid).

`upsample_conv_2d` / `conv_downsample_2d` are XLA in the JAX package and
plain PyTorch in the port, on both devices: no kernel sits under them.
Tolerances are test_torch_ncsnpp.py's (rtol 1e-4, atol 1e-5): float32 sums
of a 3x3 conv and a 4x4 FIR in another order; the tiny models are its
cut of the cifar10 leaf (16x16, nf 16, ch_mult (1, 2, 2), one res block,
attention at 8x8) with the JAX params redrawn by its `perturb`.
"""
import contextlib
import importlib
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.configs_continuous import (
    get_continuous_config as jax_get_config)
from inverseproblemwithdiffusionmodel_tpu.models import layerspp as jlpp
from inverseproblemwithdiffusionmodel_tpu.models.ncsnpp import (
    NCSNpp as JaxNCSNpp)
from inverseproblemwithdiffusionmodel_tpu.ops.upfirdn2d import (
    conv_downsample_2d as jax_conv_downsample_2d,
    upsample_conv_2d as jax_upsample_conv_2d)
from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
    get_continuous_config)
from inverseproblemwithdiffusionmodel_tpu_torch.models import create_model
from inverseproblemwithdiffusionmodel_tpu_torch.models import layerspp
# the submodule: the package-level name ops.upfirdn2d is the function,
# as the JAX package exports it
tup = importlib.import_module(
    "inverseproblemwithdiffusionmodel_tpu_torch.ops.upfirdn2d")
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch, flax_to_torch_ncsnpp, seeded_weights)

from test_torch_ncsnpp import TINY, TOL, perturb

torch.set_num_threads(1)

LEAF = "ve/cifar10_ncsnpp_continuous"
KERNELS = [(1, 1), (1, 2, 1), (1, 3, 3, 1)]


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("gain", [1.0, 2.0])
def test_upsample_conv_2d_matches_jax(k, gain):
    x, w = _rand(2, 5, 6, 4), _rand(3, 3, 4, 7, seed=1)
    ref = np.asarray(jax_upsample_conv_2d(jnp.asarray(x), jnp.asarray(w),
                                          k=k, factor=2, gain=gain))
    out = tup.upsample_conv_2d(torch.from_numpy(x), torch.from_numpy(w),
                               k=k, factor=2, gain=gain)
    assert out.shape == ref.shape == (2, 10, 12, 7)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("gain", [1.0, 2.0])
def test_conv_downsample_2d_matches_jax(k, gain):
    x, w = _rand(2, 8, 6, 4, seed=2), _rand(3, 3, 4, 5, seed=3)
    ref = np.asarray(jax_conv_downsample_2d(jnp.asarray(x), jnp.asarray(w),
                                            k=k, factor=2, gain=gain))
    out = tup.conv_downsample_2d(torch.from_numpy(x), torch.from_numpy(w),
                                 k=k, factor=2, gain=gain)
    assert out.shape == ref.shape == (2, 4, 3, 5)
    assert out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("out_ch", [None, 12])
def test_fir_resamplers_with_conv_match_jax(direction, out_ch):
    # The parameters cross through utils/convert.py by name and layout.
    jcls, tcls = ((jlpp.Upsample, layerspp.Upsample) if direction == "up"
                  else (jlpp.Downsample, layerspp.Downsample))
    jmod = jcls(out_ch=out_ch, with_conv=True, fir=True,
                fir_kernel=(1, 3, 3, 1))
    tmod = tcls(in_ch=8, out_ch=out_ch, with_conv=True, fir=True,
                fir_kernel=(1, 3, 3, 1))
    x = _rand(2, 8, 8, 8, seed=4)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = perturb(params, np.random.RandomState(5))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("progressive,progressive_input", [
    ("none", "residual"),        # the cifar10 leaf's own pyramids
    ("residual", "residual"),
    ("residual", "input_skip"),
])
def test_tiny_residual_ncsnpp_matches_jax(progressive, progressive_input):
    over = {**TINY, "model.progressive": progressive,
            "model.progressive_input": progressive_input}
    jcfg = jax_get_config(LEAF).replace(**over)
    module = JaxNCSNpp(config=jcfg)
    params = jax.jit(module.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 16, 16, 3)),
                                  jnp.ones((1,)))["params"]
    params = perturb(params, np.random.RandomState(0))
    cfg = get_continuous_config(LEAF).replace(**over)
    model = create_model(cfg).eval()
    model.load_state_dict(flax_to_torch_ncsnpp(params, cfg), strict=True)

    rs = np.random.RandomState(1)
    x = rs.rand(2, 16, 16, 3).astype(np.float32)
    sigma = np.array([0.7, 40.0], np.float32)
    ref = np.asarray(jax.jit(lambda x, s: module.apply(
        {"params": params}, x, s))(jnp.asarray(x), jnp.asarray(sigma)))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(sigma))
    assert np.abs(ref).max() > 1e-2   # the weights make the output count
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_seeded_weights_draw_the_fused_resamplers():
    cfg = get_continuous_config(LEAF).replace(**TINY)
    model = seeded_weights(create_model(cfg), seed=0)
    w = model.pyr_down_0.Conv2d_0_weight
    assert w.shape == (3, 3, 3, 16)
    # fan-in scale: std 1 / sqrt(27)
    assert 0.5 / np.sqrt(27) < w.std().item() < 2 / np.sqrt(27)
    assert model.pyr_down_0.Conv2d_0_bias.abs().max() > 0


def test_pc_sampling_runs_with_no_config_like_jax(tmp_path):
    from inverseproblemwithdiffusionmodel_tpu.scripts import (
        pc_sampling as jax_pc_sampling)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        pc_sampling)
    tiny = ["--num_samples", "2", "--override", "data.image_size=16",
            "--override", "model.nf=16",
            "--override", "model.ch_mult=[1, 2, 2]",
            "--override", "model.num_res_blocks=1",
            "--override", "model.attn_resolutions=[8]",
            "--override", "model.num_scales=2"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ref = jax_pc_sampling.main(tiny + ["--save_dir",
                                           str(tmp_path / "jax")])
        out = pc_sampling.main(tiny + ["--device", "cpu", "--save_dir",
                                       str(tmp_path / "port")])
    assert type(out) is type(ref) is np.ndarray
    assert out.shape == ref.shape == (2, 16, 16, 3)
    assert out.dtype == ref.dtype == np.float32
    assert np.isfinite(out).all()
    assert printed.getvalue().count("(nfe=4)") == 2
