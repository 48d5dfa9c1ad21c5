"""The port's host tools against the JAX package's: the misc data helpers
(utils/misc.py), the dataset statistics (utils/dataset_stats.py), the
numeric and drawing helpers of utils/visualizations.py, the three hooks of
training/callbacks.py, data.vol2slice with scripts/vol2slices.py, and
utils/profiling.py on the CPU.

Numbers are held equal, or at 1e-6 where the two packages sum in another
order. A figure is held by its file name and its size in pixels (and a
GIF by its frame count): both packages draw with the same matplotlib and
Pillow calls, and the samples inside differ where their random streams
do. matplotlib and Pillow are imported only by the drawing functions.
"""
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from PIL import Image

from inverseproblemwithdiffusionmodel_tpu.config import Config as JConfig
from inverseproblemwithdiffusionmodel_tpu.data import datasets as jdatasets
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2 as JaxNCSNv2)
from inverseproblemwithdiffusionmodel_tpu.models.simple import (
    ScoreNet as JaxScoreNet)
from inverseproblemwithdiffusionmodel_tpu.sde import VESDE as JaxVESDE
from inverseproblemwithdiffusionmodel_tpu.training import (
    TrainState as JTrainState, callbacks as jcallbacks)
from inverseproblemwithdiffusionmodel_tpu.utils import (
    dataset_stats as jstats, misc as jmisc, profiling as jprofiling,
    visualizations as jvis)
from inverseproblemwithdiffusionmodel_tpu_torch.config import Config
from inverseproblemwithdiffusionmodel_tpu_torch.data import datasets
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.models.simple import ScoreNet
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import vol2slices
from inverseproblemwithdiffusionmodel_tpu_torch.sde import VESDE
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    TrainState, callbacks)
from inverseproblemwithdiffusionmodel_tpu_torch.training.state import (
    Optimizer)
from inverseproblemwithdiffusionmodel_tpu_torch.utils import (
    dataset_stats, misc, profiling, visualizations as vis)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnv2, flax_to_torch_scorenet)
from tests.test_torch_ncsn import flax_params
from tests.test_torch_ncsnv2 import init_flax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-7)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _png(path):
    with Image.open(path) as im:
        return im.size, getattr(im, "n_frames", 1)


# -- utils/misc ---------------------------------------------------------------

def _data_config(**data):
    base = dict(uniform_dequantization=False, gaussian_dequantization=False,
                rescaled=False, logit_transform=False)
    return dict(data=dict(base, **data))


def test_misc_helpers_equal_jax():
    rs = np.random.RandomState(0)
    x = _np(rs.rand(3, 6, 5, 2) * 0.98 + 0.01)
    v = _np(rs.rand(3))
    tx = torch.from_numpy(x)
    assert misc.expand_like(torch.from_numpy(v), tx).shape == (3, 1, 1, 1)
    np.testing.assert_array_equal(
        misc.expand_like(torch.from_numpy(v), tx).numpy(),
        np.asarray(jmisc.expand_like(jnp.asarray(v), jnp.asarray(x))))
    np.testing.assert_allclose(misc.logit_transform(tx).numpy(),
                               np.asarray(jmisc.logit_transform(
                                   jnp.asarray(x))), **TOL)
    for centered in (True, False):
        np.testing.assert_array_equal(
            misc.inverse_data_scaler(centered)(tx).numpy(),
            np.asarray(jmisc.inverse_data_scaler(centered)(jnp.asarray(x))))
    img = _np(rs.randn(12, 10) * 3)
    out, lo, hi = misc.normalize(torch.from_numpy(img), return_q=True)
    jout, jlo, jhi = jmisc.normalize(jnp.asarray(img), return_q=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose([lo.item(), hi.item()],
                               [float(jlo), float(jhi)], **TOL)
    np.testing.assert_allclose(
        misc.normalize(torch.from_numpy(img), 0.1, 0.7).numpy(),
        np.asarray(jmisc.normalize(jnp.asarray(img), 0.1, 0.7)), **TOL)
    with pytest.raises(ValueError):
        misc.normalize(torch.from_numpy(img), 0.8, 0.2)
    np.testing.assert_allclose(
        misc.denormalize(torch.from_numpy(img), -1.0, 1.0).numpy(),
        np.asarray(jmisc.denormalize(jnp.asarray(img), -1.0, 1.0)), **TOL)
    phase = _np(rs.rand(4, 4) * 6.2)
    np.testing.assert_allclose(
        misc.normalize_phase(torch.from_numpy(phase)).numpy(),
        np.asarray(jmisc.normalize_phase(jnp.asarray(phase))), **TOL)
    z = (rs.randn(5, 5) + 1j * rs.randn(5, 5)).astype(np.complex64)
    for norm in (False, True):
        np.testing.assert_allclose(
            misc.compute_angle(torch.from_numpy(z), norm),
            jmisc.compute_angle(jnp.asarray(z), norm), **TOL)


@pytest.mark.parametrize("data", [
    dict(rescaled=True), dict(logit_transform=True), dict(),
    dict(rescaled=True, mean=True)],
    ids=["rescaled", "logit", "identity", "image_mean"])
def test_data_transform_deterministic_branches_equal_jax(data):
    x = _np(np.random.RandomState(1).rand(2, 4, 4, 1) * 0.9 + 0.05)
    with_mean = data.pop("mean", False)
    cfg = _data_config(**data)
    if with_mean:
        cfg["image_mean"] = _np(np.linspace(0, 0.5, 16).reshape(4, 4, 1))
    ref = jmisc.data_transform(JConfig(cfg), jnp.asarray(x))
    out = misc.data_transform(Config(cfg), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_data_transform_dequantization_draws_from_the_generator():
    """The uniform and Gaussian draws come from the given generator: the
    same seed gives the same output; the uniform one adds [0, 1/256) to
    X 255 / 256, as JAX's does."""
    x = torch.from_numpy(_np(np.random.RandomState(2).rand(64, 8)))
    uni = Config(_data_config(uniform_dequantization=True))
    a = misc.data_transform(uni, x, torch.Generator().manual_seed(3))
    b = misc.data_transform(uni, x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    d = a - x / 256.0 * 255.0
    assert d.min() >= 0 and d.max() < 1 / 256 and d.std() > 1e-4
    gauss = Config(_data_config(gaussian_dequantization=True))
    g = misc.data_transform(gauss, x, torch.Generator().manual_seed(4)) - x
    assert abs(g.std().item() - 0.01) < 2e-3
    jref = jmisc.data_transform(JConfig(_data_config(
        uniform_dequantization=True)), jnp.asarray(x.numpy()),
        jax.random.PRNGKey(0))
    jd = np.asarray(jref) - x.numpy() / 256.0 * 255.0
    assert jd.min() >= -1e-7 and jd.max() < 1 / 256


# -- utils/dataset_stats ------------------------------------------------------

def test_dataset_stats_equal_jax():
    rs = np.random.RandomState(3)
    data = _np(rs.randn(40, 6, 5))
    for kw in (dict(), dict(max_samples=16, seed=2)):
        np.testing.assert_allclose(
            dataset_stats.max_pairwise_distance(data, **kw),
            jstats.max_pairwise_distance(data, **kw), **TOL)
        np.testing.assert_allclose(dataset_stats.suggest_sigma_max(data, **kw),
                                   jstats.suggest_sigma_max(data, **kw),
                                   **TOL)
    for tfm in ("TV", "norm"):
        for normalized in (True, False):
            vals, (hist, edges) = dataset_stats.norm_histogram(
                data, tfm=tfm, bins=7, normalized=normalized)
            jvals, (jhist, jedges) = jstats.norm_histogram(
                data, tfm=tfm, bins=7, normalized=normalized)
            np.testing.assert_array_equal(vals, jvals)
            np.testing.assert_array_equal(hist, jhist)
            np.testing.assert_array_equal(edges, jedges)
    with pytest.raises(KeyError):
        dataset_stats.norm_histogram(data, tfm="L1")
    vals, (hist, edges) = dataset_stats.tv_norm_histogram(data, bins=9)
    jvals, (jhist, jedges) = jstats.tv_norm_histogram(data, bins=9)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(hist, jhist)
    for th in (edges[3], float(np.median(vals)), edges[-1] + 1):
        assert dataset_stats.count_samples(hist, edges, th) == \
            jstats.count_samples(jhist, jedges, th)


# -- utils/visualizations: numbers --------------------------------------------

def _run_dir(tmp_path, name, frames=None):
    """A run directory as scripts/_common.save_artifacts writes it: 4
    complex reconstructions near a phantom, its original, ZF, args."""
    rs = np.random.RandomState(4)
    shape = (16, 16, 1) if frames is None else (frames, 16, 16, 1)
    truth = _np(rs.rand(*shape))
    recons = (truth[None] + 0.1 * rs.randn(4, *shape)
              + 0.05j * rs.randn(4, *shape)).astype(np.complex64)
    path = tmp_path / name
    path.mkdir()
    np.save(path / "original.npy", truth[None].astype(np.complex64))
    np.save(path / "reconstructions.npy", recons)
    np.save(path / "ZF.npy", (truth[None] * 0.7).astype(np.complex64))
    with open(path / "args.json", "w") as f:
        json.dump({"lamda": float(len(name)), "R": 8 if "b" in name else 4},
                  f)
    return str(path)


@pytest.mark.parametrize("frames", [None, 3], ids=["image", "2d_time"])
def test_numeric_visualization_helpers_equal_jax(tmp_path, frames):
    run_dir = _run_dir(tmp_path, "run", frames)
    run, jrun = vis.load_run(run_dir), jvis.load_run(run_dir)
    assert sorted(run) == sorted(jrun) and run["args"] == jrun["args"]
    for a, b in zip(vis.ensemble_stats(run["reconstructions"]),
                    jvis.ensemble_stats(jrun["reconstructions"])):
        np.testing.assert_array_equal(a, b)
    truth = np.abs(run["original"][0])
    mag = np.abs(run["reconstructions"][0])
    np.testing.assert_allclose(vis._ssim_nd(mag, truth),
                               jvis._ssim_nd(mag, truth), rtol=1e-5)
    with pytest.raises(ValueError):
        vis._ssim_nd(mag, truth[..., :8, :])
    rows = vis.per_sample_metrics(run["reconstructions"], run["original"])
    jrows = jvis.per_sample_metrics(jrun["reconstructions"],
                                    jrun["original"])
    assert sorted(rows) == sorted(jrows)
    for key in rows:
        np.testing.assert_allclose(rows[key], jrows[key], rtol=1e-5)


# -- utils/visualizations: figures --------------------------------------------

def _drawings(tmp_path, mod, tag):
    """Every drawing function of `mod` once; returns {file: (size,
    frames)}, and the sample grid's and the sweep's numbers."""
    out = tmp_path / tag
    out.mkdir()
    rs = np.random.RandomState(5)
    runs = [_run_dir(out, n) for n in ("a", "bb", "ccc")]
    files = {}
    grid, metrics = mod.create_sample_grid_plot(runs[0])
    files["sample_grid.png"] = grid
    points = mod.metric_vs_hyperparam(runs, ["lamda", "R"],
                                      save_path=str(out / "sweep2.png"))
    files["sweep2.png"] = str(out / "sweep2.png")
    mod.metric_vs_one_hyperparam(runs, "lamda",
                                 save_path=str(out / "sweep1.png"))
    files["sweep1.png"] = str(out / "sweep1.png")
    vol = rs.rand(7, 12, 12, 1) + 0.2j
    for name, call in (
            ("temporal.png", lambda p: mod.grid_of_temporal_samples(
                vol, num_frames=4, save_path=p)),
            ("vol.gif", lambda p: mod.save_vol_as_gif(vol, p)),
            ("signals.png", lambda p: mod.vis_signals(
                rs.randn(24), rs.randn(24, 3), titles=["a", "b"],
                save_path=p)),
            ("channels.png", lambda p: mod.vis_multi_channel_signal(
                rs.randn(24, 6), ncols=4, save_path=p)),
            ("tensor.png", lambda p: mod.vis_tensor(vol, save_path=p)),
            ("images.png", lambda p: mod.vis_images(
                vol[0], vol[1], titles=["x", "y"], save_path=p))):
        assert call(str(out / name)) == str(out / name)
        files[name] = str(out / name)
    with open(os.path.join(runs[0], "metrics.txt")) as f:
        text = f.read()
    return {k: _png(v) for k, v in files.items()}, metrics, points, text


def test_drawing_functions_write_the_jax_files(tmp_path):
    ours, metrics, points, text = _drawings(tmp_path, vis, "port")
    ref, jmetrics, jpoints, jtext = _drawings(tmp_path, jvis, "jax")
    assert ours == ref
    assert ours["vol.gif"][1] == 7 and ours["temporal.png"][0] == (960, 264)
    for key in metrics:
        np.testing.assert_allclose(metrics[key], jmetrics[key], rtol=1e-5)
    assert [c for c, _ in points] == [c for c, _ in jpoints]
    np.testing.assert_allclose([v for _, v in points],
                               [v for _, v in jpoints], rtol=1e-5)
    assert text.split(":")[0] == jtext.split(":")[0] == "NRMSE"


def test_drawing_is_the_only_importer_of_matplotlib_and_pillow():
    """Importing every module of the port loads neither matplotlib nor
    Pillow (a fresh interpreter); a drawing call then loads matplotlib."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import inverseproblemwithdiffusionmodel_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'PIL')]\n"
        "assert not bad, bad[:5]\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.utils import "
        "visualizations as v\n"
        "import numpy as np, tempfile, os\n"
        "v.vis_images(np.ones((4, 4)), save_path=os.path.join("
        "tempfile.mkdtemp(), 'a.png'))\n"
        "assert 'matplotlib' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT))


# -- training/callbacks -------------------------------------------------------

TINY = {"data": {"channels": 1, "image_size": 16, "logit_transform": False,
                 "rescaled": False},
        "model": {"ngf": 8, "nonlinearity": "elu",
                  "normalization": "InstanceNorm++", "sigma_begin": 1.0,
                  "sigma_end": 0.1, "num_classes": 3,
                  "sigma_dist": "geometric"}}
SIGMAS = np.array([1.0, 0.3, 0.1], np.float32)


def _adam(params):
    return Optimizer(params, torch.optim.Adam)


@pytest.fixture(scope="module")
def ncsnv2():
    module = JaxNCSNv2(config=JConfig(TINY))
    params = init_flax(module, jnp.zeros((1, 16, 16, 1)), jnp.ones((1,)))
    model = NCSNv2(Config(TINY))
    model.load_state_dict(flax_to_torch_ncsnv2(params, Config(TINY),
                                               "ncsnv2"))
    return module, params, model


def test_ald_visualization_hook_writes_the_jax_png(tmp_path, ncsnv2):
    module, params, model = ncsnv2
    jstate = JTrainState.create(params, optax.adam(1e-3))
    jhook = jcallbacks.make_ald_visualization_hook(
        module, jnp.asarray(SIGMAS), (2, 16, 16, 1), str(tmp_path / "jax"),
        every_n_epochs=2, n_steps_each=1, step_lr=1e-5)
    state = TrainState.create(model, _adam, ema_decay=0.9)
    hook = callbacks.make_ald_visualization_hook(
        model, SIGMAS, (2, 16, 16, 1), str(tmp_path / "port"),
        every_n_epochs=2, n_steps_each=1, step_lr=1e-5)
    for epoch in (0, 1):
        jhook(jstate, epoch)
        hook(state, epoch)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "samples_epoch0001.png"]
    assert _png(tmp_path / "port" / names[0]) == _png(
        tmp_path / "jax" / names[0])
    assert model.training                     # the hook restores the mode


@pytest.mark.parametrize("temporal", [False, True])
def test_snapshot_hook_writes_the_jax_files(tmp_path, temporal):
    """Same level, sigma and state in both hooks: the magnitude .npy
    files equal, the log lines equal, the PNGs of the same sizes."""
    rs = np.random.RandomState(6)
    shape = (2, 4, 12, 12, 1) if temporal else (2, 12, 12, 1)
    re, im = _np(rs.randn(*shape)), _np(rs.randn(*shape))
    jhook = jcallbacks.make_snapshot_hook(str(tmp_path / "jax"),
                                          temporal=temporal)
    hook = callbacks.make_snapshot_hook(str(tmp_path / "port"),
                                        temporal=temporal)
    for level, sigma in ((0, 3.0), (4, 0.25)):
        jhook(level, np.float32(sigma), re, im)
        hook(level, sigma, torch.from_numpy(re), torch.from_numpy(im))
    one = callbacks.make_snapshot_hook(str(tmp_path / "port1"),
                                       prefix="one", save_png=False)
    one(1, 0.5, torch.from_numpy(re))
    np.testing.assert_array_equal(
        np.load(tmp_path / "port1" / "one_level00001.npy"), np.abs(re))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert ("snap_level00004_temporal.png" in names) == temporal
    for name in names:
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        elif name.endswith(".png"):
            assert _png(a) == _png(b)
        else:
            assert a.read_text() == b.read_text()


def test_pc_visualization_hook_writes_the_jax_png(tmp_path):
    """A tiny ScoreNet under the VE SDE (3 scales), the same converted
    weights in both packages."""
    jsde, sde = JaxVESDE(sigma_max=5.0, N=3), VESDE(sigma_max=5.0, N=3)
    jstd = lambda t: jsde.marginal_prob(jnp.zeros((t.shape[0], 1)), t)[1]
    std = lambda t: sde.marginal_prob(torch.zeros(t.shape[0], 1), t)[1]
    jmod = JaxScoreNet(marginal_prob_std=jstd, channels=(4, 8, 16, 32),
                       embed_dim=16)
    params = flax_params(jmod, jnp.zeros((1, 16, 16, 1)), jnp.ones((1,)))
    model = ScoreNet(std, (4, 8, 16, 32), 16)
    model.load_state_dict(flax_to_torch_scorenet(params), strict=True)
    jhook = jcallbacks.make_pc_visualization_hook(
        jmod, jsde, (2, 16, 16, 1), str(tmp_path / "jax"))
    hook = callbacks.make_pc_visualization_hook(
        model, sde, (2, 16, 16, 1), str(tmp_path / "port"))
    jhook(JTrainState.create(params, optax.adam(1e-3)), 0)
    hook(TrainState.create(model, _adam, ema_decay=None), 0)
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == [
        "pc_samples_epoch0000.png"]
    name = "pc_samples_epoch0000.png"
    assert _png(tmp_path / "port" / name) == _png(tmp_path / "jax" / name)


# -- data.vol2slice and scripts/vol2slices -------------------------------------

def test_vol2slice_writes_the_jax_files(tmp_path):
    rs = np.random.RandomState(7)
    root = tmp_path / "vols"
    root.mkdir()
    for name, slices in (("patient001", 3), ("patient002", 2)):
        np.savez(root / f"{name}.npz",
                 **{k: _np(rs.rand(1, slices, 6, 5)) for k in (
                     "image", "multiClassMasks", "PD", "T1", "T2")})
    jwritten = jdatasets.vol2slice(str(root), str(tmp_path / "jax"))
    written = datasets.vol2slice(str(root), str(tmp_path / "port"))
    assert sorted(map(os.path.basename, written)) == sorted(
        map(os.path.basename, jwritten))
    assert len(written) == 5
    for path in written:
        with np.load(path) as a, np.load(
                tmp_path / "jax" / os.path.basename(path)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    again = vol2slices.main(["--root_dir", str(root), "--save_dir",
                             str(tmp_path / "cli")])
    assert sorted(os.listdir(tmp_path / "cli")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert len(again) == 5


# -- utils/profiling -----------------------------------------------------------

def test_timed_and_trace_on_the_cpu(tmp_path):
    """timed: the JAX form's keys and warm-up / iteration counts, the last
    result, host-clock times on the CPU; trace writes a Chrome trace that
    holds the annotated region."""
    calls = []

    def fn(a, b=1.0):
        calls.append(1)
        return torch.full((3,), a + b)

    out = profiling.timed(fn, 2.0, b=3.0, warmup=2, iters=4)
    jout = jprofiling.timed(lambda a, b=1.0: jnp.full((3,), a + b), 2.0,
                            b=3.0, warmup=2, iters=4)
    assert sorted(out) == sorted(jout)
    assert len(calls) == 1 + 1 + 4
    np.testing.assert_array_equal(out["result"].numpy(),
                                  np.asarray(jout["result"]))
    assert 0 < out["best_s"] <= out["mean_s"] and out["compile_s"] > 0
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("score_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "score_step" for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "score_step" in f.read()
