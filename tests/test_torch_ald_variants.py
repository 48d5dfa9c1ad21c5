"""The port's ALD variants (samplers/ald_variants: inpainting,
interpolation, class-conditioned, the inverse problem and its projection
form, the two classifier-guided inverse samplers) and the MNIST guided
CLIs (mnist_inv_clf_sampling, mnist_inv_clf_prox_sampling, mnist_MAP)
against the JAX package's, each fed JAX's start and noise: the test
replays JAX's key schedule with jax.random and hands the draws to the
port's `noise(shape)` hook in the order JAX splits its key.

Tolerances, float32:
- the seven samplers at rtol 1e-5 on the analytic scores of
  tests/test_ald_variants.py (a Gaussian's score and a small tanh
  classifier; exact up to rounding);
- at rel L2 1e-4 with a tiny NCSNv2Deepest (16 px, ngf 8) and the
  full-width ResNetClf over a 2-level ladder (the nets' float32 sums in
  another order, through a few Langevin steps), and the two guided CLIs
  against the JAX scripts at tests/test_scripts.py's geometry (16 px, ngf
  8, 6 levels) on the same weights, their step_lr cut to 1e-7 so that the
  random nets' chains stay of order one;
- mnist_MAP: its ascent direction at each of JAX's iterates at rel L2
  1e-5 and the whole run's iterates as tests/test_torch_map_tv.py holds
  them (Adam at b1 = b2 = 0.5 is nearly sign descent).
"""
import contextlib
import io
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu import samplers as jsamplers
from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config, load_general_config as jax_general)
from inverseproblemwithdiffusionmodel_tpu.models.classifier import (
    ResNetClf as JaxResNetClf)
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    TASK_NAME_TO_MODEL_CTOR as JAX_TASKS, _example_input,
    make_score_fn as jax_make_score_fn)
from inverseproblemwithdiffusionmodel_tpu.operators import (
    RandomUndersamplingFourier as JaxRUF, SingleCoil as JaxSingleCoil,
    Constrained as JaxConstrained, SkipLines as JaxSkipLines)
from inverseproblemwithdiffusionmodel_tpu.scripts import (
    mnist_MAP as jax_map_script,
    mnist_inv_clf_prox_sampling as jax_prox_script,
    mnist_inv_clf_sampling as jax_clf_script)
from inverseproblemwithdiffusionmodel_tpu.utils.misc import (
    stack_parts as jax_stack_parts)
from inverseproblemwithdiffusionmodel_tpu_torch import samplers
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
    Constrained, RandomUndersamplingFourier, SingleCoil, SkipLines)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald_variants
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import ALDConfig
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
    mnist_MAP, mnist_inv_clf_prox_sampling, mnist_inv_clf_sampling)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch, flax_to_torch_clf)
from tests.test_torch_ald_pair import replay
from tests.test_torch_guidance import draw_clf
from tests.test_torch_map_tv import (DIR_REL, FLIP_SHARE, ITER_REL, parts,
                                     probe, recorder)  # noqa: F401
from tests.test_torch_ncsnv2 import init_flax
from tests.test_torch_sense_recon import _flags, _paths

torch.set_num_threads(2)

H = W = 16
NAMES = ("inpainting", "interpolation", "cls_conditioned", "inverse_problem",
         "inverse_problem_proj", "inverse_clf", "inverse_clf_proximal")


def rel_l2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm((a - b).ravel())
                 / np.linalg.norm(b.ravel()))


def normals(key, n_steps, shapes):
    """The draws of n_steps inner steps that each split the key into
    1 + len(shapes) and draw one normal of each shape, in order."""
    draws = []
    for _ in range(n_steps):
        key, *ks = jax.random.split(key, 1 + len(shapes))
        draws += [np.asarray(jax.random.normal(k, s))
                  for k, s in zip(ks, shapes)]
    return draws


def uniform_start(key, shape):
    """(the key after the start's split, the U(0, 1) start)."""
    key, k_init = jax.random.split(key)
    return key, np.asarray(jax.random.uniform(k_init, shape))


# -- the problems --------------------------------------------------------------

def target(batch=1):
    yy, xx = np.mgrid[0:H, 0:W]
    t = np.exp(-(((yy - 8) ** 2 + (xx - 6) ** 2) / 20.0))
    return np.tile(t[None, :, :, None], (batch, 1, 1, 1)).astype(np.float32)


def analytic(sigmas, batch):
    """(JAX score, port score, JAX clf, port clf) of the analytic test
    problem: the score of N(target, sigma^2) (the target interleaved with
    zeros for an [Re, Im] batch), a tanh linear classifier of 3 classes."""
    x_t = target(batch)
    stacked = np.asarray(jax_stack_parts(jnp.asarray(x_t),
                                         jnp.zeros_like(x_t)))
    w = 0.1 * np.random.RandomState(0).randn(H * W, 3).astype(np.float32)
    sig_j, sig_t = jnp.asarray(sigmas), torch.from_numpy(sigmas)

    def pick(x):
        return stacked if x.shape[0] == 2 * batch else x_t[:1]

    def jscore(x, labels):
        s = sig_j[labels].reshape(-1, 1, 1, 1)
        return (jnp.asarray(pick(x)) - x) / s ** 2

    def tscore(x, labels):
        s = sig_t[labels].reshape(-1, 1, 1, 1)
        return (torch.from_numpy(pick(x)) - x) / s ** 2

    jclf = lambda x: jnp.tanh(x.reshape(x.shape[0], -1) @ jnp.asarray(w))
    tclf = lambda x: torch.tanh(x.reshape(x.shape[0], -1)
                                @ torch.from_numpy(w))
    return jscore, tscore, jclf, tclf


def fourier_ops():
    args = (8, 0.1, (H, W, 1))
    return (JaxRUF.create(*args, seed=0, num_frames=1),
            RandomUndersamplingFourier.create(*args, seed=0, num_frames=1))


def run_both(name, jscore, tscore, jclf, tclf, sigmas, cfg, batch, ops,
             seed=0, **kw):
    """(JAX's output, the port's output fed JAX's start and draws) of the
    sampler `name` on one problem; `ops` = (JAX op, port op, JAX
    proximal, port proximal, measurement)."""
    jop, top, jprox, tprox, y = ops
    key = jax.random.PRNGKey(seed)
    n = len(sigmas) * cfg["n_steps_each"]
    jcfg = jsamplers.ALDConfig(**cfg)
    tcfg = ALDConfig(**cfg)
    sig = jnp.asarray(sigmas)
    shape = (batch, H, W, 1)
    cls = np.arange(batch) % 3
    port = dict(config=tcfg, device="cpu")
    if name == "inpainting":
        refer, mask = target(batch), np.asarray(jsamplers.half_mask(shape))
        ref = jsamplers.ald_inpainting(jscore, sig, jnp.asarray(refer),
                                       jnp.asarray(mask), key, jcfg)
        key, x0 = uniform_start(key, shape)
        draws = normals(key, n, [shape, shape])
        out = ald_variants.ald_inpainting(
            tscore, sigmas, torch.from_numpy(refer), torch.from_numpy(mask),
            x_init=torch.from_numpy(x0), noise=replay(draws), **port)
    elif name == "interpolation":
        x_init = target(batch) + 0.1
        k = kw.get("n_interpolations", 3)
        ref = jsamplers.ald_interpolation(jscore, sig, jnp.asarray(x_init),
                                          k, key, jcfg)
        draws = normals(key, n, [shape, shape])
        out = ald_variants.ald_interpolation(
            tscore, sigmas, torch.from_numpy(x_init), k,
            noise=replay(draws), **port)
    elif name == "cls_conditioned":
        ref = jsamplers.ald_cls_conditioned(
            jscore, jclf, jnp.asarray(cls), sig, shape, key, jcfg)
        key, x0 = uniform_start(key, shape)
        draws = normals(key, n, [shape])
        out = ald_variants.ald_cls_conditioned(
            tscore, tclf, torch.from_numpy(cls), sigmas, shape,
            x_init=torch.from_numpy(x0), noise=replay(draws), **port)
    elif name == "inverse_problem":
        ref = jsamplers.ald_inverse_problem(jscore, sig, jnp.asarray(y), jop,
                                            0.7, key, jcfg)
        key, x0 = uniform_start(key, shape)
        draws = normals(key, n, [shape])
        out = ald_variants.ald_inverse_problem(
            tscore, sigmas, torch.from_numpy(y), top, 0.7,
            x_init=torch.from_numpy(x0), noise=replay(draws), **port)
    elif name == "inverse_problem_proj":
        lamdas = np.linspace(0.3, 0.9, len(sigmas)).astype(np.float32)
        ref = jsamplers.ald_inverse_problem_proj(
            jscore, sig, jnp.asarray(y), jop, jnp.asarray(lamdas), key, jcfg)
        key, x0 = uniform_start(key, shape)
        draws = normals(key, n, [shape, shape])
        out = ald_variants.ald_inverse_problem_proj(
            tscore, sigmas, torch.from_numpy(y), top, lamdas,
            x_init=torch.from_numpy(x0), noise=replay(draws), **port)
    elif name == "inverse_clf":
        ref = jsamplers.ald_inverse_clf(
            jscore, jclf, jnp.asarray(cls), sig, jnp.asarray(y), jop, 0.5,
            key, jcfg, clf_lamda=2.0)
        draws = normals(jax.random.fold_in(key, 0), n, [shape])
        out = ald_variants.ald_inverse_clf(
            tscore, tclf, torch.from_numpy(cls), sigmas, torch.from_numpy(y),
            top, 0.5, clf_lamda=2.0, noise=replay(draws), **port)
    else:
        ramp = dict(clf_start_time=kw.get("clf_start_time"))
        ref = jsamplers.ald_inverse_clf_proximal(
            jscore, jclf, jnp.asarray(cls), sig, jnp.asarray(y), jop, jprox,
            key, jcfg, lr_scaled=kw.get("lr_scaled", 100.0), clf_lamda=2.0,
            **ramp)
        draws = normals(key, n, [shape, shape])
        out = ald_variants.ald_inverse_clf_proximal(
            tscore, tclf, torch.from_numpy(cls), sigmas, torch.from_numpy(y),
            top, tprox, lr_scaled=kw.get("lr_scaled", 100.0), clf_lamda=2.0,
            noise=replay(draws), **ramp, **port)
    return np.asarray(ref), out.numpy()


SIGMAS = np.exp(np.linspace(np.log(1.0), np.log(0.01), 8)).astype(np.float32)
CFG = dict(n_steps_each=2, step_lr=3e-5)


@pytest.mark.parametrize("name,kw", [(n, {}) for n in NAMES] + [
    ("inverse_clf_proximal", {"clf_start_time": 0.5}),
    ("inverse_clf_proximal", {"clf_start_time": 0.25, "prox": "constrained",
                              "lr_scaled": 3e3})],
    ids=list(NAMES) + ["inverse_clf_proximal-ramp",
                       "inverse_clf_proximal-constrained"])
def test_sampler_matches_jax_on_analytic_scores(name, kw):
    batch = 2
    jscore, tscore, jclf, tclf = analytic(SIGMAS, batch)
    jop, top = fourier_ops()
    z = target(batch) * np.exp(1j * 0.3).astype(np.complex64)
    y = np.asarray(jop(jnp.asarray(z.astype(np.complex64))))
    if kw.pop("prox", None) == "constrained":
        proxes = JaxConstrained(lin_tfm=jop), Constrained(lin_tfm=top)
    else:
        proxes = JaxSingleCoil(lin_tfm=jop), SingleCoil(lin_tfm=top)
    ref, out = run_both(name, jscore, tscore, jclf, tclf, SIGMAS, CFG, batch,
                        (jop, top, *proxes, y), **kw)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.isfinite(out).all() and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_normalized_mixing_uses_the_global_norms():
    """Two chains whose score norms differ by 10x: the likelihood gradient
    is scaled by norms over the whole batch, so splitting the batch
    changes the result (as in JAX), and the port agrees with JAX on it."""
    jop, top = fourier_ops()
    y = np.asarray(jop(jnp.asarray(target(2).astype(np.complex64))))
    sig = np.array([0.5], np.float32)
    scale = np.array([1.0, 10.0], np.float32).reshape(2, 1, 1, 1)
    jscore = lambda x, c: -x * jnp.asarray(scale)
    tscore = lambda x, c: -x * torch.from_numpy(scale)
    cfg = dict(n_steps_each=1, step_lr=1e-3, denoise=False)
    ref, out = run_both("inverse_problem", jscore, tscore, None, None, sig,
                        cfg, 2, (jop, top, None, None, y))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    x0 = uniform_start(jax.random.PRNGKey(0), (2, H, W, 1))[1]
    single = ald_variants.ald_inverse_problem(
        lambda x, c: -x * torch.from_numpy(scale[:1]), sig,
        torch.from_numpy(y[:1]), top, 0.7, config=ALDConfig(**cfg),
        x_init=torch.from_numpy(x0[:1]),
        noise=lambda s: torch.zeros(tuple(s)), device="cpu")
    pair = ald_variants.ald_inverse_problem(
        tscore, sig, torch.from_numpy(y), top, 0.7, config=ALDConfig(**cfg),
        x_init=torch.from_numpy(x0), noise=lambda s: torch.zeros(tuple(s)),
        device="cpu")
    assert not torch.allclose(single[0], pair[0], rtol=1e-3)


def test_half_mask_and_the_draws_of_a_seed():
    np.testing.assert_array_equal(
        ald_variants.half_mask((2, 4, 6, 1)).numpy(),
        np.asarray(jsamplers.half_mask((2, 4, 6, 1))))
    np.testing.assert_array_equal(
        ald_variants.half_mask((3, 5), axis=0).numpy(),
        np.asarray(jsamplers.half_mask((3, 5), axis=0)))
    _, tscore, _, tclf = analytic(SIGMAS[:2], 1)
    cfg = ALDConfig(n_steps_each=1, step_lr=3e-5)
    run = lambda **kw: ald_variants.ald_cls_conditioned(
        tscore, tclf, torch.tensor([1]), SIGMAS[:2], (1, H, W, 1),
        config=cfg, device="cpu", **kw)
    assert torch.equal(run(seed=4), run(seed=4))
    gen = torch.Generator().manual_seed(4)
    x0 = torch.rand((1, H, W, 1), generator=gen)
    assert torch.equal(run(seed=4), run(
        x_init=x0, noise=lambda s: torch.randn(tuple(s), generator=gen)))
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            ald_variants.ald_cls_conditioned(tscore, tclf, torch.tensor([1]),
                                             SIGMAS[:2], (1, H, W, 1))


def test_samplers_export_what_jax_exports():
    for name in ("ald_inpainting", "half_mask", "ald_interpolation",
                 "ald_cls_conditioned", "ald_inverse_problem",
                 "ald_inverse_problem_proj", "ald_inverse_clf",
                 "ald_inverse_clf_proximal"):
        assert hasattr(jsamplers, name) and hasattr(samplers, name), name


# -- with nets: a tiny NCSNv2Deepest and the full-width ResNetClf ------------

TINY = {"data.image_size": H, "model.ngf": 8, "model.num_classes": 6,
        "recons.num_classes": 6}


@pytest.fixture(scope="module")
def nets():
    """The tiny NCSNv2Deepest and the ResNetClf in both packages, one set
    of weights each."""
    jcfg = jax_load_config("MNIST", **TINY)
    cfg = load_config("MNIST", **TINY)
    jscore_net = JAX_TASKS["Diffusion"](jcfg)
    sparams = init_flax(jscore_net, _example_input(jcfg, "Diffusion"),
                        jnp.ones((1,)), seed=2)
    jclf_net = JaxResNetClf(config=jax_general())
    shapes = jax.eval_shape(jclf_net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, H, W, 1)))
    cparams = draw_clf(shapes["params"], np.random.RandomState(3))

    def port_score_net():
        model = registry.TASK_NAME_TO_MODEL_CTOR["Diffusion"](cfg)
        model.load_state_dict(flax_to_torch(sparams), strict=True)
        return model.eval()

    def port_clf():
        model = registry.build_clf(in_channels=1)
        model.load_state_dict(flax_to_torch_clf(cparams), strict=True)
        return model.eval().requires_grad_(False)

    def jax_reload(config, task_name, ckpt_dir=None):
        if task_name == "Clf":
            return jclf_net, cparams
        return JAX_TASKS[task_name](config), sparams

    def port_reload(config, task_name, ckpt_dir=None):
        net = port_clf() if task_name == "Clf" else port_score_net()
        return net, None

    return dict(jscore_net=jscore_net, sparams=sparams, jclf_net=jclf_net,
                cparams=cparams, score_net=port_score_net(), clf=port_clf(),
                jax_reload=jax_reload, port_reload=port_reload)


@pytest.mark.parametrize("name", ["inpainting", "interpolation",
                                  "cls_conditioned", "inverse_problem",
                                  "inverse_problem_proj"])
def test_sampler_matches_jax_with_nets(nets, name):
    """The samplers the CLIs below do not run, on the nets over a 2-level
    ladder (the MNIST ladder's ends, 50 and 0.01, would throw the random
    nets' chains far; 1.0 to 0.05 keeps them of order one)."""
    sigmas = np.array([1.0, 0.05], np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, nets["sparams"])
    jscore = jax_make_score_fn(nets["jscore_net"], params,
                               jnp.asarray(sigmas))
    tscore = registry.make_score_fn(nets["score_net"], sigmas)
    cparams = jax.tree_util.tree_map(jnp.asarray, nets["cparams"])
    jclf = lambda x: nets["jclf_net"].apply({"params": cparams}, x)
    tclf = registry.make_clf_fn(nets["clf"])
    jop = JaxSkipLines(num_skip_lines=2, height=H)
    top = SkipLines(num_skip_lines=2, height=H)
    y = np.asarray(jop(jnp.asarray(target(2).astype(np.complex64))))
    cfg = dict(n_steps_each=2, step_lr=1e-5)
    ref, out = run_both(name, jscore, tscore, jclf, tclf, sigmas, cfg, 2,
                        (jop, top, None, None, y), seed=5)
    assert np.isfinite(out).all() and np.abs(ref).max() > 1e-2
    assert rel_l2(out, ref) <= 1e-4


# -- the MNIST CLIs ------------------------------------------------------------

def _override():
    return [a for k, v in TINY.items() for a in ("--override", f"{k}={v}")]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = main(argv)
    return result, out.getvalue()


@pytest.mark.parametrize("kind", ["clf", "prox"])
def test_guided_cli_matches_the_jax_script(nets, tmp_path, monkeypatch,
                                           kind):
    """Both scripts at tests/test_scripts.py's geometry on the same
    weights, the port fed the JAX script's draws (ald_inverse_clf folds 0
    into PRNGKey(seed); the proximal sampler splits Re, then Im)."""
    jax_script, script, sampler = {
        "clf": (jax_clf_script, mnist_inv_clf_sampling, "ald_inverse_clf"),
        "prox": (jax_prox_script, mnist_inv_clf_prox_sampling,
                 "ald_inverse_clf_proximal")}[kind]
    argv = ["--num_skip_lines", "8", "--cls", "2" if kind == "clf" else "1",
            "--num_samples", "2", "--num_steps_each", "2", "--step_lr",
            "1e-7", "--seed", "3"] + _override()
    monkeypatch.setattr(jax_script, "reload_model", nets["jax_reload"])
    ref, _ = _run(jax_script.main, argv + ["--save_dir",
                                           str(tmp_path / "jax")])
    key = jax.random.PRNGKey(3)
    shapes = [ref.shape] if kind == "clf" else [ref.shape, ref.shape]
    draws = normals(jax.random.fold_in(key, 0) if kind == "clf" else key,
                       6 * 2, shapes)
    inner = getattr(script, sampler)

    def fed(*args, **kwargs):
        assert kwargs["seed"] == 3
        return inner(*args, **dict(kwargs, noise=replay(draws)))

    monkeypatch.setattr(mnist_inv_clf_sampling, "reload_model",
                        nets["port_reload"])
    monkeypatch.setattr(script, sampler, fed)
    ours, text = _run(script.main, argv + ["--device", "cpu", "--save_dir",
                                           str(tmp_path / "port")])
    assert isinstance(ours, np.ndarray) and ours.shape == ref.shape == (
        2, H, W, 1) and ours.dtype == ref.dtype
    assert np.abs(ref).max() > 1e-2 and np.isfinite(ours).all()
    assert rel_l2(ours, ref) <= 1e-4
    assert "NRMSE" in text and "SSIM" in text
    (jrun,) = os.listdir(tmp_path / "jax")
    (run,) = os.listdir(tmp_path / "port")
    assert sorted(os.listdir(tmp_path / "port" / run)) == sorted(
        os.listdir(tmp_path / "jax" / jrun))
    for name in ("original", "measurement", "ZF"):
        np.testing.assert_allclose(
            np.load(tmp_path / "port" / run / f"{name}.npy"),
            np.load(tmp_path / "jax" / jrun / f"{name}.npy"), atol=1e-6)


def test_mnist_map_matches_the_jax_script(nets, tmp_path, monkeypatch,
                                          recorder):
    """The JAX script's Adam records its iterates and directions; the
    port's ascent direction at each of them, and the whole run."""
    argv = ["--num_skip_lines", "8", "--n_iters", "5"] + _override()
    monkeypatch.setattr(jax_map_script, "reload_model", nets["jax_reload"])
    ref, jtext = _run(jax_map_script.main, argv + [
        "--save_dir", str(tmp_path / "jax")])
    monkeypatch.setattr(mnist_MAP, "reload_model", nets["port_reload"])
    port = argv + ["--device", "cpu", "--save_dir", str(tmp_path / "port")]
    with probe(recorder) as seen:
        _run(mnist_MAP.main, port)
    assert len(recorder.points) == len(seen["ascent"]) == 5
    assert rel_l2(seen["x0"], parts(recorder.points[0])) <= DIR_REL
    for a, d in zip(seen["ascent"], recorder.directions):
        assert np.linalg.norm(a) > 0 and rel_l2(a, -parts(d)) <= DIR_REL
    ours, text = _run(mnist_MAP.main, port)
    assert ours.shape == ref.shape == (1, H, W, 1)
    assert ours.dtype == np.complex64 and np.isfinite(ours).all()
    assert rel_l2(parts(ours), parts(ref)) <= ITER_REL
    assert np.mean(np.abs(parts(ours) - parts(ref)) > 1e-3) <= FLIP_SHARE
    assert "MAP inpainting NRMSE" in text and "MAP inpainting NRMSE" in jtext


def test_mnist_measurement_is_image_domain_skiplines(nets, tmp_path,
                                                     monkeypatch):
    """As tests/test_scripts.py checks the JAX script: the saved
    measurement is every 4th row of the original image itself."""
    monkeypatch.setattr(mnist_MAP, "reload_model", nets["port_reload"])
    _run(mnist_MAP.main, ["--device", "cpu", "--save_dir", str(tmp_path),
                          "--n_iters", "2", "--num_skip_lines", "4"]
         + _override())
    (run,) = os.listdir(tmp_path)
    original = np.load(tmp_path / run / "original.npy")
    measurement = np.load(tmp_path / run / "measurement.npy")
    assert measurement.shape == (1, 4, H, 1)
    np.testing.assert_allclose(np.abs(measurement),
                               np.abs(original[:, 0::4]), atol=1e-6)


@pytest.mark.parametrize("name", ["mnist_inv_clf_sampling",
                                  "mnist_inv_clf_prox_sampling",
                                  "mnist_MAP"])
def test_cli_flags_are_the_jax_scripts(name):
    ours, ref = _paths(f"{name}.py")
    assert _flags(ours) == _flags(ref)
