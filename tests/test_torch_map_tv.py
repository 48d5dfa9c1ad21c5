"""The port's MAP and TV baselines against the JAX package's: the
regularizers, the Adam step, map_optimizer on the three complex operators,
map_optimizer_pair and make_stepped_map_pair_optimizer, tv_reconstruction
and its pair form, and the four ACDC scripts (flags, main on the CPU).

Each optimizer runs in both packages on the same weights (the tiny NCSNv2
of tests/test_torch_serving.py, 16 px, ngf 8), operator and measurement.
JAX's Adam is wrapped to record, every iteration, the iterate and the
descent direction it is handed (a debug callback inside the scan); the
port's direction function is then evaluated at JAX's own iterates and
held to JAX's direction at relative L2 DIR_REL (float32 sums in another
order through the FFTs and the net). The whole runs are held apart: with
b1 = b2 = 0.5 Adam's update is nearly lr * sign(g), so a gradient
component whose sign differs between the two float32 computations moves
the iterate 2 lr apart. The iterates after N_ITERS steps hold at relative
L2 ITER_REL, and at most FLIP_SHARE of the elements may lie more than lr
apart (each such element is a sign flip of a near-zero component), room
for one flip in 200 elements. The Adam step itself holds to optax at
ADAM_REL.
"""
import contextlib
import io
import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu import regularizers as jreg
from inverseproblemwithdiffusionmodel_tpu.config import Config as JConfig
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2 as JaxNCSNv2)
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    make_score_fn as jax_make_score_fn)
from inverseproblemwithdiffusionmodel_tpu.operators import fourier as jfourier
from inverseproblemwithdiffusionmodel_tpu.operators import pair as jpair
from inverseproblemwithdiffusionmodel_tpu.samplers import map_opt as jmap
from inverseproblemwithdiffusionmodel_tpu.samplers import (
    map_pair as jmap_pair)
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    sigma_ladder as jax_sigma_ladder)
from inverseproblemwithdiffusionmodel_tpu_torch import regularizers
from inverseproblemwithdiffusionmodel_tpu_torch import samplers
from inverseproblemwithdiffusionmodel_tpu_torch.config import Config
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    make_score_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
    fourier, pair)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import (
    map_opt, map_pair)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
    acdc_MAP, acdc_MAP_keep_center, acdc_SENSE_MAP, acdc_SENSE_TV)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnv2)
from tests.test_torch_ncsnv2 import init_flax
from tests.test_torch_sense_recon import _calls, _flags, _paths
from tests.test_torch_serving import TINY

torch.set_num_threads(1)

H = W = 16
B, COILS, LEVELS = 2, 2, 3
LR, LAMDA, N_ITERS = 1e-3, 0.1, 4
DIR_REL = 1e-5        # the ascent direction at JAX's iterates
ITER_REL = 1e-4       # the iterates after N_ITERS, two independent runs
FLIP_SHARE = 5e-3     # share of elements more than lr apart after N_ITERS
ADAM_REL = 1e-6       # the Adam step against optax
CFG = dict(n_iters=N_ITERS, lr=LR)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def parts(z):
    """A complex array or an (re, im) pair as one real (2, ...) array."""
    if isinstance(z, (tuple, list)):
        return np.stack([np.asarray(v, np.float32) for v in z])
    z = np.asarray(z)
    return np.stack([z.real, z.imag]).astype(np.float32)


@pytest.fixture(scope="module")
def net():
    """The tiny NCSNv2 in both packages on one set of weights, and its
    ladder."""
    module = JaxNCSNv2(config=JConfig(TINY))
    params = init_flax(module, jnp.zeros((1, H, W, 1)), jnp.ones((1,)))
    cfg = Config(TINY)
    model = NCSNv2(cfg).eval()
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg, "ncsnv2"))
    sigmas = jax_sigma_ladder(10.0, 0.1, LEVELS, "geometric")
    return dict(module=module, params=params, model=model, sigmas=sigmas,
                jscore=jax_make_score_fn(module, params, sigmas),
                score=make_score_fn(model, torch.tensor(np.asarray(sigmas))))


def image(seed=0, batch=B):
    rs = np.random.RandomState(seed)
    return (rs.rand(batch, H, W, 1) * np.exp(1j * rs.randn(batch, H, W, 1))
            ).astype(np.complex64)


def operators(kind):
    """(port op, JAX op) of one complex operator, built alike."""
    if kind == "uf":
        return (fourier.UndersamplingFourier.create(2, H),
                jfourier.UndersamplingFourier.create(2, H))
    if kind == "random":
        args = (8, 0.125, (H, W, 1))
        return (fourier.RandomUndersamplingFourier.create(*args, seed=0,
                                                          num_frames=1),
                jfourier.RandomUndersamplingFourier.create(*args, seed=0,
                                                           num_frames=1))
    args = ("exp", COILS, 8, 0.125, (H, W, 1))
    return (fourier.make_sense(*args, seed=0, num_frames=1),
            jfourier.make_sense(*args, seed=0, num_frames=1))


def pair_operators():
    """PairSENSE in both packages on the SENSE operator's mask and maps."""
    op, _ = operators("sense")
    mask, maps = op.base.mask.numpy(), op.sens_maps.numpy()
    return (pair.PairSENSE(mask=torch.tensor(mask),
                           sens_re=torch.tensor(maps.real.copy()),
                           sens_im=torch.tensor(maps.imag.copy())),
            jpair.PairSENSE(mask=jnp.asarray(mask),
                            sens_re=jnp.asarray(maps.real),
                            sens_im=jnp.asarray(maps.imag)))


class Recorder:
    """optax for the JAX samplers' modules: adam() records each
    iteration's iterate and the descent direction handed to it."""

    def __init__(self):
        self.points, self.directions = [], []

    def adam(self, lr, b1, b2):
        inner = optax.adam(lr, b1=b1, b2=b2)

        def update(updates, state, params=None):
            jax.debug.callback(self._keep, params, updates, ordered=True)
            return inner.update(updates, state, params)

        return optax.GradientTransformation(inner.init, update)

    def _keep(self, params, updates):
        self.points.append((np.asarray(params["re"]),
                            np.asarray(params["im"])))
        self.directions.append((np.asarray(updates["re"]),
                                np.asarray(updates["im"])))


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    shim = types.SimpleNamespace(adam=rec.adam,
                                 apply_updates=optax.apply_updates)
    monkeypatch.setattr(jmap, "optax", shim)
    monkeypatch.setattr(jmap_pair, "optax", shim)
    return rec


@contextlib.contextmanager
def probe(rec: Recorder):
    """Inside the block the port's optimizers evaluate their ascent
    direction at each of JAX's recorded iterates instead of running Adam;
    yields {"x0": their start, "ascent": the directions}."""
    seen = {}

    def run(ascent, x0, config):
        seen["x0"] = parts(x0)
        seen["ascent"] = [parts(ascent(*(torch.from_numpy(v) for v in p)))
                          for p in rec.points]
        return x0

    saved = map_opt._run_adam, map_pair._run_adam
    map_opt._run_adam = map_pair._run_adam = run
    try:
        yield seen
    finally:
        map_opt._run_adam, map_pair._run_adam = saved


def check(rec, seen, ours, ref):
    """The port's start and its direction at every JAX iterate (JAX hands
    Adam the negated ascent), then the two whole runs."""
    assert len(rec.points) == len(seen["ascent"]) == N_ITERS
    assert rel_l2(seen["x0"], parts(rec.points[0])) <= DIR_REL
    for k, (a, d) in enumerate(zip(seen["ascent"], rec.directions)):
        assert np.linalg.norm(a) > 0
        assert rel_l2(a, -parts(d)) <= DIR_REL, (k, rel_l2(a, -parts(d)))
    ours, ref = parts(ours), parts(ref)
    assert np.isfinite(ours).all()
    assert rel_l2(ours, ref) <= ITER_REL, rel_l2(ours, ref)
    assert np.mean(np.abs(ours - ref) > LR) <= FLIP_SHARE


# -- regularizers and Adam ----------------------------------------------------

def tv_input(seed):
    """A (B, H, W, 1) complex image of constant 4 x 4 blocks (exactly equal
    neighbours inside each block) with one random column."""
    rs = np.random.RandomState(seed)
    blocks = rs.randn(B, H // 4, W // 4, 1) + 1j * rs.randn(B, H // 4,
                                                            W // 4, 1)
    z = np.kron(blocks, np.ones((1, 4, 4, 1))).astype(np.complex64)
    z[:, :, 5] = (rs.randn(B, H, 1) + 1j * rs.randn(B, H, 1))
    return z


@pytest.mark.parametrize("name", ["tv", "tv_axes", "zero"])
@pytest.mark.parametrize("form", ["complex", "pair"])
def test_regularizers_match_jax_values_and_gradients(name, form):
    """Value and gradient with respect to Re and Im, on an input with
    exactly equal neighbours: the modulus' subgradient there is 0, not
    NaN."""
    z = tv_input(1)
    kw = {"tv": (1.7,), "tv_axes": (0.3, (2, 1)), "zero": ()}[name]
    ctor = (lambda m: m.ZeroReg()) if name == "zero" else (
        lambda m: m.TVRegularizer(*kw))
    jr, pr = ctor(jreg), ctor(regularizers)

    def jloss(re, im):
        out = jr.pair(re, im) if form == "pair" else jr(re + 1j * im)
        return jnp.asarray(out, jnp.float32)

    ref_val, ref_grad = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(z.real), jnp.asarray(z.imag))
    re = torch.tensor(z.real.copy(), requires_grad=True)
    im = torch.tensor(z.imag.copy(), requires_grad=True)
    val = pr.pair(re, im) if form == "pair" else pr(torch.complex(re, im))
    if name == "zero":
        assert float(val) == float(ref_val) == 0.0
        assert form == "complex" or val.shape == ()
        return
    grads = torch.autograd.grad(val, (re, im))
    val = float(val.detach())
    assert abs(val - float(ref_val)) <= 1e-6 * abs(float(ref_val))
    for g, r in zip(grads, ref_grad):
        assert torch.isfinite(g).all()
        assert rel_l2(g.numpy(), r) <= 1e-6
    # zero differences give zero subgradients inside the constant blocks
    assert float(torch.abs(grads[0][:, 1:3, 1:3]).max()) == 0.0


def test_tv_norm_of_a_real_image_and_safe_modulus():
    x = tv_input(2).real.copy()
    ours = map_opt.tv_norm_noncircular(torch.tensor(x), (1, 2))
    ref = jmap.tv_norm_noncircular(jnp.asarray(x), (1, 2))
    assert abs(float(ours) - float(ref)) <= 1e-6 * abs(float(ref))
    sq = torch.tensor([0.0, 4.0, 0.25], requires_grad=True)
    (g,) = torch.autograd.grad(map_opt._safe_modulus(sq).sum(), sq)
    assert g.tolist() == [0.0, 0.25, 1.0]


@pytest.mark.parametrize("betas", [(0.5, 0.5), (0.9, 0.999)])
def test_adam_step_matches_optax(betas):
    """Twelve steps on a fixed sequence of gradients with near-zero and
    large components, against optax.adam(lr, b1, b2) step for step."""
    rs = np.random.RandomState(3)
    shape = (B, H, W, 1)
    grads = [(rs.randn(*shape) * 10.0 ** rs.randint(-9, 2, shape)
              ).astype(np.float32) for _ in range(24)]
    x0 = rs.randn(2, *shape).astype(np.float32)
    config = map_opt.MAPConfig(n_iters=12, lr=LR, b1=betas[0], b2=betas[1])
    opt = optax.adam(LR, b1=betas[0], b2=betas[1])
    jp = {"re": jnp.asarray(x0[0]), "im": jnp.asarray(x0[1])}
    js = opt.init(jp)
    tp = tuple(torch.from_numpy(v.copy()) for v in x0)
    ts = map_opt.adam_init(tp)
    for k in range(12):
        g = {"re": jnp.asarray(grads[2 * k]),
             "im": jnp.asarray(grads[2 * k + 1])}
        u, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = map_opt.adam_step(
            tp, (torch.from_numpy(grads[2 * k]),
                 torch.from_numpy(grads[2 * k + 1])), ts, config)
        assert ts.count == k + 1
        # the displacement from x0, so the bound sees the updates
        moved = parts(tp) - x0
        assert rel_l2(moved, parts((jp["re"], jp["im"])) - x0) <= ADAM_REL
        for ours, ref in ((ts.mu, js[0].mu), (ts.nu, js[0].nu)):
            assert rel_l2(parts(ours), parts((ref["re"], ref["im"]))
                          ) <= ADAM_REL


# -- MAP ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uf", "random", "sense"])
def test_map_optimizer_matches_jax(net, recorder, kind):
    """From a perturbed start (UndersamplingFourier's A A^H = I on the kept
    lines would zero the data gradient at A^H y), the direction at every
    JAX iterate and the whole run."""
    op, jop = operators(kind)
    y = np.asarray(jop(jnp.asarray(image())))
    x_init = (np.asarray(jop.conj_op(jnp.asarray(y)))
              + 0.1 * image(1)).astype(np.complex64)
    data = op.log_lh_grad(torch.from_numpy(x_init), torch.from_numpy(y))
    assert float(torch.abs(data).max()) > 1e-2     # the data term is live
    cfg = jmap.MAPConfig(**CFG)
    ref = jmap.map_optimizer(net["jscore"], jnp.asarray(y), jop, LAMDA, cfg,
                             x_init=jnp.asarray(x_init))
    run = lambda: map_opt.map_optimizer(
        net["score"], torch.from_numpy(y), op, LAMDA,
        map_opt.MAPConfig(**CFG), x_init=torch.from_numpy(x_init),
        device="cpu")
    with probe(recorder) as seen:
        run()
    ours = run()
    assert ours.dtype == torch.complex64 and ours.shape == (B, H, W, 1)
    check(recorder, seen, ours, ref)


def test_map_optimizer_pair_matches_jax(net, recorder):
    op, jop = pair_operators()
    yr, yi = (np.asarray(v) for v in jop(*(jnp.asarray(p) for p in
                                          parts(image()))))
    ref = jmap_pair.map_optimizer_pair(
        net["jscore"], (jnp.asarray(yr), jnp.asarray(yi)), jop, LAMDA,
        jmap.MAPConfig(**CFG))
    y = (torch.from_numpy(yr), torch.from_numpy(yi))
    run = lambda: map_pair.map_optimizer_pair(
        net["score"], y, op, LAMDA, map_opt.MAPConfig(**CFG), device="cpu")
    with probe(recorder) as seen:
        run()
    ours = run()
    check(recorder, seen, ours, ref)
    # the stepped form is the same loop, with lamda a tensor
    stepped = map_pair.make_stepped_map_pair_optimizer(
        net["model"], net["sigmas"], op, map_opt.MAPConfig(**CFG),
        device="cpu")
    for a, b in zip(stepped(net["model"], *y, LAMDA), ours):
        assert torch.equal(a, b)


def test_stepped_map_pair_optimizer_matches_jax(net, recorder):
    """JAX's stepped optimizer (one jitted Adam iteration per host call)
    against the port's: the direction of the port's `step` at every JAX
    iterate, the whole run, and a second lamda through the same set-up."""
    op, jop = pair_operators()
    yr, yi = (np.asarray(v) for v in jop(*(jnp.asarray(p) for p in
                                          parts(image(4)))))
    jrun = jmap_pair.make_stepped_map_pair_optimizer(
        net["module"], net["sigmas"], jop, jmap.MAPConfig(**CFG))
    ref = jrun(net["params"], jnp.asarray(yr), jnp.asarray(yi), LAMDA)
    opt = map_pair.make_stepped_map_pair_optimizer(
        net["model"], net["sigmas"], op, map_opt.MAPConfig(**CFG),
        device="cpu")
    y = (torch.from_numpy(yr), torch.from_numpy(yi))
    lam = torch.tensor(LAMDA)
    score = opt.score_fn(net["model"])
    seen = {"ascent": []}

    def grab(params, grads, state, config):
        seen["ascent"].append(-parts(grads))
        return params, state

    with torch.inference_mode():
        params, state = opt.start(*y)
        seen["x0"] = parts(params)
        saved = map_pair.adam_step
        map_pair.adam_step = grab
        try:
            for p in recorder.points:
                opt.step(score, tuple(torch.from_numpy(v) for v in p),
                         state, *y, lam)
        finally:
            map_pair.adam_step = saved
    check(recorder, seen, opt(net["model"], *y, LAMDA), ref)
    recorder.points.clear()
    recorder.directions.clear()
    ref2 = jrun(net["params"], jnp.asarray(yr), jnp.asarray(yi), 0.5)
    ours2 = opt(net["model"], *y, torch.tensor(0.5))
    assert rel_l2(parts(ours2), parts(ref2)) <= ITER_REL
    assert rel_l2(parts(ours2), parts(ref)) > 10 * ITER_REL


# -- TV -----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["complex", "complex_zero_reg", "pair"])
def test_tv_reconstruction_matches_jax(recorder, case):
    """TV least squares from a start of constant blocks (zero
    differences): the autograd gradient at every JAX iterate and the whole
    run; with ZeroReg, plain least squares through `regularizer=`. After
    one step the blocks' differences are rounding-sized, and their signs
    part between the packages: at the config's lr (1e-3) the runs still
    hold at ITER_REL after N_ITERS steps (5e-2 would part them by 4e-3)."""
    cfg = CFG
    x_init = tv_input(5)
    if case == "pair":
        op, jop = pair_operators()
        y = [np.asarray(v) for v in jop(*(jnp.asarray(p) for p in
                                          parts(image(6))))]
        ref = jmap_pair.tv_reconstruction_pair(
            tuple(jnp.asarray(v) for v in y), jop, 0.05,
            jmap.MAPConfig(**cfg), x_init=tuple(jnp.asarray(v)
                                                for v in parts(x_init)))
        run = lambda: map_pair.tv_reconstruction_pair(
            tuple(torch.from_numpy(v) for v in y), op, 0.05,
            map_opt.MAPConfig(**cfg),
            x_init=tuple(torch.from_numpy(v) for v in parts(x_init)),
            device="cpu")
    else:
        op, jop = operators("sense")
        y = np.asarray(jop(jnp.asarray(image(6))))
        zero = case == "complex_zero_reg"
        ref = jmap.tv_reconstruction(
            jnp.asarray(y), jop, 0.05, jmap.MAPConfig(**cfg),
            x_init=jnp.asarray(x_init),
            regularizer=jreg.ZeroReg() if zero else None)
        run = lambda: map_opt.tv_reconstruction(
            torch.from_numpy(y), op, 0.05, map_opt.MAPConfig(**cfg),
            x_init=torch.from_numpy(x_init),
            regularizer=regularizers.ZeroReg() if zero else None,
            device="cpu")
    with probe(recorder) as seen:
        run()
    ours = run()
    assert rel_l2(seen["x0"], parts(x_init)) == 0.0
    check(recorder, seen, ours, ref)


def test_samplers_export_what_jax_exports():
    from inverseproblemwithdiffusionmodel_tpu import samplers as jsamplers
    names = ["MAPConfig", "map_optimizer", "map_optimizer_2d_time",
             "tv_reconstruction", "map_optimizer_pair",
             "map_optimizer_2d_time_pair", "tv_reconstruction_pair"]
    for name in names:
        assert hasattr(jsamplers, name) and hasattr(samplers, name), name
    assert samplers.MAPConfig() == map_opt.MAPConfig(200, 1e-3, 0.5, 0.5)


# -- the scripts --------------------------------------------------------------

SCRIPTS = {"acdc_MAP": acdc_MAP, "acdc_MAP_keep_center": acdc_MAP_keep_center,
           "acdc_SENSE_MAP": acdc_SENSE_MAP, "acdc_SENSE_TV": acdc_SENSE_TV}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_flags_are_the_jax_scripts(name):
    """Each add_argument and the add_common_args keywords equal the JAX
    script's (the shared flags, --device among them, are _common's)."""
    ours, ref = _paths(f"{name}.py")
    assert _flags(ours) == _flags(ref)
    common = [{k.arg: k.value.value for k in call.keywords}
              for path in (ours, ref)
              for call in _calls(path, "add_common_args")]
    assert common[0] == common[1]


def _artifacts(name):
    path = _paths("acdc_MAP.py" if "MAP" in name else f"{name}.py")[1]
    (call,) = _calls(path, "save_artifacts")
    return sorted(f"{k.arg}.npy" for k in call.keywords)


@pytest.mark.parametrize("name,flags", [
    ("acdc_MAP", ["--num_skip_lines", "2"]),
    ("acdc_MAP_keep_center", ["--R", "8"]),
    ("acdc_SENSE_MAP", ["--num_sens", "2"]),
    ("acdc_SENSE_TV", ["--num_sens", "2", "--num_epochs", "3"]),
])
def test_script_main_runs_on_the_cpu(tmp_path, name, flags):
    argv = ["--device", "cpu", "--save_dir", str(tmp_path), "--override",
            "data.image_size=32", "--override", "model.ngf=8", *flags]
    if name != "acdc_SENSE_TV":
        argv += ["--n_iters", "3"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        recon = SCRIPTS[name].main(argv)
    assert isinstance(recon, np.ndarray) and recon.dtype == np.complex64
    assert recon.shape == (1, 32, 32, 1) and np.isfinite(recon).all()
    assert "NRMSE" in out.getvalue() and "SSIM" in out.getvalue()
    (run_dir,) = list(tmp_path.iterdir())
    assert sorted(os.listdir(run_dir)) == sorted(_artifacts(name)
                                                 + ["args.json"])
    args = json.load(open(os.path.join(run_dir, "args.json")))
    assert args["device"] == "cpu"
    assert args["n_iters"] == 3
