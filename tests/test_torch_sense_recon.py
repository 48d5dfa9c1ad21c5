"""The port's complex reconstruction sampler and its two scripts against the
JAX package's.

ald_inverse_seg_proximal_real_imag runs on the tiny NCSNv2 of
tests/test_torch_serving.py (16 px, ngf 8, 3 levels x 2 inner steps) with
the same weights, operator, measurement and the JAX sampler's own noise
(its key schedule replayed with jax.random): SENSE with the CG L2Penalty
and single-coil with the closed-form SingleCoil, unguided and guided by
the tiny seg UNet. It holds at relative L2 1e-4: float32 sums in another
order through the FFTs, 8 CG iterations per step and the nets. The
scripts run on the CPU at 32 px and are held to the JAX scripts' flags and
artifact names, read from their sources.
"""
import ast
import contextlib
import io
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.config import Config as JConfig
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2 as JaxNCSNv2)
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    make_score_fn as jax_make_score_fn)
from inverseproblemwithdiffusionmodel_tpu.operators import fourier as jfourier
from inverseproblemwithdiffusionmodel_tpu.operators import proximal as jprox
from inverseproblemwithdiffusionmodel_tpu.samplers import ald as jald
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    sigma_ladder as jax_sigma_ladder)
from inverseproblemwithdiffusionmodel_tpu_torch.config import Config
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    make_score_fn, make_seg_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
    fourier, proximal)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
    acdc_SENSE_real_img, acdc_inv_seg_sampling_keep_center_prox_real_imag)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnv2)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
    gaussian_noise)
from tests.test_torch_ald_pair import jax_noise, replay
from tests.test_torch_ncsnv2 import init_flax
from tests.test_torch_serving import TINY, port_unet, seg_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 16
LEVELS, NSTEPS, CHAINS, COILS = 3, 2, 2, 2
REL_L2 = 1e-4
SCRIPTS = {"sense": acdc_SENSE_real_img,
           "single": acdc_inv_seg_sampling_keep_center_prox_real_imag}


def rel_l2(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def setup():
    """The tiny NCSNv2 in both packages on one set of weights, its ladder,
    the tiny seg UNet, a random label and a random complex image."""
    module = JaxNCSNv2(config=JConfig(TINY))
    params = init_flax(module, jnp.zeros((1, H, W, 1)), jnp.ones((1,)))
    cfg = Config(TINY)
    model = NCSNv2(cfg)
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg, "ncsnv2"))
    seg_module, sparams = seg_params(np.random.RandomState(5))
    rs = np.random.RandomState(6)
    label = (rs.rand(H, W) > 0.5).astype(np.int32)
    x = (rs.rand(1, H, W, 1) * np.exp(1j * rs.randn(1, H, W, 1))
         ).astype(np.complex64)
    return dict(module=module, params=params, model=model,
                sigmas=jax_sigma_ladder(10.0, 0.1, LEVELS, "geometric"),
                seg_module=seg_module, seg_params=sparams,
                seg_model=port_unet(sparams).requires_grad_(False),
                label=np.broadcast_to(label, (CHAINS, H, W)).copy(), x=x)


def operators(kind):
    """(port op, JAX op, proximal name, measurement chain axis)."""
    if kind == "sense":
        args = ("exp", COILS, 8, 0.125, (H, W, 1))
        return (fourier.make_sense(*args, seed=0, num_frames=1),
                jfourier.make_sense(*args, seed=0, num_frames=1),
                "L2Penalty", 1)
    args = (8, 0.125, (H, W, 1))
    return (fourier.RandomUndersamplingFourier.create(*args, seed=0,
                                                      num_frames=1),
            jfourier.RandomUndersamplingFourier.create(*args, seed=0,
                                                       num_frames=1),
            "SingleCoil", 0)


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("kind", ["sense", "single"])
def test_sampler_matches_jax_fed_its_noise(setup, kind, guided):
    op, jop, prox_name, axis = operators(kind)
    y = np.asarray(jop(jnp.asarray(setup["x"])))
    y = np.repeat(y, CHAINS, axis=axis)
    kw = dict(lr_scaled=2.0, seg_lamda=3.0, seg_start_time=0.0)
    key = jax.random.PRNGKey(2)
    jcfg = jald.ALDConfig(n_steps_each=NSTEPS, step_lr=1e-5)
    sigmas = setup["sigmas"]
    seg = {}
    if guided:
        seg = dict(seg_fn=lambda v: setup["seg_module"].apply(
            {"params": setup["seg_params"]}, v),
            seg_label=jnp.asarray(setup["label"]))
    ref = jald.ald_inverse_seg_proximal_real_imag(
        jax_make_score_fn(setup["module"], setup["params"], sigmas), sigmas,
        jnp.asarray(y), jop, jprox.get_proximal(prox_name)(lin_tfm=jop), key,
        jcfg, **seg, **kw)
    if guided:
        seg = dict(seg_fn=make_seg_fn(setup["seg_model"]),
                   seg_label=torch.from_numpy(setup["label"]))
    ts = torch.tensor(np.asarray(sigmas))
    ours = ald.ald_inverse_seg_proximal_real_imag(
        make_score_fn(setup["model"], ts), ts, torch.from_numpy(y), op,
        proximal.get_proximal(prox_name)(lin_tfm=op),
        config=ald.ALDConfig(n_steps_each=NSTEPS, step_lr=1e-5),
        noise=replay(jax_noise(key, (CHAINS, H, W, 1), LEVELS * NSTEPS)),
        device="cpu", **seg, **kw)
    assert ours.shape == (CHAINS, H, W, 1) and ours.dtype == torch.complex64
    assert torch.isfinite(torch.view_as_real(ours)).all()
    assert rel_l2(ours.numpy(), ref) <= REL_L2, rel_l2(ours.numpy(), ref)


def test_sampler_seed_snapshots_and_refusals(setup):
    op, jop, _, _ = operators("sense")
    y = op(torch.from_numpy(setup["x"])).repeat(1, CHAINS, 1, 1, 1)
    ts = torch.tensor(np.asarray(setup["sigmas"]))
    run = lambda **kw: ald.ald_inverse_seg_proximal_real_imag(
        make_score_fn(setup["model"], ts), ts, y, op,
        proximal.L2Penalty(lin_tfm=op, num_iters=2), device="cpu",
        **{"config": ald.ALDConfig(n_steps_each=1, step_lr=1e-5), **kw})
    seen = []
    by_seed = run(seed=3)
    snap = run(noise=gaussian_noise(3, "cpu"),
               config=ald.ALDConfig(n_steps_each=1, step_lr=1e-5,
                                    snapshot_every=2),
               snapshot_fn=lambda c, s, xr, xi: seen.append((c, s,
                                                             xr.shape)))
    assert torch.equal(by_seed, snap)
    assert seen == [(c, float(ts[c]), (CHAINS, H, W, 1)) for c in (0, 2)]
    with pytest.raises(ValueError, match="seg_label"):
        run(seg_fn=make_seg_fn(setup["seg_model"]))


# -- the scripts ------------------------------------------------------------

def _calls(path, func):
    """The ast.Call nodes of `func` in the file at path."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and (
                getattr(node.func, "attr", None) == func
                or getattr(node.func, "id", None) == func):
            yield node


def _flags(path):
    """{flag names: (default, type, choices, action)} of every
    add_argument in a file, as source text."""
    out = {}
    for call in _calls(path, "add_argument"):
        names = tuple(a.value for a in call.args)
        kw = {k.arg: ast.unparse(k.value) for k in call.keywords}
        out[names] = tuple(kw.get(k) for k in ("default", "type", "choices",
                                               "action"))
    return out


def _paths(name):
    return (os.path.join(ROOT, "inverseproblemwithdiffusionmodel_tpu_torch",
                         "scripts", name),
            os.path.join(ROOT, "inverseproblemwithdiffusionmodel_tpu",
                         "scripts", name))


@pytest.mark.parametrize("kind", sorted(SCRIPTS))
def test_script_flags_are_the_jax_scripts_plus_device(kind):
    name = f"{SCRIPTS[kind].__name__.rsplit('.', 1)[1]}.py"
    ours, ref = (_flags(p) for p in _paths(name))
    assert ours == ref
    common, jcommon = (_flags(p) for p in _paths("_common.py"))
    assert set(common) - set(jcommon) == {("--device",)}
    for flags in jcommon:
        assert common[flags] == jcommon[flags]


def _artifacts(kind):
    """The .npy names the JAX script's save_artifacts call writes."""
    name = f"{SCRIPTS[kind].__name__.rsplit('.', 1)[1]}.py"
    (call,) = _calls(_paths(name)[1], "save_artifacts")
    return sorted(f"{k.arg}.npy" for k in call.keywords)


def run_script(kind, tmp_path, *flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        recons = SCRIPTS[kind].main([
            "--device", "cpu", "--num_samples", "2", "--save_dir",
            str(tmp_path), "--override", "data.image_size=32", "--override",
            "model.ngf=8", "--override", "recons.num_classes=2",
            "--num_steps_each", "1", *flags])
    return recons, out.getvalue()


@pytest.mark.parametrize("kind,flags", [
    ("sense", []),
    ("sense", ["--seg_start_time", "0.5", "--seg_fraction", "0.5"]),
    ("single", ["--proximal", "SingleCoil"]),
], ids=["sense", "sense_guided", "single_coil"])
def test_script_main_runs_on_the_cpu(tmp_path, kind, flags):
    recons, printed = run_script(kind, tmp_path, *flags)
    assert isinstance(recons, np.ndarray) and recons.dtype == np.complex64
    assert recons.shape == (2, 32, 32, 1) and np.isfinite(recons).all()
    assert "NRMSE" in printed and "SSIM" in printed
    (run_dir,) = list(tmp_path.iterdir())
    names = sorted(os.listdir(run_dir))
    assert names == sorted(_artifacts(kind) + ["args.json"])
    np.testing.assert_array_equal(
        np.load(os.path.join(run_dir, "reconstructions.npy")), recons)
    args = json.load(open(os.path.join(run_dir, "args.json")))
    assert args["device"] == "cpu"
    assert args["data_provenance"]["ACDC/test"]["source"] == "synthetic"


def test_use_mesh_raises(tmp_path):
    # --use_mesh is ported: on the default device it needs a card, as
    # every run without --device cpu, and raises before any work; on the
    # CPU (a mesh of the one CPU device, guided) it is the run without it
    with pytest.raises(RuntimeError, match="no CUDA"):
        acdc_SENSE_real_img.main(["--use_mesh", "--save_dir",
                                  str(tmp_path)])
    assert not list(tmp_path.iterdir())
    guided = ["--seg_start_time", "0.5", "--seg_fraction", "0.5"]
    plain, _ = run_script("sense", tmp_path / "plain", *guided)
    meshed, _ = run_script("sense", tmp_path / "mesh", *guided, "--use_mesh")
    np.testing.assert_array_equal(meshed, plain)
