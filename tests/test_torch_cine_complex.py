"""The port's complex 2D+time cine reconstruction against the JAX
package's: ald_2d_time in all five temporal modes fed JAX's noise and
shifts, the complex form against the port's pair form, and the three cine
scripts (flags, main on the CPU, the chain-tiled mask, the refusal of a
dataset that is not ported). The 2D+time MAP is in
tests/test_torch_map_2d_time.py.

Geometry of tests/test_torch_cine.py (its fixture and draws): 16 px, a
spatial NCSNv2 of ngf 8, an NCSN1D of ngf 8 on 2 x 2 tubes, T = 3 frames,
2 chains (the per-frame mask tiled to B T), 2 coils, 3 levels x 2 inner
steps; here the operator is the complex SENSE and the proximal its CG
L2Penalty (3 iterations). The samplers hold at relative L2 REL_L2 (float32
sums in another order through the FFTs, the CG and the nets).
"""
import contextlib
import io
import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    make_score_fn as jax_make_score_fn)
from inverseproblemwithdiffusionmodel_tpu.operators import fourier as jfourier
from inverseproblemwithdiffusionmodel_tpu.operators import proximal as jprox
from inverseproblemwithdiffusionmodel_tpu.samplers import ald as jald
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    make_score_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
    fourier, proximal)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
    make_stepped_2d_time_pair_reconstructor)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
    cine_SENSE_real_img_2d_time, cine_SENSE_real_img_2d_time_MAP,
    cine_inv_sampling_keep_center_prox_real_imag)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
    gaussian_noise)
from tests.test_torch_cine import (
    CHAINS, H, J_S, J_T, LAMDA_T, LEVELS, LR_SCALED, NSTEPS, SIG, SIG_T,
    STEP_LR, TF, W, WIN, cine_draws, setup)
from tests.test_torch_sense_recon import _calls, _flags, _paths

torch.set_num_threads(1)

REL_L2 = 1e-5
CG_ITERS = 3
SHAPE = (CHAINS, TF, H, W, 1)


def rel_l2(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def complex_ops(s):
    """The complex SENSE on the fixture's chain-tiled per-frame mask and
    real coil maps, its CG proximal, and the measurement, in both
    packages."""
    mask_bt = np.tile(s["mask"], (CHAINS, 1, 1, 1))
    maps = s["maps"].astype(np.complex64)
    y = (s["yb"] + 1j * s["yib"]).astype(np.complex64)
    jop = jfourier.SENSE(base=jfourier.RandomUndersamplingFourier(
        mask=jnp.asarray(mask_bt)), sens_maps=jnp.asarray(maps))
    op = fourier.SENSE(base=fourier.RandomUndersamplingFourier(
        mask=torch.tensor(mask_bt)), sens_maps=torch.tensor(maps))
    return dict(op=op, jop=jop, y=y,
                prox=proximal.L2Penalty(lin_tfm=op, num_iters=CG_ITERS),
                jprox=jprox.L2Penalty(lin_tfm=jop, num_iters=CG_ITERS))


def scores(s):
    return (make_score_fn(s["netS"], torch.tensor(np.asarray(SIG))),
            make_score_fn(s["netT"], torch.tensor(np.asarray(SIG_T))))


def port_ald(s, c, mode, shift_on, noise, shift=None, **kw):
    score_S, score_T = scores(s)
    return ald.ald_2d_time(
        score_S, score_T, SIG, SIG_T, torch.from_numpy(c["y"]), c["op"],
        c["prox"], config=ald.ALDConfig(n_steps_each=NSTEPS, step_lr=STEP_LR),
        lr_scaled=LR_SCALED, mode_T=mode, lamda_T=LAMDA_T,
        if_random_shift=shift_on, win_size=WIN, num_frames=TF, noise=noise,
        shift=shift, device="cpu", **kw)


@pytest.mark.parametrize("mode,shift_on", [
    ("diffusion1d", True), ("tv", False), ("none", False),
    ("diffusion1d-only", False), ("tv-only", False)])
def test_ald_2d_time_matches_jax(setup, mode, shift_on):
    """The whole chain, 3 levels x 2 inner steps, fed JAX's noise and
    shifts (its key schedule: per inner step the frames' Re and Im, then
    where the temporal diffusion step runs its roll and the tubes' Re and
    Im)."""
    s = setup
    c = complex_ops(s)
    key = jax.random.PRNGKey(21)
    ref = jald.ald_2d_time(
        jax_make_score_fn(J_S, s["pS"], SIG),
        jax_make_score_fn(J_T, s["pT"], SIG_T), SIG, SIG_T,
        jnp.asarray(c["y"]), c["jop"], c["jprox"], key,
        jald.ALDConfig(n_steps_each=NSTEPS, step_lr=STEP_LR),
        lr_scaled=LR_SCALED, mode_T=mode, lamda_T=LAMDA_T,
        if_random_shift=shift_on, win_size=WIN, num_frames=TF)
    levels = range(len(jald.setup_2d_time_ladders(SIG, SIG_T, mode)[0]))
    noise, shift = cine_draws(key, mode, shift_on, levels, NSTEPS)
    ours = port_ald(s, c, mode, shift_on, noise, shift)
    assert ours.dtype == torch.complex64 and ours.shape == SHAPE
    assert torch.isfinite(torch.view_as_real(ours)).all()
    assert rel_l2(ours.numpy(), ref) <= REL_L2, rel_l2(ours.numpy(), ref)


def test_complex_form_is_the_pair_form(setup):
    """The complex sampler against the port's pair reconstructor
    (Stepped2DTimePairReconstructor, the pair SENSE with its normal-kernel
    CG) on the same measurement, seed and shifts, level by level."""
    s = setup
    c = complex_ops(s)
    levels = {"complex": [], "pair": []}
    keep = lambda form: lambda lvl, sigma, a, b: levels[form].append(
        (a + 1j * b).numpy())
    snap = ald.ALDConfig(n_steps_each=NSTEPS, step_lr=STEP_LR,
                         snapshot_every=1)
    score_S, score_T = scores(s)
    ours = ald.ald_2d_time(
        score_S, score_T, SIG, SIG_T, torch.from_numpy(c["y"]), c["op"],
        c["prox"], seed=5, config=snap, lr_scaled=LR_SCALED,
        lamda_T=LAMDA_T, if_random_shift=True, win_size=WIN, num_frames=TF,
        snapshot_fn=keep("complex"), device="cpu")
    recon = make_stepped_2d_time_pair_reconstructor(
        s["netS"], s["netT"], torch.tensor(np.asarray(SIG)),
        torch.tensor(np.asarray(SIG_T)), s["lin"], s["prox"], snap,
        lr_scaled=LR_SCALED, lamda_T=LAMDA_T, if_random_shift=True,
        win_size=WIN, num_frames=TF, snapshot_fn=keep("pair"), device="cpu")
    xr, xi = recon(torch.tensor(s["yb"]), torch.tensor(s["yib"]), seed=5)
    assert len(levels["complex"]) == len(levels["pair"]) == LEVELS
    for a, b in zip(levels["complex"], levels["pair"]):
        assert rel_l2(a, b) <= REL_L2
    assert rel_l2(ours.numpy(), (xr + 1j * xi).numpy()) <= REL_L2
    # a seed and its noise source are the same draws
    again = port_ald(s, c, "diffusion1d", False, gaussian_noise(5, "cpu"))
    assert torch.equal(again, port_ald(s, c, "diffusion1d", False,
                                       gaussian_noise(5, "cpu")))
    with pytest.raises(ValueError, match="temporal score"):
        ald.ald_2d_time(score_S, None, SIG, SIG_T, torch.from_numpy(c["y"]),
                        c["op"], c["prox"], device="cpu")


# -- the scripts --------------------------------------------------------------

SCRIPTS = {"cine_SENSE_real_img_2d_time": cine_SENSE_real_img_2d_time,
           "cine_SENSE_real_img_2d_time_MAP": cine_SENSE_real_img_2d_time_MAP,
           "cine_inv_sampling_keep_center_prox_real_imag":
               cine_inv_sampling_keep_center_prox_real_imag}
TINY_T = ["--image_size", "16", "--num_frames", "3", "--win_size", "2",
          "--override", "data.image_size=16", "--override", "model.ngf=8",
          "--override_T", "data.image_size=3", "--override_T",
          "data.channels=4", "--override_T", "model.ngf=8"]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_flags_are_the_jax_scripts(name):
    ours, ref = _paths(f"{name}.py")
    assert _flags(ours) == _flags(ref)


def _artifacts(name):
    (call,) = _calls(_paths(f"{name}.py")[1], "save_artifacts")
    return sorted([f"{k.arg}.npy" for k in call.keywords] + ["args.json"])


def run_script(name, tmp_path, *flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        recons = SCRIPTS[name].main(["--device", "cpu", "--save_dir",
                                     str(tmp_path), *flags])
    (run_dir,) = list(tmp_path.iterdir())
    return recons, out.getvalue(), run_dir


@pytest.mark.parametrize("flags", [
    ["--if_random_shift"], ["--mode_T", "tv"],
    ["--mode_T", "tv-only"]],
    ids=["diffusion1d_shift", "tv", "tv_only"])
def test_cine_script_main_runs_on_the_cpu(tmp_path, flags):
    recons, printed, run_dir = run_script(
        "cine_SENSE_real_img_2d_time", tmp_path, *TINY_T, "--num_samples",
        "2", "--override", "recons.num_classes=2", "--override_T",
        "recons.num_classes=2", "--num_steps_each", "1", *flags)
    assert isinstance(recons, np.ndarray) and recons.dtype == np.complex64
    assert recons.shape == (2, 3, 16, 16, 1) and np.isfinite(recons).all()
    assert "chain-steps/s" in printed and "NRMSE" in printed
    assert "4 chain-steps (2 levels x 1 steps x 2 chains)" in printed
    assert sorted(os.listdir(run_dir)) == _artifacts(
        "cine_SENSE_real_img_2d_time")
    assert json.load(open(os.path.join(run_dir, "args.json")))[
        "device"] == "cpu"


def test_cine_map_script_saves_the_strip(tmp_path):
    recon, printed, run_dir = run_script(
        "cine_SENSE_real_img_2d_time_MAP", tmp_path, *TINY_T,
        "--num_samples", "2", "--n_iters", "2", "--if_random_shift",
        "--num_plot_times", "2")
    assert recon.shape == (2, 3, 16, 16, 1) and np.isfinite(recon).all()
    assert "iterations/s" in printed and "ROADMAP Slice H" in printed
    names = _artifacts("cine_SENSE_real_img_2d_time_MAP")
    assert sorted(os.listdir(run_dir)) == sorted(names + [
        "temporal_grid.npz"])
    strip = np.load(os.path.join(run_dir, "temporal_grid.npz"))
    assert strip["frames"].tolist() == [0, 2]
    mag = np.abs(recon).mean(axis=0)[[0, 2]]
    np.testing.assert_allclose(strip["magnitudes"], mag, rtol=1e-6)


def test_single_frame_cine_script_runs_on_the_cpu(tmp_path):
    recons, printed, run_dir = run_script(
        "cine_inv_sampling_keep_center_prox_real_imag", tmp_path,
        "--override", "data.image_size=16", "--override", "model.ngf=8",
        "--override", "recons.num_classes=2", "--num_steps_each", "1",
        "--num_samples", "2", "--proximal", "SingleCoil")
    assert recons.shape == (2, 16, 16, 1) and np.isfinite(recons).all()
    assert "NRMSE" in printed
    assert sorted(os.listdir(run_dir)) == _artifacts(
        "cine_inv_sampling_keep_center_prox_real_imag")


def test_cine_problem_tiles_the_mask_over_the_chains():
    """B = 2 chains: the mask is tiled B-major to the B T axis, so the
    chain-tiled operator on the chain-tiled image gives the chain-tiled
    measurement; the untiled per-frame mask does not fit that axis."""
    args = types.SimpleNamespace(
        image_size=16, num_frames=3, data_root=None, sample_idx=0, seed=0,
        sens_type="exp", num_sens=2, R=8, center_lines_frac=1 / 16,
        num_samples=2)
    x_true, op, y, _, y_b, op_b = \
        cine_SENSE_real_img_2d_time.cine_problem(args, torch.device("cpu"))
    assert tuple(op.base.mask.shape) == (3, 1, 16, 1)
    assert torch.equal(op_b.base.mask, op.base.mask.repeat(2, 1, 1, 1))
    assert tuple(y_b.shape) == (2, 6, 16, 16, 1)
    assert torch.equal(op_b(x_true.repeat(2, 1, 1, 1)), y_b)
    with pytest.raises(RuntimeError):
        op(x_true.repeat(2, 1, 1, 1))


@pytest.mark.parametrize("name", ["cine_SENSE_real_img_2d_time",
                                  "cine_SENSE_real_img_2d_time_MAP"])
def test_diffusion3d_is_not_ported(tmp_path, name):
    """Diffusion3D is ported now (tests/test_torch_diffusion3d.py); an
    unknown dataset config still raises before any work."""
    with pytest.raises(KeyError, match="unknown dataset"):
        SCRIPTS[name].main(["--device", "cpu", "--save_dir", str(tmp_path),
                            "--task_name_T", "Diffusion3D", "--ds_name_T",
                            "IMAGENET"])
    assert not list(tmp_path.iterdir())
