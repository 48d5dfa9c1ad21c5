"""The 3-D temporal prior (NCSN3DShallow, task "Diffusion3D") through the
port's entry points against the JAX package's: one `train_ncsn` training
step on the (N, k, k, T, 1) volumes of `to3d`, fed JAX's draws (loss,
gradient, parameters after the step), and the two cine CLIs with
--task_name_T Diffusion3D at the geometry of tests/test_scripts.py:160-174
(16 px, 4 frames, 4 x 4 tubes, ngf 8, 6 levels), on the same weights,
phase map and noise.

Tolerances, float32: the loss at rel 1e-5 and the gradient and parameters
at rel L2 1e-5 (tests/test_torch_train_ncsn.py); the ALD reconstruction at
rel L2 REL_L2 (tests/test_torch_cine_complex.py: sums in another order
through the FFTs, the CG and both nets); the MAP iterates after N_ITERS
Adam steps at ITER_REL with at most FLIP_SHARE of the elements more than
lr apart (tests/test_torch_map_tv.py: Adam at b1 = b2 = 0.5 is nearly
sign descent).
"""
import contextlib
import io
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.losses.dsm import (
    anneal_dsm_score_estimation as jax_anneal_dsm)
from inverseproblemwithdiffusionmodel_tpu.models import ncsn3d as jncsn3d
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    TASK_NAME_TO_MODEL_CTOR as JAX_TASKS, _example_input)
from inverseproblemwithdiffusionmodel_tpu.samplers import ald as jald
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    get_sigmas as jax_get_sigmas)
from inverseproblemwithdiffusionmodel_tpu.scripts import (
    cine_SENSE_real_img_2d_time as jax_cine,
    cine_SENSE_real_img_2d_time_MAP as jax_cine_map)
from inverseproblemwithdiffusionmodel_tpu.training.state import (
    TrainState as JaxTrainState, get_optimizer as jax_get_optimizer)
from inverseproblemwithdiffusionmodel_tpu.training.train import (
    _mixed_precision_apply as jax_mixed_precision_apply,
    make_score_train_step as jax_make_step)
from inverseproblemwithdiffusionmodel_tpu.utils import misc as jmisc
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsn3d import (
    NCSN3DShallow)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
    get_sigmas)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
    cine_SENSE_real_img_2d_time as cine, cine_SENSE_real_img_2d_time_MAP as
    cine_map, train_ncsn)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts._common import (
    reload_model)
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    TrainState, get_optimizer, make_score_train_step)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch, flax_to_torch_ncsn3d)
from tests.test_torch_ald_pair import replay
from tests.test_torch_map_tv import FLIP_SHARE, ITER_REL
from tests.test_torch_ncsnv2 import init_flax
from tests.test_torch_train_ncsn import jax_draws, rel_l2, state_vector

torch.set_num_threads(1)

REL_L2 = 1e-5

# -- one Diffusion3D training step ------------------------------------------

WIN, T, NGF, B = 4, 8, 8, 3
TUBE3D = {"model.ngf": NGF, "data.channels": WIN * WIN,
          "data.image_size": T, "model.num_classes": 10}


def test_to3d_is_the_jax_scripts_reshape():
    tubes = np.random.RandomState(0).rand(5, T, WIN * WIN).astype(np.float32)
    vols = train_ncsn.to3d(tubes)
    assert vols.shape == (5, WIN, WIN, T, 1)
    ref = np.asarray(jncsn3d._tube_to_volume(jnp.asarray(tubes), WIN))
    np.testing.assert_array_equal(vols, ref)


def test_diffusion3d_train_step_matches_jax():
    jcfg = jax_load_config("CINE127_1D", "real-imag", **TUBE3D)
    cfg = load_config("CINE127_1D", "real-imag", **TUBE3D)
    module = jncsn3d.NCSN3DShallow(config=jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, init_flax(
        module, jnp.zeros((1, WIN, WIN, T, 1)), jnp.ones((1,)), seed=4))
    sigmas = np.asarray(jax_get_sigmas(jcfg))
    rs = np.random.RandomState(9)
    batch = train_ncsn.to3d(rs.rand(B, T, WIN * WIN).astype(np.float32))
    key = jax.random.PRNGKey(31)
    th = jcfg.data.th                 # rank 5: the filter weighs every row 1

    apply_fn = jax_mixed_precision_apply(module, None)
    jsig = jnp.asarray(sigmas)

    def loss_fn(p):
        key_collate, key_dsm = jax.random.split(key)
        x = 2.0 * jnp.asarray(batch) - 1.0
        weight = jmisc.filter_batch(x, th)
        parts = jmisc.collate_batch(x, "real-imag", key_collate)
        return jax_anneal_dsm(
            lambda v, labels: apply_fn(p, v, jsig[labels]),
            jmisc.stack_parts(*parts), jsig, key_dsm, anneal_power=2.0,
            sample_weight=jmisc.stack_parts(weight, weight))

    jloss, jgrad = jax.jit(jax.value_and_grad(loss_fn))(params)
    jstate = JaxTrainState.create(params, jax_get_optimizer(jcfg),
                                  ema_decay=jcfg.model.ema_rate)
    jstate, jloss_step = jax_make_step(
        module, jsig, data_mode="real-imag", filter_th=th,
        if_centering=True)(jstate, jnp.asarray(batch), key)
    assert float(jloss_step) == pytest.approx(float(jloss), rel=1e-6)

    model = NCSN3DShallow(cfg)
    model.load_state_dict(flax_to_torch_ncsn3d(params, cfg), strict=True)
    state = TrainState.create(model, get_optimizer(cfg),
                              ema_decay=cfg.model.ema_rate)
    state, loss = make_score_train_step(
        model, get_sigmas(cfg), data_mode="real-imag", filter_th=th,
        if_centering=True)(state, batch, **jax_draws(key, batch.shape,
                                                     len(sigmas)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want_grad = flax_to_torch_ncsn3d(jgrad, cfg)
    names = list(want_grad)
    grad = {k: p.grad for k, p in model.named_parameters()}
    assert rel_l2(state_vector(grad, names),
                  state_vector(want_grad, names)) <= 1e-5
    want = flax_to_torch_ncsn3d(jstate.params, cfg)
    assert rel_l2(state_vector(state.params, names),
                  state_vector(want, names)) <= 1e-5


def test_train_ncsn_trains_the_3d_prior(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state = train_ncsn.main([
            "--ds_name", "CINE64_1D", "--task_name", "Diffusion3D", "--mode",
            "real-imag", "--flatten_type", "temporal", "--device", "cpu",
            "--batch_size", "2", "--log_dir", str(tmp_path), "--override",
            "model.ngf=4", "--override", "training.n_iters=2"])
    assert state.step == 2 and type(state.model) is NCSN3DShallow
    assert "done: 2 steps" in out.getvalue()
    ckpts = tmp_path / "CINE64_1D_Diffusion3D_real-imag" / "ckpts"
    cfg = load_config("CINE64_1D", "real-imag", **{"model.ngf": 4})
    with contextlib.redirect_stdout(out):
        model, _ = reload_model(cfg, "Diffusion3D", str(ckpts))
    assert "Diffusion3D: restored step 2" in out.getvalue()
    for k, v in model.state_dict().items():
        assert torch.equal(v, state.ema.params[k].detach()), k


# -- the cine CLIs with a 3-D temporal prior ---------------------------------

S_PX, FRAMES, CLI_WIN, CHAINS, STEPS, N_ITERS = 16, 4, 4, 2, 2, 3
TINY = ["--override", "data.image_size=16", "--override", "model.ngf=8",
        "--override", "model.num_classes=6",
        "--override", "recons.num_classes=6"]
TINY_T = ["--override_T", "model.num_classes=6",
          "--override_T", "recons.num_classes=6",
          "--override_T", "model.ngf=8",
          "--override_T", "data.channels=16",
          "--override_T", "data.channels_3d=1",
          "--override_T", "data.image_size=4"]
GEOMETRY = ["--mode_T", "diffusion1d", "--task_name_T", "Diffusion3D",
            "--image_size", str(S_PX), "--num_frames", str(FRAMES),
            "--win_size", str(CLI_WIN), "--R", "8", "--seed", "2"
            ] + TINY + TINY_T


def draws_2d_time(key, sig_T, n_steps, chains):
    """JAX ald_2d_time's draws at the CLI geometry, in the order the port
    asks for them: per inner step `key, k_s, k_t = split(key, 3)`, the
    frames' Re and Im from split(k_s), and where the temporal step runs
    split(k_t, 3) -> (shift, the tubes' Re, Im)."""
    frames = (chains * FRAMES, S_PX, S_PX, 1)
    tubes = (chains * (S_PX // CLI_WIN) ** 2, FRAMES, CLI_WIN * CLI_WIN)
    out = []
    for sigma_T in np.asarray(sig_T):
        for _ in range(n_steps):
            key, k_s, k_t = jax.random.split(key, 3)
            out += [np.asarray(jax.random.normal(k, frames))
                    for k in jax.random.split(k_s)]
            if float(sigma_T) > 0:
                _, k_re, k_im = jax.random.split(k_t, 3)
                out += [np.asarray(jax.random.normal(k, tubes))
                        for k in (k_re, k_im)]
    return replay(out)


def _patch_models(monkeypatch, jax_module):
    """Both scripts on the same weights: the JAX script's nets get params
    drawn with numpy (no Flax init compile), the port's the converted
    ones."""
    held = {}

    def jax_reload(config, task_name, ckpt_dir=None):
        module = JAX_TASKS[task_name](config)
        held[task_name] = init_flax(module, _example_input(config, task_name),
                                    jnp.ones((1,)), seed=len(held) + 5)
        return module, held[task_name]

    def port_reload(config, task_name, ckpt_dir=None):
        model = registry.TASK_NAME_TO_MODEL_CTOR[task_name](config)
        transposed = {n for n, m in model.named_modules()
                      if type(m).__name__ == "ConvTranspose"}
        model.load_state_dict(flax_to_torch(held[task_name], transposed),
                              strict=True)
        return model, None

    monkeypatch.setattr(jax_module, "reload_model", jax_reload)
    monkeypatch.setattr(cine, "reload_model", port_reload)
    monkeypatch.setattr(cine_map, "reload_model", port_reload)
    return held


def _patch_phase(monkeypatch, k_phase):
    """The port's cine problem on JAX's phase map (its (5, 5, 5, 1) patch
    from k_phase)."""
    patch = torch.from_numpy(np.array(jax.random.normal(k_phase,
                                                        (5, 5, 5, 1))))
    add_phase = cine.add_phase
    monkeypatch.setattr(cine, "add_phase", lambda vol, gen, **kw: add_phase(
        vol, gen, patch=patch.to(vol.device), **kw))


def _quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return main(argv)


def test_cine_cli_with_a_3d_temporal_prior_matches_jax(tmp_path,
                                                       monkeypatch):
    held = _patch_models(monkeypatch, jax_cine)
    argv = GEOMETRY + ["--num_samples", str(CHAINS), "--num_steps_each",
                       str(STEPS)]
    ref = np.asarray(_quiet(jax_cine.main, argv + [
        "--save_dir", str(tmp_path / "jax")]))
    assert set(held) == {"Diffusion", "Diffusion3D"}
    _, k_phase, k_run = jax.random.split(jax.random.PRNGKey(2), 3)
    _patch_phase(monkeypatch, k_phase)
    cfg_S = load_config("CINE127", "real-imag", **{"recons.num_classes": 6})
    cfg_T = load_config("CINE127_1D", "real-imag",
                        **{"recons.num_classes": 6})
    _, sig_T, _ = jald.setup_2d_time_ladders(
        get_sigmas(cfg_S, "recons").numpy(),
        get_sigmas(cfg_T, "recons").numpy(), "diffusion1d")
    sampler = cine.ald_2d_time

    def fed(*args, **kwargs):
        assert kwargs["if_random_shift"] is False
        return sampler(*args, **dict(kwargs, noise=draws_2d_time(
            k_run, sig_T, STEPS, CHAINS)))

    monkeypatch.setattr(cine, "ald_2d_time", fed)
    ours = _quiet(cine.main, argv + ["--device", "cpu", "--save_dir",
                                     str(tmp_path / "port")])
    assert ours.shape == ref.shape == (CHAINS, FRAMES, S_PX, S_PX, 1)
    assert np.isfinite(ours).all() and np.abs(ref).max() > 1e-3
    err = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
    assert err <= REL_L2, err


def test_cine_map_cli_with_a_3d_temporal_prior_matches_jax(tmp_path,
                                                           monkeypatch):
    held = _patch_models(monkeypatch, jax_cine_map)
    argv = GEOMETRY + ["--n_iters", str(N_ITERS)]
    ref = np.asarray(_quiet(jax_cine_map.main, argv + [
        "--save_dir", str(tmp_path / "jax")]))
    assert set(held) == {"Diffusion", "Diffusion3D"}
    _, k_phase = jax.random.split(jax.random.PRNGKey(2))
    _patch_phase(monkeypatch, k_phase)
    ours = _quiet(cine_map.main, argv + ["--device", "cpu", "--save_dir",
                                         str(tmp_path / "port")])
    assert ours.shape == ref.shape == (1, FRAMES, S_PX, S_PX, 1)
    assert np.abs(ref).max() > 1e-3
    diff = np.abs(ours - ref)
    assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) <= ITER_REL
    lr = 1e-3                      # MAPConfig's default (no MAP section)
    assert np.mean(diff > lr) <= FLIP_SHARE


def test_cli_window_must_match_the_3d_prior(tmp_path):
    """--win_size 2 against a 3-D prior on 16-channel (4 x 4) tubes: the
    tube score adapter refuses before the sampler starts."""
    argv = list(GEOMETRY)
    argv[argv.index("--win_size") + 1] = "2"
    for main in (cine.main, cine_map.main):
        with pytest.raises(ValueError, match="win_size 2"):
            _quiet(main, argv + ["--device", "cpu", "--save_dir",
                                 str(tmp_path)])
