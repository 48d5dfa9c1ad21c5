"""2D+time cine reconstruction on the complex SENSE operator: the spatial
2-D score, the temporal 1-D score (or TV) and per-frame SENSE data
consistency, on the GPU unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.cine_SENSE_real_img_2d_time \\
      --ckpt_dir runs/cine_prior/ckpts --ckpt_dir_T runs/cine_prior_1d/ckpts \\
      --R 8 --num_sens 4 --num_samples 4

Port of inverseproblemwithdiffusionmodel_tpu/scripts/
cine_SENSE_real_img_2d_time.py (reference: scripts/
cine_SENSE_real_img_2d_time.py, ALD2DTime with two configs and ladders,
:63-87, per-frame masks, the wall time printed, :163-182). It takes the
JAX script's flags plus --device and saves the same artifacts. Chains are
batch rows: the measurement is repeated B-major over the chains x frames
axis and the per-frame mask tiled to match. It prints the sampler's
chain-steps/s between CUDA synchronizations (the config, data, operator
and nets' set-up apart) and the wall seconds. The random draws (the phase,
the chains' noise, the tubes' roll) come from torch.Generators seeded with
--seed. --task_name_T Diffusion3D takes the temporal score of a 3-D net
(NCSN3DShallow) on the pixel tubes (models/registry.make_tube_score_fn_3d,
which checks --win_size against the net's window).
"""
from __future__ import annotations

import argparse
import time

import torch

from ._common import apply_overrides, add_common_args, save_artifacts, reload_model
from ..config import load_config
from ..data import load_cine, transforms as dT
from ..models.registry import make_score_fn, make_tube_score_fn_3d
from ..operators import get_proximal, make_sense
from ..parallel import repeat_measurement
from ..samplers.ald import ALDConfig, ald_2d_time, setup_2d_time_ladders
from ..samplers.sigmas import check_ladder_stability, get_sigmas
from ..utils.device import resolve_device, synchronize
from ..utils.metrics import nrmse, ssim
from ..utils.misc import add_phase


def cine_problem(args, device: torch.device):
    """The test volume `--sample_idx` resized to (num_frames, s, s) with
    its smooth 2D+time phase, the per-frame SENSE operator, its
    measurement and zero-filled image, and the chain-tiled measurement
    and operator (mask tiled to B T): (x_true, lin_tfm, measurement, zf,
    measurement_b, lin_tfm_b). Shared with cine_SENSE_real_img_2d_time_MAP."""
    s = args.image_size or (128 if "127" in args.ds_name else 64)
    T = args.num_frames
    kw = {"root_dir": args.data_root} if args.data_root else {}
    vols = load_cine(mode="test", flatten=False, **kw).data  # (N, T0, H, W)
    vol = dT.resize(vols[args.sample_idx], (s, s))  # (T0, s, s)
    if vol.shape[0] != T:
        vol = dT.resize(vol.transpose(1, 0, 2), (T, s)).transpose(1, 0, 2)
    vol = torch.as_tensor(vol)[..., None].to(device)  # (T, s, s, 1)

    gen = torch.Generator(device).manual_seed(args.seed)
    x_true = add_phase(vol, gen, init_shape=(5, 5, 5), mode="2D+time")
    lin_tfm = make_sense(args.sens_type, args.num_sens, args.R,
                         args.center_lines_frac, (s, s, 1), seed=args.seed,
                         num_frames=T).to(device)
    measurement = lin_tfm(x_true)                  # (S, T, s, s, 1)
    zf = lin_tfm.conj_op(measurement)
    # ensemble chains: B-major repeat of the T-frame block -> (S, B T, ...)
    # (reference: cine_SENSE_real_img_2d_time.py:121 measurement.repeat);
    # the per-frame mask is tiled to the same axis, or it would broadcast
    # wrongly against the chains' batch
    B = args.num_samples
    measurement_b = repeat_measurement(measurement, B, batch_axis=1)
    lin_tfm_b = lin_tfm if B == 1 else lin_tfm.replace(
        base=lin_tfm.base.replace(mask=lin_tfm.base.mask.repeat(B, 1, 1, 1)))
    return x_true, lin_tfm, measurement, zf, measurement_b, lin_tfm_b


def temporal_score_fn(model_T, sigmas_T, task_name_T: str, win_size: int):
    """The temporal prior's score on the sampler's (B', T, win^2) tubes:
    a 1-D net's through make_score_fn, a 3-D net's (Diffusion3D) through
    make_tube_score_fn_3d, which raises ValueError where win_size^2 is not
    the net's config.data.channels (the JAX scripts' :126-127)."""
    if task_name_T == "Diffusion3D":
        return make_tube_score_fn_3d(model_T, sigmas_T, win_size)
    return make_score_fn(model_T, sigmas_T)


def cine_metrics(recons: torch.Tensor, x_true: torch.Tensor):
    """NRMSE of the chains' mean magnitude (T, s, s, 1) against |x_true|,
    and the mean over frames of the per-frame SSIM; and that magnitude."""
    mag = torch.abs(recons).mean(dim=0)
    truth = torch.abs(x_true)
    ssims = [float(ssim(mag[t, ..., 0], truth[t, ..., 0]))
             for t in range(mag.shape[0])]
    return float(nrmse(mag, truth)), sum(ssims) / len(ssims), mag


def main(argv=None):
    t_main = time.perf_counter()
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--ds_name", default="CINE127")
    p.add_argument("--ds_name_T", default="CINE127_1D")
    p.add_argument("--task_name_T", "--temporal_type", default="Diffusion1D",
                   choices=["Diffusion1D", "Diffusion3D"])
    p.add_argument("--mode_T", default="diffusion1d",
                   choices=["tv", "diffusion1d", "none", "diffusion1d-only",
                            "tv-only"])
    p.add_argument("--R", type=int, default=8, choices=[8, 16, 20])
    p.add_argument("--num_sens", type=int, default=4)
    p.add_argument("--center_lines_frac", type=float,
                   default=1 / 16)
    p.add_argument("--sens_type", default="exp", choices=["exp"],
                   help="synthetic coil-map family (reference default exp)")
    p.add_argument("--lamda_T", type=float, default=1.0)
    p.add_argument("--lr_scaled", type=float, default=5.0)
    p.add_argument("--proximal_type", default="L2Penalty",
                   choices=["L2Penalty", "Constrained"],
                   help="data-consistency step (SingleCoil's "
                        "closed form needs a single-coil "
                        "masked-Fourier operator)")
    p.add_argument("--if_random_shift", action="store_true")
    p.add_argument("--win_size", type=int, default=8)
    p.add_argument("--num_frames", type=int, default=24)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--ckpt_dir_T", default=None)
    p.add_argument("--override_T", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--sample_idx", "--ds_idx", type=int, default=0,
                   help="test-set slice index (reference name: --ds_idx)")
    p.add_argument("--data_root", default=None)
    p.add_argument("--step_lr", type=float, default=None,
                   help="Langevin step size (defaults to the config's "
                        "sampling.step_lr)")
    p.add_argument("--num_steps_each", type=int, default=None,
                   help="inner steps per noise level (defaults to the "
                        "config's sampling.n_steps_each)")
    args = p.parse_args(argv)
    use_T = "diffusion1d" in args.mode_T
    device = resolve_device(args.device)   # no card: raise before any work

    config_S = apply_overrides(load_config(args.ds_name, "real-imag"),
                               args.override)
    config_T = apply_overrides(load_config(args.ds_name_T, "real-imag"),
                               args.override_T or [])
    x_true, lin_tfm, measurement, zf, measurement_b, lin_tfm_b = \
        cine_problem(args, device)

    model_S, _ = reload_model(config_S, "Diffusion", args.ckpt_dir)
    model_S = model_S.to(device).eval()
    sigmas_S = get_sigmas(config_S, "recons")
    sigmas_T = get_sigmas(config_T, "recons")
    score_T = None
    if use_T:
        model_T, _ = reload_model(config_T, args.task_name_T,
                                  args.ckpt_dir_T)
        score_T = temporal_score_fn(model_T.to(device).eval(), sigmas_T,
                                    args.task_name_T, args.win_size)

    cfg = ALDConfig(
        n_steps_each=args.num_steps_each or config_S.sampling.n_steps_each,
        step_lr=args.step_lr or config_S.sampling.step_lr)
    check_ladder_stability(sigmas_S, cfg.n_steps_each, cfg.step_lr)
    proximal = get_proximal(args.proximal_type)(lin_tfm=lin_tfm_b)

    synchronize(device)
    t_run = time.perf_counter()
    recons = ald_2d_time(
        make_score_fn(model_S, sigmas_S), score_T, sigmas_S, sigmas_T,
        measurement_b, lin_tfm_b, proximal, seed=args.seed, config=cfg,
        lr_scaled=args.lr_scaled, mode_T=args.mode_T, lamda_T=args.lamda_T,
        if_random_shift=args.if_random_shift, win_size=args.win_size,
        num_frames=args.num_frames, device=device)
    synchronize(device)
    sampler_s = time.perf_counter() - t_run
    levels = len(setup_2d_time_ladders(sigmas_S, sigmas_T, args.mode_T)[0])
    chain_steps = levels * cfg.n_steps_each * args.num_samples
    print(f"2D+time recon: sampler {sampler_s:.4f} s for {chain_steps} "
          f"chain-steps ({levels} levels x {cfg.n_steps_each} steps x "
          f"{args.num_samples} chains), {chain_steps / sampler_s:.2f} "
          f"chain-steps/s (set-up apart); wall "
          f"{time.perf_counter() - t_main:.2f} s")

    m_nrmse, m_ssim, _ = cine_metrics(recons, x_true)
    print(f"R={args.R} mode_T={args.mode_T}: NRMSE {m_nrmse:.4f} "
          f"SSIM {m_ssim:.4f}")
    recons = recons.cpu().numpy()
    host = lambda t: t.cpu().numpy()
    run_dir = save_artifacts(args.save_dir, vars(args),
                             original=host(x_true),
                             measurement=host(measurement), ZF=host(zf),
                             reconstructions=recons)
    print(f"artifacts -> {run_dir}")
    return recons


if __name__ == "__main__":
    main()
