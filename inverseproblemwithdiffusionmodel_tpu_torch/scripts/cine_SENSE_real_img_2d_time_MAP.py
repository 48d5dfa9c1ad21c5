"""2D+time cine MAP reconstruction with factorized spatial and temporal
priors, on the GPU unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.cine_SENSE_real_img_2d_time_MAP \\
      --ckpt_dir runs/cine_prior/ckpts --ckpt_dir_T runs/cine_prior_1d/ckpts

Port of inverseproblemwithdiffusionmodel_tpu/scripts/
cine_SENSE_real_img_2d_time_MAP.py (reference: scripts/
cine_SENSE_real_img_2d_time_MAP.py, MAPOptimizer2DTime, :160-169). It
takes the JAX script's flags plus --device and saves the same arrays. The
cine configs carry no MAP section, so Adam falls back to MAPConfig's
defaults and --beta1 / --beta2. Like the JAX script it draws a strip of
--num_plot_times frames of the chains' mean magnitude into
temporal_grid.png of the run's directory (utils/visualizations;
matplotlib is imported only then; where it is not installed, the strip
is skipped with a printed line and the arrays are saved all the same). --task_name_T Diffusion3D takes the
temporal score of a 3-D net (NCSN3DShallow) on the pixel tubes.
"""
from __future__ import annotations

import argparse
import os
import time

from ._common import apply_overrides, add_common_args, save_artifacts, reload_model
from .cine_SENSE_real_img_2d_time import (cine_metrics, cine_problem,
                                          temporal_score_fn)
from ..config import load_config
from ..models.registry import make_score_fn
from ..samplers.map_opt import MAPConfig, map_optimizer_2d_time
from ..samplers.sigmas import get_sigmas
from ..utils.device import resolve_device, synchronize


def main(argv=None):
    t_main = time.perf_counter()
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--ds_name", default="CINE127")
    p.add_argument("--ds_name_T", default="CINE127_1D")
    p.add_argument("--task_name_T", "--temporal_type", default="Diffusion1D")
    p.add_argument("--mode_T", default="diffusion1d",
                   choices=["tv", "diffusion1d", "none"])
    p.add_argument("--R", type=int, default=8, choices=[8, 16, 20])
    p.add_argument("--num_sens", type=int, default=4)
    p.add_argument("--center_lines_frac", type=float,
                   default=1 / 16)
    p.add_argument("--sens_type", default="exp", choices=["exp"],
                   help="synthetic coil-map family (reference default exp)")
    p.add_argument("--prior_weight", type=float, default=1.0)
    p.add_argument("--spatial_step_weight", type=float, default=1.0)
    p.add_argument("--temporal_step_weight", type=float, default=1.0)
    p.add_argument("--win_size", type=int, default=8)
    p.add_argument("--num_frames", type=int, default=24)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--n_iters", "--num_iters", "--max_iter",
                   type=int, default=None,
                   help="Adam iterations (reference names: "
                        "--num_iters/--max_iter)")
    p.add_argument("--beta1", type=float, default=None)
    p.add_argument("--beta2", type=float, default=None)
    p.add_argument("--if_random_shift", action="store_true")
    p.add_argument("--num_plot_times", type=int, default=6,
                   help="frames in the saved temporal strip "
                        "(reference name)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--ckpt_dir_T", default=None)
    p.add_argument("--override_T", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--sample_idx", "--ds_idx", type=int, default=0,
                   help="test-set slice index (reference name: --ds_idx)")
    p.add_argument("--data_root", default=None)
    args = p.parse_args(argv)
    use_T = args.mode_T == "diffusion1d"
    device = resolve_device(args.device)   # no card: raise before any work

    config_S = apply_overrides(load_config(args.ds_name, "real-imag"),
                               args.override)
    config_T = apply_overrides(load_config(args.ds_name_T, "real-imag"),
                               args.override_T or [])
    T = args.num_frames
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

    # cine configs carry no MAP section (the reference's cine127.yml has
    # none either); fall back to MAPConfig's defaults
    map_cfg = config_S.get("MAP")
    cfg = MAPConfig(
        n_iters=args.n_iters or (map_cfg.n_iters if map_cfg else 200),
        lr=args.lr or (map_cfg.lr if map_cfg else 1e-3),
        b1=args.beta1 if args.beta1 is not None else 0.5,
        b2=args.beta2 if args.beta2 is not None else 0.5)
    synchronize(device)
    t_run = time.perf_counter()
    recon = map_optimizer_2d_time(
        make_score_fn(model_S, sigmas_S), score_T, measurement_b, lin_tfm_b,
        cfg, prior_weight=args.prior_weight,
        spatial_step_weight=args.spatial_step_weight,
        temporal_step_weight=args.temporal_step_weight, mode_T=args.mode_T,
        if_random_shift=args.if_random_shift, win_size=args.win_size,
        num_frames=T, seed=args.seed, device=device)
    synchronize(device)
    run_s = time.perf_counter() - t_run
    print(f"MAP 2D+time: {cfg.n_iters} Adam iterations in {run_s:.4f} s, "
          f"{cfg.n_iters / run_s:.2f} iterations/s (set-up apart); wall "
          f"{time.perf_counter() - t_main:.2f} s")

    m_nrmse, m_ssim, mag = cine_metrics(recon, x_true)
    print(f"R={args.R} mode_T={args.mode_T}: NRMSE {m_nrmse:.4f} "
          f"SSIM {m_ssim:.4f}")
    recon = recon.cpu().numpy()
    host = lambda t: t.cpu().numpy()
    run_dir = save_artifacts(args.save_dir, vars(args),
                             original=host(x_true),
                             measurement=host(measurement), ZF=host(zf),
                             reconstructions=recon)
    from ..utils.visualizations import grid_of_temporal_samples
    try:
        grid_of_temporal_samples(
            host(mag), num_frames=min(args.num_plot_times, T),
            save_path=os.path.join(run_dir, "temporal_grid.png"))
    except ModuleNotFoundError as err:
        # a card machine may have no matplotlib: keep the reconstruction
        if err.name != "matplotlib":
            raise
        print("matplotlib is not installed: temporal_grid.png not drawn")
    print(f"artifacts -> {run_dir}")
    return recon


if __name__ == "__main__":
    main()
