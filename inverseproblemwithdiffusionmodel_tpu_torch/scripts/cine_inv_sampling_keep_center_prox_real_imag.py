"""CINE single-frame 2-D reconstruction with a keep-center mask and the
proximal step on the Re/Im split, on the GPU unless --device says
otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.cine_inv_sampling_keep_center_prox_real_imag \\
      --ckpt_dir runs/cine_prior/ckpts --R 8 --num_samples 4

Port of inverseproblemwithdiffusionmodel_tpu/scripts/
cine_inv_sampling_keep_center_prox_real_imag.py (reference: the script of
that name, the ACDC keep-center pattern on CINE127 frames). It takes the
JAX script's flags plus --device and saves the same artifacts; the random
draws come from torch.Generators seeded with --seed. As in the JAX script
(and the reference) --lamda, --seg_start_time and --seg_step_type are
accepted and inert: no segmentation guides the frames.
"""
from __future__ import annotations

import argparse

import torch

from ._common import apply_overrides, add_common_args, save_artifacts, reload_model
from ..config import load_config
from ..data import load_data
from ..models.registry import make_score_fn
from ..operators import RandomUndersamplingFourier, get_proximal
from ..parallel import repeat_measurement
from ..samplers.ald import ALDConfig, ald_inverse_seg_proximal_real_imag
from ..samplers.sigmas import check_ladder_stability, get_sigmas
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim
from ..utils.misc import add_phase


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--ds_name", default="CINE127")
    p.add_argument("--R", type=int, default=8, choices=[8, 16, 20])
    p.add_argument("--center_lines_frac", type=float, default=1 / 16)
    p.add_argument("--lr_scaled", type=float, default=5.0)
    p.add_argument("--lamda", type=float, default=0.1,
                   help="guidance weight (reference surface; "
                        "inert: the reference passes label=None here too)")
    p.add_argument("--seg_start_time", type=float, default=0.0)
    p.add_argument("--seg_step_type", default="linear")
    p.add_argument("--proximal", "--proximal_type", default="L2Penalty",
                   choices=["L2Penalty", "Constrained", "SingleCoil"])
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
    device = resolve_device(args.device)   # no card: raise before any work

    config = apply_overrides(load_config(args.ds_name, "real-imag"),
                             args.override)
    s = config.data.image_size
    kw = {"root_dir": args.data_root} if args.data_root else {}
    ds = load_data(args.ds_name, "test", resize_shape=s, **kw)
    img = torch.as_tensor(ds.data[args.sample_idx:args.sample_idx + 1]).to(
        device)

    gen = torch.Generator(device).manual_seed(args.seed)
    x_true = add_phase(img, gen)                   # complex (1, s, s, 1)
    lin_tfm = RandomUndersamplingFourier.create(
        args.R, args.center_lines_frac, (s, s, 1), seed=args.seed,
        num_frames=1).to(device)
    measurement = lin_tfm(x_true)
    zf = lin_tfm.conj_op(measurement)

    model, _ = reload_model(config, "Diffusion", args.ckpt_dir)
    model = model.to(device).eval()
    sigmas = get_sigmas(config, "recons")

    cfg = ALDConfig(
        n_steps_each=args.num_steps_each or config.sampling.n_steps_each,
        step_lr=args.step_lr or config.sampling.step_lr)
    check_ladder_stability(sigmas, cfg.n_steps_each, cfg.step_lr)
    y_b = repeat_measurement(measurement, args.num_samples)
    proximal = get_proximal(args.proximal)(lin_tfm=lin_tfm)

    recons = ald_inverse_seg_proximal_real_imag(
        make_score_fn(model, sigmas), sigmas, y_b, lin_tfm, proximal,
        seed=args.seed, config=cfg, lr_scaled=args.lr_scaled, device=device)

    mean_mag = torch.abs(recons).mean(dim=0)
    truth = torch.abs(x_true[0])
    print(f"R={args.R}: NRMSE {float(nrmse(mean_mag, truth)):.4f} "
          f"SSIM {float(ssim(mean_mag[..., 0], truth[..., 0])):.4f}")
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
