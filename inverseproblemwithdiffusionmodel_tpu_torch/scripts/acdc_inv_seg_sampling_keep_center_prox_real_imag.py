"""Single-coil ACDC reconstruction: ALD, optional segmentation guidance
and proximal data consistency on the Re/Im split, on the GPU unless
--device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.acdc_inv_seg_sampling_keep_center_prox_real_imag \\
      --ckpt_dir runs/acdc_prior/ckpts --R 8 --proximal SingleCoil

Port of inverseproblemwithdiffusionmodel_tpu/scripts/
acdc_inv_seg_sampling_keep_center_prox_real_imag.py (reference: the
script of that name: RandomUndersamplingFourier, get_proximal and
ALDInvSegProximalRealImag with a synthetic phase and the `recons` sigma
ladder). It takes the JAX script's flags plus --device and saves the same
artifacts; the random draws come from torch.Generators seeded with
--seed, so they differ from the JAX script's.
"""
from __future__ import annotations

import argparse

import torch

from ._common import apply_overrides, add_common_args, save_artifacts, reload_model
from ..config import load_config
from ..data import load_data
from ..models.registry import make_score_fn, make_seg_fn
from ..operators import RandomUndersamplingFourier, get_proximal
from ..parallel import repeat_measurement
from ..samplers.ald import ALDConfig, ald_inverse_seg_proximal_real_imag
from ..samplers.sigmas import check_ladder_stability, get_sigmas
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim
from ..utils.misc import add_phase


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--ds_name", default="ACDC")
    p.add_argument("--R", type=int, default=8)
    p.add_argument("--center_lines_frac", type=float, default=1 / 16)
    p.add_argument("--lamda", type=float, default=1.0, help="seg guidance weight")
    p.add_argument("--lr_scaled", type=float, default=5.0,
                   help="proximal step scale")
    p.add_argument("--proximal", "--proximal_type", default="L2Penalty",
                   choices=["L2Penalty", "Constrained", "SingleCoil"])
    p.add_argument("--seg_start_time", type=float, default=1.0,
                   help="guidance ramp start (1.0 disables guidance)")
    p.add_argument("--seg_step_type", default="linear",
                   help="guidance ramp curve (reference name)")
    p.add_argument("--seg_ckpt_dir", default=None)
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
    kw = {"image_size": s}
    if args.data_root:
        kw["root_dir"] = args.data_root
    ds = load_data(args.ds_name, "test", **kw)
    idx = args.sample_idx
    img = torch.as_tensor(ds.data[idx:idx + 1]).to(device)
    seg_label = torch.as_tensor(ds.labels[idx:idx + 1]).to(device)

    gen = torch.Generator(device).manual_seed(args.seed)
    x_true = add_phase(img, gen)                   # complex (1, H, W, 1)

    lin_tfm = RandomUndersamplingFourier.create(
        args.R, args.center_lines_frac, (s, s, 1), seed=args.seed,
        num_frames=1).to(device)
    measurement = lin_tfm(x_true)
    zf = lin_tfm.conj_op(measurement)

    model, _ = reload_model(config, "Diffusion", args.ckpt_dir)
    model = model.to(device).eval()
    sigmas = get_sigmas(config, "recons")

    use_seg = args.seg_start_time < 1.0
    seg_fn = seg_label_b = None
    if use_seg:
        seg_model, _ = reload_model(config, "Seg", args.seg_ckpt_dir)
        seg_fn = make_seg_fn(seg_model.to(device).eval().requires_grad_(
            False))
        seg_label_b = repeat_measurement(seg_label, args.num_samples)

    cfg = ALDConfig(
        n_steps_each=args.num_steps_each or config.sampling.n_steps_each,
        step_lr=args.step_lr or config.sampling.step_lr)
    check_ladder_stability(sigmas, cfg.n_steps_each, cfg.step_lr)
    y_b = repeat_measurement(measurement, args.num_samples)
    proximal = get_proximal(args.proximal)(lin_tfm=lin_tfm)

    recons = ald_inverse_seg_proximal_real_imag(
        make_score_fn(model, sigmas), sigmas, y_b, lin_tfm, proximal,
        seed=args.seed, config=cfg, lr_scaled=args.lr_scaled, seg_fn=seg_fn,
        seg_label=seg_label_b, seg_lamda=args.lamda,
        seg_start_time=args.seg_start_time,
        seg_step_type=args.seg_step_type, device=device)

    mean_mag = torch.abs(recons).mean(dim=0)
    truth_mag = torch.abs(x_true[0])
    m_nrmse = float(nrmse(mean_mag, truth_mag))
    m_ssim = float(ssim(mean_mag[..., 0], truth_mag[..., 0]))
    print(f"NRMSE {m_nrmse:.4f}  SSIM {m_ssim:.4f}  "
          f"(ZF NRMSE {float(nrmse(torch.abs(zf)[0], truth_mag)):.4f})")

    recons = recons.cpu().numpy()
    host = lambda t: t.cpu().numpy()
    run_dir = save_artifacts(args.save_dir, vars(args),
                             original=host(x_true),
                             measurement=host(measurement), ZF=host(zf),
                             reconstructions=recons,
                             seg_label=host(seg_label))
    print(f"artifacts -> {run_dir}")
    return recons


if __name__ == "__main__":
    main()
