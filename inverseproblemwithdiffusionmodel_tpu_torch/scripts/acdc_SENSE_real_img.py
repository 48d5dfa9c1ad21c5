"""Multi-coil SENSE ACDC reconstruction (R 8, 16 or 20, 4 coils) with ALD,
optional segmentation guidance and proximal data consistency, on the GPU
unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.acdc_SENSE_real_img \\
      --ckpt_dir runs/acdc_prior/ckpts --R 8 --num_sens 4 --num_samples 16

Port of inverseproblemwithdiffusionmodel_tpu/scripts/acdc_SENSE_real_img.py
(reference: scripts/acdc_SENSE_real_img.py, the SENSE operator with
synthetic exp coil maps and ALDInvSegProximalRealImag; ensembles are batch
rows, :104 `torch.cat([measurement] * num_samples)`). It takes the JAX
script's flags plus --device and saves the same artifacts. The random
draws (the synthetic phase, the chains' noise) come from torch.Generators
seeded with --seed, so they differ from the JAX script's. --ckpt_dir and
--seg_ckpt_dir are training/checkpoint.Checkpointer directories; without
them the nets take weights drawn from a seed, with a loud warning.
Not ported: chain sharding with --use_mesh (ROADMAP: Slice P), which
raises NotImplementedError.
"""
from __future__ import annotations

import argparse

import torch

from ._common import apply_overrides, add_common_args, save_artifacts, reload_model
from ..config import load_config
from ..data import load_data
from ..models.registry import make_score_fn, make_seg_fn
from ..operators import make_sense, get_proximal
from ..parallel import repeat_measurement, ensemble_mean_std
from ..samplers.ald import ALDConfig, ald_inverse_seg_proximal_real_imag
from ..samplers.sigmas import check_ladder_stability, get_sigmas
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim
from ..utils.misc import add_phase, undersample_seg_mask


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--ds_name", default="ACDC")
    p.add_argument("--R", type=int, default=8, choices=[8, 16, 20])
    p.add_argument("--num_sens", type=int, default=4)
    p.add_argument("--sens_type", default="exp", choices=["exp"],
                   help="synthetic coil-map family (reference default exp)")
    p.add_argument("--center_lines_frac", type=float, default=1 / 16)
    p.add_argument("--lamda", type=float, default=1.0)
    p.add_argument("--lr_scaled", type=float, default=5.0)
    p.add_argument("--proximal_type", default="L2Penalty",
                   choices=["L2Penalty", "Constrained"],
                   help="data-consistency step (SingleCoil's "
                        "closed form needs a single-coil "
                        "masked-Fourier operator)")
    p.add_argument("--seg_start_time", type=float, default=1.0)
    p.add_argument("--seg_step_type", default="linear",
                   help="guidance ramp curve (reference name)")
    p.add_argument("--seg_mode", default="full", choices=["full", "FG"],
                   help="apply the seg gradient everywhere or only on "
                        "foreground pixels (reference name)")
    p.add_argument("--seg_fraction", type=float, default=1.0,
                   help="fraction of foreground seg pixels kept for "
                        "guidance (reference: undersample_seg_mask, "
                        "acdc_SENSE_real_img.py:92)")
    p.add_argument("--seg_ckpt_dir", default=None)
    p.add_argument("--use_mesh", action="store_true",
                   help="shard the ensemble chains over all local devices "
                        "(not ported yet: raises)")
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
    if args.use_mesh:
        raise NotImplementedError("--use_mesh: chain sharding over devices "
                                  "is not ported yet (ROADMAP: Slice P)")
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

    lin_tfm = make_sense(args.sens_type, args.num_sens, args.R,
                         args.center_lines_frac, (s, s, 1), seed=args.seed,
                         num_frames=1).to(device)
    measurement = lin_tfm(x_true)                  # (S, 1, H, W, 1)
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
        if args.seg_fraction < 1.0:
            seg_label = undersample_seg_mask(seg_label, args.seg_fraction,
                                             gen)
        seg_label_b = repeat_measurement(seg_label, args.num_samples)

    cfg = ALDConfig(
        n_steps_each=args.num_steps_each or config.sampling.n_steps_each,
        step_lr=args.step_lr or config.sampling.step_lr)
    check_ladder_stability(sigmas, cfg.n_steps_each, cfg.step_lr)
    y_b = repeat_measurement(measurement, args.num_samples, batch_axis=1)
    proximal = get_proximal(args.proximal_type)(lin_tfm=lin_tfm)

    recons = ald_inverse_seg_proximal_real_imag(
        make_score_fn(model, sigmas), sigmas, y_b, lin_tfm, proximal,
        seed=args.seed, config=cfg, lr_scaled=args.lr_scaled, seg_fn=seg_fn,
        seg_label=seg_label_b, seg_lamda=args.lamda,
        seg_start_time=args.seg_start_time,
        seg_step_type=args.seg_step_type, seg_mode=args.seg_mode,
        device=device)

    mean_mag, std_mag = ensemble_mean_std(recons)
    truth_mag = torch.abs(x_true[0])
    m_nrmse = float(nrmse(mean_mag, truth_mag))
    m_ssim = float(ssim(mean_mag[..., 0], truth_mag[..., 0]))
    print(f"R={args.R} {args.num_sens}-coil: NRMSE {m_nrmse:.4f} "
          f"SSIM {m_ssim:.4f}")

    recons = recons.cpu().numpy()
    host = lambda t: t.cpu().numpy()
    run_dir = save_artifacts(args.save_dir, vars(args),
                             original=host(x_true),
                             measurement=host(measurement), ZF=host(zf),
                             reconstructions=recons,
                             ensemble_mean=host(mean_mag),
                             ensemble_std=host(std_mag))
    print(f"artifacts -> {run_dir}")
    return recons


if __name__ == "__main__":
    main()
