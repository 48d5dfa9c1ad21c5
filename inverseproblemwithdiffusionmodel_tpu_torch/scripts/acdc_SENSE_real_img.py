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
The chains run in the pair form of the serving engines
(samplers/ald_pair.make_stepped_pair_reconstructor, PairSENSE and the
pair CG of the L2Penalty proximal on the normal kernel; `reconstruct`). --use_mesh splits them
over every card torch sees (the one CPU device with --device cpu) as the
JAX script shards them: parallel.run_sharded_ensemble pads the
measurement's chain axis (1) to a multiple of the cards with copies of
the last chain, the reconstructor advances every card's block in step
with the unsharded run's noise and CG dot products that span the whole
ensemble (samplers/ald_pair.ShardedReconstructor), and the padding chains
are dropped. Without padding the result is the run's without the mesh, up
to the order of the CG's sums.
"""
from __future__ import annotations

import argparse

import torch

from ._common import (apply_overrides, add_common_args, reload_model,
                      save_artifacts, script_mesh)
from ..config import load_config
from ..data import load_data
from ..operators import make_sense
from ..operators.pair import PairL2Penalty, PairSENSE
from ..parallel import (ensemble_mean_std, repeat_measurement,
                        run_sharded_ensemble)
from ..samplers.ald import ALDConfig
from ..samplers.ald_pair import make_stepped_pair_reconstructor
from ..samplers.sigmas import check_ladder_stability, get_sigmas
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim
from ..utils.misc import add_phase, undersample_seg_mask


def reconstruct(model, sigmas, measurement: torch.Tensor, lin_tfm,
                config: ALDConfig, num_samples: int, seed: int = 0,
                lr_scaled: float = 5.0, num_iters: int = 8, seg_model=None,
                seg_label=None, seg_lamda: float = 1.0,
                seg_start_time: float = 1.0, seg_step_type: str = "linear",
                seg_mode: str = "full", device="cuda", mesh=None,
                noise=None) -> torch.Tensor:
    """`num_samples` ALD chains from the complex SENSE `measurement` (S,
    1, H, W, C) with the CG L2Penalty proximal (`num_iters` iterations),
    in pair form (the CG on the line mask's normal kernel, as the serving
    engines run it): complex64 (num_samples, H, W, C). seg_model (the seg
    net) and seg_label (1, H, W) turn the guidance on. With a `mesh` the
    chains split over its data axis (padded to a multiple of it, the
    padding dropped). `noise(shape)` overrides the draws seeded with
    `seed`."""
    op = PairSENSE(lin_tfm.base.mask, lin_tfm.sens_maps.real.contiguous(),
                   lin_tfm.sens_maps.imag.contiguous())
    prox = PairL2Penalty.with_normal_kernel(op, num_iters=num_iters)

    def sampler(y, key):
        label = (None if seg_label is None
                 else repeat_measurement(seg_label, y.shape[1]))
        recon = make_stepped_pair_reconstructor(
            model, sigmas, op, prox, config, lr_scaled, seg_fn=seg_model,
            seg_label=label, seg_lamda=seg_lamda,
            seg_start_time=seg_start_time, seg_step_type=seg_step_type,
            seg_mode=seg_mode, device=device, mesh=mesh)
        xr, xi = recon(y.real.contiguous(), y.imag.contiguous(), seed=key,
                       noise=noise)
        return torch.complex(xr, xi)

    return run_sharded_ensemble(sampler, measurement, num_samples, seed,
                                mesh, measurement_batch_axis=1)


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
                   help="shard the ensemble chains over all local devices")
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

    lin_tfm = make_sense(args.sens_type, args.num_sens, args.R,
                         args.center_lines_frac, (s, s, 1), seed=args.seed,
                         num_frames=1).to(device)
    measurement = lin_tfm(x_true)                  # (S, 1, H, W, 1)
    zf = lin_tfm.conj_op(measurement)

    model, _ = reload_model(config, "Diffusion", args.ckpt_dir)
    model = model.to(device).eval()
    sigmas = get_sigmas(config, "recons")
    if args.proximal_type != "L2Penalty":
        # as in the JAX package, SENSE has no k-space projection
        raise ValueError(f"--proximal_type {args.proximal_type} needs the "
                         "operator's k-space projection, which SENSE lacks;"
                         " use L2Penalty")

    seg_model = None
    if args.seg_start_time < 1.0:
        seg_model, _ = reload_model(config, "Seg", args.seg_ckpt_dir)
        seg_model = seg_model.to(device).eval().requires_grad_(False)
        if args.seg_fraction < 1.0:
            seg_label = undersample_seg_mask(seg_label, args.seg_fraction,
                                             gen)

    cfg = ALDConfig(
        n_steps_each=args.num_steps_each or config.sampling.n_steps_each,
        step_lr=args.step_lr or config.sampling.step_lr)
    check_ladder_stability(sigmas, cfg.n_steps_each, cfg.step_lr)
    recons = reconstruct(
        model, sigmas, measurement, lin_tfm, cfg, args.num_samples,
        args.seed, args.lr_scaled, seg_model=seg_model,
        seg_label=None if seg_model is None else seg_label,
        seg_lamda=args.lamda, seg_start_time=args.seg_start_time,
        seg_step_type=args.seg_step_type, seg_mode=args.seg_mode,
        device=device, mesh=script_mesh(device) if args.use_mesh else None)

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
