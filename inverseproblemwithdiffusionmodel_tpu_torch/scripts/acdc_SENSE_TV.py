"""ACDC SENSE TV-regularized least-squares baseline (prior-free), on the GPU
unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.acdc_SENSE_TV \\
      --R 8 --num_sens 4 --reg_weight 1e-3

Port of inverseproblemwithdiffusionmodel_tpu/scripts/acdc_SENSE_TV.py
(reference: scripts/acdc_SENSE_TV.py, kornia's TotalVariation inside a
Lightning "training" loop, TrainMAPModel); here samplers.map_opt.
tv_reconstruction, Adam on the autograd gradient. It takes the JAX
script's flags plus --device (--num_epochs, --log_dir and --num_workers
are the reference's names) and saves the same artifacts; the synthetic
phase comes from a torch.Generator seeded with --seed.
"""
from __future__ import annotations

import argparse

import torch

from ._common import apply_overrides, add_common_args, save_artifacts
from ..config import load_config
from ..data import load_data
from ..operators import make_sense
from ..samplers.map_opt import MAPConfig, tv_reconstruction
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim
from ..utils.misc import add_phase


def main(argv=None):
    # TV is prior-free (no score checkpoint) and deterministic (no ensemble)
    p = add_common_args(argparse.ArgumentParser(description=__doc__),
                        num_samples=False, ckpt=False)
    p.add_argument("--ds_name", default="ACDC")
    p.add_argument("--R", type=int, default=8, choices=[8, 16, 20])
    p.add_argument("--num_sens", type=int, default=4)
    p.add_argument("--sens_type", default="exp", choices=["exp"],
                   help="synthetic coil-map family (reference default exp)")
    p.add_argument("--center_lines_frac", type=float, default=1 / 16)
    p.add_argument("--reg_weight", type=float, default=1e-3)
    p.add_argument("--n_iters", "--num_epochs", type=int, default=None,
                   help="Adam iterations (reference name: "
                        "--num_epochs, Lightning epochs over the "
                        "single measurement)")
    p.add_argument("--log_dir", default=None,
                   help="accepted for reference CLI compatibility; "
                        "alias of --save_dir")
    p.add_argument("--num_workers", type=int, default=0,
                   help="accepted for reference CLI compatibility; "
                        "unused: one measurement needs no loader workers")

    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--sample_idx", "--ds_idx", type=int, default=0,
                   help="test-set slice index (reference name: --ds_idx)")
    p.add_argument("--data_root", default=None)
    args = p.parse_args(argv)
    if args.log_dir:
        args.save_dir = args.log_dir
    device = resolve_device(args.device)   # no card: raise before any work

    config = apply_overrides(load_config(args.ds_name, "real-imag"),
                             args.override)
    s = config.data.image_size
    kw = {"image_size": s}
    if args.data_root:
        kw["root_dir"] = args.data_root
    ds = load_data(args.ds_name, "test", **kw)
    img = torch.as_tensor(ds.data[args.sample_idx:args.sample_idx + 1]).to(
        device)

    gen = torch.Generator(device).manual_seed(args.seed)
    x_true = add_phase(img, gen)                   # complex (1, H, W, 1)
    lin_tfm = make_sense(args.sens_type, args.num_sens, args.R,
                         args.center_lines_frac, (s, s, 1), seed=args.seed,
                         num_frames=1).to(device)
    measurement = lin_tfm(x_true)
    zf = lin_tfm.conj_op(measurement)

    cfg = MAPConfig(n_iters=args.n_iters or config.MAP.n_iters,
                    lr=args.lr or config.MAP.lr)
    recon = tv_reconstruction(measurement, lin_tfm, args.reg_weight, cfg,
                              device=device)

    truth = torch.abs(x_true[0])
    m_nrmse = float(nrmse(torch.abs(recon[0]), truth))
    m_ssim = float(ssim(torch.abs(recon[0, ..., 0]), truth[..., 0]))
    print(f"TV: NRMSE {m_nrmse:.4f}  SSIM {m_ssim:.4f}")
    recon = recon.cpu().numpy()
    host = lambda t: t.cpu().numpy()
    run_dir = save_artifacts(args.save_dir, vars(args),
                             original=host(x_true),
                             measurement=host(measurement), ZF=host(zf),
                             reconstructions=recon)
    print(f"artifacts -> {run_dir}")
    return recon


if __name__ == "__main__":
    main()
