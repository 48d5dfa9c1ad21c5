"""Class-conditional MNIST inverse sampling with proximal data consistency
on the Re/Im split, on the GPU unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.mnist_inv_clf_prox_sampling \\
      --ckpt_dir runs/MNIST_Diffusion_real-imag/ckpts \\
      --clf_ckpt_dir runs/MNIST_Clf/ckpts --cls 3 --proximal L2Penalty

Port of inverseproblemwithdiffusionmodel_tpu/scripts/
mnist_inv_clf_prox_sampling.py (reference: scripts/
mnist_inv_clf_prox_sampling.py, whose `ALDInvClfProximal` the JAX package
re-grew as ald_inverse_clf_proximal): the MNIST config in its real-imag
mode and its `recons` ladder, the image-domain SkipLines measurement of
mnist_inv_clf_sampling, --proximal L2Penalty (CG) or Constrained (the
projection) on SkipLines (SingleCoil assumes a masked Fourier operator),
and the classifier guidance ramped from --clf_start_time by
--clf_step_type. It takes the JAX script's flags plus --device, saves the
same artifacts, prints the NRMSE and SSIM of the chains' mean magnitude,
and returns the complex64 reconstructions.
"""
from __future__ import annotations

import argparse

import torch

from ._common import add_common_args, apply_overrides, save_artifacts
from .mnist_inv_clf_sampling import load_guided_nets, load_problem, report
from ..config import load_config
from ..models.registry import make_score_fn
from ..operators import get_proximal
from ..parallel import repeat_measurement
from ..samplers.ald import ALDConfig
from ..samplers.ald_variants import ald_inverse_clf_proximal
from ..samplers.sigmas import check_ladder_stability, get_sigmas
from ..utils.device import resolve_device


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--ds_name", default="MNIST")
    p.add_argument("--cls", type=int, default=3)
    p.add_argument("--num_skip_lines", type=int, default=2,
                   help="keep-stride: keep every Nth image row "
                        "(reference default 2)")
    p.add_argument("--lr_scaled", type=float, default=5.0)
    p.add_argument("--clf_lamda", "--lamda", type=float, default=1.0,
                   help="classifier-guidance weight (reference name: --lamda)")
    p.add_argument("--clf_start_time", type=float, default=0.0,
                   help="guidance ramp start as a ladder fraction "
                        "(reference default 0)")
    p.add_argument("--clf_step_type", default="linear")
    # SingleCoil's closed form assumes a masked-Fourier operator; the
    # image-domain SkipLines measurement supports the CG and projection forms
    p.add_argument("--proximal", "--proximal_type", default="L2Penalty",
                   choices=["L2Penalty", "Constrained"])
    p.add_argument("--clf_ckpt_dir", default=None)
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
    img, lin_tfm, measurement = load_problem(args, config, device)
    y_b = repeat_measurement(measurement, args.num_samples)
    model, clf_fn = load_guided_nets(args, config, device)
    sigmas = get_sigmas(config, "recons" if "recons" in config
                        else "unconditioned")

    cfg = ALDConfig(
        n_steps_each=args.num_steps_each or config.sampling.n_steps_each,
        step_lr=args.step_lr or config.sampling.step_lr)
    check_ladder_stability(sigmas, cfg.n_steps_each, cfg.step_lr)
    cls = torch.full((args.num_samples,), args.cls, dtype=torch.long,
                     device=device)
    proximal = get_proximal(args.proximal)(lin_tfm=lin_tfm)
    recons = ald_inverse_clf_proximal(
        make_score_fn(model, sigmas), clf_fn, cls, sigmas, y_b, lin_tfm,
        proximal, seed=args.seed, config=cfg, lr_scaled=args.lr_scaled,
        clf_lamda=args.clf_lamda, clf_start_time=args.clf_start_time,
        clf_step_type=args.clf_step_type, device=device)

    zf = lin_tfm.conj_op(measurement)
    report(recons, img, zf)
    recons = recons.cpu().numpy()
    host = lambda t: t.cpu().numpy()
    run_dir = save_artifacts(args.save_dir, vars(args), original=host(img),
                             measurement=host(measurement), ZF=host(zf),
                             reconstructions=recons)
    print(f"artifacts -> {run_dir}")
    return recons


if __name__ == "__main__":
    main()
