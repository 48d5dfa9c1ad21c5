"""MNIST MAP inpainting of an image-domain line-skip measurement, on the
GPU unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.mnist_MAP \\
      --ckpt_dir runs/MNIST_Diffusion_real-imag/ckpts --num_skip_lines 2

Port of inverseproblemwithdiffusionmodel_tpu/scripts/mnist_MAP.py
(reference: scripts/mnist_MAP.py, the `Inpainting` MAP optimizer over
SkipLines applied to the image itself, mnist_MAP.py:66): the test digit
`--sample_idx` as complex64, the MNIST prior on its `recons` ladder, then
samplers.map_opt.map_optimizer from A^H y (the config's MAP.n_iters Adam
iterations at MAP.lr unless --n_iters / --lr say otherwise). It takes the
JAX script's flags plus --device, prints the NRMSE of |x| and saves the
same artifacts. MAP is deterministic: one chain, no --num_samples.
"""
from __future__ import annotations

import argparse

import torch

from ._common import (add_common_args, apply_overrides, reload_model,
                      save_artifacts)
from .mnist_inv_clf_sampling import load_problem
from ..config import load_config
from ..models.registry import make_score_fn
from ..samplers.map_opt import MAPConfig, map_optimizer
from ..samplers.sigmas import get_sigmas
from ..utils.device import resolve_device
from ..utils.metrics import nrmse


def main(argv=None):
    # MAP is a deterministic optimizer from x0 = A^H y: no chain ensemble
    p = add_common_args(argparse.ArgumentParser(description=__doc__),
                        num_samples=False)
    p.add_argument("--ds_name", default="MNIST")
    p.add_argument("--num_skip_lines", type=int, default=2,
                   help="keep-stride: keep every Nth image row "
                        "(reference default 2)")
    p.add_argument("--lamda", type=float, default=0.1)
    p.add_argument("--n_iters", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--sample_idx", "--ds_idx", type=int, default=0,
                   help="test-set slice index (reference name: --ds_idx)")
    p.add_argument("--data_root", default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)   # no card: raise before any work

    config = apply_overrides(load_config(args.ds_name, "real-imag"),
                             args.override)
    img, lin_tfm, measurement = load_problem(args, config, device)
    x_true = img.to(torch.complex64)
    zf = lin_tfm.conj_op(measurement)

    model, _ = reload_model(config, "Diffusion", args.ckpt_dir)
    model = model.to(device).eval()
    sigmas = get_sigmas(config, "recons" if "recons" in config
                        else "unconditioned")

    cfg = MAPConfig(n_iters=args.n_iters or config.MAP.n_iters,
                    lr=args.lr or config.MAP.lr)
    recon = map_optimizer(make_score_fn(model, sigmas), measurement,
                          lin_tfm, args.lamda, cfg, device=device)

    print(f"MAP inpainting NRMSE "
          f"{float(nrmse(torch.abs(recon[0]), torch.abs(x_true[0]))):.4f}")
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
