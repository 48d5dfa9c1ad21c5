"""Class-conditional MNIST inverse sampling: ALD with classifier guidance
and the data-consistency gradient of an image-domain line-skip
measurement, on the GPU unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.mnist_inv_clf_sampling \\
      --ckpt_dir runs/MNIST_Diffusion_real-valued/ckpts \\
      --clf_ckpt_dir runs/MNIST_Clf/ckpts --cls 3 --num_samples 8

Port of inverseproblemwithdiffusionmodel_tpu/scripts/
mnist_inv_clf_sampling.py (reference: scripts/mnist_inv_clf_sampling.py,
whose `ALDInvClf` the JAX package re-grew as ald_inverse_clf): the test
digit `--sample_idx`, SkipLines applied to the image itself (keep every
`--num_skip_lines`-th row), the measurement repeated over --num_samples
chains, the MNIST prior (the model ladder) and the classifier
(`--clf_ckpt_dir`, a train_clf checkpoint), then
samplers.ald_variants.ald_inverse_clf. It takes the JAX script's flags plus
--device, saves the same artifacts, and prints the NRMSE and SSIM of the
chains' mean magnitude. Without a checkpoint a net keeps weights drawn
from a seed, with a loud warning.
"""
from __future__ import annotations

import argparse

import torch

from ._common import (add_common_args, apply_overrides, reload_model,
                      save_artifacts)
from ..config import load_config
from ..data import load_data
from ..models.registry import make_clf_fn, make_score_fn
from ..operators import SkipLines
from ..parallel import repeat_measurement
from ..samplers.ald import ALDConfig
from ..samplers.ald_variants import ald_inverse_clf
from ..samplers.sigmas import check_ladder_stability, get_sigmas
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim


def load_problem(args, config, device):
    """(the test digit (1, s, s, 1), the image-domain SkipLines, its
    measurement), the digit and measurement on `device`."""
    s = config.data.image_size
    kw = {"root_dir": args.data_root} if args.data_root else {}
    ds = load_data(args.ds_name, "test", size=s, **kw)
    idx = args.sample_idx
    img = torch.as_tensor(ds.data[idx:idx + 1]).to(device)
    lin_tfm = SkipLines(num_skip_lines=args.num_skip_lines, height=s)
    return img, lin_tfm, lin_tfm(img.to(torch.complex64))


def load_guided_nets(args, config, device):
    """(the score net, the classifier's `clf_fn`) on `device`; the
    classifier frozen, so that its guidance gradient is x's alone."""
    model, _ = reload_model(config, "Diffusion", args.ckpt_dir)
    clf, _ = reload_model(config, "Clf", args.clf_ckpt_dir)
    clf = clf.to(device).eval().requires_grad_(False)
    return model.to(device).eval(), make_clf_fn(clf)


def report(recons: torch.Tensor, img: torch.Tensor, zf: torch.Tensor) -> None:
    """Print the NRMSE and SSIM of the chains' mean magnitude against the
    digit, and the zero-filled NRMSE."""
    mean_mag = torch.abs(recons).mean(dim=0)
    truth = img[0]
    print(f"NRMSE {float(nrmse(mean_mag, truth)):.4f}  SSIM "
          f"{float(ssim(mean_mag[..., 0], truth[..., 0])):.4f}  (ZF NRMSE "
          f"{float(nrmse(torch.abs(zf[0]), truth)):.4f})")


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--ds_name", default="MNIST")
    p.add_argument("--cls", type=int, default=3, help="target class")
    p.add_argument("--num_skip_lines", type=int, default=2,
                   help="keep-stride: keep every Nth image row "
                        "(reference default 2)")
    p.add_argument("--lamda", type=float, default=1.0,
                   help="data-consistency weight")
    p.add_argument("--clf_lamda", type=float, default=1.0)
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

    config = apply_overrides(load_config(args.ds_name), args.override)
    img, lin_tfm, measurement = load_problem(args, config, device)
    y_b = repeat_measurement(measurement, args.num_samples)
    model, clf_fn = load_guided_nets(args, config, device)
    sigmas = get_sigmas(config)

    cfg = ALDConfig(
        n_steps_each=args.num_steps_each or config.sampling.n_steps_each,
        step_lr=args.step_lr or config.sampling.step_lr)
    check_ladder_stability(sigmas, cfg.n_steps_each, cfg.step_lr)
    cls = torch.full((args.num_samples,), args.cls, dtype=torch.long,
                     device=device)
    recons = ald_inverse_clf(make_score_fn(model, sigmas), clf_fn, cls,
                             sigmas, y_b, lin_tfm, args.lamda,
                             seed=args.seed, config=cfg,
                             clf_lamda=args.clf_lamda, device=device)

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
