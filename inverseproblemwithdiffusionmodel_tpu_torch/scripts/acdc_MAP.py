"""ACDC MAP reconstruction with a uniform line-skip mask, on the GPU unless
--device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.acdc_MAP \\
      --ckpt_dir runs/acdc_prior/ckpts --num_skip_lines 2 --lamda 0.1

Port of inverseproblemwithdiffusionmodel_tpu/scripts/acdc_MAP.py
(reference: scripts/acdc_MAP.py, UndersamplingFourier and the MAP
optimizer, UFMAP). `run_map` is shared with acdc_MAP_keep_center and
acdc_SENSE_MAP, which differ only in the operator. It takes the JAX
script's flags plus --device and saves the same artifacts. The synthetic
phase comes from a torch.Generator seeded with --seed, so it differs from
the JAX script's. --ckpt_dir is a training/checkpoint.Checkpointer
directory; without it the net takes weights drawn from a seed, with a
loud warning.
"""
from __future__ import annotations

import argparse

import torch

from ._common import apply_overrides, add_common_args, save_artifacts, reload_model
from ..config import load_config
from ..data import load_data
from ..models.registry import make_score_fn
from ..operators import UndersamplingFourier
from ..samplers.map_opt import MAPConfig, map_optimizer
from ..samplers.sigmas import get_sigmas
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim
from ..utils.misc import add_phase


def run_map(args, lin_tfm_factory):
    """MAP from A^H y on the test slice `--sample_idx` with its synthetic
    phase: prints NRMSE / SSIM of |x| and saves original, measurement, ZF
    and reconstructions. Returns the (1, H, W, 1) complex64
    reconstruction."""
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
    lin_tfm = lin_tfm_factory(s).to(device)
    measurement = lin_tfm(x_true)
    zf = lin_tfm.conj_op(measurement)

    model, _ = reload_model(config, "Diffusion", args.ckpt_dir)
    model = model.to(device).eval()
    sigmas = get_sigmas(config, "recons")

    cfg = MAPConfig(n_iters=args.n_iters or config.MAP.n_iters,
                    lr=args.lr or config.MAP.lr)
    recon = map_optimizer(make_score_fn(model, sigmas), measurement,
                          lin_tfm, args.lamda, cfg, device=device)

    truth = torch.abs(x_true[0])
    m_nrmse = float(nrmse(torch.abs(recon[0]), truth))
    m_ssim = float(ssim(torch.abs(recon[0, ..., 0]), truth[..., 0]))
    print(f"MAP: NRMSE {m_nrmse:.4f}  SSIM {m_ssim:.4f}")
    recon = recon.cpu().numpy()
    host = lambda t: t.cpu().numpy()
    run_dir = save_artifacts(args.save_dir, vars(args),
                             original=host(x_true),
                             measurement=host(measurement), ZF=host(zf),
                             reconstructions=recon)
    print(f"artifacts -> {run_dir}")
    return recon


def main(argv=None):
    # MAP is a deterministic optimizer from x0 = A^H y: no chain ensemble
    p = add_common_args(argparse.ArgumentParser(description=__doc__),
                        num_samples=False)
    p.add_argument("--ds_name", default="ACDC")
    p.add_argument("--num_skip_lines", type=int, default=2,
                   help="keep-stride: keep every Nth k-space line "
                        "(reference default 2 = R=2, acdc_MAP.py:30)")
    p.add_argument("--lamda", type=float, default=0.1, help="prior weight")
    p.add_argument("--n_iters", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--sample_idx", "--ds_idx", type=int, default=0,
                   help="test-set slice index (reference name: --ds_idx)")
    p.add_argument("--data_root", default=None)
    args = p.parse_args(argv)

    def factory(s):
        return UndersamplingFourier.create(args.num_skip_lines, s)

    return run_map(args, factory)


if __name__ == "__main__":
    main()
