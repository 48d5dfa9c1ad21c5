"""Continuous-stack prior sampling: NCSN++ with the VE SDE and the PC
sampler, on the GPU unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.pc_sampling \\
      --config ve/ffhq_256_ncsnpp_continuous --num_samples 2 \\
      --override model.num_scales=100

Port of inverseproblemwithdiffusionmodel_tpu/scripts/pc_sampling.py. With
--ckpt_dir (a training/checkpoint.Checkpointer directory, `<log_dir>/ckpts`
of a training run) the network takes the latest checkpoint's EMA weights;
without it, weights drawn from --seed (utils/convert.seeded_weights).
"""
from __future__ import annotations

import argparse

import torch

from ._common import apply_overrides, save_artifacts
from ..configs_continuous import get_continuous_config, make_sde
from ..models.registry import create_model
from ..sde import get_sampling_fn, get_score_fn
from ..training.checkpoint import Checkpointer
from ..utils.convert import seeded_weights


def main(argv=None):
    """Run the sampler; returns (samples as an NHWC numpy array, nfe)."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="ve/cifar10_ncsnpp_continuous")
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--method", default=None, choices=[None, "pc", "ode"])
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--save_dir", default="outputs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                           "pass --device cpu to run on the CPU")
    config = apply_overrides(get_continuous_config(args.config),
                             args.override)
    if args.method:
        config = config.replace(**{"sampling.method": args.method})

    model = create_model(config)
    if args.ckpt_dir:
        # params only, the EMA shadow where the checkpoint has one
        ckpt = Checkpointer(args.ckpt_dir, track_best=False)
        params, step = ckpt.restore_params(use_ema=True)
        ckpt.close()
        model.load_state_dict(params, strict=True)
        print(f"restored step {step} from {args.ckpt_dir}")
    else:
        seeded_weights(model, args.seed)
        print("WARNING: sampling with random weights drawn from --seed "
              f"{args.seed} (no --ckpt_dir)")
    model = model.to(device).eval()
    sde = make_sde(config)
    s = config.data.image_size
    shape = (args.num_samples, s, s, config.data.num_channels)
    sampling_fn = get_sampling_fn(config, sde, shape, device=device)
    score_fn = get_score_fn(sde, model,
                            continuous=config.training.continuous)
    with torch.no_grad():
        samples, nfe = sampling_fn(score_fn, seed=args.seed)
    samples = samples.cpu().numpy()
    run_dir = save_artifacts(args.save_dir, vars(args), samples=samples)
    print(f"{samples.shape} samples (nfe={nfe}) -> {run_dir}")
    return samples, nfe


if __name__ == "__main__":
    main()
