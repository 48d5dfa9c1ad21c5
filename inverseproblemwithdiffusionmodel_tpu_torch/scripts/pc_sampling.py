"""Continuous-stack prior sampling: a leaf's net (NCSN++, DDPM++, DDPM,
NCSN v1 or NCSNv2) with its VE, VP or subVP SDE and the PC sampler, or the
probability-flow ODE sampler with --method ode, on the GPU unless --device
says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.pc_sampling \\
      --config ve/ffhq_256_ncsnpp_continuous --num_samples 2 \\
      --override model.num_scales=100
  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.pc_sampling \\
      --config vp/cifar10_ncsnpp_continuous --method ode --num_samples 16

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
from ..models.registry import continuous_model_fn, create_model
from ..sde import get_sampling_fn, get_score_fn
from ..training.checkpoint import Checkpointer
from ..utils.convert import seeded_weights


def first_cond(config) -> torch.Tensor:
    """The conditioning of the net's first forward, as the JAX main
    initializes its net with: the integer label 0 for NCSN v1, 0. for a
    positional embedding (a ladder index, or t * 999), else 1. (a sigma,
    or a DDPM label)."""
    if config.model.name in ("ncsn", "ncsn_deeper"):
        return torch.zeros(1, dtype=torch.int32)
    if config.model.get("embedding_type") == "positional":
        return torch.zeros(1)
    return torch.ones(1)


def main(argv=None):
    """Run the sampler; returns the samples as an NHWC numpy array, as the
    JAX package's main does. The printed line gives the number of network
    evaluations (nfe)."""
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
    model_fn = continuous_model_fn(model, config)
    sde = make_sde(config)
    s = config.data.image_size
    shape = (args.num_samples, s, s, config.data.num_channels)
    with torch.no_grad():
        # the first forward, on one zero image: the net takes the config's
        # shapes and conditioning
        x0 = torch.zeros((1,) + shape[1:], device=device)
        out = model_fn(x0, first_cond(config).to(device))
        if out.shape != x0.shape:
            raise ValueError(f"{config.model.name}: output {tuple(out.shape)}"
                             f" for input {tuple(x0.shape)}")
    sampling_fn = get_sampling_fn(config, sde, shape, device=device)
    score_fn = get_score_fn(sde, model_fn,
                            continuous=config.training.continuous)
    with torch.no_grad():
        samples, nfe = sampling_fn(score_fn, seed=args.seed)
    samples = samples.cpu().numpy()
    run_dir = save_artifacts(args.save_dir, vars(args), samples=samples)
    print(f"{samples.shape} samples (nfe={nfe}) -> {run_dir}")
    return samples


if __name__ == "__main__":
    main()
