"""Unconditional ALD prior sampling from a 2-D, 1-D or 3-D score net, on
the GPU unless --device says otherwise, e.g. the README quick start's

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.unconditioned_sampling \\
      --ds_name MNIST --ckpt_dir runs/MNIST_Diffusion_real-valued/ckpts

Port of inverseproblemwithdiffusionmodel_tpu/scripts/unconditioned_sampling.py
(reference: scripts/unconditioned_sampling.py, reload_model ->
ALDUnconditionalSampler), with its flags plus --device. --task_name
Diffusion samples (num_samples, s, s, C) images, Diffusion1D (num_samples,
T, C) tubes, Diffusion3D (num_samples, win, win, T, C3) volumes, win^2 =
config.data.channels. The samples go to samples.npy with args.json under a
timestamped --save_dir directory. --if_save_fig draws the first four 1-D
signals (signals.png) and --if_save_as_gif the first sample's (T, H, W)
volume as sample0.gif, as the JAX script does (utils/visualizations:
matplotlib and Pillow, imported only then). It prints the
sampler's network evaluations per second between CUDA synchronizations
(the config, model and weight set-up apart) and the wall seconds.
--use_mesh splits the chains over every card torch sees (the one CPU
device with --device cpu) as the JAX script shards them: the start is
padded to a multiple of the cards with copies of the last chain
(parallel.run_sharded_ensemble), which are dropped, and every net
evaluation runs each card's block of chains on that card's replica of the
net. The sampler's loop, its noise and its updates stay the run's without
the mesh, so the samples are that run's where no chain was padded.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ._common import (add_common_args, apply_overrides, reload_model,
                      save_artifacts, script_mesh)
from ..config import load_config
from ..models.ncsn3d import tube_window
from ..models.registry import make_score_fn
from ..parallel import run_sharded_ensemble
from ..samplers.ald import ALDConfig, ald_unconditional_sampler
from ..samplers.ald_pair import replica_placer
from ..samplers.sigmas import check_ladder_stability, get_sigmas
from ..utils.device import resolve_device, synchronize

def _mesh_score_fn(model, sigmas, mesh):
    """make_score_fn over the mesh's data axis: a replica of the net on
    each device takes its block of the batch, and the scores are gathered
    on the batch's device. The blocks run in step, one net evaluation at a
    time."""
    devices, cache = mesh.data_devices, {}
    fns = [make_score_fn(replica_placer(d, cache)(model), sigmas)
           for d in devices]
    n = len(fns)

    def score_fn(x, labels):
        outs = [fn(xc.to(d), lc.to(d)) for fn, d, xc, lc in
                zip(fns, devices, x.chunk(n), labels.chunk(n))]
        return torch.cat([o.to(x.device) for o in outs])

    return fns[0] if n == 1 else score_fn


def _sharded_samples(model, sigmas, shape, cfg, seed: int, device):
    """--use_mesh: the start U(0, 1) and the noise drawn as the unsharded
    sampler draws them, the chains padded for the mesh and sampled with
    the net split over it, the padding dropped."""
    mesh = script_mesh(device)
    gen = torch.Generator(device).manual_seed(seed)
    x_init = torch.rand(shape, generator=gen, device=device)
    noise = lambda s: torch.randn(tuple(s), generator=gen, device=device)
    return run_sharded_ensemble(
        lambda x0, _: ald_unconditional_sampler(
            _mesh_score_fn(model, sigmas, mesh), sigmas, x0.shape,
            config=cfg, x_init=x0, noise=noise, device=device),
        x_init, 1, seed, mesh)


def sample_shape(config, task_name: str, num_samples: int) -> tuple:
    """The channel-last shape the task's net samples (the JAX script's
    :44-54)."""
    data = config.data
    if task_name == "Diffusion1D":
        return (num_samples, data.image_size, data.channels)
    if task_name == "Diffusion3D":
        win = tube_window(config)
        return (num_samples, win, win, data.image_size,
                data.get("channels_3d", 1))
    s = data.image_size
    return (num_samples, s, s, data.channels)


def main(argv=None):
    t_main = time.perf_counter()
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--ds_name", default="MNIST")
    p.add_argument("--task_name", default="Diffusion",
                   choices=["Diffusion", "Diffusion1D", "Diffusion3D"])
    p.add_argument("--mode", default="real-valued")
    p.add_argument("--step_lr", type=float, default=None)
    p.add_argument("--n_steps_each", "--num_steps_each",
                   type=int, default=None)
    p.add_argument("--if_save_fig", action="store_true")
    p.add_argument("--if_save_as_gif", action="store_true")
    p.add_argument("--use_mesh", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device(args.device)   # no card: raise before any work

    config = apply_overrides(load_config(args.ds_name, args.mode),
                             args.override)
    model, _ = reload_model(config, args.task_name, args.ckpt_dir)
    model = model.to(device).eval()
    sigmas = get_sigmas(config)
    shape = sample_shape(config, args.task_name, args.num_samples)
    cfg = ALDConfig(
        n_steps_each=args.n_steps_each or config.sampling.n_steps_each,
        step_lr=args.step_lr or config.sampling.step_lr,
        denoise=config.sampling.get("denoise", True))
    check_ladder_stability(sigmas, cfg.n_steps_each, cfg.step_lr)

    synchronize(device)
    t_run = time.perf_counter()
    if args.use_mesh:
        samples = _sharded_samples(model, sigmas, shape, cfg, args.seed,
                                   device)
    else:
        samples = ald_unconditional_sampler(
            make_score_fn(model, sigmas), sigmas, shape, seed=args.seed,
            config=cfg, device=device)
    synchronize(device)
    sampler_s = time.perf_counter() - t_run
    nfe = len(sigmas) * cfg.n_steps_each + int(cfg.denoise)
    print(f"ALD prior sampling: {nfe} network evaluations at batch "
          f"{args.num_samples} in {sampler_s:.4f} s, {nfe / sampler_s:.2f} "
          f"evaluations/s (set-up apart); wall "
          f"{time.perf_counter() - t_main:.2f} s")

    samples = samples.cpu().numpy()
    run_dir = save_artifacts(args.save_dir, vars(args), samples=samples)
    if args.if_save_fig and samples.ndim == 3:      # (B, T, C) 1-D signals
        from ..utils.visualizations import vis_signals
        vis_signals(*[samples[i] for i in range(min(4, len(samples)))],
                    save_path=os.path.join(run_dir, "signals.png"))
    if args.if_save_as_gif:
        from ..utils.visualizations import save_vol_as_gif
        vol = None
        if samples.ndim == 5:      # (B, win, win, T, C) 3-D net volumes
            vol = np.moveaxis(samples[0][..., 0], -1, 0)     # (T, H, W)
        elif samples.ndim == 3:    # (B, T, k^2) pixel tubes (1-D nets)
            k = int(np.sqrt(samples.shape[-1]))
            if k * k == samples.shape[-1]:
                vol = samples[0].reshape(-1, k, k)            # (T, k, k)
        if vol is not None:
            save_vol_as_gif(vol, os.path.join(run_dir, "sample0.gif"))
        else:
            print("--if_save_as_gif: only 1-D tube or 3-D volume samples "
                  "have a temporal axis to animate; skipped")
    print(f"saved {samples.shape} samples -> {run_dir}")
    return samples


if __name__ == "__main__":
    main()
