"""Serve ALD reconstruction over HTTP from a score prior, on the GPU unless
--device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.serve_recon \\
      --ds_name ACDC --ckpt_dir runs/acdc_prior/ckpts --R 8 --chains 16 \\
      --dtype bf16 --port 8471

or the 2D+time (cine) workload with a spatial and a temporal prior:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.serve_recon \\
      --workload cine --ds_name CINE127 --ds_name_T CINE127_1D \\
      --mode_T diffusion1d --frames 24 --win_size 8 --R 8 --synth_sens

Port of inverseproblemwithdiffusionmodel_tpu/scripts/serve_recon.py:
builds a serving.ReconstructionEngine (2d) or a serving.
CineReconstructionEngine (cine) at a fixed geometry, runs it once
(--no_warmup skips that), then answers POST /reconstruct (k-space pair
in, ensemble mean/std out; serving/server.py has the wire protocol).
--ckpt_dir, --ckpt_dir_T and --seg_ckpt_dir are training/checkpoint.
Checkpointer directories; without them the nets take weights drawn from a
seed, with a loud warning. --seg_ckpt_dir builds a seg-guided 2-D engine.
--dtype int8 runs both workloads' score nets in bf16 with int8
convolutions (ops/quant.py; on the card K5-K7 of ops/csrc/int8conv.cu).
--data_shards N splits the chains over N cards (-1: every card torch
sees; --device cpu counts as one device), driven level by level from the
serving thread (serving/engine.py).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ._common import apply_overrides, reload_model
from ..config import load_config
from ..operators.fourier import MASK_PRESETS, _exp_sens_map
from ..operators.masks import generate_mask
from ..parallel.mesh import make_mesh
from ..samplers.sigmas import check_ladder_stability, get_sigmas, sigma_ladder
from ..serving import (CineEngineSpec, CineReconstructionEngine,
                       EngineSpec, ReconstructionEngine)
from ..serving.server import serve
from ..utils.device import resolve_device


def _ladder(config, levels: int):
    """The config's recons ladder, or `levels` levels of it."""
    if not levels:
        return get_sigmas(config, "recons")
    r = config.recons
    return sigma_ladder(r.sigma_begin, r.sigma_end, levels, r.sigma_dist)


def _synth_sens(args, size: int):
    """The reference's synthetic exp coil maps, SOS-normalized, as
    (coils, size, size, 1); None unless --synth_sens."""
    if not (args.num_sens and args.synth_sens):
        return None
    maps = np.stack([_exp_sens_map(size, size, args.seed + i)
                     for i in range(args.num_sens)])
    maps = maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))
    return maps[..., None]


def build_cine_engine(args, mesh=None) -> CineReconstructionEngine:
    """The 2D+time engine: the spatial prior of --ds_name, the temporal
    1-D prior of --ds_name_T on pixel tubes (where --mode_T uses it),
    per-frame R masks."""
    config_S = apply_overrides(load_config(args.ds_name, "real-imag"),
                               args.override)
    size = config_S.data.image_size
    model_S, _ = reload_model(config_S, "Diffusion", args.ckpt_dir)
    sigmas_S = _ladder(config_S, args.levels)
    model_T = sigmas_T = None
    if "diffusion1d" in args.mode_T:
        config_T = load_config(args.ds_name_T, "real-imag")
        model_T, _ = reload_model(config_T, "Diffusion1D", args.ckpt_dir_T)
        sigmas_T = get_sigmas(config_T, "recons")
    n_steps = args.num_steps_each or config_S.sampling.n_steps_each
    step_lr = args.step_lr or config_S.sampling.step_lr
    check_ladder_stability(sigmas_S, n_steps, step_lr)
    mask = None
    if args.R:
        mask = generate_mask(args.frames, size, seed=args.seed,
                             **MASK_PRESETS[args.R]).reshape(
                                 args.frames, 1, size, 1)
    spec = CineEngineSpec(height=size, width=size, frames=args.frames,
                          channels=config_S.data.channels,
                          num_sens=args.num_sens, chains=args.chains,
                          n_steps_each=n_steps, step_lr=step_lr,
                          lr_scaled=args.lr_scaled, mode_T=args.mode_T,
                          lamda_T=args.lamda_T, win_size=args.win_size,
                          if_random_shift=args.random_shift,
                          prox_iters=args.prox_iters, dtype=args.dtype,
                          mode=args.mode)
    return CineReconstructionEngine(
        model_S, sigmas_S, spec=spec, model_T=model_T, sigmas_T=sigmas_T,
        mask=mask, sens_re=_synth_sens(args, size), mesh=mesh,
        device=args.device)


def _serving_mesh(args):
    """The chain-sharding mesh of --data_shards N over N devices' `data`
    axis (-1: all of them), or None for 0 and 1. A count above the
    devices, or one that does not divide --chains, exits."""
    n = args.data_shards
    if n in (0, 1):
        return None
    device = resolve_device(args.device)
    available = torch.cuda.device_count() if device.type == "cuda" else 1
    if n == -1:
        n = available
    if n > available:
        raise SystemExit(f"--data_shards {n} exceeds the {available} "
                         "available devices")
    if args.chains % n:
        raise SystemExit(f"--chains {args.chains} must be a multiple of "
                         f"--data_shards {n}")
    devices = ([torch.device("cuda", i) for i in range(n)]
               if device.type == "cuda" else [device])
    return make_mesh(n_data=n, n_model=1, devices=devices)


def build_engine(args):
    resolve_device(args.device)        # no card: raise before building
    mesh = _serving_mesh(args)
    if args.workload == "cine":
        return build_cine_engine(args, mesh)
    config = apply_overrides(load_config(args.ds_name, "real-imag"),
                             args.override)
    size = config.data.image_size
    model, _ = reload_model(config, "Diffusion", args.ckpt_dir)
    sigmas = _ladder(config, args.levels)
    n_steps = args.num_steps_each or config.sampling.n_steps_each
    step_lr = args.step_lr or config.sampling.step_lr
    check_ladder_stability(sigmas, n_steps, step_lr)
    mask = None
    if args.R:
        mask = generate_mask(1, size, seed=args.seed, **MASK_PRESETS[args.R])
    sens_re = _synth_sens(args, size)
    seg_model = None
    if args.seg_ckpt_dir:
        seg_model, _ = reload_model(config, "Seg", args.seg_ckpt_dir)
    # pair-pipeline images are (B, H, W, C) with the Re/Im split on the
    # batch axis, so C is the config's per-part channel count (1 everywhere)
    spec = EngineSpec(height=size, width=size,
                      channels=config.data.channels,
                      num_sens=args.num_sens, chains=args.chains,
                      levels=int(sigmas.shape[0]), n_steps_each=n_steps,
                      step_lr=step_lr, lr_scaled=args.lr_scaled,
                      prox_iters=args.prox_iters, dtype=args.dtype,
                      mode=args.mode, seg_lamda=args.seg_lamda,
                      seg_start_time=args.seg_start_time,
                      seg_step_type=args.seg_step_type,
                      seg_mode=args.seg_mode)
    return ReconstructionEngine(model, sigmas, spec=spec, mask=mask,
                                sens_re=sens_re, seg_model=seg_model,
                                mesh=mesh, device=args.device)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", default="2d", choices=["2d", "cine"],
                   help="2d: single-volume ALD+prox; cine: 2D+time "
                        "factorized (spatial + temporal prior)")
    p.add_argument("--ds_name", default="ACDC")
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint dir of the trained score model "
                        "(training/checkpoint.Checkpointer)")
    # cine-only flags
    p.add_argument("--ds_name_T", default="CINE127_1D",
                   help="[cine] the temporal prior's dataset config")
    p.add_argument("--ckpt_dir_T", default=None,
                   help="[cine] checkpoint dir of the temporal 1-D prior")
    p.add_argument("--mode_T", default="diffusion1d",
                   choices=["tv", "diffusion1d", "none", "diffusion1d-only",
                            "tv-only"])
    p.add_argument("--lamda_T", type=float, default=1.0)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--win_size", type=int, default=8)
    p.add_argument("--random_shift", action="store_true",
                   help="[cine] random spatial shift de-aliasing")
    # seg-guided serving (reference headline recon)
    p.add_argument("--seg_ckpt_dir", default=None,
                   help="checkpoint dir of a trained seg UNet; enables "
                        "guided serving (requests pass seg_label maps)")
    p.add_argument("--seg_lamda", type=float, default=1.0)
    p.add_argument("--seg_start_time", type=float, default=0.0,
                   help="guidance ramp start as a ladder fraction "
                        "(1.0 = ramp never activates)")
    p.add_argument("--seg_step_type", default="linear",
                   choices=["linear", "constant"])
    p.add_argument("--seg_mode", default="full", choices=["full", "FG"])
    p.add_argument("--R", type=int, default=8, choices=[0, 8, 16, 20],
                   help="default undersampling mask preset (0 = fully "
                        "sampled default; requests may override per call)")
    p.add_argument("--num_sens", type=int, default=4,
                   help="coil count (0 = single-coil masked Fourier)")
    p.add_argument("--synth_sens", action="store_true",
                   help="default coil maps = the reference's synthetic exp "
                        "family (else uniform; requests may override)")
    p.add_argument("--chains", type=int, default=16,
                   help="ensemble chains per request (the batch)")
    p.add_argument("--data_shards", type=int, default=1,
                   help="shard the chain ensemble over this many devices' "
                        "`data` mesh axis (-1 = all; must divide --chains)")
    p.add_argument("--levels", type=int, default=0,
                   help="override the recons ladder length (0 = config)")
    p.add_argument("--num_steps_each", type=int, default=None)
    p.add_argument("--step_lr", type=float, default=None)
    p.add_argument("--lr_scaled", type=float, default=5.0)
    p.add_argument("--prox_iters", type=int, default=4)
    p.add_argument("--dtype", default="bf16",
                   choices=["f32", "bf16", "int8"])
    p.add_argument("--mode", default="steps", choices=["scan", "steps"],
                   help="both run the host loop over levels in the port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the start-up run (the first request pays it)")
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(args)
    if not args.no_warmup:
        print(f"[serve] warming up at {engine.spec} ...", flush=True)
        print(f"[serve] warm in {engine.warmup():.1f}s", flush=True)
    serve(engine, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
