"""Import a reference PyTorch (Lightning) checkpoint into a checkpoint of
the port that every sampling CLI here reads through ``--ckpt_dir``.

Migration path for users of the reference repo: their trained score priors
live in PL ``.ckpt`` files with EMA weights under
``callbacks.EMA.ema_state_dict`` (helpers/pl_callbacks.py:110-121). This
converts the NCSNv2-family weights (``Diffusion`` -> NCSNv2Deepest,
``Diffusion1D`` -> NCSN1D, ``Diffusion3D`` -> NCSN3DShallow;
helpers/load_model.py:23-31) into the port's net and writes a
``training.TrainState`` {params, ema, opt_state} at step 0 with
``training.Checkpointer`` (``<out_dir>/0/state.pt``):

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.import_torch_checkpoint \\
      --ckpt_path last.ckpt --ds_name ACDC --task_name Diffusion \\
      --mode real-imag --out_dir runs/imported/ckpts

Continuous-stack checkpoints (score_sde-style NCSN++/DDPM/NCSNv2 zoo; the
converter dispatches on ``config.model.name``) import through
``--continuous <config path>`` instead of --ds_name:

  python -m ... --ckpt_path ncsnpp.pth \\
      --continuous ve/cifar10_ncsnpp_continuous --out_dir runs/imported

Port of inverseproblemwithdiffusionmodel_tpu/scripts/
import_torch_checkpoint.py, with the same flags plus --device (the state
is built there; cuda by default).
"""
from __future__ import annotations

import argparse

from ._common import apply_overrides
from ..config import load_config
from ..models.registry import create_model, load_model
from ..training import Checkpointer, TrainState, get_optimizer
from ..utils.device import resolve_device
from ..utils.torch_import import (convert_continuous_state_dict,
                                  convert_ncsn_state_dict,
                                  load_torch_checkpoint)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt_path", required=True,
                   help="reference PL .ckpt or bare state-dict .pth")
    p.add_argument("--ds_name",
                   help="discrete-stack dataset config (NCSNv2 family)")
    p.add_argument("--continuous",
                   help="continuous-stack config path (NCSN++), e.g. "
                        "ve/cifar10_ncsnpp_continuous")
    p.add_argument("--task_name", default="Diffusion",
                   choices=["Diffusion", "Diffusion1D", "Diffusion3D"])
    p.add_argument("--mode", default="real-imag")
    p.add_argument("--out_dir", required=True,
                   help="checkpoint dir to write (training.Checkpointer)")
    p.add_argument("--raw_weights", action="store_true",
                   help="import the raw training weights instead of EMA")
    p.add_argument("--override", action="append", default=[],
                   help="dotted config overrides, e.g. model.ngf=128")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if bool(args.ds_name) == bool(args.continuous):
        p.error("exactly one of --ds_name / --continuous is required")
    device = resolve_device(args.device)     # no card: raise before work

    if args.continuous:
        from ..configs_continuous import get_continuous_config
        config = apply_overrides(get_continuous_config(args.continuous),
                                 args.override)
        model = create_model(config)
        convert = lambda sd: convert_continuous_state_dict(sd, model, config)
    else:
        config = apply_overrides(load_config(args.ds_name, args.mode),
                                 args.override)
        model, _ = load_model(config, args.task_name)
        convert = lambda sd: convert_ncsn_state_dict(sd, model)
    torch_sd = load_torch_checkpoint(args.ckpt_path,
                                     use_ema=not args.raw_weights)
    print(f"[import] loaded {len(torch_sd)} torch tensors from "
          f"{args.ckpt_path}")
    model.load_state_dict(convert(torch_sd), strict=True)
    print(f"[import] converted to the port's {type(model).__name__} (all "
          f"leaves matched)")

    model.to(device)
    state = TrainState.create(model, get_optimizer(config), ema_decay=0.999)
    ckpt = Checkpointer(args.out_dir, track_best=False)
    ckpt.save(0, state)
    ckpt.close()
    print(f"[import] wrote checkpoint to {args.out_dir} "
          f"(pass as --ckpt_dir to any sampling script)")
    return state


if __name__ == "__main__":
    main()
