"""Export a training run's prior as a bf16 artifact, on the port: the
tool of examples/export_prior_artifact.py, with its flags.

Reads the run's rolling checkpoint, the JAX script's `train_state.ckpt`
(Flax msgpack: step, params, Adam moments, EMA) or the port's
`train_state.pt` (examples/train_acdc_prior), and writes the durable
form: `raw_bf16.msgpack` and `ema_bf16.msgpack` (the raw and EMA params
as bfloat16 Flax trees, in the JAX package's layout: the JAX script's
bytes for a JAX checkpoint) and `META.json` (step, settings fingerprint,
source). Adam moments are dropped (train_acdc_prior --warm_start).

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
export_prior_artifact --run runs/acdc_prior_80k --out artifacts/acdc_prior
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from . import _common as C
from ..models.registry import get_network
from ..utils import artifacts, flax_msgpack


def _port_trees(path):
    """(step, raw tree, EMA tree) of a port checkpoint, in the Flax layout
    of the NCSNv2-family net `get_network` builds at the checkpoint's
    image size and width."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    net = state["net"]
    model = get_network(C.ncsn_config(1, net["size"], net["ngf"]))
    trees = []
    for params in (state["params"], state["ema"]["params"]):
        model.load_state_dict(params)
        trees.append(artifacts.prior_tree(model))
    return int(state["step"]), trees[0], trees[1]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", default="runs/acdc_prior_80k")
    p.add_argument("--out", default="artifacts/acdc_prior")
    args = p.parse_args(argv)

    jax_ckpt = os.path.join(args.run, "train_state.ckpt")
    port_ckpt = os.path.join(args.run, "train_state.pt")
    if os.path.exists(jax_ckpt):
        ckpt = jax_ckpt
        ts = artifacts.read_train_state(ckpt)
        step, raw, ema = ts["step"], ts["params"], ts["ema"]
    elif os.path.exists(port_ckpt):
        ckpt = port_ckpt
        step, raw, ema = _port_trees(ckpt)
    else:
        raise SystemExit(f"no train_state.ckpt or train_state.pt in "
                         f"{args.run}")
    os.makedirs(args.out, exist_ok=True)
    for name, tree in (("raw_bf16.msgpack", raw), ("ema_bf16.msgpack", ema)):
        flax_msgpack.save(os.path.join(args.out, name),
                          artifacts.cast_tree(tree, "bfloat16"))
    fp_path = ckpt + ".fp"
    meta = {"step": step,
            "fingerprint": (open(fp_path).read().strip()
                            if os.path.exists(fp_path) else None),
            "source": ckpt}
    with open(os.path.join(args.out, "META.json"), "w") as f:
        json.dump(meta, f, indent=2)
    size = os.path.getsize(os.path.join(args.out, "raw_bf16.msgpack"))
    print(f"exported step {step} -> {args.out} "
          f"(raw+ema bf16, {size / 1e6:.0f} MB each)")
    return meta


if __name__ == "__main__":
    main()
