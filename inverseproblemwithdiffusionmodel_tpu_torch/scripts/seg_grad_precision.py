"""How accurate the segmentation guidance gradient is in float32, layer by
layer, on the GPU unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.seg_grad_precision \\
      --size 256 --batch 2

The seg UNet of the general config at full width (weights from --seed),
x standard normal (seeded) and a disk label: samplers/ald.compute_seg_grad
in float64 on the CPU is the reference. Against it, relative L2 of the
gradient with respect to x computed on --device in float32 with TF32 off
(utils/precision.float32_exact) and with torch's defaults, in float64 on
--device, and in float32 on the CPU; then, per UNet submodule, of the
gradient at its output in float32 on the CPU and on --device with TF32
off (backward hooks), which shows where the float32 backward loses
digits. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json

import numpy as np
import torch

from ..models.registry import load_model, make_seg_fn
from ..samplers.ald import compute_seg_grad
from ..utils.device import resolve_device
from ..utils.precision import float32_exact


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def _grad(seg, x, label, dtype, device, grads_at=None):
    """compute_seg_grad of a `dtype` copy of `seg` on `device`; with
    `grads_at` (a dict), also the gradient at each submodule's output."""
    net = copy.deepcopy(seg).to(device, dtype)

    def keep(name):
        def hook(module, grad_in, grad_out):
            grads_at[name] = grad_out[0].detach().double().cpu()
        return hook

    hooks = [] if grads_at is None else [
        module.register_full_backward_hook(keep(name))
        for name, module in net.named_children()]
    try:
        return compute_seg_grad(make_seg_fn(net), x.to(device, dtype),
                                label.to(device)).cpu()
    finally:
        for hook in hooks:
            hook.remove()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    seg, _ = load_model(None, "Seg", seed=args.seed)
    seg.requires_grad_(False)
    gen = torch.Generator().manual_seed(args.seed)
    n = args.size
    x = torch.randn(args.batch, n, n, 1, generator=gen)
    hh, ww = np.mgrid[0:n, 0:n] - (n - 1) / 2
    disk = torch.from_numpy((hh ** 2 + ww ** 2 <= (n / 4) ** 2).astype(
        np.int64))
    label = disk.expand(args.batch, n, n).contiguous()
    at64, at32, at32_dev = {}, {}, {}
    ref = _grad(seg, x, label, torch.float64, "cpu", at64)
    out = {"size": n, "batch": args.batch, "device": str(device),
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu")}
    for name, dtype, mode, grads_at in (
            ("f32_exact", torch.float32, float32_exact, at32_dev),
            ("f32_defaults", torch.float32, contextlib.nullcontext, None),
            ("f64", torch.float64, contextlib.nullcontext, None)):
        with mode():
            out[f"{name}_vs_cpu_f64"] = _rel(
                _grad(seg, x, label, dtype, device, grads_at), ref)
    out["cpu_f32_vs_cpu_f64"] = _rel(
        _grad(seg, x, label, torch.float32, "cpu", at32), ref)
    for name, got in (("cpu_f32", at32), ("f32_exact", at32_dev)):
        out[f"{name}_per_layer"] = {layer: _rel(got[layer], at64[layer])
                                    for layer in at64}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
