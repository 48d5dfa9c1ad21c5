#!/usr/bin/env python3
"""Where a train step split over the mesh's model axis parts from the
plain step on one card, and how far float32 rounding alone moves the
plain step: the readings behind chip_smoke.py's `tp` gate (PERF.md §6,
PR 22).

  python3 tp_gate.py              # step by step, float32_exact
  python3 tp_gate.py --controls   # benchmark mode against heuristics

The deployed ACDC prior (NCSNv2Deepest, 256 px, ngf 128, weights from
seed 0; the ACDC config in train_ncsn's default mode), 3 steps at batch
8 on seeded batches and injected labels and noise, as chip_smoke.tp_phase
runs it; the split state on two entries of the card. Each comparison
reports, against the plain step, the largest |a - b| - 1e-3 |b| over the
parameters (how far past JAX's rtol; JAX's atol is 1e-5), the loss's
relative difference and the first step's gradient rel L2.

- default: after each step, the plain step run again, the plain step on
  a first batch one float32 ulp away, and the split step; at the worst
  entry, each run's gradient at every step so far.
- --controls: in float32_exact (cuDNN's benchmark mode) and with cuDNN's
  heuristics and deterministic algorithms, the plain step run again and
  the split step, after 3 steps.

Writes chiprun_out/tp_gate_steps.json or tp_gate_controls.json. Needs a
card.
"""
import argparse
import copy
import json
import os
import time

import numpy as np
import torch

import chip_smoke as cs
from inverseproblemwithdiffusionmodel_tpu_torch import parallel
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    get_network)
from inverseproblemwithdiffusionmodel_tpu_torch.parallel import tp
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
    get_sigmas)
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    TrainState, get_optimizer, make_score_train_step)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    seeded_weights)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
    float32_exact)

B, S, STEPS = 8, 256, 3


def heuristics():
    """cuDNN's heuristics and deterministic algorithms, TF32 off."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class Job:
    """The net, the batches and the draws, and one run of the step."""

    def __init__(self):
        self.cfg = load_config("ACDC", "real-valued")
        self.net0 = seeded_weights(get_network(self.cfg), seed=0)
        rs = np.random.RandomState(5)
        self.batches = [torch.from_numpy(rs.rand(B, S, S, 1).astype(
            np.float32)) for _ in range(STEPS)]
        self.draws = [dict(labels=torch.from_numpy(rs.randint(
            0, self.cfg.model.num_classes, B)).cuda(), noise=torch.from_numpy(
                rs.randn(B, S, S, 1).astype(np.float32)).cuda())
            for _ in range(STEPS)]
        self.card = torch.device("cuda", 0)
        self.mesh = parallel.make_mesh(n_data=1, n_model=2,
                                       devices=[self.card, self.card])

    def run(self, split=False, ulp=False, mode=float32_exact):
        """Per step: the loss, the parameters and the gradients (gathered
        by plain name)."""
        state = TrainState.create(copy.deepcopy(self.net0).to(self.card),
                                  get_optimizer(self.cfg), ema_decay=0.999)
        if split:
            state = parallel.shard_tp(state, self.mesh)
        step = make_score_train_step(
            state.model, get_sigmas(self.cfg),
            mesh=self.mesh if split else None, tp=split)
        record = []
        with mode():
            for i, (b, d) in enumerate(zip(self.batches, self.draws)):
                if ulp and i == 0:
                    b = torch.nextafter(b, torch.full_like(b, 2.0))
                state, loss = step(state, b, **d)
                grads = {}
                for name, sp, ts in tp.entries(state.model):
                    g = [t.grad for t in ts]
                    grads[name] = (g[0] if sp is None else sp.whole(
                        g)).detach().clone()
                record.append(dict(loss=float(loss), grads=grads, params={
                    k: v.detach().clone() for k, v in state.params.items()}))
        del state
        torch.cuda.empty_cache()
        return record


def excess(pa, pb):
    """The largest |a - b| - 1e-3 |b| over the parameters, and where."""
    worst, name = -1.0, None
    for k in pb:
        e = ((pa[k] - pb[k]).abs() - 1e-3 * pb[k].abs()).max().item()
        if e > worst:
            worst, name = e, k
    return worst, name


def grad_rel_l2(ga, gb):
    diff = torch.cat([(ga[n] - gb[n]).flatten() for n in gb]).norm()
    return (diff / torch.cat([gb[n].flatten() for n in gb]).norm()).item()


def step_by_step(job):
    base = job.run()
    out = {}
    for label, kw in (("rerun", {}), ("ulp", dict(ulp=True)),
                      ("split", dict(split=True))):
        other = job.run(**kw)
        steps = []
        for i in range(STEPS):
            e, k = excess(other[i]["params"], base[i]["params"])
            d = (other[i]["params"][k] - base[i]["params"][k]).abs()
            j = int(d.argmax())
            hist = [dict(g_other=other[s]["grads"][k].flatten()[j].item(),
                         g_base=base[s]["grads"][k].flatten()[j].item())
                    for s in range(i + 1)]
            steps.append(dict(
                step=i + 1, loss_rel=abs(other[i]["loss"] - base[i]["loss"])
                / abs(base[i]["loss"]), max_excess=e, name=k,
                diff=d.flatten()[j].item(), grads_at_entry=hist,
                grad_rel_l2=grad_rel_l2(other[i]["grads"],
                                        base[i]["grads"])))
        out[label] = steps
        print(label, json.dumps(steps), flush=True)
        del other
        torch.cuda.empty_cache()
    return out


def controls(job):
    def compare(a, b):
        e, k = excess(a[-1]["params"], b[-1]["params"])
        return dict(loss_rel=[abs(x["loss"] - y["loss"]) / abs(y["loss"])
                              for x, y in zip(a, b)],
                    max_excess=max(e, 0.0), worst=k,
                    grad_rel_l2_step1=grad_rel_l2(a[0]["grads"],
                                                  b[0]["grads"]))

    out = {}
    for label, mode in (("exact_benchmark", float32_exact),
                        ("deterministic_heuristics", heuristics)):
        t = time.perf_counter()
        p1, p2 = job.run(mode=mode), job.run(mode=mode)
        s = job.run(split=True, mode=mode)
        out[label] = dict(control=compare(p2, p1), split=compare(s, p1),
                          seconds=time.perf_counter() - t)
        print(label, json.dumps(out[label]), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--controls", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tp_gate: torch sees no CUDA device")
    print(cs.nvidia_smi(), flush=True)
    job = Job()
    out = controls(job) if args.controls else step_by_step(job)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "controls" if args.controls else "steps"
    with open(os.path.join("chiprun_out", f"tp_gate_{name}.json"), "w") as f:
        json.dump(out, f)
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
