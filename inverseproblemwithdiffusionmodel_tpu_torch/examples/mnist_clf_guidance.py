"""Classifier-guided class-conditional sampling on the port: the
experiment of examples/mnist_clf_guidance.py, with its flags, defaults
and results.json keys.

Trains an NCSNv2 prior and two ResNet-18 classifiers on MNIST (the
synthetic digits where the IDX files are absent): a noise-robust guide
(perturbed inputs over the ladder) whose gradient steers
`ald_cls_conditioned`, and an independent clean judge that scores the
samples. For every class it draws --per_class samples and reports the
share the judge assigns to that class, against the unconditional
sampler's most frequent class. Prior and classifiers are Flax msgpack
files under --out (either package's load in the other).

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
mnist_clf_guidance [--quick] [--out runs/mnist_clf]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import _common as C
from ..config import load_general_config
from ..data.datasets import load_mnist
from ..models.classifier import ResNetClf
from ..models.ncsnv2 import NCSNv2
from ..models.registry import make_clf_fn, make_score_fn, to_nchw
from ..samplers.ald import ALDConfig, ald_unconditional_sampler
from ..samplers.ald_variants import ald_cls_conditioned
from ..samplers.sigmas import check_ladder_stability, sigma_ladder
from ..training import TrainState, get_optimizer, make_clf_train_step
from ..utils import artifacts
from ..utils.dataset_stats import max_pairwise_distance
from ..utils.device import resolve_device


def log(msg):
    print(f"[clf] {msg}", flush=True)


def train_clf(model, imgs, ys, sigmas, batch, steps, seed, tag,
              ckpt_path=None, device="cuda"):
    """Classifier training (Adam 3e-4, clip 1; batches from
    RandomState(seed * 99991 + s)); `sigmas=[0]` trains on clean inputs
    (the judge). Returns the model with its EMA weights (the JAX loop's
    state.eval_params), or with the saved ones at ckpt_path."""
    model = model.to(device)
    if ckpt_path and os.path.exists(ckpt_path):
        log(f"loading saved {tag}")
        return C.load_prior(model, ckpt_path, log, tag).eval()
    state = TrainState.create(model, get_optimizer(C.adam_config(3e-4)),
                              ema_decay=0.999)
    step_fn = make_clf_train_step(model, sigmas)
    n = imgs.shape[0]
    t0 = time.time()
    for s in range(steps):
        idx = np.random.RandomState(seed * 99991 + s).randint(0, n,
                                                              size=batch)
        state, loss = step_fn(state, (imgs[idx], ys[idx]),
                              C.step_generator(seed + 13, s, device))
        if s % max(steps // 8, 1) == 0 or s == steps - 1:
            log(f"{tag} step {s}: loss {float(loss):.4f} "
                f"({time.time() - t0:.0f}s)")
    C.load_params(model, state.eval_params)
    if ckpt_path:
        artifacts.save_prior(model, ckpt_path)
    return model.eval()


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--ngf", type=int, default=32)
    p.add_argument("--steps", type=int, default=8000)
    p.add_argument("--clf_steps", type=int, default=1200)
    p.add_argument("--levels", type=int, default=232)
    p.add_argument("--n_steps_each", type=int, default=5)
    p.add_argument("--step_lr", type=float, default=6.2e-6)
    p.add_argument("--per_class", type=int, default=16)
    p.add_argument("--clf_temp", type=float, default=1.0,
                   help="guidance strength: the classifier's logits are "
                        "scaled by this before the log-softmax gradient")
    p.add_argument("--f32", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/mnist_clf")
    C.add_device_args(p)
    args = p.parse_args(argv)
    if args.quick:
        args.ngf, args.steps, args.clf_steps = 16, 60, 30
        args.levels, args.per_class = 16, 4
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = C.compute_dtype(device, args.f32)
    os.makedirs(args.out, exist_ok=True)
    S = args.size

    train = load_mnist(mode="train", size=S)
    imgs = np.asarray(train.data, np.float32)
    ys = np.asarray(train.labels, np.int64)
    log(f"{imgs.shape} digits")
    sigma_max = max_pairwise_distance(imgs, max_samples=256)
    sigmas = sigma_ladder(sigma_max, 0.01, args.levels)
    ratio = check_ladder_stability(sigmas, args.n_steps_each, args.step_lr)
    log(f"sigma_max {sigma_max:.1f}; ladder stability {ratio:.1f}")

    model = NCSNv2(C.ncsn_config(1, S, args.ngf))
    prior_path = os.path.join(args.out, "prior.msgpack")
    if os.path.exists(prior_path):
        C.load_prior(model, prior_path, log)
        model.to(device).eval()
    else:
        C.train_score_net(model, imgs, sigmas, 32, args.steps, args.seed,
                          "prior", ckpt_path=prior_path + ".ckpt",
                          device=device, dtype=dtype, log=log)
        artifacts.save_prior(model, prior_path)
        C.remove(prior_path + ".ckpt", prior_path + ".ckpt.fp")

    gc = load_general_config()
    guide = train_clf(ResNetClf(gc), imgs, ys, sigmas, 64, args.clf_steps,
                      args.seed, "guide clf",
                      os.path.join(args.out, "guide.msgpack"), device)
    judge = train_clf(ResNetClf(gc), imgs, ys, [0.0], 64, args.clf_steps,
                      args.seed + 1, "judge clf",
                      os.path.join(args.out, "judge.msgpack"), device)

    def judge_predict(x):
        with torch.no_grad():
            x = torch.as_tensor(x).to(device)
            return judge(to_nchw(x)).argmax(dim=-1).cpu().numpy()

    test = load_mnist(mode="test", size=S)
    judge_acc = float(np.mean(judge_predict(np.asarray(test.data))
                              == np.asarray(test.labels)))
    log(f"judge accuracy on held-out digits: {judge_acc:.4f}")

    cfg = ALDConfig(n_steps_each=args.n_steps_each, step_lr=args.step_lr)
    B = args.per_class
    score_fn = make_score_fn(model, sigmas, dtype)
    guide_fn = make_clf_fn(guide)

    def clf_fn(x):
        return args.clf_temp * guide_fn(x)

    t0 = time.time()
    xu = ald_unconditional_sampler(score_fn, sigmas, (B, S, S, 1),
                                   seed=args.seed + 500, config=cfg,
                                   device=device)
    pred_u = judge_predict(xu)
    log(f"unconditional: judge histogram {np.bincount(pred_u, minlength=10)}"
        f" ({time.time() - t0:.0f}s)")

    per_class_acc, grids = {}, {}
    for c in range(10):
        t0 = time.time()
        cls = torch.full((B,), c, dtype=torch.int64)
        x = ald_cls_conditioned(score_fn, clf_fn, cls, sigmas, (B, S, S, 1),
                                seed=args.seed + 1000 + c, config=cfg,
                                device=device)
        pred = judge_predict(x)
        per_class_acc[c] = float(np.mean(pred == c))
        grids[c] = C.to_cpu(x).numpy()
        log(f"class {c}: judge-agreement {per_class_acc[c]:.3f} "
            f"(pred histogram {np.bincount(pred, minlength=10)}) "
            f"({time.time() - t0:.0f}s)")

    cond_acc = float(np.mean(list(per_class_acc.values())))
    uncond_hist = np.bincount(pred_u, minlength=10) / max(len(pred_u), 1)
    uncond_acc = float(uncond_hist.max())
    log(f"mean class-agreement: conditional {cond_acc:.3f} vs "
        f"unconditional best-single-class {uncond_acc:.3f} "
        f"(uncond histogram {np.round(uncond_hist, 2)})")

    class_grid(args, grids, per_class_acc)
    payload = {"args": vars(args),
               "judge_test_accuracy": round(judge_acc, 4),
               "per_class_agreement": {str(k): round(v, 4)
                                       for k, v in per_class_acc.items()},
               "mean_conditional_agreement": round(cond_acc, 4),
               "unconditional_best_single_class": round(uncond_acc, 4)}
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(payload, f, indent=2)
    log(json.dumps({"conditional": round(cond_acc, 4),
                    "unconditional": round(uncond_acc, 4),
                    "judge": round(judge_acc, 4)}))
    return payload


def class_grid(args, grids, per_class_acc):
    """class_grid.png (matplotlib; skipped where it is missing)."""
    try:
        import matplotlib
    except ImportError:
        log("matplotlib missing: class_grid.png not drawn")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    B = args.per_class
    ncol = min(B, 8)
    fig, axes = plt.subplots(10, ncol, figsize=(1.2 * ncol, 12))
    for c in range(10):
        for j in range(ncol):
            ax = axes[c][j] if ncol > 1 else axes[c]
            ax.imshow(grids[c][j, ..., 0], cmap="gray")
            ax.set_axis_off()
            if j == 0:
                ax.set_title(f"cls {c} ({per_class_acc[c]:.2f})",
                             fontsize=8, loc="left")
    fig.tight_layout()
    fig.savefig(os.path.join(args.out, "class_grid.png"), dpi=120)
    plt.close(fig)


if __name__ == "__main__":
    main()
