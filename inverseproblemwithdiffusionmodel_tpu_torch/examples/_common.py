"""What the experiments share: the synthetic data and measurement inputs
the JAX examples draw, the score-prior training loop, prior files, and
the device and precision choice.

The JAX examples train with the JAX PRNG and save Flax msgpack files; the
port trains with torch generators and saves the same files
(utils/artifacts), so a prior trained by either package loads in the
other. Their deterministic inputs (data, ladders, masks, coil maps,
phase, measurements) are the JAX examples' own, the JAX PRNG's phase
field included (utils/threefry).
"""
from __future__ import annotations

import hashlib
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data import transforms as dT
from ..data.datasets import synthetic_acdc_slice
from ..operators.fourier import _exp_sens_map
from ..ops.resize import resize_align_corners
from ..training import TrainState, get_optimizer, make_score_train_step
from ..utils import artifacts, threefry


def add_device_args(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device; the examples run on the card "
                        "unless given 'cpu'")


def compute_dtype(device: torch.device, f32: bool = False):
    """The score nets' forward dtype: bf16 on the card (the JAX examples'
    BF16Wrap on an accelerator), float32 on the CPU or with --f32."""
    if f32 or device.type == "cpu":
        return None
    return torch.bfloat16


def make_dataset(n: int, size: int, seed: int) -> np.ndarray:
    """Synthetic short-axis slices (n, size, size, 1) in [0, 1]
    (examples/acdc_sense_ensemble.py make_dataset)."""
    rng = np.random.RandomState(seed)
    out = np.empty((n, size, size, 1), np.float32)
    for i in range(n):
        img, _ = synthetic_acdc_slice(rng)
        img = dT.scale_intensity(img)
        out[i, ..., 0] = dT.resize(img, (size, size))[0]
    return out


def phase_field(seed: int, n: int, size: int) -> torch.Tensor:
    """The smooth synthetic phase (n, size, size, 1): a (n, 5, 5, 1) draw
    of jax.random.normal(PRNGKey(seed)) resized with aligned corners."""
    patch = torch.from_numpy(threefry.normal(threefry.prng_key(seed),
                                             (n, 5, 5, 1)))
    return resize_align_corners(patch, (size, size), axes=(1, 2))


def sens_maps(size: int, num_sens: int, seed: int) -> np.ndarray:
    """SOS-normalized exponential coil maps (num_sens, size, size)."""
    maps = np.stack([_exp_sens_map(size, size, seed + i)
                     for i in range(num_sens)])
    return maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))


def ncsn_config(channels: int, image_size: int, ngf: int) -> Config:
    """The examples' NCSNv2-family config (ELU, InstanceNorm++)."""
    return Config({"data": {"channels": channels, "image_size": image_size,
                            "logit_transform": False, "rescaled": False},
                   "model": {"ngf": ngf, "nonlinearity": "elu",
                             "normalization": "InstanceNorm++"}})


def adam_config(lr: float, eps: float = 1e-8, grad_clip: float = 1.0
                ) -> Config:
    return Config({"optim": {"optimizer": "Adam", "lr": lr, "beta1": 0.9,
                             "eps": eps, "weight_decay": 0.0,
                             "grad_clip": grad_clip}})


def step_generator(seed: int, i: int, device) -> torch.Generator:
    """The draws of training step i: a generator seeded from (seed, i), so
    a resumed run replays the stream (the JAX loop's fold_in(key, i))."""
    return torch.Generator(device).manual_seed(
        (seed * 1_000_003 + i) % (2 ** 63))


def train_score_net(model, data, sigmas, batch, steps, seed, tag,
                    ckpt_path=None, retrain=False, device="cuda",
                    dtype=None, log=print):
    """The JAX examples' train_score_net: Adam 1e-4 (clip 1), EMA 0.999,
    the real-imag DSM step, batch indices from RandomState([seed, i]).
    A fingerprinted mid-training checkpoint (torch.save of the state) is
    resumed when its settings match. Returns the model with the EMA
    weights loaded (the JAX form's state.eval_params)."""
    device = torch.device(device)
    model = model.to(device)
    state = TrainState.create(model, get_optimizer(adam_config(1e-4)),
                              ema_decay=0.999)
    shapes = str([tuple(v.shape) for v in model.state_dict().values()])
    fp = hashlib.sha1(
        f"{steps}|{seed}|{batch}|{shapes}".encode()).hexdigest()[:12]
    fp_path = (ckpt_path + ".fp") if ckpt_path else None
    if ckpt_path and retrain:
        for pth in (ckpt_path, fp_path):
            if os.path.exists(pth):
                os.remove(pth)
    start = 0
    if ckpt_path and os.path.exists(ckpt_path):
        saved_fp = (open(fp_path).read().strip()
                    if os.path.exists(fp_path) else "<missing>")
        if saved_fp != fp:
            log(f"{tag}: ignoring stale checkpoint (settings changed)")
        else:
            try:
                state.load_state_dict(torch.load(ckpt_path,
                                                 map_location=device,
                                                 weights_only=True))
                start = state.step
                log(f"{tag}: resumed mid-training checkpoint at step "
                    f"{start}")
            except Exception as e:   # corrupt or incompatible file
                log(f"{tag}: ignoring unreadable checkpoint ({e})")
    step = make_score_train_step(model, sigmas, data_mode="real-imag",
                                 compute_dtype=dtype)
    every = max(steps // 8, 1)
    t0 = time.time()
    for i in range(start, steps):
        idx = np.random.RandomState([seed, i]).choice(len(data), batch)
        state, loss = step(state, data[idx],
                           step_generator(seed + 1, i, device))
        if i % every == 0 or i == steps - 1:
            log(f"{tag} step {i}: loss {float(loss):.2f} "
                f"({time.time() - t0:.0f}s)")
            if ckpt_path and i > start:
                tmp = ckpt_path + ".tmp"
                torch.save(state.state_dict(), tmp)
                os.replace(tmp, ckpt_path)
                with open(fp_path + ".tmp", "w") as f:
                    f.write(fp)
                os.replace(fp_path + ".tmp", fp_path)
    return load_params(model, state.eval_params).eval()


def load_params(model, params):
    """Copy `params` (name -> tensor: a TrainState's eval_params, its EMA
    where it tracks one) into the model's parameters; returns the
    model."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    return model


def load_prior(model, path: str, log=print, tag: str = "prior"):
    """Load the Flax prior file at `path` into `model` (raises on a name
    or shape difference)."""
    artifacts.load_prior(path, model)
    log(f"loaded {tag} prior: {path}")
    return model


def mag(xr, xi) -> torch.Tensor:
    return torch.sqrt(torch.as_tensor(xr) ** 2 + torch.as_tensor(xi) ** 2)


def to_cpu(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().float().cpu()


def remove(*paths: Optional[str]) -> None:
    for pth in paths:
        if pth and os.path.exists(pth):
            os.remove(pth)
