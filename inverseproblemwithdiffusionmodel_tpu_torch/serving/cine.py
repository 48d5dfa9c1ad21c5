"""2D+time (cine) reconstruction engine for serving.

Port of `CineEngineSpec` and `CineReconstructionEngine` from
inverseproblemwithdiffusionmodel_tpu/serving/cine.py: the serving form of
the factorized sampler (samplers/ald_pair.Stepped2DTimePairReconstructor;
reference: ALD2DTime, ncsn/models/ALD_optimizers.py:330-554), a spatial
2-D score prior over all frames, a temporal prior (the 1-D NCSN on pixel
tubes, or TV) and per-frame-mask SENSE data consistency. The serving
rules are the 2-D engine's (serving/engine.py): the nets are placed on the
device once; a request brings its measurement and may override the
per-frame masks, the coil maps, the seed, `lr_scaled` and `lamda_T`; the
request's operator and normal kernel are built on the host, the kernel
collapsed to (T, W, W) whatever the chain count
(PairL2Penalty.with_normal_kernel); `stats()["input_signatures"]` counts
the level step's input signatures, one per spec. The chain ensemble is
the batch: chains x frames rows. Duck-typed for serving.server.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .engine import ReconResult, _make_arg_score_fn, _signature, _validate_mesh
from ..operators.pair import (PairL2Penalty, PairRandomUndersamplingFourier,
                              PairSENSE)
from ..samplers.ald import ALDConfig, setup_2d_time_ladders
from ..samplers.ald_pair import Stepped2DTimePairReconstructor
from ..utils.device import Noise, Shift, resolve_device


@dataclasses.dataclass(frozen=True)
class CineEngineSpec:
    """The fixed geometry of one 2D+time engine."""
    height: int
    width: int
    frames: int
    channels: int = 1
    num_sens: int = 4          # 0 => single-coil masked Fourier
    chains: int = 4            # ensemble rows per request
    n_steps_each: int = 3
    step_lr: float = 9e-7
    lr_scaled: float = 1.0
    mode_T: str = "diffusion1d"   # tv | diffusion1d | none | *-only
    lamda_T: float = 1.0
    win_size: int = 8
    if_random_shift: bool = False
    prox_iters: int = 4
    dtype: str = "bf16"        # f32 | bf16 | int8
    mode: str = "scan"         # scan | steps: both the host loop here


class CineReconstructionEngine:
    """Build-once, serve-many 2D+time reconstructor, with the request
    interface of ReconstructionEngine.

    model_S is the spatial NCSNv2-family net over `sigmas_S`; model_T (a
    1-D net, models/ncsn1d.py) over its RAW ladder `sigmas_T` is needed
    only where mode_T uses the temporal diffusion prior. Both move to
    `device` (default "cuda"; without a card that raises unless
    device="cpu") in eval mode. Results are per-chain (T, H, W, C)
    volumes and their aggregates over the chains.
    """

    def __init__(self, model_S: torch.nn.Module, sigmas_S, *,
                 spec: CineEngineSpec,
                 model_T: Optional[torch.nn.Module] = None, sigmas_T=None,
                 mask: Optional[np.ndarray] = None,
                 sens_re: Optional[np.ndarray] = None,
                 sens_im: Optional[np.ndarray] = None,
                 mesh=None, device="cuda"):
        _validate_mesh(mesh, spec.chains)
        if spec.mode not in ("scan", "steps"):
            raise ValueError(f"unknown mode {spec.mode!r} (scan|steps)")
        if "diffusion1d" in spec.mode_T and (model_T is None
                                             or sigmas_T is None):
            raise ValueError(f"mode_T={spec.mode_T!r} needs a temporal "
                             "score model (model_T, sigmas_T)")
        self.mesh = mesh
        self.spec = spec
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            # requests run on server threads, whose current device need
            # not be this one
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.sigmas_S = torch.as_tensor(sigmas_S, dtype=torch.float32)
        self.sigmas_T = torch.as_tensor(
            [1.0] if sigmas_T is None else sigmas_T, dtype=torch.float32)
        self.model_S = model_S.to(device).eval()
        self._score_S = _make_arg_score_fn(self.model_S, self.sigmas_S,
                                           spec.dtype)
        self.model_T = self._score_T = None
        if model_T is not None:
            self.model_T = model_T.to(device).eval()
            self._score_T = _make_arg_score_fn(self.model_T, self.sigmas_T,
                                               spec.dtype)
        self.ald_config = ALDConfig(n_steps_each=spec.n_steps_each,
                                    step_lr=spec.step_lr)
        self._lock = threading.Lock()
        self._compile_s: Optional[float] = None
        self._requests = 0
        self._total_latency = 0.0
        self._signatures = set()
        self.default_lin_tfm = self._build_lin_tfm(mask, sens_re, sens_im)
        # the ladder the levels run over (the temporal one in *-only
        # modes); raises where the two ladders do not overlap
        self.L = len(setup_2d_time_ladders(self.sigmas_S, self.sigmas_T,
                                           spec.mode_T)[0])

    # ---------------------------------------------------------- operators

    def _build_lin_tfm(self, mask, sens_re, sens_im):
        """mask: per-frame (T, 1, W, 1), or one (1, 1, W, 1) for all
        frames, tiled to the chains x frames axis."""
        s = self.spec
        if mask is None:
            mask = np.ones((s.frames, 1, s.width, 1), np.float32)
        mask = np.asarray(mask, np.float32).reshape(-1, 1, s.width, 1)
        if mask.shape[0] == 1:
            mask = np.tile(mask, (s.frames, 1, 1, 1))
        if mask.shape[0] != s.frames:
            raise ValueError(f"mask has {mask.shape[0]} frames, spec has "
                             f"{s.frames}")
        mask_bt = torch.from_numpy(np.tile(mask, (s.chains, 1, 1, 1)))
        if s.num_sens == 0:
            if sens_re is not None or sens_im is not None:
                raise ValueError("coil maps given to a single-coil engine")
            return PairRandomUndersamplingFourier(mask=mask_bt).to(
                self.device)
        if sens_re is None:
            sens_re = np.ones((s.num_sens, s.height, s.width, s.channels),
                              np.float32) / np.sqrt(s.num_sens)
        sens_re = np.asarray(sens_re, np.float32).reshape(
            s.num_sens, s.height, s.width, s.channels)
        if sens_im is None:
            sens_im = np.zeros_like(sens_re)
        sens_im = np.asarray(sens_im, np.float32).reshape(sens_re.shape)
        return PairSENSE(mask=mask_bt, sens_re=torch.from_numpy(sens_re),
                         sens_im=torch.from_numpy(sens_im)).to(self.device)

    def _build_proximal(self, lin_tfm) -> PairL2Penalty:
        # per request: the (T, W, W) normal kernel on the host (the mask
        # tiled over the chains collapses to its T frames)
        return PairL2Penalty.with_normal_kernel(
            lin_tfm, num_iters=self.spec.prox_iters)

    # -------------------------------------------------------------- chain

    def _reconstructor(self, lin_tfm, proximal, lr_scaled, lamda_T
                       ) -> Stepped2DTimePairReconstructor:
        s = self.spec
        return Stepped2DTimePairReconstructor(
            self._score_S, self._score_T, self.sigmas_S, self.sigmas_T,
            lin_tfm, proximal, self.ald_config, lr_scaled, s.mode_T,
            lamda_T, s.if_random_shift, s.win_size, s.frames,
            device=self.device)

    def _broadcast_chains(self, y: torch.Tensor) -> torch.Tensor:
        """(coils?, T, H, W, C) single copy -> (coils?, chains T, H, W, C)
        on the device, once per request."""
        s = self.spec
        ax = 1 if s.num_sens else 0
        y = y.to(self.device).unsqueeze(ax)
        shape = y.shape[:ax] + (s.chains,) + y.shape[ax + 1:]
        return y.expand(shape).flatten(ax, ax + 1).contiguous()

    def _run(self, lin_tfm, proximal, yr, yi, lr_scaled: float,
             lamda_T: float, seed: int, noise: Optional[Noise] = None,
             shift: Optional[Shift] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        yr, yi = self._broadcast_chains(yr), self._broadcast_chains(yi)
        recon = self._reconstructor(lin_tfm, proximal, lr_scaled, lamda_T)
        # what the level step receives besides the chain state: the
        # measurement, the operator, the normal kernel, the two weights
        lin = recon.lin_tfm
        self._signatures.add(_signature(
            yr, yi, lin.mask, getattr(lin, "sens_re", None),
            getattr(lin, "sens_im", None), recon.proximal.kernel_re,
            recon.proximal.kernel_im, recon.lr_scaled, recon.lamda_T))
        return recon(yr, yi, seed=seed, noise=noise, shift=shift)

    # ------------------------------------------------------------- public

    def _example_measurement(self) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.spec
        shape = (s.frames, s.height, s.width, s.channels)
        if s.num_sens:
            shape = (s.num_sens,) + shape
        return torch.zeros(shape), torch.zeros(shape)

    def warmup(self) -> float:
        """Run once at the spec geometry (cuDNN's algorithm choice and the
        allocator's pools happen here); returns the seconds of the first
        warm-up."""
        t0 = time.perf_counter()
        yr, yi = self._example_measurement()
        prox = self._build_proximal(self.default_lin_tfm)
        with self._lock:
            xr, xi = self._run(self.default_lin_tfm, prox, yr, yi,
                               self.spec.lr_scaled, self.spec.lamda_T, 0)
            float(xr.sum() + xi.sum())             # device -> host sync
        if self._compile_s is None:
            self._compile_s = time.perf_counter() - t0
        return self._compile_s

    def reconstruct(self, y_re, y_im, *, mask=None, sens_re=None,
                    sens_im=None, seed: int = 0,
                    lr_scaled: Optional[float] = None,
                    lamda_T: Optional[float] = None,
                    noise: Optional[Noise] = None,
                    shift: Optional[Shift] = None) -> ReconResult:
        """y_re/y_im: (num_sens, T, H, W[, C]), or (T, H, W[, C]) for a
        single-coil engine. mask: per-frame (T, 1, W, 1) override;
        sens_*: coil maps; lr_scaled / lamda_T retune the data-consistency
        and temporal weights. `noise(shape)` and `shift(win)` replace the
        draws seeded with `seed` (a test's hook)."""
        s = self.spec
        yr = self._canon_measurement(y_re)
        yi = self._canon_measurement(y_im)
        if mask is None and sens_re is None and sens_im is None:
            lin_tfm = self.default_lin_tfm
        else:
            if mask is None:
                # the default mask, un-tiled back to per-frame
                mask = self.default_lin_tfm.mask[:s.frames].cpu().numpy()
            lin_tfm = self._build_lin_tfm(mask, sens_re, sens_im)
        proximal = self._build_proximal(lin_tfm)
        lr = s.lr_scaled if lr_scaled is None else lr_scaled
        lt = s.lamda_T if lamda_T is None else lamda_T

        t0 = time.perf_counter()
        with self._lock:
            xr, xi = self._run(lin_tfm, proximal, yr, yi, lr, lt, seed,
                               noise=noise, shift=shift)
            xr, xi = xr.cpu().numpy(), xi.cpu().numpy()   # (B, T, H, W, C)
            dt = time.perf_counter() - t0
            self._requests += 1
            self._total_latency += dt

        mag = np.sqrt(xr ** 2 + xi ** 2)
        steps = self.L * s.n_steps_each * s.chains
        return ReconResult(
            x_re=xr, x_im=xi,
            mean_re=xr.mean(axis=0), mean_im=xi.mean(axis=0),
            mean_mag=mag.mean(axis=0), std_mag=mag.std(axis=0),
            latency_s=dt, chain_steps_per_s=steps / max(dt, 1e-9))

    def _canon_measurement(self, y) -> torch.Tensor:
        """(num_sens, T, H, W[, C]) or (T, H, W[, C]) -> float32 on the
        host, channel axis added where missing."""
        s = self.spec
        y = np.asarray(y, np.float32)
        if y.ndim == 3:                                   # (T, H, W)
            y = y[..., None]
        elif y.ndim == 4 and y.shape[-1] != s.channels:
            y = y[..., None]                              # (coils, T, H, W)
        want = (s.frames, s.height, s.width, s.channels)
        if s.num_sens:
            want = (s.num_sens,) + want
        if y.shape != want:
            raise ValueError(f"measurement shape {y.shape} != {want} "
                             f"(engine spec {s})")
        return torch.from_numpy(y.copy())

    def stats(self) -> Dict[str, Any]:
        return {
            "spec": dataclasses.asdict(self.spec),
            "requests": self._requests,
            "compile_s": self._compile_s,
            "mean_latency_s": (self._total_latency / self._requests
                               if self._requests else None),
            # distinct (shape, dtype) signatures the level step has seen
            "input_signatures": len(self._signatures),
            "mesh": None,
        }
