"""ALD reconstruction engine for serving.

Port of `EngineSpec`, `ReconResult`, `_make_arg_score_fn`, `_validate_mesh`
and `ReconstructionEngine` from inverseproblemwithdiffusionmodel_tpu/
serving/engine.py.

- One engine serves one geometry (`EngineSpec`). The score net, its bf16
  copy where the spec asks for bf16, and the seg net of a guided engine
  are placed on the device once, at construction. Each request brings its
  measurement and may override the mask, the coil maps, the seed, the
  data-consistency weight `lr_scaled`, the seg label and `seg_lamda`; the
  engine builds that request's operator, normal kernel and A^H y, moves
  them to the device once, and runs the chain
  (samplers/ald_pair.SteppedPairReconstructor) over them. In the JAX
  package these are arguments of one compiled program, so no request
  retraces it; here `stats()["input_signatures"]` counts the distinct
  (shape, dtype) signatures the level step has seen, one per spec when
  no request changed a shape (cuDNN keeps its plans per shape).
- The chain ensemble is the batch: the single-copy measurement is tiled
  over `chains` rows on the device, and the result is their mean and
  spread.
- dtype "f32" runs the score net in float32, "bf16" in bf16, "int8" in
  bf16 with its convolutions in int8 (models/registry.make_score_fn,
  ops/quant.py; the activation scale spans the whole chain batch); the
  Langevin state, the proximal and the segmentation guidance stay
  float32, and the seg net keeps its float32 convolutions.
- mode "scan" and "steps" are both the host loop over noise levels (the
  JAX package's whole-chain program and its stepped form give equal
  results; the port has only the loop).
- `mesh` (parallel/mesh.py) splits the chains evenly over its data
  axis: each device holds a replica of the nets and runs its block of
  chains, all advanced level by level (samplers/ald_pair.
  ShardedReconstructor: each shard's Langevin step on a thread of its
  own, on the serving thread's streams, so two shards on one card launch
  K5 on its one stream in turn). The chains' noise is the unsharded
  engine's, so the result is too (bit for bit on a mesh of one device;
  the CG proximal's sums in another order on several). int8's
  per-tensor activation scale spans the whole batch, as JAX's does: the
  shards meet at every int8 convolution (ops/quant.ScaleGroup).
- Requests are serialized behind a lock: one engine is one mesh's (or
  one device's) worth of work.

The reference counterpart of the math is ALDInvSegProximalRealImag
(ncsn/models/ALD_optimizers.py:161-327) in pair form, with its
segmentation guidance when the engine has a seg net.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.registry import make_score_fn, make_seg_fn
from ..operators.pair import (PairL2Penalty, PairRandomUndersamplingFourier,
                              PairSENSE)
from ..parallel.mesh import DATA_AXIS
from ..samplers.ald import ALDConfig
from ..samplers.ald_pair import (ShardedReconstructor,
                                 SteppedPairReconstructor, replica_placer,
                                 shard_rows)
from ..utils.device import Noise, resolve_device


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """The fixed geometry of one engine."""
    height: int
    width: int
    channels: int = 1
    num_sens: int = 4          # 0 => single-coil masked Fourier
    chains: int = 16           # ensemble rows per request (the batch)
    levels: int = 2311         # sigma-ladder length
    n_steps_each: int = 3
    step_lr: float = 9e-7
    lr_scaled: float = 5.0     # default data-consistency weight
    denoise: bool = True
    prox_iters: int = 4
    dtype: str = "bf16"        # f32 | bf16 | int8
    mode: str = "scan"         # scan | steps: both the host loop here
    # segmentation guidance (on where the engine has a seg net; reference
    # ramp semantics, ncsn/models/ALD_optimizers.py:23,
    # ncsn/models/__init__.py:197-215)
    seg_lamda: float = 1.0     # default guidance weight (0 disables)
    seg_start_time: float = 0.0   # ramp start (1.0 = ramp never activates)
    seg_step_type: str = "linear"
    seg_mode: str = "full"     # full | FG

    def chain_steps(self) -> int:
        return self.levels * self.n_steps_each


@dataclasses.dataclass
class ReconResult:
    """One request's output. Aggregates are over the chain ensemble;
    magnitudes are |x| per chain, then their mean and std."""
    x_re: np.ndarray           # (chains, H, W, C) per-chain reconstructions
    x_im: np.ndarray
    mean_re: np.ndarray        # (H, W, C)
    mean_im: np.ndarray
    mean_mag: np.ndarray
    std_mag: np.ndarray
    latency_s: float
    chain_steps_per_s: float

    def to_npz_dict(self) -> Dict[str, np.ndarray]:
        return {"mean_re": self.mean_re, "mean_im": self.mean_im,
                "mean_mag": self.mean_mag, "std_mag": self.std_mag,
                "x_re": self.x_re, "x_im": self.x_im}


_COMPUTE_DTYPES = {"f32": None, "bf16": torch.bfloat16, "int8": "int8"}


def _make_arg_score_fn(model: torch.nn.Module, sigmas: torch.Tensor,
                       dtype: str):
    """The engine's score function for a spec dtype, built once (the JAX
    form takes the params as an argument of the compiled program; here
    the model holds them)."""
    if dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"unknown dtype {dtype!r} (f32|bf16|int8)")
    return make_score_fn(model, sigmas, _COMPUTE_DTYPES[dtype])


def _validate_mesh(mesh, chains: int) -> None:
    """A serving mesh shards the chain ensemble over its `data` axis, so
    the chains must divide evenly (every device runs chains / n_data
    whole chains; no padding rows in a long-lived engine)."""
    if mesh is None:
        return
    names = getattr(mesh, "axis_names", ())
    if DATA_AXIS not in names:
        raise ValueError(f"serving mesh needs a {DATA_AXIS!r} axis, got "
                         f"{names}")
    n_data = mesh.shape[DATA_AXIS]
    if chains % n_data:
        raise ValueError(f"spec.chains={chains} must be a multiple of the "
                         f"mesh data axis ({n_data} devices)")


def _mesh_devices(mesh, device) -> list:
    """The devices an engine runs on: the mesh's data axis, or `device`
    with its CUDA index pinned (requests run on server threads, whose
    current device need not be this one)."""
    if mesh is not None:
        return [resolve_device(d) for d in mesh.data_devices]
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return [device]


def _mesh_stats(mesh) -> Optional[Dict[str, int]]:
    return None if mesh is None else {k: int(v)
                                      for k, v in mesh.shape.items()}


def _signature(*tensors: Optional[torch.Tensor]) -> Tuple:
    return tuple(None if t is None else (tuple(t.shape), str(t.dtype))
                 for t in tensors)


class ReconstructionEngine:
    """Build-once, serve-many ALD inverse-problem reconstructor.

    >>> eng = ReconstructionEngine(model, sigmas, spec=EngineSpec(...))
    >>> eng.warmup()                        # first run: cuDNN's set-up
    >>> res = eng.reconstruct(y_re, y_im)
    >>> res = eng.reconstruct(y2_re, y2_im, mask=new_mask, sens_re=...)

    `model` is the NCSNv2-family score net; `seg_model` (optional, e.g.
    models/registry.build_seg_unet) turns the segmentation guidance on.
    Both move to `device` (default "cuda"; without a card that raises
    unless device="cpu"), in eval mode, and the seg net's parameters stop
    requiring grad. With a `mesh` they move to its first data-axis device
    instead, and each other device gets a copy. The engine owns a default
    operator (mask + coil maps); requests may override any of them as long
    as shapes match the spec.
    """

    def __init__(self, model: torch.nn.Module, sigmas, *, spec: EngineSpec,
                 mask: Optional[np.ndarray] = None,
                 sens_re: Optional[np.ndarray] = None,
                 sens_im: Optional[np.ndarray] = None,
                 seg_model: Optional[torch.nn.Module] = None,
                 seg_label: Optional[np.ndarray] = None,
                 mesh=None, device="cuda"):
        if spec.levels != int(np.shape(sigmas)[0]):
            raise ValueError(f"spec.levels={spec.levels} != "
                             f"len(sigmas)={np.shape(sigmas)[0]}")
        if spec.mode not in ("scan", "steps"):
            raise ValueError(f"unknown mode {spec.mode!r} (scan|steps)")
        _validate_mesh(mesh, spec.chains)
        self.mesh = mesh
        self.spec = spec
        self.devices = _mesh_devices(mesh, device)
        device = self.device = self.devices[0]
        self.model = model.to(device).eval()
        self.sigmas = torch.as_tensor(sigmas, dtype=torch.float32)
        self.ald_config = ALDConfig(n_steps_each=spec.n_steps_each,
                                    step_lr=spec.step_lr,
                                    denoise=spec.denoise)
        self.seg_model = None
        if seg_model is not None:
            self.seg_model = seg_model.to(device).eval().requires_grad_(False)
        self._has_seg = self.seg_model is not None
        # built once per device: the bf16 copy of the net is made here,
        # not per request
        self._score_fns, self._seg_fns, cache = [], [], {}
        for dev in self.devices:
            place = replica_placer(dev, cache)
            self._score_fns.append(_make_arg_score_fn(
                place(self.model), self.sigmas, spec.dtype))
            self._seg_fns.append(make_seg_fn(place(self.seg_model))
                                 if self._has_seg else None)
        self._score_fn = self._score_fns[0]
        self.default_seg_label = (None if seg_label is None
                                  else self._canon_seg_label(seg_label))
        self._lock = threading.Lock()
        self._compile_s: Optional[float] = None
        self._requests = 0
        self._total_latency = 0.0
        self._signatures = set()
        self.default_lin_tfm = self._build_lin_tfm(mask, sens_re, sens_im)

    # ---------------------------------------------------------- operators

    def _build_lin_tfm(self, mask, sens_re, sens_im):
        s = self.spec
        if mask is None:
            mask = np.ones((1, 1, s.width, 1), np.float32)
        mask = torch.as_tensor(np.asarray(mask, np.float32).reshape(
            -1, 1, s.width, 1))
        if s.num_sens == 0:
            if sens_re is not None or sens_im is not None:
                raise ValueError("coil maps given to a single-coil engine")
            return PairRandomUndersamplingFourier(mask=mask).to(self.device)
        if sens_re is None:
            sens_re = np.ones((s.num_sens, s.height, s.width, s.channels),
                              np.float32) / np.sqrt(s.num_sens)
        sens_re = np.asarray(sens_re, np.float32).reshape(
            s.num_sens, s.height, s.width, s.channels)
        if sens_im is None:
            sens_im = np.zeros_like(sens_re)
        sens_im = np.asarray(sens_im, np.float32).reshape(sens_re.shape)
        return PairSENSE(mask=mask, sens_re=torch.as_tensor(sens_re),
                         sens_im=torch.as_tensor(sens_im)).to(self.device)

    def _build_proximal(self, lin_tfm) -> PairL2Penalty:
        # per request: one W x W einsum on the host (the normal kernel),
        # then the kernel on the device
        return PairL2Penalty.with_normal_kernel(
            lin_tfm, num_iters=self.spec.prox_iters)

    # -------------------------------------------------------------- chain

    def _broadcast_chains(self, y: torch.Tensor) -> torch.Tensor:
        """Tile the single-copy measurement over the chain axis on the
        device, once per request (the host copy and the wire stay 1x)."""
        s = self.spec
        ax = 1 if s.num_sens else 0
        shape = y.shape[:ax] + (s.chains,) + y.shape[ax + 1:]
        return y.to(self.device).expand(shape).contiguous()

    def _run(self, lin_tfm, proximal, yr, yi, lr_scaled: float, seed: int,
             seg_label=None, seg_lamda=None, noise: Optional[Noise] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.spec
        yr, yi = self._broadcast_chains(yr), self._broadcast_chains(yi)
        n = len(self.devices)
        shards = []
        for d, dev in enumerate(self.devices):
            seg = {}
            if self._has_seg:
                label = seg_label.expand((s.chains // n,)
                                         + tuple(seg_label.shape))
                seg = dict(seg_fn=self._seg_fns[d], seg_label=label,
                           seg_lamda=seg_lamda,
                           seg_start_time=s.seg_start_time,
                           seg_step_type=s.seg_step_type,
                           seg_mode=s.seg_mode)
            shards.append(SteppedPairReconstructor(
                self._score_fns[d], self.sigmas, shard_rows(lin_tfm, n, d),
                shard_rows(proximal, n, d), self.ald_config, lr_scaled,
                device=dev, **seg))
        recon = shards[0]
        # what the level step receives besides the chain state (whose
        # shape follows from yr): the measurement, the operator, the
        # normal kernel, the per-level weight, the seg label
        lin = recon.lin_tfm
        self._signatures.add(_signature(
            yr, yi, lin.mask, getattr(lin, "sens_re", None),
            getattr(lin, "sens_im", None), recon.proximal.kernel_re,
            recon.proximal.kernel_im, recon.lr_sched,
            recon.seg_label2 if self._has_seg else None))
        return ShardedReconstructor(shards)(yr, yi, seed=seed, noise=noise)

    # ------------------------------------------------------------- public

    def _example_measurement(self) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.spec
        shape = (1, s.height, s.width, s.channels)
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
        seg_label = None
        if self._has_seg:
            s = self.spec
            seg_label = torch.zeros((s.height, s.width), dtype=torch.long)
        with self._lock:
            xr, xi = self._run(self.default_lin_tfm, prox, yr, yi,
                               self.spec.lr_scaled, 0, seg_label=seg_label,
                               seg_lamda=self.spec.seg_lamda)
            float(xr.sum() + xi.sum())             # device -> host sync
        if self._compile_s is None:
            self._compile_s = time.perf_counter() - t0
        return self._compile_s

    def reconstruct(self, y_re, y_im, *, mask=None, sens_re=None,
                    sens_im=None, seed: int = 0,
                    lr_scaled: Optional[float] = None,
                    seg_label: Optional[np.ndarray] = None,
                    seg_lamda: Optional[float] = None,
                    noise: Optional[Noise] = None) -> ReconResult:
        """Reconstruct one measurement with the chain ensemble.

        y_re/y_im: k-space pair, shape (num_sens, H, W[, C]), or (H, W[, C])
        single-coil, tiled across the engine's `chains` rows (independent
        Langevin chains; the mean is the product). mask/sens_* override the
        engine's default operator for this request (same shapes as the
        spec). seg_label: per-pixel (H, W) int target map of a guided
        engine (else its construction-time default); seg_lamda retunes the
        guidance weight. `seed` seeds the chains' noise; `noise(shape)`
        replaces it (a test's hook, e.g. to replay the JAX engine's draws).
        """
        s = self.spec
        yr = self._canon_measurement(y_re)
        yi = self._canon_measurement(y_im)
        if not self._has_seg:
            if seg_label is not None or seg_lamda is not None:
                raise ValueError("seg_label/seg_lamda given, but the engine "
                                 "was built without a seg model")
            seg_label_t = None
        else:
            if seg_label is None:
                seg_label_t = self.default_seg_label
                if seg_label_t is None:
                    raise ValueError("seg-guided engine needs seg_label "
                                     "(no construction-time default)")
            else:
                seg_label_t = self._canon_seg_label(seg_label)
            seg_lamda = s.seg_lamda if seg_lamda is None else seg_lamda
        if mask is None and sens_re is None and sens_im is None:
            lin_tfm = self.default_lin_tfm
        else:
            if mask is None:
                mask = self.default_lin_tfm.mask.cpu().numpy()
            lin_tfm = self._build_lin_tfm(mask, sens_re, sens_im)
        proximal = self._build_proximal(lin_tfm)
        lr = s.lr_scaled if lr_scaled is None else lr_scaled

        t0 = time.perf_counter()
        with self._lock:
            xr, xi = self._run(lin_tfm, proximal, yr, yi, lr, seed,
                               seg_label=seg_label_t, seg_lamda=seg_lamda,
                               noise=noise)
            xr, xi = xr.cpu().numpy(), xi.cpu().numpy()
            dt = time.perf_counter() - t0
            self._requests += 1
            self._total_latency += dt

        mag = np.sqrt(xr ** 2 + xi ** 2)
        return ReconResult(
            x_re=xr, x_im=xi,
            mean_re=xr.mean(axis=0), mean_im=xi.mean(axis=0),
            mean_mag=mag.mean(axis=0), std_mag=mag.std(axis=0),
            latency_s=dt,
            chain_steps_per_s=s.chain_steps() * s.chains / max(dt, 1e-9))

    def _canon_measurement(self, y) -> torch.Tensor:
        """(num_sens, H, W[, C]) or (H, W[, C]) -> (coils, 1, H, W, C), or
        (1, H, W, C) single-coil; float32 on the host."""
        s = self.spec
        y = np.asarray(y, np.float32)
        if y.ndim == 2:                      # (H, W)
            y = y[None, ..., None]
        elif y.ndim == 3:
            if y.shape[0] == s.height and y.shape[-1] == s.channels:
                y = y[None]                  # (H, W, C) single-coil
            else:
                y = y[..., None]             # (coils, H, W)
        ncoil = s.num_sens if s.num_sens else 1
        want = (ncoil, s.height, s.width, s.channels)
        if y.shape != want:
            raise ValueError(f"measurement shape {y.shape} != {want} "
                             f"(engine spec {s})")
        # single copy on the wire and the host; _broadcast_chains tiles it
        if s.num_sens == 0:
            # single-coil operators carry no coil axis: (1, H, W, C)
            return torch.from_numpy(y[0][None].copy())
        return torch.from_numpy(y[:, None].copy())    # (coils, 1, H, W, C)

    def _canon_seg_label(self, label) -> torch.Tensor:
        """(H, W) [or (1, H, W, 1)-squeezable] int per-pixel target map."""
        s = self.spec
        label = np.asarray(label).reshape(s.height, s.width)  # raises if not
        return torch.from_numpy(label.astype(np.int64))

    def stats(self) -> Dict[str, Any]:
        return {
            "spec": dataclasses.asdict(self.spec),
            "requests": self._requests,
            "compile_s": self._compile_s,
            "mean_latency_s": (self._total_latency / self._requests
                               if self._requests else None),
            # distinct (shape, dtype) signatures the level step has seen;
            # 1 when no request changed a shape
            "input_signatures": len(self._signatures),
            "mesh": _mesh_stats(self.mesh),
        }
