"""Dataset loaders: MNIST (IDX files), CIFAR-10 (pickle batches), image
folders (CelebA, LSUN, FFHQ), ACDC .npz slices, the CINE .mat volumes
(frames or pixel tubes) and the synthetic SanityCheck1D signals.

A copy of the numpy code of inverseproblemwithdiffusionmodel_tpu/data/
datasets.py (`ArrayDataset`, `REGISTERED_DATA_ROOT_DIR`, `_read_idx`,
`synthetic_digits` and `load_mnist` :84-131, `load_cifar10` :138,
`synthetic_rgb` :166, `load_image_folder` :187, `synthetic_cine` and
`load_cine` :243-366, `load_tissue_data`, `vol2slice`,
`synthetic_acdc_slice` and `load_acdc` :369-456, `load_sanity_check_1d` :460, the provenance wrappers
and `load_data` :523-586; reference: helpers/load_data.py:55-298); the
port imports nothing of the JAX package. Roots come from the
IPDM_DATA_ROOT environment variable or arguments. Where the files are
absent a loader warns and falls back to a seeded synthetic stand-in of the
same shapes; `data_provenance()` says which datasets this process loaded
(through `load_data` or a loader called directly) and from which source.
Pillow is imported only where an image folder holds images, as in the
JAX package: the stand-ins need none.
"""
from __future__ import annotations

import glob
import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import transforms as T
from ..utils.reshape import reshape_temporal_dim_np

DATA_ROOT = os.environ.get("IPDM_DATA_ROOT", os.path.expanduser("~/data"))

REGISTERED_DATA_ROOT_DIR = {
    "MNIST": os.path.join(DATA_ROOT, "mnist"),
    "CIFAR10": os.path.join(DATA_ROOT, "cifar10"),
    "CINE64": os.path.join(DATA_ROOT, "cine_64"),
    "CINE64_1D": os.path.join(DATA_ROOT, "cine_64"),
    "CINE127": os.path.join(DATA_ROOT, "cine_127"),
    "CINE127_1D": os.path.join(DATA_ROOT, "cine_127"),
    "ACDC": os.path.join(DATA_ROOT, "ACDC_slices"),
    "CELEBA": os.path.join(DATA_ROOT, "celeba"),
    "BEDROOM": os.path.join(DATA_ROOT, "lsun", "bedroom"),
    "CHURCH": os.path.join(DATA_ROOT, "lsun", "church_outdoor"),
    "TOWER": os.path.join(DATA_ROOT, "lsun", "tower"),
    "FFHQ": os.path.join(DATA_ROOT, "ffhq"),
}


@dataclass
class ArrayDataset:
    """In-memory dataset: data (N, ...) + optional labels (N, ...)."""
    data: np.ndarray
    labels: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, i):
        if self.labels is None:
            return self.data[i]
        return self.data[i], self.labels[i]


_PROVENANCE: Dict[str, Dict[str, Any]] = {}
_SYNTH_FLAG = {"v": False}


def data_provenance() -> Dict[str, Dict[str, Any]]:
    """{"<ds_name>/<mode>": {"source": "real" | "synthetic", "num_items":
    N}} for every `load_data` call of this process."""
    return {k: dict(v) for k, v in _PROVENANCE.items()}


def _warn_synthetic(name: str, root: str):
    _SYNTH_FLAG["v"] = True
    warnings.warn(
        f"{name}: dataset not found under {root!r}; using a SYNTHETIC "
        f"stand-in (set IPDM_DATA_ROOT or pass root_dir for real data)")


# ---------------------------------------------------------------------------
# MNIST, CIFAR10 and image folders (reference: load_data.py:95-122)
# ---------------------------------------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    """An IDX file (optionally gzipped) as a uint8 array of its shape."""
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = int.from_bytes(f.read(4), "big")
        ndim = magic & 0xFF
        shape = [int.from_bytes(f.read(4), "big") for _ in range(ndim)]
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def synthetic_digits(n: int, size: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Digit-like blobs, a bright stroke pattern per class: the synthetic
    stand-in for MNIST. Images (n, size, size, 1) float32 in [0, 1] and
    their classes (n,)."""
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, n)
    xs = np.zeros((n, size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1)
    for i, c in enumerate(ys):
        phase = 2 * np.pi * c / 10
        img = (np.sin(3 * np.pi * yy + phase) *
               np.cos((2 + c % 3) * np.pi * xx - phase))
        cy, cx = rng.uniform(0.3, 0.7, 2)
        bump = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 0.05))
        xs[i] = np.clip(np.abs(img) * bump + 0.05 * rng.rand(size, size),
                        0, 1)
    return xs[..., None], ys


def load_mnist(root_dir: Optional[str] = None, mode: str = "train",
               size: int = 32, **_) -> ArrayDataset:
    """MNIST resized to size x size (reference: load_data.py:95-108):
    images (N, size, size, 1) in [0, 1] and labels (N,). Reads the
    standard IDX files (train-* or t10k-*, plain or .gz, in root, MNIST/raw
    or raw) if present; the synthetic digits otherwise."""
    if mode not in ("train", "val", "test"):
        raise ValueError(f"unknown split {mode!r}")
    root = root_dir or REGISTERED_DATA_ROOT_DIR["MNIST"]
    prefix = "train" if mode == "train" else "t10k"
    candidates = [os.path.join(root, sub, f"{prefix}-images-idx3-ubyte{gz}")
                  for sub in ("", "MNIST/raw", "raw") for gz in ("", ".gz")]
    img_path = next((p for p in candidates if os.path.exists(p)), None)
    if img_path is None:
        _warn_synthetic("MNIST", root)
        n = 2048 if mode == "train" else 256
        xs, ys = synthetic_digits(n, size, seed=0 if mode == "train" else 1)
        return ArrayDataset(xs, ys)
    lbl_path = img_path.replace("images-idx3", "labels-idx1")
    xs = _read_idx(img_path).astype(np.float32) / 255.0       # (N, 28, 28)
    ys = _read_idx(lbl_path).astype(np.int64)
    if size != xs.shape[1]:
        xs = np.stack([T.resize(x[None], (size, size))[0] for x in xs])
    return ArrayDataset(xs[..., None], ys)


def load_cifar10(root_dir: Optional[str] = None, mode: str = "train",
                 **_) -> ArrayDataset:
    """CIFAR-10 (reference: load_data.py:110-122): the python-pickle
    batches under <root>/cifar-10-batches-py if present (data_batch_1..5
    for train, test_batch otherwise), else 2048 / 256 seeded uniform
    stand-ins; (N, 32, 32, 3) float32 in [0, 1] and int64 labels."""
    assert mode in ("train", "val", "test")
    root = root_dir or REGISTERED_DATA_ROOT_DIR["CIFAR10"]
    batch_dir = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(batch_dir):
        _warn_synthetic("CIFAR10", root)
        rng = np.random.RandomState(0 if mode == "train" else 1)
        n = 2048 if mode == "train" else 256
        xs = rng.rand(n, 32, 32, 3).astype(np.float32)
        ys = rng.randint(0, 10, n)
        return ArrayDataset(xs, ys)
    import pickle
    names = [f"data_batch_{i}" for i in range(1, 6)] if mode == "train" \
        else ["test_batch"]
    data, labels = [], []
    for nm in names:
        with open(os.path.join(batch_dir, nm), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        data.append(d[b"data"])
        labels.extend(d[b"labels"])
    xs = np.concatenate(data).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(xs.astype(np.float32) / 255.0,
                        np.asarray(labels, np.int64))


def synthetic_rgb(n: int, size: int, seed: int = 0) -> np.ndarray:
    """Smooth RGB stand-ins (N, size, size, 3) in [0, 1] for the
    natural-image recipes (CelebA, LSUN, FFHQ): six Gaussian blobs of
    random colour per image, normalized to a maximum of 1."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        img = np.zeros((size, size, 3), np.float32)
        for _ in range(6):
            cx, cy = rng.rand(2)
            sx, sy = 0.08 + 0.3 * rng.rand(2)
            blob = np.exp(-((xx - cx) ** 2 / (2 * sx ** 2)
                            + (yy - cy) ** 2 / (2 * sy ** 2)))
            img += blob[..., None] * rng.rand(3)
        img /= max(img.max(), 1e-6)
        out[i] = img
    return out


def load_image_folder(root_dir: str, mode: str = "train", size: int = 64,
                      name: str = "images", **_) -> ArrayDataset:
    """A natural-image folder (CelebA, LSUN categories, FFHQ): every png /
    jpg / jpeg / webp file under root_dir, sorted by path, center-cropped
    to a square and resized bilinearly to (size, size) RGB in [0, 1]. The
    last tenth (at least 2 files, leaving train one) is held out, its
    first half val and its second half test. An empty or absent folder
    gives `synthetic_rgb` stand-ins (2048 train, 256 otherwise); Pillow is
    imported only to read files."""
    assert mode in ("train", "val", "test")
    exts = (".png", ".jpg", ".jpeg", ".webp")
    files: List[str] = []
    if os.path.isdir(root_dir):
        for dirpath, _dirs, names in os.walk(root_dir):
            files.extend(os.path.join(dirpath, f) for f in names
                         if f.lower().endswith(exts))
    files.sort()
    if not files:
        _warn_synthetic(name, root_dir)
        n = 2048 if mode == "train" else 256
        return ArrayDataset(
            synthetic_rgb(n, size, seed=0 if mode == "train" else 1))
    n_hold = min(max(2, len(files) // 10), max(len(files) - 1, 0))
    if n_hold == 0:     # a single file serves every split, with a warning
        _warn_synthetic(name + " (single file; no held-out split)", root_dir)
    elif mode == "train":
        files = files[:-n_hold]
    else:
        hold = files[-n_hold:]
        if len(hold) < 2:
            files = hold    # val and test share the one held-out file
        else:
            half = len(hold) // 2
            files = hold[:half] if mode == "val" else hold[half:]
    from PIL import Image
    xs = np.empty((len(files), size, size, 3), np.float32)
    for i, path in enumerate(files):
        with Image.open(path) as im:
            im = im.convert("RGB")
            w, h = im.size
            s = min(w, h)
            im = im.crop(((w - s) // 2, (h - s) // 2,
                          (w + s) // 2, (h + s) // 2))
            im = im.resize((size, size), Image.BILINEAR)
            xs[i] = np.asarray(im, np.float32) / 255.0
    return ArrayDataset(xs)


# ---------------------------------------------------------------------------
# CINE (reference: load_data.py:125-164)
# ---------------------------------------------------------------------------

def synthetic_cine(n: int, T_frames: int, H: int, W: int, seed: int = 0
                   ) -> np.ndarray:
    """Beating-heart phantoms (N, T, H, W) in [0, 1], the synthetic
    stand-in for the cardiac cine .mat files: a two-harmonic beat, periodic
    centre drift, a rotating angular texture, a fast flicker of the
    myocardial ring (4-8 cycles per loop) and a non-periodic contrast
    bolus through the blood pool."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = np.zeros((n, T_frames, H, W), np.float32)
    for i in range(n):
        cy0, cx0 = rng.uniform(0.35, 0.65, 2) * [H, W]
        r0 = rng.uniform(0.15, 0.25) * min(H, W)
        amp = rng.uniform(0.05, 0.12) * min(H, W)
        bg = 0.15 + 0.1 * rng.rand(H, W)
        ph_beat = rng.uniform(0, 2 * np.pi)
        h2 = rng.uniform(0.2, 0.5)                 # 2nd beat harmonic
        drift = rng.uniform(0.01, 0.03) * min(H, W)
        ph_drift = rng.uniform(0, 2 * np.pi)
        k_ang = rng.randint(3, 7)                  # angular lobes
        m_rot = rng.randint(1, 4) * rng.choice([-1, 1])  # rot cycles/loop
        tex_amp = rng.uniform(0.10, 0.20)
        f_flick = rng.randint(4, 9)                # through-plane flicker
        flick_amp = rng.uniform(0.15, 0.30)
        ph_flick = rng.uniform(0, 2 * np.pi)
        bolus_t0 = rng.uniform(0.05, 0.35)         # arrival, loop fraction
        bolus_tau = rng.uniform(0.08, 0.18)
        bolus_amp = rng.uniform(0.25, 0.5)
        for t in range(T_frames):
            p = 2 * np.pi * t / T_frames
            r = r0 + amp * (np.sin(p + ph_beat)
                            + h2 * np.sin(2 * (p + ph_beat))) / (1 + h2)
            cy = cy0 + drift * np.sin(p + ph_drift)
            cx = cx0 + drift * np.cos(p + ph_drift)
            d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            theta = np.arctan2(yy - cy, xx - cx)
            ring = np.clip(1.2 - np.abs(d - r) / (0.35 * r), 0, 1)
            blob = 0.8 * np.exp(-(d / (0.55 * r)) ** 2)
            tex = tex_amp * np.cos(k_ang * theta - m_rot * p) \
                * np.exp(-(d / (0.8 * r)) ** 2)
            flick = 1.0 + flick_amp * np.sin(f_flick * p + ph_flick)
            tb = max(t / T_frames - bolus_t0, 0.0) / bolus_tau
            bolus = 1.0 + bolus_amp * (tb * np.exp(1.0 - tb))
            out[i, t] = np.clip(bg + ring * 0.6 * flick
                                + blob * 0.25 * bolus + tex, 0, 1)
    return out


def load_cine(root_dir: Optional[str] = None, mode: str = "train",
              img_key: str = "imgs", flatten: bool = True,
              flatten_type: str = "spatial",
              resize_shape: Optional[int] = None,
              resize_shape_T: Optional[int] = None,
              win_size: int = 2, default_t: int = 25, default_hw: int = 127,
              **_) -> ArrayDataset:
    """CINE .mat loader with per-sample min-max normalization and spatial
    or temporal flattening (reference: load_data.py:125-164).

    spatial: (N, T, H, W) -> (N*T, H, W, 1) frames.
    temporal: resize, then k x k pixel tubes -> (N', T, win^2).
    """
    if mode not in ("train", "val", "test"):
        raise ValueError(f"unknown split {mode!r}")
    if flatten_type not in ("spatial", "temporal"):
        raise ValueError(f"unknown flatten_type {flatten_type!r}")
    fmode = "test" if mode == "val" else mode
    root = root_dir or REGISTERED_DATA_ROOT_DIR["CINE127"]
    matches = glob.glob(os.path.join(root, f"*{fmode}*.mat")) \
        if os.path.isdir(root) else []
    if matches:
        import scipy.io as sio
        ds = sio.loadmat(matches[0])[img_key]          # (H, W, T, N)
        ds = ds.transpose(3, 2, 0, 1).astype(np.float32)  # (N, T, H, W)
    else:
        _warn_synthetic("CINE", root)
        n = 12 if fmode == "train" else 4
        ds = synthetic_cine(n, default_t, default_hw, default_hw,
                            seed=0 if fmode == "train" else 1)

    lo = ds.min(axis=(1, 2, 3), keepdims=True)
    hi = ds.max(axis=(1, 2, 3), keepdims=True)
    ds = (ds - lo) / np.maximum(hi - lo, 1e-12)

    if not flatten:
        return ArrayDataset(ds)
    N, Tf, H, W = ds.shape
    if flatten_type == "spatial":
        frames = ds.reshape(-1, H, W)
        if resize_shape is not None and (H, W) != (resize_shape, resize_shape):
            frames = np.stack([
                T.resize(f[None], (resize_shape, resize_shape))[0]
                for f in frames])
        return ArrayDataset(frames[..., None])
    # temporal: resize (T, H, W) jointly, then tubes
    rT = resize_shape_T or Tf
    rH = resize_shape or H
    rW = resize_shape or W
    if (rT, rH, rW) != (Tf, H, W):
        ds = np.stack([
            np.stack([T.resize(fr[None], (rH, rW))[0] for fr in vol])
            for vol in ds])
        if rT != Tf:
            ds = np.stack([
                T.resize(vol.transpose(1, 0, 2), (rT, rW)).transpose(1, 0, 2)
                for vol in ds])
    tubes = reshape_temporal_dim_np(ds, win_size, win_size)  # (N', T, k^2)
    return ArrayDataset(tubes.astype(np.float32))


# ---------------------------------------------------------------------------
# ACDC (reference: load_data.py:206-283)
# ---------------------------------------------------------------------------

def load_tissue_data(path: str):
    """(image, multiClassMasks, PD, T1, T2), each (1, H, W)
    (reference: load_data.py:170-183)."""
    d = np.load(path)
    return (d["image"], d["multiClassMasks"], d["PD"], d["T1"], d["T2"])


def vol2slice(root_dir: str, save_dir: str) -> List[str]:
    """Split each volume .npz of root_dir (image, multiClassMasks, PD, T1,
    T2, slices on axis 1) into per-slice files `<name>_<s>.npz` in
    save_dir; returns the paths written (reference: load_data.py:185-203)."""
    os.makedirs(save_dir, exist_ok=True)
    written = []
    for filename in glob.glob(os.path.join(root_dir, "*.npz")):
        image, mc, PD, T1, T2 = load_tissue_data(filename)
        base = os.path.basename(filename)[:-len(".npz")]
        for s in range(image.shape[1]):
            out = os.path.join(save_dir, f"{base}_{s}.npz")
            np.savez(out, image=image[:, s], multiClassMasks=mc[:, s],
                     PD=PD[:, s], T1=T1[:, s], T2=T2[:, s])
            written.append(out)
    return written


def synthetic_acdc_slice(rng: np.random.RandomState, H: int = 200,
                         W: int = 220) -> Tuple[np.ndarray, np.ndarray]:
    """Cardiac-slice phantom: blood pool + myocardium ring; labels use the
    ACDC convention (3 = left myocardium)."""
    yy, xx = np.mgrid[0:H, 0:W]
    cy, cx = rng.uniform(0.4, 0.6, 2) * [H, W]
    r = rng.uniform(0.1, 0.16) * min(H, W)
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    myo = (d > r) & (d < 1.5 * r)
    pool = d <= r
    img = (0.2 + 0.15 * rng.rand(H, W) + 0.5 * pool + 0.35 * myo
           ).astype(np.float32)
    label = np.zeros((H, W), np.int64)
    label[myo] = 3
    return img[None], label[None]


def load_acdc(root_dir: Optional[str] = None,
              train_test_split: Sequence[float] = (0.8, 0.1),
              seg_labels: Sequence[int] = (3,), mode: str = "train",
              seed: int = 0, if_aug: bool = True, image_size: int = 256,
              **_) -> ArrayDataset:
    """ACDC slice pipeline: binarize seg labels, ScaleIntensity,
    CropForeground, train-time aug (rotate/contrast/noise), Resize
    (reference: load_data.py:246-283). Returns images (N, S, S, 1) and
    masks (N, S, S)."""
    if mode not in ("train", "val", "test"):
        raise ValueError(f"unknown split {mode!r}")
    root = root_dir or REGISTERED_DATA_ROOT_DIR["ACDC"]
    files = sorted(glob.glob(os.path.join(root, "*.npz"))) \
        if os.path.isdir(root) else []
    rng = np.random.RandomState(seed)
    if files:
        rng.shuffle(files)
        i0 = int(len(files) * train_test_split[0])
        i1 = int(len(files) * sum(train_test_split))
        files = {"train": files[:i0], "val": files[i0:i1],
                 "test": files[i1:]}[mode]
        raw = [load_tissue_data(f)[:2] for f in files]
    else:
        _warn_synthetic("ACDC", root)
        n = {"train": 24, "val": 6, "test": 6}[mode]
        srng = np.random.RandomState(seed + {"train": 0, "val": 1,
                                             "test": 2}[mode])
        raw = [synthetic_acdc_slice(srng) for _ in range(n)]

    aug_rng = np.random.RandomState(seed + 123)
    imgs, labels = [], []
    for image, mc in raw:
        label = np.isin(mc, list(seg_labels)).astype(np.int64)
        image = T.scale_intensity(image.astype(np.float32))
        image, label = T.crop_foreground(image, label, source=image)
        if mode == "train" and if_aug:
            image, label = T.rand_rotate(image, label, aug_rng)
            image = T.rand_adjust_contrast(image, aug_rng)
            image = T.rand_gaussian_noise(image, aug_rng)
        image = T.resize(image, (image_size, image_size), "bilinear")
        label = T.resize(label, (image_size, image_size), "nearest")
        imgs.append(image[0])
        labels.append(label[0])
    xs = np.stack(imgs)[..., None].astype(np.float32)
    ys = np.stack(labels).astype(np.int64)
    return ArrayDataset(xs, ys)


# ---------------------------------------------------------------------------
# SanityCheck1D (reference: load_data.py:286-298)
# ---------------------------------------------------------------------------

def load_sanity_check_1d(num_samples: int = 1024, num_channels: int = 4,
                         num_features: int = 24, seed: int = 0,
                         **_) -> ArrayDataset:
    """s(t) = a t / T + b sin(w t) + noise, a ~ Unif{-1, 1} per sample and
    channel: (N, T, C) float32, channel-last."""
    rng = np.random.RandomState(seed)
    b, w, sigma = 0.2, 1.0, 0.01
    a = rng.choice([-1.0, 1.0], (num_samples, 1, num_channels))
    t = np.arange(num_features, dtype=np.float32)[None, :, None]
    x = a * t / num_features + b * np.sin(w * t)
    x = x + rng.randn(*x.shape).astype(np.float32) * sigma
    return ArrayDataset(x.astype(np.float32))


# ---------------------------------------------------------------------------
# dispatch (reference: load_data.py:55-92)
# ---------------------------------------------------------------------------

def load_data(ds_name: str, mode: str = "train", **kwargs) -> ArrayDataset:
    """The dataset `ds_name`'s split `mode`, recorded in
    `data_provenance()`."""
    _SYNTH_FLAG["v"] = False
    ds = _load_data(ds_name, mode=mode, **kwargs)
    _PROVENANCE[f"{ds_name}/{mode}"] = {
        "source": "synthetic" if _SYNTH_FLAG["v"] else "real",
        "num_items": len(ds)}
    return ds


def _load_data(ds_name: str, mode: str = "train", **kwargs) -> ArrayDataset:
    if ds_name == "MNIST":
        return load_mnist(mode=mode, **kwargs)
    if ds_name in ("CINE64", "CINE127"):
        root = kwargs.pop("root_dir", REGISTERED_DATA_ROOT_DIR[ds_name])
        size = 64 if ds_name == "CINE64" else 127
        kwargs.setdefault("flatten_type", "spatial")
        if ds_name == "CINE127":
            # the reference resizes 127 -> 128 in both flatten modes
            # (load_data.py:74-78); cine127.yml declares image_size 128
            kwargs.setdefault("resize_shape", 128)
        return load_cine(root_dir=root, mode=mode,
                         default_hw=size, **kwargs)
    if ds_name in ("CINE64_1D", "CINE127_1D"):
        root = kwargs.pop("root_dir", REGISTERED_DATA_ROOT_DIR[ds_name])
        size = 64 if "64" in ds_name else 127
        kwargs.setdefault("win_size", 8)
        kwargs.setdefault("resize_shape", 128 if size == 127 else 64)
        kwargs.setdefault("resize_shape_T", 24)
        kwargs.setdefault("flatten_type", "temporal")
        return load_cine(root_dir=root, mode=mode,
                         default_hw=size, **kwargs)
    if ds_name == "ACDC":
        return load_acdc(mode=mode, **kwargs)
    if ds_name == "SanityCheck1D":
        _SYNTH_FLAG["v"] = True          # synthetic by construction
        # the reference's splits: train seed 0, 1000 samples; val and test
        # seed 10, 300 (load_data.py:88-91)
        train = mode == "train"
        kwargs.setdefault("seed", 0 if train else 10)
        kwargs.setdefault("num_samples", 1000 if train else 300)
        return load_sanity_check_1d(**kwargs)
    if ds_name in ("CIFAR10", "NCSN_ORIGINAL"):
        # NCSN_ORIGINAL is NCSN v1's CIFAR-10 recipe (its config's
        # data.dataset); the JAX package's load_data has no branch for it
        return load_cifar10(mode=mode, **kwargs)
    if ds_name in ("CELEBA", "BEDROOM", "CHURCH", "TOWER", "FFHQ"):
        root = kwargs.pop("root_dir", REGISTERED_DATA_ROOT_DIR[ds_name])
        kwargs.setdefault("size", {"CELEBA": 64, "BEDROOM": 128,
                                   "CHURCH": 64, "TOWER": 128,
                                   "FFHQ": 256}[ds_name])
        return load_image_folder(root, mode=mode, name=ds_name, **kwargs)
    raise KeyError(f"unknown dataset {ds_name!r}")


def _wrap_provenance(fn, name: str):
    """A loader that records its own `<name>/<mode>` provenance when called
    directly (scripts call load_cine etc. without load_data)."""
    import functools
    import inspect

    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        prev = _SYNTH_FLAG["v"]
        _SYNTH_FLAG["v"] = False
        ds = fn(*args, **kwargs)
        # bind positionally too: every loader takes root_dir first, so a
        # bare positional "test" is the root, not the mode
        try:
            bound = sig.bind_partial(*args, **kwargs).arguments
        except TypeError:
            bound = kwargs
        param = sig.parameters.get("mode")
        default = ("train" if param is None
                   or param.default is inspect.Parameter.empty
                   else param.default)
        mode = bound.get("mode", default)
        _PROVENANCE[f"{name}/{mode}"] = {
            "source": "synthetic" if _SYNTH_FLAG["v"] else "real",
            "num_items": len(ds)}
        _SYNTH_FLAG["v"] = _SYNTH_FLAG["v"] or prev
        return ds

    return wrapper


def reset_provenance() -> None:
    """Clear the provenance map (a long-lived process, at the start of a
    run, so that saved artifacts name only that run's datasets)."""
    _PROVENANCE.clear()
    _SYNTH_FLAG["v"] = False


load_mnist = _wrap_provenance(load_mnist, "MNIST")
load_cifar10 = _wrap_provenance(load_cifar10, "CIFAR10")
load_cine = _wrap_provenance(load_cine, "CINE")
load_acdc = _wrap_provenance(load_acdc, "ACDC")
load_image_folder = _wrap_provenance(load_image_folder, "images")
