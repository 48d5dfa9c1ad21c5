"""The README quick start's data and sampler in the port against the JAX
package: the MNIST and SanityCheck1D configs, the MNIST loader (its IDX
files and its synthetic digits), the SanityCheck1D signals, the loaders'
file branches (CINE .mat, ACDC .npz slices), `ald_unconditional_sampler`
fed JAX's start and noise, and `scripts/unconditioned_sampling` for its
three task names against the JAX script.

Configs and data are held bit for bit. The sampler runs an analytic score
(a Gaussian's, exact in float32 up to rounding) at rtol 1e-5; the scripts
run the nets at NET_TOL (tests/test_torch_ncsnv2.py) over a few Langevin
steps, each with the same weights, start and noise in both packages.
"""
import ast
import contextlib
import gzip
import io
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from PIL import Image
import scipy.io as sio
import torch

from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.data import datasets as jdatasets
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    TASK_NAME_TO_MODEL_CTOR as JAX_TASKS, _example_input)
from inverseproblemwithdiffusionmodel_tpu.samplers import ald as jald
from inverseproblemwithdiffusionmodel_tpu.scripts import (
    unconditioned_sampling as jax_script)
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.data import datasets
from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
    unconditioned_sampling as script)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch)
from tests.test_torch_ald_pair import replay
from tests.test_torch_ncsnv2 import NET_TOL, init_flax
from tests.test_torch_sense_recon import _flags, _paths

torch.set_num_threads(1)

MODES = ("real-valued", "mag", "complex", "real-imag", "real-imag-random")


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["MNIST", "SanityCheck1D"])
@pytest.mark.parametrize("mode", MODES)
def test_config_equals_the_yaml(name, mode):
    ours = load_config(name, mode).to_dict()
    ref = jax_load_config(name, mode).to_dict()
    assert ours == ref

    def types(d):
        return {k: types(v) if isinstance(v, dict) else type(v)
                for k, v in d.items()}

    assert types(ours) == types(ref)


# -- MNIST and SanityCheck1D data -------------------------------------------

@pytest.mark.parametrize("n,size,seed", [(5, 32, 0), (3, 28, 1), (4, 16, 7)])
def test_synthetic_digits_are_bit_equal(n, size, seed):
    xs, ys = datasets.synthetic_digits(n, size, seed)
    jxs, jys = jdatasets.synthetic_digits(n, size, seed)
    assert xs.dtype == jxs.dtype and xs.shape == (n, size, size, 1)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)


@pytest.mark.parametrize("kw", [{}, {"num_samples": 7, "num_channels": 64,
                                     "num_features": 32, "seed": 3}])
def test_sanity_check_1d_is_bit_equal(kw):
    ours = datasets.load_sanity_check_1d(**kw).data
    ref = jdatasets.load_sanity_check_1d(**kw).data
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("name,mode,kw", [
    ("MNIST", "train", {}), ("MNIST", "test", {"size": 28}),
    ("SanityCheck1D", "train", {"num_channels": 64, "num_features": 32}),
    ("SanityCheck1D", "val", {})],
    ids=["mnist-train", "mnist-test28", "sanity-train", "sanity-val"])
def test_load_data_equals_jax_on_the_synthetic_data(tmp_path, name, mode,
                                                    kw):
    if name == "MNIST":
        kw = dict(kw, root_dir=str(tmp_path))       # no files: synthetic
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = datasets.load_data(name, mode, **dict(kw))
        ref = jdatasets.load_data(name, mode, **dict(kw))
    np.testing.assert_array_equal(ours.data, ref.data)
    if ref.labels is not None:
        np.testing.assert_array_equal(ours.labels, ref.labels)
    assert datasets.data_provenance()[f"{name}/{mode}"] == {
        "source": "synthetic", "num_items": len(ref)}


def _write_idx(path, array):
    """An IDX file of uint8 `array` (the MNIST layout: magic 0x0000080n,
    n big-endian sizes, the bytes)."""
    header = (0x800 | array.ndim).to_bytes(4, "big") + b"".join(
        int(d).to_bytes(4, "big") for d in array.shape)
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


@pytest.mark.parametrize("sub,gz,size", [("", "", 28), ("raw", ".gz", 32),
                                         ("MNIST/raw", "", 32)])
def test_load_mnist_reads_idx_files_as_jax_does(tmp_path, sub, gz, size):
    rs = np.random.RandomState(0)
    folder = tmp_path / sub
    folder.mkdir(parents=True, exist_ok=True)
    for prefix, n in (("train", 6), ("t10k", 3)):
        _write_idx(str(folder / f"{prefix}-images-idx3-ubyte{gz}"),
                   rs.randint(0, 256, (n, 28, 28)))
        _write_idx(str(folder / f"{prefix}-labels-idx1-ubyte{gz}"),
                   rs.randint(0, 10, (n,)))
    for mode, n in (("train", 6), ("val", 3)):
        ours = datasets.load_data("MNIST", mode, root_dir=str(tmp_path),
                                  size=size)
        ref = jdatasets.load_data("MNIST", mode, root_dir=str(tmp_path),
                                  size=size)
        assert ours.data.shape == (n, size, size, 1)
        assert ours.data.dtype == ref.data.dtype
        np.testing.assert_array_equal(ours.data, ref.data)
        np.testing.assert_array_equal(ours.labels, ref.labels)
        assert datasets.data_provenance()[f"MNIST/{mode}"]["source"] == \
            "real"


# -- the loaders' file branches ----------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("CINE64", {}), ("CINE64_1D", {}),
    ("CINE127_1D", {"resize_shape": 16, "win_size": 4})],
    ids=["cine64-frames", "cine64_1d-tubes", "cine127_1d-resized"])
def test_cine_mat_files_load_as_jax_loads_them(tmp_path, name, kw):
    """*train*.mat / *test*.mat files holding `imgs` (H, W, T, N)."""
    rs = np.random.RandomState(1)
    for split, n in (("train", 3), ("test", 2)):
        sio.savemat(str(tmp_path / f"cine_{split}_set.mat"),
                    {"imgs": (rs.rand(16, 16, 6, n) * 300).astype(
                        np.float64)})
    for mode in ("train", "val"):
        ours = datasets.load_data(name, mode, root_dir=str(tmp_path), **kw)
        ref = jdatasets.load_data(name, mode, root_dir=str(tmp_path), **kw)
        assert ours.data.dtype == ref.data.dtype
        assert ours.data.shape == ref.data.shape
        np.testing.assert_array_equal(ours.data, ref.data)
        assert datasets.data_provenance()[f"{name}/{mode}"]["source"] == \
            "real"


def test_acdc_npz_slices_load_as_jax_loads_them(tmp_path):
    """Per-slice .npz files with image and multiClassMasks (1, H, W), and
    the PD / T1 / T2 maps `load_tissue_data` reads: shuffled, split 80 /
    10 / 10, augmented in train."""
    rs = np.random.RandomState(2)
    for i in range(10):
        img, lab = datasets.synthetic_acdc_slice(rs, 40, 44)
        maps = {k: rs.rand(1, 40, 44).astype(np.float32)
                for k in ("PD", "T1", "T2")}
        np.savez(str(tmp_path / f"patient{i:03d}_{i % 3}.npz"), image=img,
                 multiClassMasks=lab, **maps)
    for mode in ("train", "val", "test"):
        kw = dict(root_dir=str(tmp_path), image_size=24, seed=5)
        ours = datasets.load_data("ACDC", mode, **kw)
        ref = jdatasets.load_data("ACDC", mode, **kw)
        assert len(ours) == {"train": 8, "val": 1, "test": 1}[mode]
        np.testing.assert_array_equal(ours.data, ref.data)
        np.testing.assert_array_equal(ours.labels, ref.labels)


def test_loaders_refuse_what_is_not_ported():
    # all fourteen dataset names are ported (tests/test_torch_natural_
    # data.py); an unknown one raises
    with pytest.raises(KeyError, match="unknown dataset"):
        datasets.load_data("IMAGENET")
    with pytest.raises(KeyError, match="unknown dataset"):
        load_config("IMAGENET")


# -- ald_unconditional_sampler ------------------------------------------------

def jax_draws(seed, shape, n_draws):
    """The JAX script's start (U(0, 1) from the first split of
    PRNGKey(seed)), the key it hands the sampler, and the sampler's noise
    draws in its key schedule (one split for its unused start, then one
    per inner step)."""
    key, k_init = jax.random.split(jax.random.PRNGKey(seed))
    x0 = np.array(jax.random.uniform(k_init, shape))
    sampler_key = key
    key, _ = jax.random.split(key)
    noises = []
    for _ in range(n_draws):
        key, kn = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(kn, shape)))
    return x0, sampler_key, noises


SIGMAS = np.exp(np.linspace(np.log(2.0), np.log(0.05), 4)).astype(np.float32)


@pytest.mark.parametrize("denoise", [True, False])
def test_sampler_matches_jax_fed_its_draws(denoise):
    rs = np.random.RandomState(3)
    shape = (3, 5, 4, 2)
    mu = rs.randn(*shape[1:]).astype(np.float32)
    cfg = dict(n_steps_each=3, step_lr=2e-4, denoise=denoise)
    x0, key, noises = jax_draws(4, shape, len(SIGMAS) * 3)
    jsig = jnp.asarray(SIGMAS)
    jscore = lambda x, c: (jnp.asarray(mu) - x) / jsig[c][:, None, None,
                                                          None] ** 2
    ref = np.asarray(jald.ald_unconditional_sampler(
        jscore, jsig, shape, key, jald.ALDConfig(**cfg),
        x_init=jnp.asarray(x0)))
    snaps = []
    tsig = torch.from_numpy(SIGMAS)
    tmu = torch.from_numpy(mu)
    tscore = lambda x, c: (tmu - x) / tsig[c].reshape(-1, 1, 1, 1) ** 2
    ours = ald.ald_unconditional_sampler(
        tscore, SIGMAS, shape, config=ald.ALDConfig(**cfg, snapshot_every=2),
        x_init=torch.from_numpy(x0), noise=replay(noises), device="cpu",
        snapshot_fn=lambda c, s, x: snaps.append((c, s, x.clone())))
    assert ours.shape == shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert [c for c, _, _ in snaps] == [0, 2]
    assert snaps[1][1] == pytest.approx(float(SIGMAS[2]))


def test_sampler_seed_draws_start_and_noise_from_one_generator():
    shape = (2, 3, 3, 1)
    score = lambda x, c: -x
    cfg = ald.ALDConfig(n_steps_each=2, step_lr=1e-3, denoise=False)
    a = ald.ald_unconditional_sampler(score, SIGMAS, shape, seed=5,
                                      config=cfg, device="cpu")
    b = ald.ald_unconditional_sampler(score, SIGMAS, shape, seed=5,
                                      config=cfg, device="cpu")
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(5)
    x0 = torch.rand(shape, generator=gen)
    c = ald.ald_unconditional_sampler(
        score, SIGMAS, shape, config=cfg, x_init=x0, device="cpu",
        noise=lambda s: torch.randn(tuple(s), generator=gen))
    assert torch.equal(a, c)
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            ald.ald_unconditional_sampler(score, SIGMAS, shape)


# -- the script ---------------------------------------------------------------

TASKS = {
    "Diffusion": ("MNIST", {"data.image_size": 16}),
    "Diffusion1D": ("CINE64_1D", {"data.image_size": 8}),
    "Diffusion3D": ("CINE64_1D", {"data.image_size": 8, "data.channels": 16}),
}
# the ladders cut to 3 levels; step_lr 1e-7 keeps the first step of the
# cut ladder (step_lr (sigma_1 / sigma_L)^2, 1.6 to 2.5) from throwing the
# random nets' chains to values of order 1e2
LEVELS, STEPS = 3, 2


def _override(over):
    flags = []
    for k, v in dict(over, **{"model.ngf": 8,
                              "model.num_classes": LEVELS}).items():
        flags += ["--override", f"{k}={v}"]
    return flags


@pytest.mark.parametrize("task", sorted(TASKS))
def test_script_matches_the_jax_script(tmp_path, monkeypatch, task):
    """Both scripts on the same weights (drawn for the JAX net, converted
    for the port's), the port fed the JAX script's start and noise: the
    samples, and the artifacts."""
    ds, over = TASKS[task]
    argv = ["--ds_name", ds, "--task_name", task, "--num_samples", "2",
            "--n_steps_each", str(STEPS), "--step_lr", "1e-7", "--seed",
            "1"] + _override(over)
    held = {}

    def jax_reload(config, task_name, ckpt_dir=None):
        module = JAX_TASKS[task_name](config)
        held["params"] = init_flax(module, _example_input(config, task_name),
                                   jnp.ones((1,)), seed=2)
        return module, held["params"]

    def port_reload(config, task_name, ckpt_dir=None):
        model = registry.TASK_NAME_TO_MODEL_CTOR[task_name](config)
        transposed = {n for n, m in model.named_modules()
                      if type(m).__name__ == "ConvTranspose"}
        model.load_state_dict(flax_to_torch(held["params"], transposed),
                              strict=True)
        return model, None

    monkeypatch.setattr(jax_script, "reload_model", jax_reload)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_script.main(argv + ["--save_dir", str(tmp_path / "jax"),
                                      "--if_save_fig", "--if_save_as_gif"])
    shape = ref.shape
    x0, _, noises = jax_draws(1, shape, LEVELS * STEPS)

    sampler = script.ald_unconditional_sampler

    def fed(*args, **kwargs):
        assert kwargs["seed"] == 1 and tuple(args[2]) == shape
        return sampler(*args, **dict(kwargs, x_init=torch.from_numpy(x0),
                                     noise=replay(noises)))

    monkeypatch.setattr(script, "reload_model", port_reload)
    monkeypatch.setattr(script, "ald_unconditional_sampler", fed)
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = script.main(argv + ["--device", "cpu", "--save_dir",
                                   str(tmp_path / "port"), "--if_save_fig",
                                   "--if_save_as_gif"])
    assert isinstance(ours, np.ndarray) and ours.shape == shape
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(ours, ref, **NET_TOL)
    assert "evaluations/s" in out.getvalue()
    (run,) = os.listdir(tmp_path / "port")
    (jrun,) = os.listdir(tmp_path / "jax")
    saved = set(os.listdir(tmp_path / "port" / run))
    expect = {"samples.npy", "args.json"}
    if task != "Diffusion":
        expect.add("sample0.gif")
    if task == "Diffusion1D":
        expect.add("signals.png")
    # the JAX script's files: the figure and the GIF drawn the same way
    assert saved == expect == set(os.listdir(tmp_path / "jax" / jrun))
    for name in expect - {"samples.npy", "args.json"}:
        with Image.open(tmp_path / "port" / run / name) as a, \
                Image.open(tmp_path / "jax" / jrun / name) as b:
            assert a.size == b.size
            assert getattr(a, "n_frames", 1) == getattr(b, "n_frames", 1)
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / run / "samples.npy"), ours)


def test_sample_shapes_are_the_jax_scripts():
    for task, (ds, over) in TASKS.items():
        cfg = load_config(ds, **over)
        assert script.sample_shape(cfg, task, 3) == {
            "Diffusion": (3, 16, 16, 1), "Diffusion1D": (3, 8, 64),
            "Diffusion3D": (3, 4, 4, 8, 1)}[task]


def test_script_flags_are_the_jax_scripts_and_use_mesh_raises(tmp_path):
    ours, ref = _paths("unconditioned_sampling.py")
    assert _flags(ours) == _flags(ref)
    # --use_mesh is ported: on the default device it needs a card and
    # raises before any work; on the CPU (a mesh of the one CPU device) it
    # gives the samples of the run without it
    with pytest.raises(RuntimeError, match="no CUDA"):
        script.main(["--use_mesh", "--save_dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
    tiny = ["--ds_name", "MNIST", "--device", "cpu", "--num_samples", "2",
            "--n_steps_each", "1", "--override", "model.ngf=8",
            "--override", "model.num_classes=3", "--save_dir",
            str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()):
        plain = script.main(tiny)
        meshed = script.main(tiny + ["--use_mesh"])
    np.testing.assert_array_equal(meshed, plain)
    tree = ast.parse(open(ours).read())
    assert not any(isinstance(n, ast.ImportFrom) and n.module
                   and n.module.startswith("jax") for n in ast.walk(tree))
