"""The port stands alone: it imports no JAX, Flax, Optax, Orbax, YAML or
msgpack and no module of the JAX package, and its entry points refuse to
fall back to the CPU when asked for the card."""
import ast
import contextlib
import importlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "inverseproblemwithdiffusionmodel_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "yaml", "msgpack", "optax", "orbax",
             "inverseproblemwithdiffusionmodel_tpu")


def _sources():
    for dirpath, _, names in os.walk(PORT):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "fir_ab.py")
    yield os.path.join(ROOT, "int8_ab.py")
    yield os.path.join(ROOT, "guided_gate.py")
    yield os.path.join(ROOT, "smoke_profile.py")
    yield os.path.join(ROOT, "tp_gate.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import sys\n"
        "import inverseproblemwithdiffusionmodel_tpu_torch\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.scripts import "
        "pc_sampling\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.utils import convert\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch import training\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.losses import dsm\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.models import ema\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.ops import "
        "flr_kernels, fused_act\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.utils import "
        "device, misc, precision\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.scripts import "
        "profile_forward\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch import config, "
        "configs_discrete\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.models import "
        "layers, ncsnv2, normalization, registry\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.operators import "
        "fourier, masks, pair\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.ops import "
        "fft_pair, resize\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.samplers import "
        "ald, ald_pair, sigmas\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.models import unet\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.serving import "
        "cine, engine, server\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.utils import "
        "reshape\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.operators import "
        "finite_diff\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.models import "
        "ncsn1d\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.scripts import "
        "serve_recon, train_ncsn\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.data import "
        "datasets, transforms\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.models import "
        "ddpm\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.sde import "
        "sampling, sde_lib\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.operators import "
        "base, masking, proximal\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.ops import fft\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch import parallel\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.utils import "
        "metrics\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.scripts import "
        "acdc_SENSE_real_img, "
        "acdc_inv_seg_sampling_keep_center_prox_real_imag\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch import "
        "regularizers, samplers\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.samplers import "
        "map_opt, map_pair\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.scripts import "
        "acdc_MAP, acdc_MAP_keep_center, acdc_SENSE_MAP, acdc_SENSE_TV, "
        "cine_SENSE_real_img_2d_time, cine_SENSE_real_img_2d_time_MAP, "
        "cine_inv_sampling_keep_center_prox_real_imag\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.models import "
        "ncsn3d\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.scripts import "
        "unconditioned_sampling\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.models import "
        "classifier\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.losses import "
        "guidance\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.samplers import "
        "ald_variants\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.scripts import "
        "train_clf, train_seg, mnist_inv_clf_sampling, "
        "mnist_inv_clf_prox_sampling, mnist_MAP, generate_train_ncsn, "
        "generate_train_seg\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.models import "
        "ncsn, simple\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.sde import odeint\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.utils import "
        "tb_export, torch_import\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.data import "
        "native_loader\n"
        "from inverseproblemwithdiffusionmodel_tpu_torch.scripts import "
        "export_tensorboard, import_torch_checkpoint\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_of_the_port_imports_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


RECON_SCRIPTS = ["acdc_SENSE_real_img",
                 "acdc_inv_seg_sampling_keep_center_prox_real_imag",
                 "acdc_MAP", "acdc_MAP_keep_center", "acdc_SENSE_MAP",
                 "acdc_SENSE_TV", "cine_SENSE_real_img_2d_time",
                 "cine_SENSE_real_img_2d_time_MAP",
                 "cine_inv_sampling_keep_center_prox_real_imag",
                 "unconditioned_sampling", "mnist_inv_clf_sampling",
                 "mnist_inv_clf_prox_sampling", "mnist_MAP"]


@pytest.mark.parametrize("script", ["pc_sampling", "pc_sampling --method ode",
                                    "pc_sampling --config ve/ncsn/cifar10",
                                    "profile_forward",
                                    "profile_forward --step --bf16",
                                    "serve_recon", "seg_grad_precision",
                                    "train_ncsn",
                                    "train_ncsn --task_name Diffusion3D",
                                    "train_clf", "train_seg",
                                    "unconditioned_sampling --task_name "
                                    "Diffusion3D --ds_name CINE127_1D",
                                    "import_torch_checkpoint"]
                         + RECON_SCRIPTS)
def test_entry_points_raise_without_a_card(monkeypatch, tmp_path, script):
    script, *flags = script.split()
    module = importlib.import_module(
        f"inverseproblemwithdiffusionmodel_tpu_torch.scripts.{script}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    save_dir = ["--save_dir", str(tmp_path)]
    argv = flags + {
        "pc_sampling": save_dir,
        "train_ncsn": ["--ds_name", "ACDC", "--log_dir", str(tmp_path)],
        "train_clf": ["--log_dir", str(tmp_path)],
        "train_seg": ["--log_dir", str(tmp_path)],
        "import_torch_checkpoint": ["--ckpt_path", str(tmp_path / "x.ckpt"),
                                    "--ds_name", "ACDC", "--out_dir",
                                    str(tmp_path / "ckpts")],
        **{name: save_dir for name in RECON_SCRIPTS},
    }.get(script, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert not list(tmp_path.iterdir())


def _tiny_reconstruction():
    """A 16 px NCSNv2Deepest (ngf 4), 2 coils, one static line mask and a
    2-level ladder, on the CPU: (model, sigmas, lin_tfm, proximal, y)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        NCSNv2Deepest)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairL2Penalty, PairSENSE)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        sigma_ladder)
    cfg = load_config("ACDC", "real-imag",
                      **{"data.image_size": 16, "model.ngf": 4})
    gen = torch.Generator().manual_seed(0)
    mask = (torch.rand(1, 1, 16, 1, generator=gen) < 0.5).float()
    sens = torch.rand(2, 16, 16, 1, generator=gen)
    op = PairSENSE(mask=mask, sens_re=sens, sens_im=torch.zeros_like(sens))
    y = op(torch.rand(1, 16, 16, 1, generator=gen),
           torch.zeros(1, 16, 16, 1))
    return (NCSNv2Deepest(cfg), sigma_ladder(348, 0.01, 2), op,
            PairL2Penalty.with_normal_kernel(op, num_iters=2), y)


@pytest.mark.parametrize("entry", ["stepped", "scanned"])
def test_reconstruction_raises_without_a_card(monkeypatch, entry):
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        make_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        ald_inverse_proximal_pair, make_stepped_pair_reconstructor)
    model, sigmas, op, prox, y = _tiny_reconstruction()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "stepped":
            make_stepped_pair_reconstructor(model, sigmas, op, prox)
        else:
            ald_inverse_proximal_pair(make_score_fn(model, sigmas), sigmas,
                                      y, op, prox)
    assert next(model.parameters()).device.type == "cpu"


def test_reconstruction_runs_on_the_cpu_when_asked():
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        make_stepped_pair_reconstructor)
    model, sigmas, op, prox, y = _tiny_reconstruction()
    recon = make_stepped_pair_reconstructor(
        model, sigmas, op, prox, ALDConfig(n_steps_each=1), lr_scaled=5.0,
        device="cpu")
    xr, xi = recon(*y, seed=0)
    assert xr.shape == xi.shape == (1, 16, 16, 1)
    assert torch.isfinite(xr).all() and torch.isfinite(xi).all()


def _tiny_engine(**kw):
    from inverseproblemwithdiffusionmodel_tpu_torch.serving import (
        EngineSpec, ReconstructionEngine)
    model, sigmas, op, _, _ = _tiny_reconstruction()
    spec = EngineSpec(height=16, width=16, num_sens=2, chains=1, levels=2,
                      n_steps_each=1, dtype="f32")
    return model, ReconstructionEngine(
        model, sigmas, spec=spec, mask=op.mask.numpy(),
        sens_re=op.sens_re.numpy(), **kw)


def test_engine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tiny_engine()


def test_engine_runs_on_the_cpu_when_asked():
    model, eng = _tiny_engine(device="cpu")
    assert eng.device.type == "cpu"
    assert next(model.parameters()).device.type == "cpu"
    res = eng.reconstruct(np.zeros((2, 16, 16), np.float32),
                          np.zeros((2, 16, 16), np.float32))
    assert res.x_re.shape == (1, 16, 16, 1)
    assert np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()


def test_entry_point_runs_on_the_cpu_when_asked(tmp_path):
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import pc_sampling
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        samples = pc_sampling.main([
            "--config", "ve/ffhq_256_ncsnpp_continuous", "--num_samples",
            "2", "--device", "cpu", "--save_dir", str(tmp_path),
            "--override", "data.image_size=16", "--override", "model.nf=16",
            "--override", "model.ch_mult=(1, 2, 2)",
            "--override", "model.num_res_blocks=1",
            "--override", "model.attn_resolutions=(8,)",
            "--override", "model.num_scales=2"])
    assert isinstance(samples, np.ndarray)
    assert samples.shape == (2, 16, 16, 3) and "(nfe=4)" in out.getvalue()
    (run_dir,) = list(tmp_path.iterdir())
    assert sorted(os.listdir(run_dir)) == ["args.json", "samples.npy"]


def test_reconstruction_script_runs_on_the_cpu_when_asked(tmp_path):
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        acdc_inv_seg_sampling_keep_center_prox_real_imag as script)
    with contextlib.redirect_stdout(io.StringIO()):
        recons = script.main([
            "--device", "cpu", "--save_dir", str(tmp_path), "--override",
            "data.image_size=16", "--override", "model.ngf=4", "--override",
            "recons.num_classes=2", "--num_steps_each", "1"])
    assert isinstance(recons, np.ndarray) and recons.shape == (1, 16, 16, 1)
    assert np.isfinite(recons).all()


def test_unported_checkpoint_loading_raises(tmp_path):
    # --ckpt_dir reads the port's own checkpoints; an orbax checkpoint of
    # the JAX package (a step directory without the port's state.pt) is
    # converted first on a host with orbax, and the error names the tool.
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import pc_sampling
    (tmp_path / "5" / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="convert_orbax_checkpoint.py"):
        pc_sampling.main(["--device", "cpu", "--ckpt_dir", str(tmp_path)])


def test_overrides_parse_literals_without_yaml():
    from inverseproblemwithdiffusionmodel_tpu_torch.config import Config
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts._common import (
        apply_overrides)
    cfg = apply_overrides(Config({"model": {"nf": 128}}), [
        "model.nf=16", "model.ch_mult=(1, 2)", "model.name=ncsnpp",
        "model.snr=0.5", "model.fir=True"])
    assert cfg.model.to_dict() == {"nf": 16, "ch_mult": (1, 2),
                                   "name": "ncsnpp", "snr": 0.5, "fir": True}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
