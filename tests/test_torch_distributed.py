"""The port's parallel/distributed.py and the data-parallel train steps,
on the CPU: process groups of gloo on 127.0.0.1 in child processes (the
pytest process forms no group), beside tests/test_distributed_smoke.py.

- Two ranks check initialize_distributed, is_primary, local_batch_slice
  and an all_reduce, then take make_score_train_step(mesh=...) on the
  tiny NCSN1D with and without the foreground filter (filter_th), and
  the seg step (perturbed, Dice over the ranks), on the same weights,
  global batch and injected global draws. Each rank holds the same
  parameters afterwards; they are held to the one-process step (rel_l2
  <= 1e-6: the loss's sums split over the ranks) and, for the score
  steps, to the JAX step on a 2-device mesh fed the same draws (rel_l2 <=
  1e-5, the port's bound for a train step against JAX).
- A world of one (gloo) takes the mesh step bit for bit as the step
  without a mesh; so does `train_ncsn --use_mesh` in one process.

Each child gets a timeout, and every child still running when one
fails or the wait ends is killed.
"""
import contextlib
import io
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu import parallel as jparallel
from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.models import ncsn1d as jncsn1d
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    get_sigmas as jax_get_sigmas)
from inverseproblemwithdiffusionmodel_tpu.training.state import (
    TrainState as JaxTrainState, get_optimizer as jax_get_optimizer)
from inverseproblemwithdiffusionmodel_tpu.training.train import (
    make_score_train_step as jax_make_step)
from inverseproblemwithdiffusionmodel_tpu_torch import parallel
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import train_ncsn
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    Checkpointer)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnv2)
from tests.test_torch_ncsnv2 import init_flax
from tests.test_torch_train_ncsn import TUBE, jax_draws

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240                 # seconds for all children of one group
SEG = {"spatial_dims": 2, "in_channels": 1, "out_channels": 2,
       "channels": [4, 8], "strides": [2]}

# One rank of the group: reads the job, takes the steps, writes its state.
CHILD = textwrap.dedent('''
    import sys
    import torch
    torch.set_num_threads(1)
    from inverseproblemwithdiffusionmodel_tpu_torch import parallel
    from inverseproblemwithdiffusionmodel_tpu_torch.config import (
        Config, load_config)
    from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsn1d import (
        NCSN1D)
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        build_seg_unet)
    from inverseproblemwithdiffusionmodel_tpu_torch.parallel.distributed \\
        import all_reduce_sum_
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        TrainState, get_optimizer, make_score_train_step,
        make_seg_train_step)

    job, rank, world, port = (torch.load(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    assert not parallel.initialize_distributed(device="cpu")
    assert parallel.initialize_distributed(
        f"127.0.0.1:{port}", world, rank, device="cpu", timeout=60)
    assert parallel.initialize_distributed(device="cpu")   # already formed
    assert parallel.is_primary() == (rank == 0)
    per = 8 // world
    assert parallel.local_batch_slice(8) == slice(rank * per,
                                                  (rank + 1) * per)
    if world > 1:
        try:
            parallel.local_batch_slice(7)
            raise AssertionError("an indivisible batch passed")
        except ValueError:
            pass
    total = all_reduce_sum_([torch.tensor([rank + 1.0])])[0]
    assert total.item() == world * (world + 1) / 2
    mesh = parallel.make_mesh(devices=["cpu"])
    cfg = load_config("CINE127_1D", "real-imag", **job["over"])
    out = {}
    for name, th in (("plain", None), ("filtered", job["th"])):
        for meshed in ((False, True) if world == 1 else (True,)):
            model = NCSN1D(cfg)
            model.load_state_dict(job["params"])
            state = TrainState.create(model, get_optimizer(cfg),
                                      ema_decay=cfg.model.ema_rate)
            step = make_score_train_step(
                model, get_sigmas(cfg), data_mode="real-imag",
                filter_th=th, if_centering=True,
                mesh=mesh if meshed else None)
            state, loss = step(state, job["batch"], **job["draws"])
            out[name, meshed] = (dict(state.params), dict(state.ema.params),
                                 loss)
    gc = Config({"Seg": dict(job["seg"])})
    unet = build_seg_unet(gc)
    unet.load_state_dict(job["seg_params"])
    state = TrainState.create(unet, get_optimizer(load_config(
        "ACDC", "real-imag")), ema_decay=None)
    step = make_seg_train_step(unet, get_sigmas(load_config(
        "ACDC", "real-imag")), perturb=True, mesh=mesh,
        data_mode="real-imag")
    state, loss = step(state, job["seg_batch"],
                       torch.Generator().manual_seed(5))
    out["seg", True] = (dict(state.params), None, loss)
    torch.save(out, sys.argv[5])
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(job: dict, world: int, tmp_path) -> list:
    """Run CHILD as `world` ranks of one gloo group; returns each rank's
    output. Kills every child still running when one fails or the time
    is up."""
    path = str(tmp_path / "job.pt")
    torch.save(job, path)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    outs = [str(tmp_path / f"out{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, path, str(r), str(world), str(port),
         outs[r]], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(o) for o in outs]


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def vector(sd, names):
    return np.concatenate([np.asarray(sd[k].detach(), np.float64).ravel()
                           for k in names])


@pytest.fixture(scope="module")
def job():
    """The tiny NCSN1D (tests/test_torch_train_ncsn.py's TUBE) on JAX's
    weights, a global batch of 8 tubes, three of them background (zero
    weight under the filter), JAX's draws from one key, JAX's step on a
    2-device mesh with and without the filter; the tiny seg UNet and a
    batch of 4 images with masks."""
    jcfg = jax_load_config("CINE127_1D", "real-imag", **TUBE)
    cfg = load_config("CINE127_1D", "real-imag", **TUBE)
    module = jncsn1d.NCSN1D(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, init_flax(
        module, jnp.zeros((1, 8, 4)), jnp.ones((1,)), seed=4))
    sigmas = np.asarray(jax_get_sigmas(jcfg))
    batch = np.random.RandomState(8).rand(8, 8, 4).astype(np.float32)
    batch[[2, 5, 6]] = 0.3
    key = jax.random.PRNGKey(21)
    mesh = jparallel.make_mesh(n_data=2, n_model=1)
    jax_steps = {}
    torch_params = flax_to_torch_ncsnv2(params, cfg, "ncsn1d")
    for name, th in (("plain", None), ("filtered", jcfg.data.th)):
        # the mesh step donates its state: each run on a copy
        jstate = JaxTrainState.create(
            jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                   params),
            jax_get_optimizer(jcfg), ema_decay=jcfg.model.ema_rate)
        jstate, jloss = jax_make_step(
            module, jnp.asarray(sigmas), data_mode="real-imag",
            filter_th=th, if_centering=True, mesh=mesh)(
                jstate, jnp.asarray(batch), key)
        jax_steps[name] = (flax_to_torch_ncsnv2(jstate.params, cfg,
                                                "ncsn1d"), float(jloss))
    from inverseproblemwithdiffusionmodel_tpu_torch.config import Config
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        build_seg_unet)
    torch.manual_seed(3)
    unet = build_seg_unet(Config({"Seg": dict(SEG)}))
    rs = np.random.RandomState(2)
    seg_batch = (rs.rand(4, 16, 16, 1).astype(np.float32),
                 (rs.rand(4, 16, 16) > 0.6).astype(np.int64))
    return dict(over=TUBE, th=jcfg.data.th,
                params=torch_params,
                batch=torch.from_numpy(batch),
                draws=jax_draws(key, batch.shape, len(sigmas)),
                seg=SEG, seg_params=unet.state_dict(),
                seg_batch=tuple(torch.from_numpy(v) for v in seg_batch),
                jax=jax_steps)


@pytest.fixture(scope="module")
def world_of_one(job, tmp_path_factory):
    return run_group(job, 1, tmp_path_factory.mktemp("world1"))[0]


def test_world_of_one_takes_the_plain_step(world_of_one):
    out = world_of_one
    for name in ("plain", "filtered"):
        mesh_p, mesh_e, mesh_l = out[name, True]
        p, e, loss = out[name, False]
        assert torch.equal(mesh_l, loss)
        for k in p:
            assert torch.equal(mesh_p[k], p[k]) and torch.equal(
                mesh_e[k], e[k]), k


def test_two_ranks_take_the_one_process_step_and_jax_mesh_step(
        job, world_of_one, tmp_path):
    ranks = run_group(job, 2, tmp_path)
    for key in ranks[0]:
        a, b = ranks[0][key], ranks[1][key]
        assert torch.equal(a[2], b[2])
        assert all(torch.equal(a[0][k], b[0][k]) for k in a[0]), key
    single = world_of_one
    for name in ("plain", "filtered"):
        params, ema, loss = ranks[0][name, True]
        p1, e1, l1 = single[name, False]
        names = list(p1)
        assert rel_l2(vector(params, names), vector(p1, names)) <= 1e-6
        assert rel_l2(vector(ema, names), vector(e1, names)) <= 1e-6
        np.testing.assert_allclose(float(loss), float(l1), rtol=1e-6)
        want, jloss = job["jax"][name]
        assert rel_l2(vector(params, names), vector(want, names)) <= 1e-5
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
        moved = rel_l2(vector(params, names), vector(job["params"], names))
        assert moved > 1e-4
    # the filter changes the step: its normaliser spans both ranks
    assert rel_l2(vector(ranks[0]["plain", True][0], names),
                  vector(ranks[0]["filtered", True][0], names)) > 1e-6
    seg, seg1 = ranks[0]["seg", True], single["seg", True]
    names = list(seg1[0])
    assert rel_l2(vector(seg[0], names), vector(seg1[0], names)) <= 1e-6
    np.testing.assert_allclose(float(seg[2]), float(seg1[2]), rtol=1e-6)


def test_train_ncsn_use_mesh_in_one_process_is_the_plain_run(tmp_path):
    argv = ["--ds_name", "CINE64_1D", "--task_name", "Diffusion1D",
            "--mode", "real-imag", "--flatten_type", "temporal", "--device",
            "cpu", "--batch_size", "4", "--no_native_loader", "--override",
            "model.ngf=8", "--override", "training.n_iters=2"]
    states = []
    for flags in ([], ["--use_mesh"]):
        log = tmp_path / ("mesh" if flags else "plain")
        with contextlib.redirect_stdout(io.StringIO()):
            states.append(train_ncsn.main(argv + flags + ["--log_dir",
                                                          str(log)]))
    assert states[0].step == states[1].step == 2
    for k, v in states[0].params.items():
        assert torch.equal(v, states[1].params[k]), k
    ckpts = [Checkpointer(str(tmp_path / d / "CINE64_1D_Diffusion1D_real-imag"
                              / "ckpts")).restore_params()[0]
             for d in ("plain", "mesh")]
    assert all(torch.equal(ckpts[0][k], ckpts[1][k]) for k in ckpts[0])


def test_helpers_without_a_group():
    assert parallel.initialize_distributed(device="cpu") is False
    assert parallel.is_primary()
    assert parallel.local_batch_slice(16) == slice(0, 16)
    t = torch.ones(3)
    from inverseproblemwithdiffusionmodel_tpu_torch.parallel.distributed \
        import all_reduce_sum_
    assert torch.equal(all_reduce_sum_([t])[0], torch.ones(3))
