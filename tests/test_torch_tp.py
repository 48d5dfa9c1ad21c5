"""Tensor parallelism over the mesh's model axis (parallel.tp_sharding,
parallel.shard_tp, make_score_train_step(tp=True), parallel/tp.py)
against the JAX package's (tests/test_parallel_tp.py), on the CPU: meshes
of CPU entries, the same numpy-drawn weights, batch and draws.

- The rule: JAX's four cases (kernel, bias, small, odd channels), and the
  leaves the port splits are the ones JAX shards, matched by
  utils/convert's names, for JAX's test NCSNv2 (ngf 16, 16 px) and the
  tiny NCSN1D, at min_size 256 and at the default 4096.
- One step of a state split over 2 entries (n_data 1, n_model 2) against
  JAX's single-device step, at JAX's bounds: loss rtol 1e-5, parameters
  and EMA rtol 1e-3, atol 1e-5 (measured max |diff| 1.5e-8 in float32).
  The optimizer is the deployed ACDC one (Adam, lr 1e-4, eps 1e-3) with
  grad_clip 1.0, which clips this step. At JAX's test optimizer (lr
  1e-3, eps 1e-8) Adam's first update lr g / (|g| + eps) turns the float32
  rounding of a gradient entry near 1e-8 into a change of up to lr: there
  the port's own plain step reads 1.7e-5 from JAX's on 1 of 465,873
  entries, its split step 3.0e-5; that case is held at the port's bound
  for a train step against JAX, rel L2 1e-5 over all parameters, and the
  split step to the plain one at 1e-6. bf16 with remat, and NCSN1D with
  the foreground filter: tests/test_torch_tp_modes.py.
- A gloo world of 2 ranks x n_model 2 (child processes, as
  tests/test_torch_distributed.py runs them) against the same JAX step.
- A split state's checkpoint is the plain state's, and restores into a
  split state; MultiSteps' accumulators split and gather.
"""
import os
import textwrap
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu import parallel as jparallel
from inverseproblemwithdiffusionmodel_tpu.config import Config as JConfig
from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.models import ncsn1d as jncsn1d
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2 as JaxNCSNv2)
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    get_sigmas as jax_get_sigmas)
from inverseproblemwithdiffusionmodel_tpu.training.state import (
    TrainState as JaxTrainState, get_optimizer as jax_get_optimizer)
from inverseproblemwithdiffusionmodel_tpu.training.train import (
    make_score_train_step as jax_make_step)
from inverseproblemwithdiffusionmodel_tpu_torch import parallel
from inverseproblemwithdiffusionmodel_tpu_torch.config import (
    Config, load_config)
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsn1d import NCSN1D
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.parallel import tp
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
    get_sigmas)
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    Checkpointer, MultiSteps, TrainState, get_optimizer,
    make_score_eval_step, make_score_train_step)
from inverseproblemwithdiffusionmodel_tpu_torch.utils import convert
from tests import test_torch_distributed
from tests.test_torch_ncsnv2 import init_flax
from tests.test_torch_train_ncsn import TUBE, jax_draws

torch.set_num_threads(1)

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-3, 1e-5          # JAX's bounds for the parameters
REL_L2 = 1e-5                    # the port's bound for a step against JAX
DEPLOYED = {"optimizer": "Adam", "lr": 1e-4, "beta1": 0.9, "eps": 1e-3,
            "weight_decay": 0.0, "grad_clip": 1.0}
JAX_TEST = {"optimizer": "Adam", "lr": 1e-3, "beta1": 0.9, "eps": 1e-8,
            "weight_decay": 0.0, "grad_clip": 1.0}


def ncsnv2_config(optim=DEPLOYED):
    """tests/test_parallel_tp.py's config, its optimizer `optim`."""
    return {
        "data": {"channels": 1, "image_size": 16,
                 "logit_transform": False, "rescaled": False},
        "model": {"ngf": 16, "nonlinearity": "elu",
                  "normalization": "InstanceNorm++", "sigma_begin": 10.0,
                  "sigma_end": 0.01, "num_classes": 8,
                  "sigma_dist": "geometric", "ema_rate": 0.999},
        "training": {"anneal_power": 2.0},
        "optim": dict(optim),
    }


def cpu_mesh(n_data=1, n_model=2):
    return parallel.make_mesh(n_data, n_model, [CPU] * (n_data * n_model))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def vector(sd, names):
    return np.concatenate([np.asarray(sd[k].detach(), np.float64).ravel()
                           for k in names])


# -- the workloads: JAX's step and the port's inputs -------------------------

def ncsnv2_job(optim=DEPLOYED, compute_dtype=None, remat=False):
    """JAX's test NCSNv2 on numpy-drawn weights, a batch of 8 and one key;
    JAX's single-device step on them."""
    jcfg = JConfig(ncsnv2_config(optim))
    module = JaxNCSNv2(config=jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, init_flax(
        module, jnp.zeros((1, 16, 16, 1)), jnp.ones((1,)), seed=0))
    batch = np.random.RandomState(1).rand(8, 16, 16, 1).astype(np.float32)
    key = jax.random.PRNGKey(2)
    sigmas = jax_get_sigmas(jcfg)
    jstate = JaxTrainState.create(params, jax_get_optimizer(jcfg),
                                  ema_decay=0.999)
    jstate, jloss = jax_make_step(module, sigmas, compute_dtype=compute_dtype,
                                  remat=remat)(jstate, jnp.asarray(batch),
                                               key)
    cfg = Config(ncsnv2_config(optim))
    return dict(cfg=cfg, kind="ncsnv2", build=lambda: NCSNv2(cfg),
                params=convert.flax_to_torch_ncsnv2(params, cfg, "ncsnv2"),
                batch=batch, draws=jax_draws(key, batch.shape, 8,
                                             "real-valued"),
                step_kw={}, jax_loss=float(jloss),
                jax_params=convert.flax_to_torch_ncsnv2(jstate.params, cfg,
                                                        "ncsnv2"),
                jax_ema=convert.flax_to_torch_ncsnv2(jstate.ema.params, cfg,
                                                     "ncsnv2"))


def ncsn1d_job():
    """The tiny NCSN1D (tests/test_torch_train_ncsn.py's TUBE) in real-imag
    mode with the foreground filter and centering, the deployed optimizer
    with grad_clip 1.0; JAX's single-device step."""
    over = {**TUBE, "optim.grad_clip": 1.0}
    jcfg = jax_load_config("CINE127_1D", "real-imag", **over)
    module = jncsn1d.NCSN1D(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, init_flax(
        module, jnp.zeros((1, 8, 4)), jnp.ones((1,)), seed=4))
    batch = np.random.RandomState(8).rand(8, 8, 4).astype(np.float32)
    batch[[2, 5]] = 0.3                     # background tubes
    key = jax.random.PRNGKey(21)
    sigmas = np.asarray(jax_get_sigmas(jcfg))
    jstate = JaxTrainState.create(params, jax_get_optimizer(jcfg),
                                  ema_decay=jcfg.model.ema_rate)
    jstate, jloss = jax_make_step(
        module, jnp.asarray(sigmas), data_mode="real-imag",
        filter_th=jcfg.data.th, if_centering=True)(
            jstate, jnp.asarray(batch), key)
    cfg = load_config("CINE127_1D", "real-imag", **over)
    to_torch = lambda p: convert.flax_to_torch_ncsnv2(p, cfg, "ncsn1d")
    return dict(cfg=cfg, kind="ncsn1d", build=lambda: NCSN1D(cfg),
                params=to_torch(params), batch=batch,
                draws=jax_draws(key, batch.shape, len(sigmas)),
                step_kw=dict(data_mode="real-imag", filter_th=jcfg.data.th,
                             if_centering=True),
                jax_loss=float(jloss), jax_params=to_torch(jstate.params),
                jax_ema=to_torch(jstate.ema.params))


def port_state(job, tx=None):
    model = job["build"]()
    model.load_state_dict(job["params"], strict=True)
    return TrainState.create(model, tx or get_optimizer(job["cfg"]),
                             ema_decay=job["cfg"].model.ema_rate)


def port_step(job, split=True, mesh=None, min_size=256, tx=None, **kw):
    """One port step on the job's weights: the state split over `mesh`
    (default 2 CPU entries) where `split`, else the plain step."""
    state = port_state(job, tx)
    if split:
        mesh = mesh or cpu_mesh()
        state = parallel.shard_tp(state, mesh, min_size=min_size)
    step = make_score_train_step(state.model, get_sigmas(job["cfg"]),
                                 mesh=mesh if split else None, tp=split,
                                 **job["step_kw"], **kw)
    state, loss = step(state, job["batch"], **job["draws"])
    return state, float(loss)


def held_to_jax(params, ema, loss, job):
    """The loss, the parameters and the EMA after the step against JAX's,
    at JAX's bounds; the parameters moved."""
    np.testing.assert_allclose(loss, job["jax_loss"], rtol=LOSS_RTOL)
    for name, want in job["jax_params"].items():
        np.testing.assert_allclose(params[name].detach().numpy(),
                                   want.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(ema[name].numpy(),
                                   job["jax_ema"][name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    names = list(job["params"])
    moved = rel_l2(vector(params, names), vector(job["params"], names))
    assert moved > 1e-4


@pytest.fixture(scope="module")
def ncsnv2():
    return ncsnv2_job()


# -- (a) the rule and the leaves it splits ----------------------------------

def test_tp_sharding_rule_is_jax():
    """JAX's four cases on a 4 x 2 mesh, the leaves in the port's layout
    (a conv weight (O, I, k, k): output channels first)."""
    jmesh, mesh = jparallel.make_mesh(n_data=4, n_model=2), cpu_mesh(4, 2)
    cases = [((3, 3, 16, 16), 256, True), ((16,), 256, False),
             ((2, 2), 256, False), ((3, 3, 16, 15), 1, False)]
    for shape, min_size, split in cases:
        spec = jparallel.tp_sharding(jmesh, jnp.zeros(shape), min_size).spec
        assert (len(spec) > 0 and spec[-1] == jparallel.MODEL_AXIS) == split
        port_shape = shape[-1:] + shape[-2:-1] + shape[:-2] \
            if len(shape) == 4 else shape
        got = parallel.tp_sharding(mesh, torch.zeros(port_shape), min_size)
        assert got.axis == (0 if split else None)
        # the same leaf in the Flax layout, its output axis last
        assert parallel.tp_sharding(mesh, torch.zeros(shape), min_size,
                                    axis=-1).axis == (3 if split else None)
    # a transposed convolution's weight (I, O, k, k) splits along O
    assert parallel.tp_sharding(mesh, torch.zeros(16, 8, 3, 3), 256,
                                axis=1).axis == 1
    # one model entry splits nothing
    assert parallel.tp_sharding(cpu_mesh(2, 1), torch.zeros(
        16, 16, 3, 3), 1).axis is None
    # a leaf placed by the rule: its slices, or copies
    w = torch.arange(32.0).reshape(4, 8)
    parts = parallel.shard_tp({"w": w, "b": torch.ones(3)}, cpu_mesh(),
                              min_size=1)
    assert [p.shape for p in parts["w"]] == [(2, 8), (2, 8)]
    assert torch.equal(torch.cat(parts["w"]), w)
    assert all(torch.equal(b, torch.ones(3)) for b in parts["b"])


def _jax_split_names(module, args, min_size, cfg, kind):
    """The port names of the leaves JAX's shard_tp shards, and of all."""
    params = init_flax(module, *args, seed=0)
    jmesh = jparallel.make_mesh(n_data=4, n_model=2)
    split, names = set(), set()
    for path, value in convert._flatten(params):
        name, _ = convert._convert_leaf(path, value)
        names.add(name)
        spec = jparallel.tp_sharding(jmesh, jnp.zeros(value.shape),
                                     min_size).spec
        if len(spec) and spec[-1] == jparallel.MODEL_AXIS:
            split.add(name)
    assert names == set(convert.flax_to_torch_ncsnv2(params, cfg, kind))
    return split


@pytest.mark.parametrize("kind", ["ncsnv2", "ncsn1d"])
@pytest.mark.parametrize("min_size", [256, 4096])
def test_split_leaves_are_jax_sharded_leaves(kind, min_size):
    if kind == "ncsnv2":
        jcfg = JConfig(ncsnv2_config())
        cfg = Config(ncsnv2_config())
        module, model = JaxNCSNv2(config=jcfg), NCSNv2(cfg)
        args = (jnp.zeros((1, 16, 16, 1)), jnp.ones((1,)))
    else:
        jcfg = jax_load_config("CINE127_1D", "real-imag", **TUBE)
        cfg = load_config("CINE127_1D", "real-imag", **TUBE)
        module, model = jncsn1d.NCSN1D(jcfg), NCSN1D(cfg)
        args = (jnp.zeros((1, 8, 4)), jnp.ones((1,)))
    want = _jax_split_names(module, args, min_size, cfg, kind)
    whole = {k: v.detach().clone() for k, v in model.named_parameters()}
    state = parallel.shard_tp(TrainState.create(model, get_optimizer(cfg)),
                              cpu_mesh(), min_size=min_size)
    got = {name for name, split, _ in tp.entries(model) if split}
    assert got == want and (want or min_size == 4096)
    for name, split, ts in tp.entries(model):
        if split:
            # the output channels, halved: JAX's last axis
            assert len(ts) == 2 and split.axis == 0
            assert ts[0].shape[0] * 2 == whole[name].shape[0]
    params = state.params
    assert list(params) == list(whole)
    assert all(torch.equal(params[k], whole[k]) for k in whole)


# -- (b) one step against JAX's single-device step ---------------------------

def test_tp_step_matches_jax_with_global_clipping(ncsnv2):
    """float32, grad_clip 1.0: the clip scales the whole gradient, its norm
    over both entries' slices (per-slice norms would clip another
    gradient)."""
    state, loss = port_step(ncsnv2)
    held_to_jax(state.params, state.eval_params, loss, ncsnv2)
    grads = [t.grad for t in tp.tensors(state.model, trainable=True)]
    assert {t.device for t in tp.tensors(state.model)} == {CPU}
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    np.testing.assert_allclose(float(norm), 1.0, rtol=1e-5)   # clipped
    plain, plain_loss = port_step(ncsnv2, split=False)
    assert plain_loss == loss
    names = list(ncsnv2["params"])
    assert rel_l2(vector(state.params, names),
                  vector(plain.params, names)) <= 1e-6


def test_tp_step_at_jax_test_optimizer():
    """JAX's test optimizer (lr 1e-3, eps 1e-8): the port's bound for a
    step against JAX (the module docstring), and the split step against
    the plain one."""
    job = ncsnv2_job(JAX_TEST)
    state, loss = port_step(job)
    plain, plain_loss = port_step(job, split=False)
    np.testing.assert_allclose(loss, job["jax_loss"], rtol=LOSS_RTOL)
    assert loss == plain_loss
    names = list(job["params"])
    for got in (state.params, plain.params):
        assert rel_l2(vector(got, names),
                      vector(job["jax_params"], names)) <= REL_L2
    assert rel_l2(vector(state.params, names),
                  vector(plain.params, names)) <= 1e-6


def test_tp_multisteps_matches_the_plain_accumulation(ncsnv2):
    """optax.MultiSteps' mean over 2 micro-steps: the accumulators hold
    one tensor per slice and gather into the plain ones."""
    cfg = ncsnv2["cfg"]
    runs = {}
    for split in (False, True):
        state = port_state(ncsnv2, MultiSteps.wrap(get_optimizer(cfg), 2))
        mesh = cpu_mesh() if split else None
        if split:
            state = parallel.shard_tp(state, mesh, min_size=256)
        step = make_score_train_step(state.model, get_sigmas(cfg), mesh=mesh,
                                     tp=split)
        for _ in range(2):
            state, _ = step(state, ncsnv2["batch"], **ncsnv2["draws"])
        runs[split] = state
    assert runs[True].optimizer.gradient_step == 1
    assert len(runs[True].optimizer.acc) > len(runs[False].optimizer.acc)
    names = list(ncsnv2["params"])
    assert rel_l2(vector(runs[True].params, names),
                  vector(runs[False].params, names)) <= 1e-6


# -- (c) the data axis of a process group x the model axis -------------------

CHILD = textwrap.dedent('''
    import sys
    import torch
    torch.set_num_threads(1)
    from inverseproblemwithdiffusionmodel_tpu_torch import parallel
    from inverseproblemwithdiffusionmodel_tpu_torch.config import Config
    from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import (
        NCSNv2)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        TrainState, get_optimizer, make_score_train_step)

    job, rank, world, port = (torch.load(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    assert parallel.initialize_distributed(
        f"127.0.0.1:{port}", world, rank, device="cpu", timeout=60)
    cfg = Config(job["config"])
    model = NCSNv2(cfg)
    model.load_state_dict(job["params"])
    state = TrainState.create(model, get_optimizer(cfg), ema_decay=0.999)
    mesh = parallel.make_mesh(world, 2, ["cpu"] * (2 * world))
    state = parallel.shard_tp(state, mesh, min_size=256)
    step = make_score_train_step(model, get_sigmas(cfg), mesh=mesh, tp=True)
    state, loss = step(state, job["batch"], **job["draws"])
    torch.save((state.params, state.eval_params, loss,
                len(parallel.tp.tensors(model))), sys.argv[5])
''')


def test_tp_over_two_ranks_matches_jax(ncsnv2, tmp_path):
    """world 2 (gloo) x n_model 2: each rank its row of a 2 x 2 mesh, its
    half of the global batch; both ranks end with JAX's state."""
    job = {"config": ncsnv2_config(), "params": ncsnv2["params"],
           "batch": torch.from_numpy(ncsnv2["batch"]),
           "draws": ncsnv2["draws"]}
    with mock.patch.object(test_torch_distributed, "CHILD", CHILD):
        ranks = test_torch_distributed.run_group(job, 2, tmp_path)
    for params, ema, loss, n in ranks:
        assert n > len(ncsnv2["params"])          # split
        held_to_jax(params, ema, float(loss), ncsnv2)
    names = list(ncsnv2["params"])
    assert np.array_equal(vector(ranks[0][0], names),
                          vector(ranks[1][0], names))


# -- (d) checkpoints ---------------------------------------------------------

def _same(a, b):
    """Equal payloads: the same structure, every tensor equal."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("accumulate", [False, True],
                         ids=["adam", "multisteps"])
def test_split_state_checkpoint_is_the_plain_one(ncsnv2, tmp_path,
                                                 accumulate):
    cfg = ncsnv2["cfg"]
    tx = lambda: (MultiSteps.wrap(get_optimizer(cfg), 2) if accumulate
                  else get_optimizer(cfg))
    state, _ = port_step(ncsnv2, split=False, tx=tx())
    plain_dir, split_dir = tmp_path / "plain", tmp_path / "split"
    Checkpointer(str(plain_dir)).save(1, state)
    state = parallel.shard_tp(state, cpu_mesh(), min_size=256)
    assert state.tp and any(split for _, split, _ in tp.entries(state.model))
    with pytest.raises(ValueError, match="already"):
        parallel.shard_tp(state, cpu_mesh())
    Checkpointer(str(split_dir)).save(1, state)
    load = lambda d: torch.load(os.path.join(d, "1", "state.pt"),
                                weights_only=True)
    _same(load(split_dir), load(plain_dir))
    # restored into a split state: it shards again, and steps as the state
    # it was saved from
    other = parallel.shard_tp(port_state(ncsnv2, tx()), cpu_mesh(),
                              min_size=256)
    Checkpointer(str(split_dir)).restore(other)
    _same(other.state_dict(), state.state_dict())
    step = make_score_train_step(state.model, get_sigmas(cfg),
                                 mesh=cpu_mesh(), tp=True)
    step_other = make_score_train_step(other.model, get_sigmas(cfg),
                                       mesh=cpu_mesh(), tp=True)
    a, la = step(state, ncsnv2["batch"], **ncsnv2["draws"])
    b, lb = step_other(other, ncsnv2["batch"], **ncsnv2["draws"])
    assert la == lb
    _same(a.state_dict(), b.state_dict())


def test_eval_step_and_refusals_on_a_split_state(ncsnv2):
    """The eval step takes the gathered EMA of a split state as the plain
    state's; a split state needs the tp step, the tp step a split state
    and a mesh; only layers.Conv and ConvTranspose weights split."""
    cfg = ncsnv2["cfg"]
    plain = port_state(ncsnv2)
    split = parallel.shard_tp(port_state(ncsnv2), cpu_mesh(), min_size=256)
    losses = [float(make_score_eval_step(state.model, get_sigmas(cfg))(
        state, ncsnv2["batch"], **ncsnv2["draws"])) for state in (plain,
                                                                   split)]
    assert losses[0] == losses[1]
    sig = get_sigmas(cfg)
    with pytest.raises(ValueError, match="needs the mesh"):
        make_score_train_step(split.model, sig, tp=True)
    with pytest.raises(ValueError, match="make_score_train_step"):
        make_score_train_step(split.model, sig)(split, ncsnv2["batch"])
    with pytest.raises(ValueError, match="shard_tp"):
        make_score_train_step(plain.model, sig, mesh=cpu_mesh(), tp=True)(
            plain, ncsnv2["batch"])
    dense = torch.nn.Sequential(torch.nn.Linear(64, 64))
    with pytest.raises(NotImplementedError, match="Linear"):
        parallel.shard_tp(TrainState.create(dense, get_optimizer(cfg)),
                          cpu_mesh(), min_size=256)
