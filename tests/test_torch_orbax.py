"""convert_orbax_checkpoint.py: JAX package checkpoints (orbax, written by
its training.Checkpointer into tmp_path) converted to the port's, on the
CPU, for a tiny NCSNv2Deepest (the ACDC prior's net) and a tiny NCSN++,
each under plain Adam and under optax.MultiSteps (every 2).

Held, at rel_l2 <= 1e-5 (the port's bound for a net against JAX):
- the port's forward on the converted params and on the converted EMA to
  JAX's forward on the restored params and EMA;
- the step count, and the best step by val_loss (the JAX manager's);
- one more optimizer step after the conversion (Adam on the converted
  moments, or a MultiSteps micro-step on the converted accumulator) to
  JAX's next step on the same gradients.
A state the converter cannot map (RMSProp) raises, naming the optimizer.
"""
import contextlib
import functools
import io
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import convert_orbax_checkpoint as convert
from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.configs_continuous import (
    get_continuous_config as jax_continuous_config)
from inverseproblemwithdiffusionmodel_tpu.models.ncsnpp import (
    NCSNpp as JaxNCSNpp)
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2Deepest as JaxNCSNv2Deepest)
from inverseproblemwithdiffusionmodel_tpu.training.checkpoint import (
    Checkpointer as JaxCheckpointer)
from inverseproblemwithdiffusionmodel_tpu.training.state import (
    TrainState as JaxTrainState, get_optimizer as jax_get_optimizer)
from inverseproblemwithdiffusionmodel_tpu_torch.training import Checkpointer
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_model)
from tests.test_torch_ncsnpp import LEAF, TINY, perturb
from tests.test_torch_ncsnv2 import init_flax

torch.set_num_threads(1)

REL_L2 = 1e-5
S = 16
NCSNV2 = {"data.image_size": S, "model.ngf": 8}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flags(over):
    return sum((["--override", f"{k}={v}"] for k, v in over.items()), [])


@functools.lru_cache(maxsize=None)
def ncsnv2():
    jcfg = jax_load_config("ACDC", "real-imag", **NCSNV2)
    module = JaxNCSNv2Deepest(config=jcfg)
    params = init_flax(module, jnp.zeros((1, S, S, 1)), jnp.ones((1,)))
    x = np.random.RandomState(1).randn(2, S, S, 1).astype(np.float32)
    cond = np.array([3.0, 0.5], np.float32)

    def port_forward(model, x, cond):
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                    torch.from_numpy(cond))
        return out.permute(0, 2, 3, 1)

    return dict(jcfg=jcfg, module=module, params=params, x=x, cond=cond,
                port_forward=port_forward, forward=_jax_forward(module, {}),
                flags=["--ds_name", "ACDC", "--mode", "real-imag",
                       *_flags(NCSNV2)])


@functools.lru_cache(maxsize=None)
def ncsnpp():
    jcfg = jax_continuous_config(LEAF).replace(**TINY)
    module = JaxNCSNpp(config=jcfg)
    params = jax.jit(module.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, S, S, 3)),
                                  jnp.ones((1,)))["params"]
    params = perturb(params, np.random.RandomState(0))
    x = np.random.RandomState(1).randn(2, S, S, 3).astype(np.float32)
    cond = np.array([3.0, 0.5], np.float32)
    return dict(jcfg=jcfg, module=module, params=params, x=x, cond=cond,
                port_forward=lambda m, x, c: m(torch.from_numpy(x),
                                               torch.from_numpy(c)),
                forward=_jax_forward(module, dict(train=False)),
                flags=["--continuous", LEAF, *_flags(TINY)])


NETS = {"ncsnv2": ncsnv2, "ncsnpp": ncsnpp}


def _jax_forward(module, kw):
    """The JAX net's forward on a params tree, jitted once per net."""
    return jax.jit(lambda tree, x, c: module.apply({"params": tree}, x, c,
                                                   **kw))


def grads_like(params, rs):
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32) * 0.1),
        params)


_apply = jax.jit(lambda state, grads: state.apply_gradients(grads))


def write_jax(net, tx, directory, saves=((3, 0.4),)):
    """Three optimizer steps on drawn gradients, a checkpoint with its
    val_loss at each step of `saves`. Returns the last state and the JAX
    manager's best step."""
    rs = np.random.RandomState(2)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray,
                                                        net["params"]), tx,
                                 ema_decay=0.9)
    ckpt = JaxCheckpointer(str(directory))
    for step in (1, 2, 3):
        state = _apply(state, grads_like(net["params"], rs))
        for at, val in saves:
            if at == step:
                ckpt.save(step, state, val_loss=val)
    best = ckpt.best_step()
    ckpt.close()
    return state, best


@pytest.mark.parametrize("every", [1, 2], ids=["adam", "multisteps"])
@pytest.mark.parametrize("name", ["ncsnv2", "ncsnpp"])
def test_converted_checkpoint_is_the_jax_state(name, every, tmp_path):
    net = NETS[name]()
    tx = jax_get_optimizer(net["jcfg"])
    if every > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=every)
    # best-tracking once: two checkpoints, the later one the better
    saves = ((2, 0.7), (3, 0.4)) if (name, every) == ("ncsnv2", 1) else (
        (3, 0.4),)
    jstate, jbest = write_jax(net, tx, tmp_path / "jax", saves)
    out = tmp_path / "port"
    with contextlib.redirect_stdout(io.StringIO()):
        states = convert.main(["--jax_ckpt_dir", str(tmp_path / "jax"),
                               "--out_dir", str(out), "--grad_accum",
                               str(every), *net["flags"]])
    steps = [at for at, _ in saves]
    assert sorted(states) == steps
    ckpt = Checkpointer(str(out))
    assert ckpt.all_steps() == steps
    assert ckpt.best_step() == jbest == 3
    params, step = ckpt.restore_params(use_ema=False)
    assert step == 3
    state = states[3]
    assert state.step == 3
    build = lambda: convert._build(convert.argparse.Namespace(
        continuous=LEAF if name == "ncsnpp" else None,
        override=[f"{k}={v}" for k, v in (TINY if name == "ncsnpp"
                                          else NCSNV2).items()],
        ds_name="ACDC", mode="real-imag", task_name="Diffusion"))[1]()

    def forward(tree):
        return np.asarray(net["forward"](tree, jnp.asarray(net["x"]),
                                         jnp.asarray(net["cond"])))

    model = build().eval()
    with torch.no_grad():
        model.load_state_dict(params)
        ours = net["port_forward"](model, net["x"], net["cond"])
        assert rel_l2(ours, forward(jstate.params)) <= REL_L2
        model.load_state_dict(state.ema.params)
        ema = net["port_forward"](model, net["x"], net["cond"])
        assert rel_l2(ema, forward(jstate.ema.params)) <= REL_L2
        assert rel_l2(ema, ours) > 10 * REL_L2      # the EMA is its own

    # the next step on the same gradients
    g = grads_like(net["params"], np.random.RandomState(9))
    jnext = _apply(jstate, g)
    tg = flax_to_torch_model(jax.tree_util.tree_map(np.asarray, g), build)
    for n, p in state.model.named_parameters():
        if p.requires_grad:
            p.grad = tg[n].clone()
    state.apply_gradients()
    want = flax_to_torch_model(jax.tree_util.tree_map(np.asarray,
                                                      jnext.params), build)
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    vec = lambda sd: np.concatenate([np.asarray(sd[k].detach(), np.float64
                                                ).ravel() for k in names])
    assert rel_l2(vec(state.params), vec(want)) <= REL_L2
    before = flax_to_torch_model(jax.tree_util.tree_map(
        np.asarray, jstate.params), build)
    assert rel_l2(vec(want), vec(before)) > 10 * REL_L2    # it moved


def test_an_optimizer_it_cannot_map_raises(tmp_path):
    net = ncsnv2()
    write_jax(net, optax.rmsprop(1e-3), tmp_path / "jax")
    with pytest.raises(ValueError, match="'RMSProp'"):
        convert.main(["--jax_ckpt_dir", str(tmp_path / "jax"), "--out_dir",
                      str(tmp_path / "port"), *net["flags"], "--override",
                      "optim.optimizer=RMSProp"])
    assert not os.path.exists(tmp_path / "port" / "3")
    # the optimizer wrapping must be the checkpoint's: plain Adam read
    # for a --grad_accum trainer (and MultiSteps without it) raises
    cfg, build = convert._build(convert.argparse.Namespace(
        continuous=None, override=[f"{k}={v}" for k, v in NCSNV2.items()],
        ds_name="ACDC", mode="real-imag", task_name="Diffusion"))
    zeros = jax.tree_util.tree_map(np.zeros_like, net["params"])
    adam = [{"count": np.int32(1), "mu": zeros, "nu": zeros}, None]
    raw = {"params": net["params"], "ema": None, "opt_state": adam,
           "step": np.int32(1)}
    with pytest.raises(ValueError, match="--grad_accum given"):
        convert.convert_step(raw, cfg, build, grad_accum=2)
    multi = {"mini_step": 0, "gradient_step": 0, "inner_opt_state": adam,
             "acc_grads": zeros, "skip_state": ()}
    with pytest.raises(ValueError, match="pass --grad_accum"):
        convert.convert_step({**raw, "opt_state": multi}, cfg, build)
