"""The port's continuous training path (losses/dsm.py, models/ema.py,
training/, utils/misc.py, scripts/pc_sampling --ckpt_dir) against the JAX
package's, on the same inputs, weights and draws.

JAX draws t and z from its key schedule (train.py:166 splits the step key
into three, dsm.py:79 splits the second into two); the tests rebuild those
draws with jax.random and hand them to the port. Tolerances, float32:
- the DSM loss at rtol 1e-5 (one reduction over the batch in another order);
- EMA shadows at rtol 1e-6 (two multiplies and an add per element);
- optimizer updates p1 - p0 at rel L2 5e-5: optax computes Adam's bias
  correction 1 - b2^t in float32, where 0.999 rounds to 0.99900001 and
  1 - b2 comes out 1.3e-5 below 0.001; torch computes it in float64. The
  update goes with 1 / sqrt of it, so the two differ by about 6.5e-6 in
  the first steps (measured rel L2 1.0e-5), plus a few ulp of float32;
- the tiny NCSN++ train step: loss at rtol 1e-5; gradients at rel L2 1e-4
  (float32 sums over a few hundred terms through about 30 layers, forward
  and backward; measured 1.6e-6); the parameter update (p1 - p0) / lr at
  rel L2 1e-3 (measured 5.1e-4). Adam's first update is g / (|g| + eps),
  about lr * sign(g) whatever the size of g, so the difference p1 - p0 is
  a few ulp of p: for the GroupNorm scales near 1 one ulp, 1.2e-7, is
  6e-4 of lr = 2e-4. A gradient entry near zero whose rounding differs
  can also flip its update's sign.
"""
import contextlib
import io
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn as nn

from inverseproblemwithdiffusionmodel_tpu.config import Config as JaxConfig
from inverseproblemwithdiffusionmodel_tpu.configs_continuous import (
    get_continuous_config as jax_get_config, make_sde as jax_make_sde)
from inverseproblemwithdiffusionmodel_tpu.losses.dsm import (
    continuous_dsm_loss as jax_continuous_dsm_loss)
from inverseproblemwithdiffusionmodel_tpu.models.ema import (
    EmaState as JaxEmaState)
from inverseproblemwithdiffusionmodel_tpu.models.ncsnpp import (
    NCSNpp as JaxNCSNpp)
from inverseproblemwithdiffusionmodel_tpu.sde import (
    get_score_fn as jax_get_score_fn)
from inverseproblemwithdiffusionmodel_tpu.training.state import (
    TrainState as JaxTrainState, get_optimizer as jax_get_optimizer)
from inverseproblemwithdiffusionmodel_tpu.training.train import (
    make_continuous_score_train_step as jax_make_step)
from inverseproblemwithdiffusionmodel_tpu.utils.misc import (
    collate_batch as jax_collate_batch)
from inverseproblemwithdiffusionmodel_tpu_torch.config import Config
from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
    get_continuous_config, make_sde)
from inverseproblemwithdiffusionmodel_tpu_torch.losses.dsm import (
    continuous_dsm_loss)
from inverseproblemwithdiffusionmodel_tpu_torch.models import create_model
from inverseproblemwithdiffusionmodel_tpu_torch.models.ema import EmaState
from inverseproblemwithdiffusionmodel_tpu_torch.models.layerspp import (
    GaussianFourierProjection)
from inverseproblemwithdiffusionmodel_tpu_torch.ops import fir_kernels as fk
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import pc_sampling
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    Checkpointer, FitConfig, TrainState, batch_iterator, fit, get_optimizer,
    make_continuous_score_train_step)
from inverseproblemwithdiffusionmodel_tpu_torch.training.loop import (
    step_generator)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnpp, seeded_weights)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.misc import (
    collate_batch)
from test_torch_ncsnpp import LEAF, TINY, perturb

torch.set_num_threads(1)

EPS = 1e-5


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_draws(key, shape, sde_T=1.0, eps=EPS):
    """t and z as JAX's continuous step draws them from its step key."""
    _, key_dsm, _ = jax.random.split(key, 3)
    key_t, key_z = jax.random.split(key_dsm)
    t = jax.random.uniform(key_t, (shape[0],), jnp.float32) * (sde_T - eps) \
        + eps
    z = jax.random.normal(key_z, shape, jnp.float32)
    return np.array(t), np.array(z)


# ---------------------------------------------------------------------------
# continuous_dsm_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce_mean", [True, False])
def test_continuous_dsm_loss_matches_jax(reduce_mean):
    cfg = get_continuous_config(LEAF)
    sde, jsde = make_sde(cfg), jax_make_sde(jax_get_config(LEAF))
    x = np.random.RandomState(0).rand(3, 8, 8, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    t, z = jax_draws(key, x.shape)

    def score(v, s):   # any smooth function of (x, t) will do
        return -v / (1.0 + s.reshape(-1, 1, 1, 1)) + 0.1 * v ** 2

    _, key_dsm, _ = jax.random.split(key, 3)
    ref = jax_continuous_dsm_loss(score, jsde, jnp.asarray(x), key_dsm,
                                  eps=EPS, reduce_mean=reduce_mean)
    out = continuous_dsm_loss(score, sde, torch.from_numpy(x), eps=EPS,
                              reduce_mean=reduce_mean, t=torch.from_numpy(t),
                              z=torch.from_numpy(z))
    assert out.shape == ()
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


def test_continuous_dsm_loss_default_draws_follow_the_generator():
    sde = make_sde(get_continuous_config(LEAF))
    x = torch.rand(4, 4, 4, 1)
    seen = []

    def score(v, s):
        seen.append(s)
        return torch.zeros_like(v)

    def loss(seed):
        return continuous_dsm_loss(score, sde, x, eps=0.3, generator=(
            torch.Generator().manual_seed(seed)))

    a, b, c = loss(0), loss(0), loss(1)
    assert float(a) == float(b) != float(c)
    assert all(((s >= 0.3) & (s <= 1.0)).all() for s in seen)


# ---------------------------------------------------------------------------
# collate_batch, EmaState, get_optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["real-valued", "mag", "complex"])
def test_collate_batch_matches_jax(mode):
    x = np.random.RandomState(1).rand(2, 4, 4, 1).astype(np.float32)
    np.testing.assert_array_equal(
        collate_batch(torch.from_numpy(x), mode).numpy(),
        np.asarray(jax_collate_batch(jnp.asarray(x), mode)))


def test_collate_batch_complex_modes_raise():
    # the complex modes are ported (parity: tests/test_torch_train_ncsn.py);
    # they raise, as the JAX package asserts, on batches of another rank
    for mode in ("complex", "real-imag-random"):
        with pytest.raises(ValueError, match="image batches"):
            collate_batch(torch.zeros(1, 2, 2), mode)
    with pytest.raises(ValueError, match="unknown"):
        collate_batch(torch.zeros(1, 2, 2, 1), "phase")


@pytest.mark.parametrize("warmup", [False, True])
def test_ema_matches_jax(warmup):
    rs = np.random.RandomState(2)
    params = {"a.weight": rs.randn(3, 4).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)}
    source = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ema = EmaState.create(source, 0.9, use_warmup=warmup)
    jema = JaxEmaState.create({k: jnp.asarray(v) for k, v in params.items()},
                              0.9, use_warmup=warmup)
    source["b"].add_(100.0)      # create() copies, it does not alias
    for _ in range(3):
        new = {k: rs.randn(*v.shape).astype(np.float32)
               for k, v in params.items()}
        assert ema.update({k: torch.from_numpy(v)
                           for k, v in new.items()}) is ema
        jema = jema.update({k: jnp.asarray(v) for k, v in new.items()})
        for k in params:
            np.testing.assert_allclose(ema.params[k].numpy(),
                                       np.asarray(jema.params[k]), rtol=1e-6,
                                       atol=1e-7)
    assert ema.num_updates == (3 if warmup else None)


class _Toy(nn.Module):
    """A frozen Fourier projection beside a dense layer."""

    def __init__(self, w, kernel, bias):
        super().__init__()
        self.fourier = GaussianFourierProjection(w.shape[0])
        self.dense = nn.Linear(*kernel.shape)
        with torch.no_grad():
            self.fourier.W.copy_(torch.from_numpy(w))
            self.dense.weight.copy_(torch.from_numpy(kernel.T))
            self.dense.bias.copy_(torch.from_numpy(bias))


@pytest.mark.parametrize("name", ["Adam", "RMSProp", "SGD"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_optimizer_updates_match_optax(name, weight_decay):
    # Three steps on the same gradients, clipped at norm 1 (the first two
    # gradients exceed it, the third does not); the frozen Fourier W takes
    # no decay on either side.
    rs = np.random.RandomState(3)
    w, kernel, bias = (rs.randn(4).astype(np.float32),
                       rs.randn(3, 2).astype(np.float32),
                       rs.randn(2).astype(np.float32))
    optim = {"optimizer": name, "lr": 0.05, "beta1": 0.9, "eps": 1e-8,
             "weight_decay": weight_decay, "grad_clip": 1.0, "warmup": 5000}
    jparams = {"GaussianFourierProjection_0": {"W": jnp.asarray(w)},
               "Dense_0": {"kernel": jnp.asarray(kernel),
                           "bias": jnp.asarray(bias)}}
    jstate = JaxTrainState.create(jparams, jax_get_optimizer(
        JaxConfig({"optim": optim})), ema_decay=None)
    model = _Toy(w, kernel, bias)
    state = TrainState.create(model, get_optimizer(Config({"optim": optim})),
                              ema_decay=None)
    for scale in (3.0, 2.0, 0.1):
        gk = (scale * rs.randn(3, 2)).astype(np.float32)
        gb = (scale * rs.randn(2)).astype(np.float32)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        jbefore = jstate.params
        jstate = jstate.apply_gradients(
            {"GaussianFourierProjection_0": {"W": jnp.zeros(4)},
             "Dense_0": {"kernel": jnp.asarray(gk), "bias": jnp.asarray(gb)}})
        model.dense.weight.grad = torch.from_numpy(gk.T.copy())
        model.dense.bias.grad = torch.from_numpy(gb)
        state = state.apply_gradients()
        for key, (mod, leaf, transpose) in {
                "dense.weight": ("Dense_0", "kernel", True),
                "dense.bias": ("Dense_0", "bias", False),
                "fourier.W": ("GaussianFourierProjection_0", "W", False)
        }.items():
            upd = (state.params[key] - before[key]).detach().numpy()
            jupd = np.asarray(jstate.params[mod][leaf]
                              - jbefore[mod][leaf])
            jupd = jupd.T if transpose else jupd
            if key == "fourier.W":
                assert not upd.any() and not jupd.any()
            else:
                assert rel_l2(upd, jupd) <= 5e-5, (key, rel_l2(upd, jupd))
    assert state.step == int(jstate.step) == 3


def test_clip_uses_optax_formula_without_epsilon():
    p = nn.Parameter(torch.zeros(2))
    opt = get_optimizer(Config({"optim": {"optimizer": "SGD", "lr": 1.0,
                                          "grad_clip": 5.0}}))([p])
    p.grad = torch.tensor([3.0, 4.0])        # norm exactly 5: scaled by 1
    opt.clip_()
    assert p.grad.tolist() == [3.0, 4.0]
    p.grad = torch.tensor([6.0, 8.0])
    opt.clip_()
    assert p.grad.tolist() == [3.0, 4.0]


# ---------------------------------------------------------------------------
# one NCSN++ train step against the JAX step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The tiny NCSN++ in both packages with the same perturbed weights."""
    jcfg = jax_get_config(LEAF).replace(**TINY)
    module = JaxNCSNpp(config=jcfg)
    params = jax.jit(module.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 16, 16, 3)),
                                  jnp.ones((1,)))["params"]
    params = jax.tree_util.tree_map(
        jnp.asarray, perturb(params, np.random.RandomState(0)))
    cfg = get_continuous_config(LEAF).replace(**TINY)
    return dict(jcfg=jcfg, cfg=cfg, module=module, params=params)


def _port_state(tiny, state_dict=None):
    cfg = tiny["cfg"]
    model = create_model(cfg)
    model.load_state_dict(state_dict or flax_to_torch_ncsnpp(
        tiny["params"], cfg), strict=True)
    return TrainState.create(model, get_optimizer(cfg),
                             ema_decay=cfg.model.ema_rate)


def test_tiny_ncsnpp_train_step_matches_jax(tiny):
    jcfg, cfg, module, params = (tiny[k] for k in
                                 ("jcfg", "cfg", "module", "params"))
    jsde, sde = jax_make_sde(jcfg), make_sde(cfg)
    batch = np.random.RandomState(4).rand(2, 16, 16, 3).astype(np.float32)
    key = jax.random.PRNGKey(6)
    t, z = jax_draws(key, batch.shape)

    # JAX: the step, and its gradients (clipped as optax clips them)
    jstate = JaxTrainState.create(params, jax_get_optimizer(jcfg),
                                  ema_decay=jcfg.model.ema_rate)
    jstate1, jloss = jax_make_step(module, jsde)(jstate, jnp.asarray(batch),
                                                 key)
    _, key_dsm, key_drop = jax.random.split(key, 3)

    def loss_fn(p):
        model_fn = lambda x, c: module.apply({"params": p}, x, c, train=True,
                                             rngs={"dropout": key_drop})
        return jax_continuous_dsm_loss(jax_get_score_fn(jsde, model_fn), jsde,
                                       jnp.asarray(batch), key_dsm, eps=EPS)

    grads = jax.jit(jax.grad(loss_fn))(params)
    norm = float(optax.global_norm(grads))
    clip = jcfg.optim.grad_clip
    if norm >= clip:
        grads = jax.tree_util.tree_map(lambda g: g / norm * clip, grads)

    # the port
    state = _port_state(tiny)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    step = make_continuous_score_train_step(state.model, sde)
    state, loss = step(state, batch, t=torch.from_numpy(t),
                       z=torch.from_numpy(z))
    assert state.step == 1 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    jgrads = flax_to_torch_ncsnpp(grads, cfg)
    new = flax_to_torch_ncsnpp(jstate1.params, cfg)
    old = flax_to_torch_ncsnpp(params, cfg)
    lr = cfg.optim.lr
    names = [k for k, p in state.model.named_parameters() if p.requires_grad]
    assert "fourier_proj.W" not in names
    port_g = np.concatenate([state.params[k].grad.numpy().ravel()
                             for k in names])
    jax_g = np.concatenate([jgrads[k].numpy().ravel() for k in names])
    assert rel_l2(port_g, jax_g) <= 1e-4
    port_u = np.concatenate([((state.params[k] - p0[k]) / lr).detach()
                             .numpy().ravel() for k in names])
    jax_u = np.concatenate([((new[k] - old[k]) / lr).numpy().ravel()
                            for k in names])
    assert rel_l2(port_u, jax_u) <= 1e-3
    ema = flax_to_torch_ncsnpp(jstate1.ema.params, cfg)
    for k in names:
        np.testing.assert_allclose(state.ema.params[k].numpy(),
                                   ema[k].numpy(), rtol=1e-5, atol=1e-6)


def test_train_step_routes_fir_gradients_through_the_kernel_functions(
        tiny, monkeypatch):
    # The tiny net has two levels with a FIR down and up each: BigGAN (h
    # and x) and pyramid, 6 ups and 6 downs per forward. Every up needs a
    # gradient; the 2 input-pyramid downs act on data and need none, so the
    # backward runs 6 downs (as "down2x.bwd") and 4 ups ("up2x.bwd").
    seen = []

    def spy(fn):
        return lambda x, taps, tag: seen.append(tag) or fn(x, taps, tag)

    monkeypatch.setattr(fk, "_up", spy(fk._up))
    monkeypatch.setattr(fk, "_down", spy(fk._down))
    state = _port_state(tiny)
    step = make_continuous_score_train_step(state.model,
                                            make_sde(tiny["cfg"]))
    step(state, np.zeros((2, 16, 16, 3), np.float32),
         torch.Generator().manual_seed(0))
    counts = {tag: seen.count(tag) for tag in set(seen)}
    assert counts == {"up2x": 6, "down2x": 6, "up2x.bwd": 4,
                      "down2x.bwd": 6}


def test_train_step_refuses_what_is_not_ported(tiny):
    # a device mesh needs a data axis (tests/test_torch_distributed.py
    # trains on one); bf16 is ported (held to JAX's bf16 step in
    # tests/test_torch_continuous_bf16.py)
    model = create_model(tiny["cfg"])
    sde = make_sde(tiny["cfg"])
    with pytest.raises(ValueError, match="'data' axis"):
        make_continuous_score_train_step(model, sde, mesh=object())
    assert callable(make_continuous_score_train_step(
        model, sde, compute_dtype=torch.bfloat16))
    other = TrainState.create(create_model(tiny["cfg"]),
                              get_optimizer(tiny["cfg"]))
    with pytest.raises(ValueError, match="another model"):
        make_continuous_score_train_step(model, sde)(
            other, np.zeros((1, 16, 16, 3), np.float32))


# ---------------------------------------------------------------------------
# checkpoints, fit, resume, sampling from a checkpoint
# ---------------------------------------------------------------------------

def _seeded_state(tiny, seed=0):
    model = seeded_weights(create_model(tiny["cfg"]), seed)
    return TrainState.create(model, get_optimizer(tiny["cfg"]),
                             ema_decay=0.9)


def test_checkpointer_keeps_the_latest(tmp_path, tiny):
    state = _seeded_state(tiny)
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2, track_best=False)
    for step in (1, 2, 3):
        state.step = step
        ckpt.save(step, state)
    assert ckpt.all_steps() == [2, 3]
    assert ckpt.latest_step() == ckpt.best_step() == 3
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_checkpointer_keeps_the_best_and_those_without_val_loss(tmp_path,
                                                                tiny):
    state = _seeded_state(tiny)
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2, track_best=True)
    for step, val in ((1, 3.0), (2, 1.0), (3, 2.0), (4, None), (5, 4.0)):
        ckpt.save(step, state, val_loss=val)
    assert ckpt.all_steps() == [2, 3, 4]
    assert ckpt.best_step() == 2 and ckpt.latest_step() == 4
    with open(tmp_path / "2" / "metrics.json") as f:
        assert json.load(f) == {"val_loss": 1.0}


def test_checkpointer_restores_state_and_params(tmp_path, tiny):
    state = _seeded_state(tiny, seed=0)
    for p in state.ema.params.values():
        p.add_(1.0)
    state.step = 7
    ckpt = Checkpointer(str(tmp_path), track_best=False)
    ckpt.save(7, state)
    raw = torch.load(tmp_path / "7" / "state.pt", weights_only=True)
    assert sorted(raw) == ["ema", "opt_state", "params", "step"]

    ema, step = ckpt.restore_params(use_ema=True)
    params, _ = ckpt.restore_params(use_ema=False)
    assert step == 7
    for k, v in state.params.items():
        torch.testing.assert_close(params[k], v.detach())
        torch.testing.assert_close(ema[k], v.detach() + 1.0)

    fresh = ckpt.restore(_seeded_state(tiny, seed=1))
    assert fresh.step == 7
    for k, v in state.params.items():
        torch.testing.assert_close(fresh.params[k].detach(), v.detach())
        torch.testing.assert_close(fresh.ema.params[k], state.ema.params[k])

    no_ema = TrainState.create(state.model, get_optimizer(tiny["cfg"]),
                               ema_decay=None)
    Checkpointer(str(tmp_path / "raw"), track_best=False).save(1, no_ema)
    loaded, _ = Checkpointer(str(tmp_path / "raw")).restore_params()
    torch.testing.assert_close(loaded["conv_in.weight"],
                               state.model.conv_in.weight.detach())


def test_checkpointer_refuses_orbax_checkpoints(tmp_path):
    # an orbax step directory is converted first (convert_orbax_checkpoint.py,
    # tests/test_torch_orbax.py); the port's reader names that tool
    (tmp_path / "3" / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        Checkpointer(str(tmp_path)).latest_step()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Checkpointer(str(tmp_path / "empty")).restore_params()


def test_step_generator_is_seeded_by_seed_and_step():
    draw = lambda s, n: torch.rand(4, generator=step_generator(s, n, "cpu"))
    assert torch.equal(draw(0, 0), draw(0, 0))
    assert not torch.equal(draw(0, 0), draw(0, 4))
    assert not torch.equal(draw(0, 0), draw(1, 0))


def test_fit_checkpoints_resumes_and_samples_from_the_checkpoint(tmp_path,
                                                                 tiny):
    cfg = tiny["cfg"]
    sde = make_sde(cfg)
    data = np.random.RandomState(5).rand(8, 16, 16, 3).astype(np.float32)
    it = batch_iterator(data, 2, seed=0)
    log_dir = str(tmp_path / "run")
    hooks = []

    state = _seeded_state(tiny)
    p0 = state.model.conv_in.weight.detach().clone()
    step = make_continuous_score_train_step(state.model, sde)
    state = fit(state, step, it, FitConfig(n_epochs=1, log_every=1,
                                           log_dir=log_dir),
                epoch_end_hook=lambda s, e: hooks.append((s.step, e)))
    assert state.step == 4 and hooks == [(4, 0)]
    assert not torch.equal(state.model.conv_in.weight, p0)
    ckpt_dir = os.path.join(log_dir, "ckpts")
    assert Checkpointer(ckpt_dir).all_steps() == [4]
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    assert len(losses) == 4 and np.isfinite(losses).all()

    # a fresh state in the same log dir resumes at step 4 and stops at 6
    resumed = _seeded_state(tiny, seed=1)
    step = make_continuous_score_train_step(resumed.model, sde)
    resumed = fit(resumed, step, it, FitConfig(
        n_epochs=2, max_steps=6, log_every=1, log_dir=log_dir))
    assert resumed.step == 6
    assert Checkpointer(ckpt_dir).all_steps() == [4, 6]

    overrides = sum((["--override", f"{k}={v}"] for k, v in TINY.items()),
                    [])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        samples = pc_sampling.main(
            ["--config", LEAF, "--device", "cpu", "--num_samples", "2",
             "--ckpt_dir", ckpt_dir, "--save_dir", str(tmp_path / "samples"),
             "--override", "model.num_scales=3", *overrides])
    assert samples.shape == (2, 16, 16, 3) and np.isfinite(samples).all()
    assert "(nfe=6)" in printed.getvalue()
