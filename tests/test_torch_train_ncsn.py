"""The port's discrete score-training path (utils/misc's complex data modes,
losses/dsm.anneal_dsm_score_estimation, training.make_score_train_step /
make_score_eval_step, MultiSteps, data/, scripts/train_ncsn) against the
JAX package's, on the same inputs, weights and draws.

JAX draws the step's randomness from its key (train.py:106 splits it into
a collation key and a DSM key, dsm.py:41 splits the DSM key into labels and
noise); `jax_draws` rebuilds those draws with jax.random and the tests hand
them to the port. Tiny nets: NCSNv2Deepest at 32 px, ngf 8; NCSN1D at
ngf 8 on tubes of 8 frames x 4 channels. JAX parameters are drawn with
numpy from `jax.eval_shape` shapes (no Flax init compile). Tolerances,
float32:
- collation at rtol 1e-6 (a cos and a sin per sample, or the phase map's
  two interpolation matmuls, then one product);
- the DSM loss at rel 1e-6 (one reduction in another order);
- the train step's loss at rel 1e-5, and the parameters and EMA after two
  steps at rel L2 1e-5 (float32 sums over a few thousand terms through
  about 60 layers, forward and backward; Adam's bias correction, which
  optax computes in float32 and torch in float64, differs by about 1e-5 of
  an update of lr = 1e-4, far below 1e-5 of the parameters);
- remat against no remat at rel 1e-6 (the same operations recomputed);
- the bf16 step against JAX's bf16 step: loss within 2e-2; the gradient
  held to the float32 gradient (at least 5e-3 from it, no farther than
  JAX's bf16 gradient) and to JAX's bf16 gradient at the distance two
  independent bf16 roundings give; the test says why and why the update
  is not compared.
"""
import contextlib
import io
import math
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.data import datasets as jdatasets
from inverseproblemwithdiffusionmodel_tpu.data import transforms as jT
from inverseproblemwithdiffusionmodel_tpu.losses.dsm import (
    anneal_dsm_score_estimation as jax_anneal_dsm)
from inverseproblemwithdiffusionmodel_tpu.models import ncsn1d as jncsn1d
from inverseproblemwithdiffusionmodel_tpu.models import ncsnv2 as jncsnv2
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    get_sigmas as jax_get_sigmas)
from inverseproblemwithdiffusionmodel_tpu.training.state import (
    TrainState as JaxTrainState, get_optimizer as jax_get_optimizer)
from inverseproblemwithdiffusionmodel_tpu.training.train import (
    _mixed_precision_apply as _jax_mixed_precision_apply,
    make_score_eval_step as jax_make_eval_step,
    make_score_train_step as jax_make_step)
from inverseproblemwithdiffusionmodel_tpu.utils import misc as jmisc
from inverseproblemwithdiffusionmodel_tpu.utils.reshape import (
    reshape_temporal_dim_np as jax_tubes_np)
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.data import datasets
from inverseproblemwithdiffusionmodel_tpu_torch.data import transforms as T
from inverseproblemwithdiffusionmodel_tpu_torch.losses.dsm import (
    anneal_dsm_score_estimation)
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsn1d import NCSN1D
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import (
    NCSNv2Deepest)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
    get_sigmas)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
    serve_recon, train_ncsn)
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    Checkpointer, MultiSteps, TrainState, get_optimizer,
    make_continuous_score_train_step, make_score_eval_step,
    make_score_train_step)
from inverseproblemwithdiffusionmodel_tpu_torch.utils import misc
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnv2)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.reshape import (
    reshape_temporal_dim_np)
from test_torch_ncsnv2 import init_flax

torch.set_num_threads(1)

SIZE, NGF, B = 32, 8, 2
OVER = {"data.image_size": SIZE, "model.ngf": NGF}
TUBE = {"model.ngf": NGF, "data.image_size": 8, "data.channels": 4,
        "model.num_classes": 10}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_phi(key, n):
    """collate_batch's real-imag phase, as JAX draws it from its key."""
    return np.array((jax.random.uniform(key, (n,)) * 2 - 1) * jnp.pi)


def jax_draws(key, batch_shape, num_sigmas, data_mode="real-imag"):
    """phi (or None), labels and noise as JAX's discrete step draws them
    from its step key, for a batch of `batch_shape`."""
    key_collate, key_dsm = jax.random.split(key)
    n = batch_shape[0]
    phi = None
    if data_mode == "real-imag":
        phi, n = jax_phi(key_collate, n), 2 * n
    key_labels, key_noise = jax.random.split(key_dsm)
    labels = jax.random.randint(key_labels, (n,), 0, num_sigmas)
    noise = jax.random.normal(key_noise, (n, *batch_shape[1:]))
    return {"phi": None if phi is None else torch.from_numpy(phi),
            "labels": torch.from_numpy(np.array(labels)).long(),
            "noise": torch.from_numpy(np.array(noise))}


# ---------------------------------------------------------------------------
# collate_batch, add_phase, filter_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 6, 6, 1), (3, 5, 4)],
                         ids=["images", "tubes"])
def test_collate_real_imag_matches_jax(shape):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jmisc.collate_batch(jnp.asarray(x), "real-imag", key)
    out = misc.collate_batch(torch.from_numpy(x), "real-imag",
                             phi=torch.from_numpy(jax_phi(key, shape[0])))
    assert isinstance(out, list) and len(out) == 2
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def test_collate_real_imag_random_matches_jax():
    x = np.random.RandomState(1).rand(2, 12, 10, 1).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jmisc.collate_batch(jnp.asarray(x), "real-imag-random", key)
    patch = np.array(jax.random.normal(key, (2, 5, 5, 1)))
    out = misc.collate_batch(torch.from_numpy(x), "real-imag-random",
                             patch=torch.from_numpy(patch))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def test_add_phase_2d_time_matches_jax():
    x = np.random.RandomState(2).rand(6, 8, 8, 1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jmisc.add_phase(jnp.asarray(x), key, init_shape=(3, 4, 4),
                          mode="2D+time")
    patch = np.array(jax.random.normal(key, (3, 4, 4, 1)))
    out = misc.add_phase(torch.from_numpy(x), init_shape=(3, 4, 4),
                         mode="2D+time", patch=torch.from_numpy(patch))
    assert out.dtype == torch.complex64 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_collate_draws_follow_the_generator():
    x = torch.rand(4, 8, 8, 1)

    def parts(mode, seed):
        return misc.collate_batch(x, mode, torch.Generator().manual_seed(seed))

    for mode in ("real-imag", "real-imag-random"):
        a, b, c = parts(mode, 0), parts(mode, 0), parts(mode, 1)
        assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
        # |x e^{i phase}| = x whatever the phase
        torch.testing.assert_close(torch.hypot(*a), x)
    phi = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    assert phi.min() >= 0     # U(0, 1) mapped to U(-pi, pi) below
    angles = torch.atan2(*reversed(misc.collate_batch(
        torch.ones(1000, 2, 2, 1), "real-imag",
        torch.Generator().manual_seed(0))))[:, 0, 0, 0]
    assert -math.pi <= angles.min() < -3 and 3 < angles.max() <= math.pi


@pytest.mark.parametrize("th", [0.0, 0.05, 0.2])
def test_filter_batch_equals_jax(th):
    rs = np.random.RandomState(3)
    x = rs.rand(8, 6, 4).astype(np.float32) * rs.rand(8, 1, 1) ** 3
    x[3] = 0.5                                  # a constant (background) tube
    ref = np.asarray(jmisc.filter_batch(jnp.asarray(x), th))
    out = misc.filter_batch(torch.from_numpy(x), th).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[:2].all() and out.dtype == np.float32
    np.testing.assert_array_equal(
        misc.filter_batch(torch.zeros(3, 4, 4, 1), th).numpy(), np.ones(3))


def test_filter_batch_keep_prob_keeps_rows():
    x = torch.zeros(6, 4, 2)
    assert misc.filter_batch(x, 0.1).tolist() == [1, 1, 0, 0, 0, 0]
    assert misc.filter_batch(x, 0.1, torch.Generator().manual_seed(0),
                             keep_prob=1.0).tolist() == [1] * 6


# ---------------------------------------------------------------------------
# anneal_dsm_score_estimation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_anneal_dsm_matches_jax(weighted):
    rs = np.random.RandomState(4)
    x = rs.rand(6, 5, 5, 1).astype(np.float32)
    sigmas = np.geomspace(10.0, 0.1, 7).astype(np.float32)
    labels = rs.randint(0, 7, 6)
    noise = rs.randn(*x.shape).astype(np.float32)
    weight = np.array([1, 1, 0, 1, 0, 1], np.float32) if weighted else None

    def score(v, lab):          # any smooth function of (x, labels) will do
        s = sigmas_of(lab).reshape(-1, 1, 1, 1)
        return -v / (1.0 + s) + 0.1 * v ** 2

    sigmas_of = lambda lab: jnp.asarray(sigmas)[lab]
    ref = jax_anneal_dsm(score, jnp.asarray(x), jnp.asarray(sigmas),
                         jax.random.PRNGKey(0), labels=jnp.asarray(labels),
                         anneal_power=2.0, noise=jnp.asarray(noise),
                         sample_weight=None if weight is None
                         else jnp.asarray(weight))
    sigmas_of = lambda lab: torch.from_numpy(sigmas)[lab]
    out = anneal_dsm_score_estimation(
        score, torch.from_numpy(x), torch.from_numpy(sigmas),
        labels=torch.from_numpy(labels), noise=torch.from_numpy(noise),
        sample_weight=None if weight is None else torch.from_numpy(weight))
    assert out.shape == ()
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_anneal_dsm_draws_follow_the_generator():
    x = torch.rand(64, 3, 3, 1)
    sigmas = torch.tensor([4.0, 2.0, 1.0])
    seen = []

    def score(v, lab):
        seen.append(lab)
        return torch.zeros_like(v)

    def loss(seed):
        return anneal_dsm_score_estimation(
            score, x, sigmas, torch.Generator().manual_seed(seed))

    a, b, c = loss(0), loss(0), loss(1)
    assert float(a) == float(b) != float(c)
    assert all(set(lab.tolist()) == {0, 1, 2} for lab in seen)
    with_weight = anneal_dsm_score_estimation(
        score, x, sigmas, labels=seen[0], noise=torch.zeros_like(x),
        sample_weight=torch.zeros(64))
    assert float(with_weight) == 0.0      # the 1e-12 floor, not 0 / 0


# ---------------------------------------------------------------------------
# the discrete train step against JAX's: tiny NCSNv2Deepest, real-imag
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def acdc():
    """The tiny NCSNv2Deepest in both packages with the same weights, its
    ladder, a batch, and two JAX steps (f32) from one key each."""
    jcfg = jax_load_config("ACDC", "real-imag", **OVER)
    cfg = load_config("ACDC", "real-imag", **OVER)
    module = jncsnv2.NCSNv2Deepest(config=jcfg)
    params = init_flax(module, jnp.zeros((1, SIZE, SIZE, 1)), jnp.ones((1,)),
                       seed=3)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    sigmas = np.asarray(jax_get_sigmas(jcfg))
    rs = np.random.RandomState(7)
    batches = [rs.rand(B, SIZE, SIZE, 1).astype(np.float32)
               for _ in range(4)]
    keys = [jax.random.PRNGKey(10 + i) for i in range(4)]
    step = jax_make_step(module, jnp.asarray(sigmas), data_mode="real-imag",
                         anneal_power=2.0, if_centering=True)
    jstate = JaxTrainState.create(params, jax_get_optimizer(jcfg),
                                  ema_decay=jcfg.model.ema_rate)
    states, losses = [], []
    for batch, key in zip(batches[:2], keys[:2]):
        jstate, loss = step(jstate, jnp.asarray(batch), key)
        states.append(jstate)
        losses.append(float(loss))
    return dict(jcfg=jcfg, cfg=cfg, module=module, params=params,
                sigmas=sigmas, batches=batches, keys=keys, states=states,
                losses=losses)


def torch_params(tree, cfg):
    return flax_to_torch_ncsnv2(tree, cfg, "ncsnv2_deepest")


def port_state(acdc, tx=None):
    cfg = acdc["cfg"]
    model = NCSNv2Deepest(cfg)
    model.load_state_dict(torch_params(acdc["params"], cfg), strict=True)
    return TrainState.create(model, tx or get_optimizer(cfg),
                             ema_decay=cfg.model.ema_rate)


def port_steps(acdc, state, n=2, **kw):
    step = make_score_train_step(state.model, get_sigmas(acdc["cfg"]),
                                 data_mode="real-imag", anneal_power=2.0,
                                 if_centering=True, **kw)
    losses = []
    for batch, key in zip(acdc["batches"][:n], acdc["keys"][:n]):
        state, loss = step(state, batch, **jax_draws(
            key, batch.shape, len(acdc["sigmas"])))
        losses.append(float(loss))
    return state, losses


def state_vector(sd, names):
    return np.concatenate([sd[k].detach().double().numpy().ravel()
                           for k in names])


def test_acdc_train_step_matches_jax(acdc):
    cfg = acdc["cfg"]
    state, losses = port_steps(acdc, port_state(acdc))
    assert state.step == 2
    np.testing.assert_allclose(losses, acdc["losses"], rtol=1e-5)
    names = [k for k, _ in state.model.named_parameters()]
    jstate = acdc["states"][1]
    want = torch_params(jstate.params, cfg)
    assert rel_l2(state_vector(state.params, names),
                  state_vector(want, names)) <= 1e-5
    ema = torch_params(jstate.ema.params, cfg)
    assert rel_l2(state_vector(state.ema.params, names),
                  state_vector(ema, names)) <= 1e-5
    # the parameters moved, by far more than the tolerance
    p0 = torch_params(acdc["params"], cfg)
    assert rel_l2(state_vector(state.params, names),
                  state_vector(p0, names)) > 1e-4


def test_acdc_train_step_with_remat_equals_without(acdc):
    a, la = port_steps(acdc, port_state(acdc), n=1)
    b, lb = port_steps(acdc, port_state(acdc), n=1, remat=True)
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    names = [k for k, _ in a.model.named_parameters()]
    for grads in (lambda s: {k: p.grad for k, p in
                             s.model.named_parameters()}, lambda s: s.params):
        assert rel_l2(state_vector(grads(b), names),
                      state_vector(grads(a), names)) <= 1e-6


def jax_loss_and_grad(acdc, batch, key, compute_dtype):
    """JAX's discrete step's loss and its gradient (train.py:97-130),
    jitted: the step itself returns no gradient."""
    sigmas = jnp.asarray(acdc["sigmas"])
    apply_fn = _jax_mixed_precision_apply(acdc["module"], compute_dtype)

    def loss_fn(params):
        key_collate, key_dsm = jax.random.split(key)
        parts = jmisc.collate_batch(2.0 * jnp.asarray(batch) - 1.0,
                                    "real-imag", key_collate)
        return jax_anneal_dsm(
            lambda x, labels: apply_fn(params, x, sigmas[labels]),
            jmisc.stack_parts(*parts), sigmas, key_dsm, anneal_power=2.0)

    return jax.jit(jax.value_and_grad(loss_fn))(acdc["params"])


def test_acdc_bf16_step_holds_to_jax_bf16(acdc):
    """One bf16 step, the JAX package's mixed-precision cast, against JAX's
    bf16 step on the same weights and draws. Two bf16 steps round each on
    its own, so each is held to the float32 step that both packages agree
    on (gradient rel L2 1e-5; measured 9.9e-7):
    - the net runs on casts: x, sigma and every parameter reach it in
      bf16, its output and the master gradients are float32, and the
      gradient reads at least 5e-3 from float32 (measured 1.19e-2), so a
      step that skips the cast fails;
    - the port's bf16 gradient is no farther from float32 than JAX's own
      (measured 1.19e-2 against 4.12e-2). XLA's CPU backend sums a bf16
      cotangent (the bias, InstanceNorm++ gamma and beta gradients, the
      norms' backward) with about three times the error of torch, which
      accumulates such sums in float32; PERF.md gives the readings;
    - the two bf16 gradients lie as far apart as two independent roundings
      put them: at most 1.25 x the root sum square of their distances from
      float32 (measured 4.15e-2 against 4.29e-2);
    - the loss within 2e-2 of JAX's bf16 loss and of float32's.
    Not the update, though the issue asked for it at rel L2 5e-2: Adam's
    first update at ACDC's eps (1e-3) is about lr * sign(g) where |g| >>
    eps, so entries near 0 that bf16 rounds to the other sign flip their
    updates. JAX's own bf16 update reads 0.34 from its float32 update, so
    no bf16 step meets that gate."""
    cfg = acdc["cfg"]
    batch, key = acdc["batches"][0], acdc["keys"][0]
    jloss, jgrads = jax_loss_and_grad(acdc, batch, key, jnp.bfloat16)
    _, jgrads32 = jax_loss_and_grad(acdc, batch, key, None)
    grads, seen = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        state = port_state(acdc)
        model = state.model
        hooks = [
            model.register_forward_pre_hook(lambda m, args: seen.update(
                x=args[0].dtype, sigma=args[1].dtype)),
            model.register_forward_hook(lambda m, args, out: seen.update(
                out=out.dtype, params={p.dtype for p in m.parameters()}))]
        state, (loss,) = port_steps(
            acdc, state, n=1,
            compute_dtype=None if dtype == torch.float32 else dtype)
        for h in hooks:
            h.remove()
        grads[dtype] = {k: p.grad for k, p in model.named_parameters()}
    assert seen == dict(x=torch.bfloat16, sigma=torch.bfloat16,
                        out=torch.bfloat16, params={torch.bfloat16})
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in model.parameters())
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-2)
    np.testing.assert_allclose(loss, acdc["losses"][0], rtol=2e-2)  # f32
    names = list(grads[torch.float32])
    g16, g32 = (state_vector(grads[d], names)
                for d in (torch.bfloat16, torch.float32))
    j16, j32 = (state_vector(torch_params(g, cfg), names)
                for g in (jgrads, jgrads32))
    assert rel_l2(g32, j32) <= 1e-5
    port_err, jax_err = rel_l2(g16, g32), rel_l2(j16, j32)
    assert 5e-3 <= port_err <= jax_err
    assert rel_l2(g16, j16) <= 1.25 * math.hypot(port_err, jax_err)


class _Pair(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v.copy())))


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_grad_accum_matches_optax_multisteps(acdc, clip):
    """--grad_accum 2 over four micro-steps on the same gradients: the
    parameters move at micro-steps 2 and 4 only, by the inner optimizer on
    the mean gradient (clipped where the config clips); the EMA and the
    step count move at every micro-step (rtol 1e-6: Adam's bias correction
    in float32 against float64, a few ulp of the parameters)."""
    jcfg = acdc["jcfg"].replace(**{"optim.grad_clip": clip})
    cfg = acdc["cfg"].replace(**{"optim.grad_clip": clip})
    rs = np.random.RandomState(11)
    params = {"w": rs.randn(4, 3).astype(np.float32),
              "b": rs.randn(3).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in
              params.items()} for _ in range(4)]
    jstate = JaxTrainState.create(
        {k: jnp.asarray(v) for k, v in params.items()},
        optax.MultiSteps(jax_get_optimizer(jcfg), every_k_schedule=2),
        ema_decay=0.9)
    model = _Pair(params)
    state = TrainState.create(model, MultiSteps.wrap(get_optimizer(cfg), 2),
                              ema_decay=0.9)
    moved = []
    for g in grads:
        jstate = jstate.apply_gradients({k: jnp.asarray(v)
                                         for k, v in g.items()})
        before = model.w.detach().clone()
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        state = state.apply_gradients()
        moved.append(not torch.equal(before, model.w))
    assert moved == [False, True, False, True]
    assert state.step == int(jstate.step) == 4
    assert state.optimizer.gradient_step == \
        int(jstate.opt_state.gradient_step) == 2
    assert state.optimizer.mini_step == int(jstate.opt_state.mini_step) == 0
    for k in params:
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   np.asarray(jstate.params[k]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(state.ema.params[k].numpy(),
                                   np.asarray(jstate.ema.params[k]),
                                   rtol=1e-6, atol=1e-7)


def test_multisteps_checkpoint_round_trip(acdc, tmp_path):
    cfg = acdc["cfg"]
    state = port_state(acdc, MultiSteps.wrap(get_optimizer(cfg), 2))
    state, _ = port_steps(acdc, state, n=1)
    ckpt = Checkpointer(str(tmp_path), track_best=False)
    ckpt.save(1, state)
    other = ckpt.restore(port_state(acdc, MultiSteps.wrap(
        get_optimizer(cfg), 2)))
    assert other.optimizer.mini_step == 1 and other.step == 1
    for a, b in zip(other.optimizer.acc, state.optimizer.acc):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        MultiSteps(get_optimizer(cfg)([torch.zeros(1)]), 0)


def test_eval_step_uses_the_ema_and_matches_jax(acdc):
    cfg = acdc["cfg"]
    jstate = acdc["states"][1]
    state, _ = port_steps(acdc, port_state(acdc))
    ev = make_score_eval_step(state.model, get_sigmas(cfg),
                              data_mode="real-imag", anneal_power=2.0,
                              if_centering=True)
    jev = jax_make_eval_step(acdc["module"], jnp.asarray(acdc["sigmas"]),
                             data_mode="real-imag", anneal_power=2.0,
                             if_centering=True)
    batch, key = acdc["batches"][2], acdc["keys"][2]
    draws = jax_draws(key, batch.shape, len(acdc["sigmas"]))
    out = ev(state, batch, **draws)
    assert out.shape == () and not out.requires_grad
    np.testing.assert_allclose(float(out), float(jev(jstate, jnp.asarray(
        batch), key)), rtol=1e-5)
    raw = make_score_eval_step(state.model, get_sigmas(cfg),
                               data_mode="real-imag", use_ema=False,
                               if_centering=True)(state, batch, **draws)
    assert abs(float(raw) - float(out)) > 1e-6 * abs(float(out))


def test_discrete_steps_refuse_what_is_not_ported(acdc):
    state = port_state(acdc)
    sig = get_sigmas(acdc["cfg"])
    # tensor parallelism needs the mesh its state was split over
    # (tests/test_torch_tp.py); a mesh needs a data axis
    # (tests/test_torch_distributed.py trains on one)
    with pytest.raises(ValueError, match="needs the mesh"):
        make_score_train_step(state.model, sig, tp=True)
    with pytest.raises(ValueError, match="'data' axis"):
        make_score_train_step(state.model, sig, mesh=object())
    other = port_state(acdc)
    with pytest.raises(ValueError, match="another model"):
        make_score_train_step(state.model, sig)(
            other, acdc["batches"][0])


# ---------------------------------------------------------------------------
# the 1-D temporal prior with the foreground filter
# ---------------------------------------------------------------------------

def test_ncsn1d_filtered_step_matches_jax():
    jcfg = jax_load_config("CINE127_1D", "real-imag", **TUBE)
    cfg = load_config("CINE127_1D", "real-imag", **TUBE)
    module = jncsn1d.NCSN1D(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, init_flax(
        module, jnp.zeros((1, 8, 4)), jnp.ones((1,)), seed=4))
    sigmas = np.asarray(jax_get_sigmas(jcfg))
    rs = np.random.RandomState(8)
    batch = rs.rand(6, 8, 4).astype(np.float32)
    batch[[2, 4]] = 0.3          # background tubes: zero weight
    key = jax.random.PRNGKey(21)
    th = jcfg.data.th
    assert misc.filter_batch(torch.from_numpy(2 * batch - 1), th).tolist() \
        == [1, 1, 0, 1, 0, 1]
    jstate = JaxTrainState.create(params, jax_get_optimizer(jcfg),
                                  ema_decay=jcfg.model.ema_rate)
    jstate, jloss = jax_make_step(module, jnp.asarray(sigmas),
                                  data_mode="real-imag", filter_th=th,
                                  if_centering=True)(
        jstate, jnp.asarray(batch), key)
    model = NCSN1D(cfg)
    model.load_state_dict(flax_to_torch_ncsnv2(params, cfg, "ncsn1d"),
                          strict=True)
    state = TrainState.create(model, get_optimizer(cfg),
                              ema_decay=cfg.model.ema_rate)
    state, loss = make_score_train_step(
        model, get_sigmas(cfg), data_mode="real-imag", filter_th=th,
        if_centering=True)(state, batch, **jax_draws(key, batch.shape,
                                                     len(sigmas)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = flax_to_torch_ncsnv2(jstate.params, cfg, "ncsn1d")
    names = list(want)
    assert rel_l2(state_vector(state.params, names),
                  state_vector(want, names)) <= 1e-5


@pytest.mark.parametrize("mode", ["complex", "real-imag",
                                  "real-imag-random"])
def test_continuous_step_refuses_complex_modes(mode):
    # the continuous step's complex data modes are ported now (held to JAX's
    # step in tests/test_torch_continuous_modes.py): it refuses none of
    # them, collates before its t and z draws, and gives the net the
    # interleaved [Re, Im] rows (or the two channels of 'complex')
    from test_torch_ncsnpp import LEAF, TINY
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        get_continuous_config, make_sde)
    from inverseproblemwithdiffusionmodel_tpu_torch.models import create_model
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        TrainState as PortState, get_optimizer)
    C = 2 if mode == "complex" else 1
    cfg = get_continuous_config(LEAF).replace(**dict(
        TINY, **{"data.num_channels": C, "model.ch_mult": (1, 2),
                 "model.dropout": 0.0}))
    weights = create_model(cfg).state_dict()
    seen = []
    batch = np.random.RandomState(0).rand(2, 16, 16, 1).astype(np.float32)

    def run(seed):
        model = create_model(cfg)
        model.load_state_dict(weights)
        model.register_forward_pre_hook(lambda m, args: seen.append(
            tuple(args[0].shape)))
        step = make_continuous_score_train_step(model, make_sde(cfg),
                                                data_mode=mode)
        state = PortState.create(model, get_optimizer(cfg))
        return float(step(state, batch,
                          torch.Generator().manual_seed(seed))[1])

    assert run(0) == run(0) != run(1)
    rows = 2 if mode == "complex" else 4
    assert seen[0] == (rows, 16, 16, C) and np.isfinite(run(2))


# ---------------------------------------------------------------------------
# data: transforms and loaders equal JAX's
# ---------------------------------------------------------------------------

def test_transforms_equal_jax():
    rs = np.random.RandomState(9)
    img = rs.rand(1, 20, 24).astype(np.float32)
    lab = (rs.rand(1, 20, 24) > 0.5).astype(np.int64)
    np.testing.assert_array_equal(T.scale_intensity(img),
                                  jT.scale_intensity(img))
    img0 = img * (rs.rand(1, 20, 24) > 0.3)
    for a, b in zip(T.crop_foreground(img0, lab, source=img0),
                    jT.crop_foreground(img0, lab, source=img0)):
        np.testing.assert_array_equal(a, b)
    for mode in ("bilinear", "nearest"):
        np.testing.assert_array_equal(T.resize(img, (32, 32), mode),
                                      jT.resize(img, (32, 32), mode))
    for seed in range(4):
        a = T.rand_rotate(img, lab, np.random.RandomState(seed), prob=0.5)
        b = jT.rand_rotate(img, lab, np.random.RandomState(seed), prob=0.5)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(
            T.rand_adjust_contrast(img, np.random.RandomState(seed)),
            jT.rand_adjust_contrast(img, np.random.RandomState(seed)))
        np.testing.assert_array_equal(
            T.rand_gaussian_noise(img, np.random.RandomState(seed), prob=0.5),
            jT.rand_gaussian_noise(img, np.random.RandomState(seed),
                                   prob=0.5))


def test_tube_reshape_np_equals_jax():
    x = np.random.RandomState(10).rand(2, 5, 18, 17).astype(np.float32)
    np.testing.assert_array_equal(reshape_temporal_dim_np(x, 4, 4),
                                  jax_tubes_np(x, 4, 4))


@pytest.mark.parametrize("name,mode,kw", [
    ("ACDC", "train", {}), ("ACDC", "val", {}),
    ("CINE127_1D", "train", {}), ("CINE64_1D", "val", {}),
    ("CINE64", "train", {}),
    ("CINE127_1D", "train", {"flatten_type": "spatial"})],
    ids=["acdc-train", "acdc-val", "cine127_1d-train", "cine64_1d-val",
         "cine64-frames", "cine127_1d-spatial"])
def test_load_data_equals_jax_on_the_synthetic_stand_ins(tmp_path, name,
                                                         mode, kw):
    kw = dict(kw, root_dir=str(tmp_path))        # no files: synthetic
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        ours = datasets.load_data(name, mode, **dict(kw))
    assert any("SYNTHETIC" in str(w.message) for w in seen)
    ref = jdatasets.load_data(name, mode, **dict(kw))
    assert ours.data.dtype == ref.data.dtype
    np.testing.assert_array_equal(ours.data, ref.data)
    if ref.labels is not None:
        np.testing.assert_array_equal(ours.labels, ref.labels)
    assert datasets.data_provenance()[f"{name}/{mode}"] == {
        "source": "synthetic", "num_items": len(ref)}


def test_load_data_refuses_what_is_not_ported():
    with pytest.raises(KeyError, match="unknown dataset"):
        datasets.load_data("IMAGENET")


def test_port_configs_keep_the_yaml_training_recipes():
    for name in ("ACDC", "CINE127_1D"):
        ours = load_config(name, "real-imag").to_dict()
        ref = jax_load_config(name, "real-imag").to_dict()
        for section, keys in (("training", ("anneal_power", "batch_size",
                                            "n_iters", "n_epochs")),
                              ("optim", ("optimizer", "lr", "eps", "beta1",
                                         "weight_decay")),
                              ("data", ("th",))):
            for k in keys:
                assert ours[section].get(k) == ref[section].get(k), (name, k)
    assert load_config("CINE127_1D").data.th == 0.05


# ---------------------------------------------------------------------------
# train_ncsn end to end, then serve what it trained
# ---------------------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = main(argv)
    return result, out.getvalue()


def test_train_ncsn_trains_and_serve_recon_serves_it(tmp_path):
    # the loader's slices are 256 px whatever the net's size, as in JAX
    tiny = ["--override", f"data.image_size={SIZE}", "--override",
            f"model.ngf={NGF}", "--override", "training.n_iters=2"]
    state, text = _run(train_ncsn.main, [
        "--ds_name", "ACDC", "--mode", "real-imag", "--device", "cpu",
        "--batch_size", "1", "--log_dir", str(tmp_path / "runs"),
        "--notes", "tiny", *tiny])
    run = tmp_path / "runs" / "ACDC_Diffusion_real-imag"
    assert state.step == 2 and "done: 2 steps" in text
    assert "notes: tiny" in (run / "desc.txt").read_text()
    ckpt_dir = run / "ckpts"
    assert Checkpointer(str(ckpt_dir)).all_steps() == [2]

    args = serve_recon.parse_args([
        "--device", "cpu", "--ckpt_dir", str(ckpt_dir), "--levels", "2",
        "--chains", "1", "--num_sens", "2", "--synth_sens", "--no_warmup",
        "--override", f"data.image_size={SIZE}", "--override",
        f"model.ngf={NGF}"])
    eng, text = _run(serve_recon.build_engine, args)
    assert "restored step 2 from" in text
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, state.ema.params[k].detach()), k
    rs = np.random.RandomState(0)
    res = eng.reconstruct(rs.rand(2, SIZE, SIZE).astype(np.float32),
                          rs.rand(2, SIZE, SIZE).astype(np.float32), seed=0)
    assert res.x_re.shape == (1, SIZE, SIZE, 1)
    assert np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()


def test_train_ncsn_temporal_prior_with_every_option(tmp_path):
    tiny = ["--override", "model.ngf=8", "--override", "training.n_iters=4"]
    state, text = _run(train_ncsn.main, [
        "--ds_name", "CINE64_1D", "--task_name", "Diffusion1D", "--mode",
        "real-imag", "--flatten_type", "temporal", "--device", "cpu",
        "--batch_size", "4", "--bf16", "--remat", "--grad_accum", "2",
        "--no_native_loader", "--num_workers", "2", "--log_dir",
        str(tmp_path), *tiny])
    assert state.step == 4 and state.optimizer.gradient_step == 2
    assert type(state.model).__name__ == "NCSNv2" and state.model.ndim == 1
    desc = (tmp_path / "CINE64_1D_Diffusion1D_real-imag" / "desc.txt"
            ).read_text()
    assert "filter_th: 0.06" in desc       # the config's data.th
    # --use_mesh is ported (tests/test_torch_distributed.py); on the
    # default device it needs a card, like every run without --device cpu
    with pytest.raises(RuntimeError, match="no CUDA"):
        train_ncsn.main(["--ds_name", "ACDC", "--use_mesh"])
    with pytest.raises(KeyError, match="unknown dataset"):
        train_ncsn.main(["--ds_name", "IMAGENET", "--device", "cpu"])
    assert not os.path.exists("runs/ACDC_Diffusion_real-valued")
