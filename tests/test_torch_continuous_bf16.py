"""The continuous train step in bf16
(training/train.make_continuous_score_train_step, compute_dtype bf16)
against the JAX package's bf16 step, on the same weights, batch and draws.

Tiny NCSN++ nets with FIR resampling, dropout 0: the VE leaf
ve/ffhq_256_ncsnpp_continuous (Fourier embedding, input_skip / output_skip
pyramids) and the VP leaf vp/cifar10_ncsnpp_continuous (positional
embedding, t * 999) at 16 x 16, nf 16, ch_mult (1, 2, 2), one res block.
JAX's bf16 step fails on the VP leaf's own residual input pyramid (see
test_jax_bf16_step_fails_on_the_residual_pyramid), so the VP comparison
takes its input pyramid as input_skip.

bf16. The port runs the net in bf16 throughout. JAX's bf16 step does not:
Flax promotes a bf16 activation to float32 where it meets a float32
operand, and NCSN++ divides every skip-rescaled block's sum by the numpy
scalar np.sqrt(2.0) (float32), so from the first residual block on the JAX
net runs in float32, and with VP its float32 time embedding does the same
from the first block's Dense_0. Two bf16 steps thus round in different
places, and each is held to the float32 step both packages agree on (rel
L2 1e-4, as tests/test_torch_training.py):
- the casts: x, the conditioning and every parameter reach the net in
  bf16, every FIR op receives bf16, the net's output is bf16, and the
  master gradients are float32;
- the port's bf16 gradient reads at least 5e-3 from its float32 gradient
  (measured 0.123 VE, 0.020 VP), so a step that skips the cast fails;
- it is no farther from float32 than twice JAX's bf16 gradient (measured
  0.123 against 0.124 VE, 0.020 against 0.012 VP: JAX rounds in bf16 only
  up to its first residual block, so VP needs the factor 2);
- the two bf16 gradients lie within 1.25 x the root sum square of their
  distances from float32, and within BF16_CROSS_MAX of each other
  (measured 0.013 VE, 0.017 VP): both cast the same inputs and weights, so
  they share most of their rounding, and this is the gate a broken bf16
  backward fails (halved or zeroed, of the whole step or of the FIR ops
  alone: 0.12 to 1.0 on both leaves);
- the loss within 2e-2 of JAX's bf16 loss (measured 6.8e-4 VE, 1.3e-4 VP).
Each leaf's own loss weighting: reduce_mean False (VE), True (VP).
The VE leaf draws t from (0.43, 0.45), where sigma(t) lies near 1 (0.90
to 1.19): the Fourier embedding sin(2 pi W log sigma), W ~ 16 N(0, 1),
then has phases of tens, not hundreds, of radians, which bf16 still
resolves. Over the leaf's whole range (t ~ U(eps, 1)) bf16 rounds those
phases by radians, in both packages: each bf16 gradient then reads about
0.6 from float32 (0.57 at t up to 0.3), too near the 1.0 of a zero
gradient for these gates to tell the two apart.
"""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.configs_continuous import (
    get_continuous_config as jax_get_config, make_sde as jax_make_sde)
from inverseproblemwithdiffusionmodel_tpu.losses.dsm import (
    continuous_dsm_loss as jax_continuous_dsm_loss)
from inverseproblemwithdiffusionmodel_tpu.models.ncsnpp import (
    NCSNpp as JaxNCSNpp)
from inverseproblemwithdiffusionmodel_tpu.sde import (
    get_score_fn as jax_get_score_fn)
from inverseproblemwithdiffusionmodel_tpu.training.train import (
    _mixed_precision_apply as jax_mixed_precision_apply)
from inverseproblemwithdiffusionmodel_tpu.utils import misc as jmisc
from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
    get_continuous_config, make_sde)
from inverseproblemwithdiffusionmodel_tpu_torch.models import create_model
from inverseproblemwithdiffusionmodel_tpu_torch.ops import fir_kernels as fk
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    TrainState, get_optimizer, make_continuous_score_train_step)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnpp)
from test_torch_ncsnpp import perturb

torch.set_num_threads(2)

EPS = 1e-5
TINY = {"data.image_size": 16, "model.nf": 16, "model.ch_mult": (1, 2, 2),
        "model.num_res_blocks": 1, "model.attn_resolutions": (8,),
        "model.dropout": 0.0}
# (leaf, overrides, FIR ops per forward, the window t is drawn from)
VE = ("ve/ffhq_256_ncsnpp_continuous", {}, 12, (0.43, 0.45))
VP = ("vp/cifar10_ncsnpp_continuous", {"model.progressive_input": "input_skip"},
      10, (EPS, 1.0))
BF16_CROSS_MAX = 0.05       # the two bf16 gradients' distance (read 0.013,
                            # 0.017; a zeroed K1 backward reads 0.18, 0.12)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def build(leaf, extra, seed=0):
    """Both packages' configs, the Flax module and perturbed params."""
    over = dict(TINY, **extra)
    jcfg = jax_get_config(leaf).replace(**over)
    cfg = get_continuous_config(leaf).replace(**over)
    module = JaxNCSNpp(config=jcfg)
    C = cfg.data.num_channels
    params = jax.jit(module.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 16, 16, C)),
                                  jnp.ones((1,)))["params"]
    params = jax.tree_util.tree_map(
        jnp.asarray, perturb(params, np.random.RandomState(seed)))
    return jcfg, cfg, module, params


def short_sde(jsde, t_hi):
    """JAX's SDE with its horizon T cut to t_hi; every other method is the
    SDE's own."""
    if t_hi == 1.0:
        return jsde
    cls = type(jsde)
    short = type("Short" + cls.__name__, (cls,),
                 {"T": property(lambda self: t_hi)})
    return short(**{f.name: getattr(jsde, f.name)
                    for f in dataclasses.fields(jsde)})


def jax_draws(key, batch, mode="real-valued", t_window=(EPS, 1.0)):
    """The collation draw and t, z as JAX's continuous step draws them from
    its step key (train.py:166, dsm.py:79), t ~ U(t_window)."""
    key_collate, key_dsm, _ = jax.random.split(key, 3)
    parts = jmisc.collate_batch(jnp.asarray(batch), mode, key_collate)
    x = jmisc.stack_parts(*parts) if isinstance(parts, list) else parts
    B = batch.shape[0]
    kw = {}
    if mode == "real-imag":
        kw["phi"] = (jax.random.uniform(key_collate, (B,)) * 2 - 1) * jnp.pi
    elif mode == "real-imag-random":
        kw["patch"] = jax.random.normal(key_collate, (B, 5, 5,
                                                      batch.shape[-1]))
    key_t, key_z = jax.random.split(key_dsm)
    t_lo, t_hi = t_window
    kw["t"] = jax.random.uniform(key_t, (x.shape[0],)) * (t_hi - t_lo) + t_lo
    kw["z"] = jax.random.normal(key_z, x.shape)
    return {k: torch.from_numpy(np.array(v)) for k, v in kw.items()}


def jax_loss_and_grads(module, jsde, params, batch, key, compute_dtype=None,
                       mode="real-valued", reduce_mean=True,
                       t_window=(EPS, 1.0)):
    """JAX's continuous step's loss and its gradients, clipped at the
    leaf's grad_clip 1.0 by their global norm as optax clips them (the
    port's master gradients are read after its clip). t ~ U(t_window):
    JAX's loss draws t ~ U(eps, T), so eps and T are set to the window."""
    t_lo, t_hi = t_window
    jsde = short_sde(jsde, t_hi)
    apply_fn = jax_mixed_precision_apply(module, compute_dtype)
    key_collate, key_dsm, _ = jax.random.split(key, 3)

    def loss_fn(p):
        parts = jmisc.collate_batch(jnp.asarray(batch), mode, key_collate)
        x = jmisc.stack_parts(*parts) if isinstance(parts, list) else parts
        score = jax_get_score_fn(jsde, lambda v, c: apply_fn(p, v, c))
        return jax_continuous_dsm_loss(score, jsde, x, key_dsm, eps=t_lo,
                                       reduce_mean=reduce_mean)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    norm = float(optax.global_norm(grads))
    if norm >= 1.0:
        grads = jax.tree_util.tree_map(lambda g: g / norm, grads)
    return float(loss), grads


def port_step(cfg, params, batch, draws, compute_dtype=None,
              mode="real-valued", watch=None, reduce_mean=True):
    """One port step; its loss and the master gradients by name. `watch`
    collects the dtypes the net and the FIR ops see."""
    model = create_model(cfg)
    model.load_state_dict(flax_to_torch_ncsnpp(params, cfg), strict=True)
    state = TrainState.create(model, get_optimizer(cfg), ema_decay=None)
    step = make_continuous_score_train_step(model, make_sde(cfg),
                                            data_mode=mode,
                                            reduce_mean=reduce_mean,
                                            compute_dtype=compute_dtype)
    hooks = []
    if watch is not None:
        hooks = [
            model.register_forward_pre_hook(lambda m, args: watch.update(
                x=args[0].dtype, cond=args[1].dtype)),
            model.register_forward_hook(lambda m, args, out: watch.update(
                out=out.dtype, params={p.dtype for p in m.parameters()}))]
    _, loss = step(state, batch, **draws)
    for h in hooks:
        h.remove()
    assert all(p.dtype == torch.float32 and (p.grad is None or
               p.grad.dtype == torch.float32) for p in model.parameters())
    return float(loss), {k: p.grad for k, p in model.named_parameters()
                         if p.requires_grad}


def vector(grads, names):
    return np.concatenate([grads[k].double().numpy().ravel() for k in names])


@pytest.fixture
def fir_dtypes(monkeypatch):
    """The dtypes every FIR op of the net receives."""
    seen = []
    for name in ("upsample2x", "downsample2x"):
        orig = getattr(fk, name)

        def spy(x, *a, _orig=orig, **k):
            seen.append(x.dtype)
            return _orig(x, *a, **k)
        monkeypatch.setattr(fk, name, spy)
    return seen


@pytest.mark.parametrize("leaf,extra,n_fir,t_window", [VE, VP],
                         ids=["ve", "vp"])
def test_bf16_step_holds_to_jax_bf16(leaf, extra, n_fir, t_window, fir_dtypes):
    jcfg, cfg, module, params = build(leaf, extra)
    jsde = jax_make_sde(jcfg)
    rm = cfg.training.reduce_mean      # the leaf's loss weighting
    batch = np.random.RandomState(4).rand(4, 16, 16, 3).astype(np.float32)
    key = jax.random.PRNGKey(6)
    draws = jax_draws(key, batch, t_window=t_window)
    jloss16, jg16 = jax_loss_and_grads(module, jsde, params, batch, key,
                                       jnp.bfloat16, reduce_mean=rm,
                                       t_window=t_window)
    _, jg32 = jax_loss_and_grads(module, jsde, params, batch, key,
                                 reduce_mean=rm, t_window=t_window)

    _, g32 = port_step(cfg, params, batch, draws, reduce_mean=rm)
    del fir_dtypes[:]
    seen = {}
    loss16, g16 = port_step(cfg, params, batch, draws, torch.bfloat16,
                            watch=seen, reduce_mean=rm)
    assert seen == dict(x=torch.bfloat16, cond=torch.bfloat16,
                        out=torch.bfloat16, params={torch.bfloat16})
    # per forward: BigGAN down (h and x) and the input pyramid's down at
    # each of 2 levels; BigGAN up (h and x), and the output pyramid's up
    # (VE), at each of 2 levels
    assert fir_dtypes == [torch.bfloat16] * n_fir

    names = list(g32)
    p16, p32 = vector(g16, names), vector(g32, names)
    j16, j32 = (vector(flax_to_torch_ncsnpp(g, cfg), names)
                for g in (jg16, jg32))
    assert rel_l2(p32, j32) <= 1e-4
    port_err, jax_err = rel_l2(p16, p32), rel_l2(j16, j32)
    assert 5e-3 <= port_err <= 2.0 * jax_err
    cross = rel_l2(p16, j16)
    assert cross <= 1.25 * math.hypot(port_err, jax_err)
    assert cross <= BF16_CROSS_MAX
    np.testing.assert_allclose(loss16, jloss16, rtol=2e-2)


def test_bf16_step_runs_the_vp_leaf_residual_pyramid(fir_dtypes):
    # the leaf's own residual input pyramid, where JAX's bf16 step fails:
    # the port runs it in bf16 and lands near its float32 step
    _, cfg, _, params = build(VP[0], {})     # the leaf's own pyramid
    batch = np.random.RandomState(4).rand(4, 16, 16, 3).astype(np.float32)
    draws = jax_draws(jax.random.PRNGKey(6), batch)
    loss32, g32 = port_step(cfg, params, batch, draws)
    del fir_dtypes[:]
    seen = {}
    loss16, g16 = port_step(cfg, params, batch, draws, torch.bfloat16,
                            watch=seen)
    assert seen["out"] == torch.bfloat16 and seen["params"] == {
        torch.bfloat16}
    assert fir_dtypes and set(fir_dtypes) == {torch.bfloat16}
    names = list(g32)
    assert 5e-3 <= rel_l2(vector(g16, names), vector(g32, names)) <= 0.2
    np.testing.assert_allclose(loss16, loss32, rtol=2e-2)


def test_jax_bf16_step_fails_on_the_residual_pyramid():
    # pins the JAX-side defect the VP comparison steps around: the residual
    # pyramid's fused FIR conv gets a float32 activation (promoted by the
    # np.sqrt(2.0) skip rescale) beside its bf16 weight
    jcfg, _, module, params = build(VP[0], {})
    batch = jnp.zeros((2, 16, 16, 3))
    with pytest.raises(TypeError, match="same dtypes"):
        jax_loss_and_grads(module, jax_make_sde(jcfg), params, batch,
                           jax.random.PRNGKey(0), jnp.bfloat16)
