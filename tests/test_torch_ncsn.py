"""The port's NCSN v1 stack against the JAX package's: the four
class-conditional norms and BatchNorm, the remaining layers
(ConditionalResidualBlock, MeanPoolConv, UpsampleConv), the conditional
RefineNet blocks, NCSN and NCSNdeeper on weights carried across by
utils/convert.flax_to_torch_ncsn, an NCSNv2 with BatchNorm and its
batch_stats (flax_to_torch_ncsnv2), ScoreNet (flax_to_torch_scorenet), the
registry's make_apply_fn / module_takes_train / get_model_fn, and one
continuous train step of NCSN v1 on discrete labels (continuous=False).

JAX parameters are drawn with numpy from jax.eval_shape shapes. The port is
NCHW, the JAX package channel-last: inputs and outputs are transposed here.
Float32 forwards hold at rel L2 1e-5 (sums in another order); the train
step's loss at 1e-5 and its gradients at 1e-4.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn.functional as F

from inverseproblemwithdiffusionmodel_tpu.configs_continuous import (
    get_continuous_config as jax_get_config, make_sde as jax_make_sde)
from inverseproblemwithdiffusionmodel_tpu.models import layers as jlayers
from inverseproblemwithdiffusionmodel_tpu.models import ncsn as jncsn
from inverseproblemwithdiffusionmodel_tpu.models import (
    normalization as jnorm)
from inverseproblemwithdiffusionmodel_tpu.models import registry as jreg
from inverseproblemwithdiffusionmodel_tpu.models.simple import (
    ScoreNet as JaxScoreNet)
from inverseproblemwithdiffusionmodel_tpu.sde import VESDE as JaxVESDE
from inverseproblemwithdiffusionmodel_tpu.training.state import (
    TrainState as JaxTrainState)
from inverseproblemwithdiffusionmodel_tpu.training.train import (
    make_continuous_score_train_step as jax_make_step)
from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
    get_continuous_config, make_sde)
from inverseproblemwithdiffusionmodel_tpu_torch.models import (
    ScoreNet, create_model, get_model, get_model_fn, layers, make_apply_fn,
    module_takes_train, ncsn, normalization)
from inverseproblemwithdiffusionmodel_tpu_torch.sde import VESDE
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    TrainState, get_optimizer, make_continuous_score_train_step)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch, flax_to_torch_ncsn, flax_to_torch_scorenet,
    seeded_weights)

torch.set_num_threads(1)

LEAF = "ve/ncsn/cifar10"
K = 5            # classes of the block tests
REL = 1e-5


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def draw(tree, rs):
    """Params for a tree of shapes: kernels and biases U(+-1/sqrt(fan_in))
    (the JAX init's bounds), alpha / gamma and the embeddings of gamma and
    alpha 1 + 0.1 z, everything else (beta, its embeddings, Dense and
    GroupNorm leaves, BatchNorm's scale) 0.1 z or 1 + 0.1 z, so that no
    parameter of a comparison is trivial."""
    out = {}
    fan_in = (int(np.prod(tree["kernel"].shape[:-1])) if "kernel" in tree
              else None)
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = draw(value, rs)
            continue
        shape = tuple(value.shape)
        z = rs.randn(*shape)
        if key in ("kernel", "bias") and fan_in:
            bound = 1 / np.sqrt(fan_in)
            v = rs.uniform(-bound, bound, shape)
        elif key in ("alpha", "gamma", "gamma_embed", "alpha_embed",
                     "scale", "var"):
            v = 1 + 0.1 * np.abs(z) if key == "var" else 1 + 0.1 * z
        elif key == "W":                       # the Fourier projection
            v = z
        else:
            v = 0.1 * z
        out[key] = np.asarray(v, np.float32)
    return out


def shapes_of(module, *args, **kw):
    return jax.eval_shape(functools.partial(module.init, **kw),
                          jax.random.PRNGKey(0), *args)


def flax_params(module, *args, seed=0):
    return draw(shapes_of(module, *args)["params"],
                np.random.RandomState(seed))


def _x(*shape, seed=1):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * 1.5 + 0.3,
                      np.float32)


Y = np.array([0, 3, 4], np.int32)

COND = [("InstanceNorm++", jnorm.ConditionalInstanceNormPlus,
         normalization.ConditionalInstanceNormPlus),
        ("InstanceNorm", jnorm.ConditionalInstanceNorm,
         normalization.ConditionalInstanceNorm),
        ("VarianceNorm", jnorm.ConditionalVarianceNorm,
         normalization.ConditionalVarianceNorm),
        ("NoneNorm", jnorm.ConditionalNoneNorm,
         normalization.ConditionalNoneNorm)]


# -- norms --------------------------------------------------------------------

@pytest.mark.parametrize("name,jcls,cls", COND, ids=[c[0] for c in COND])
def test_conditional_norm_matches_jax(name, jcls, cls):
    C = 6
    x = _x(3, 9, 7, C)
    module = jcls(num_features=C, num_classes=K)
    params = flax_params(module, jnp.asarray(x), jnp.asarray(Y))
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x),
                                  jnp.asarray(Y)))
    ours = cls(C, K)
    ours.load_state_dict(flax_to_torch(params), strict=True)
    cfg = get_continuous_config(LEAF).replace(
        **{"model.normalization": name})
    assert normalization.get_normalization(cfg, conditional=True) is cls
    out = nhwc(ours(nchw(x), torch.from_numpy(Y).long()))
    assert rel_l2(out, ref) <= REL


def test_conditional_norm_init_follows_jax():
    """Embeddings of gamma and alpha drawn N(1, 0.02), beta's zero, in
    seeded_weights as in the JAX init."""
    norm = seeded_weights(normalization.ConditionalInstanceNormPlus(64, 100),
                          0)
    for name in ("gamma_embed", "alpha_embed"):
        p = getattr(norm, name).detach()
        assert abs(p.mean().item() - 1) < 0.002
        assert abs(p.std().item() - 0.02) < 0.002
    assert not norm.beta_embed.any()
    ref = np.asarray(jnorm.normal_init(1.0, 0.02)(jax.random.PRNGKey(0),
                                                  (100, 64)))
    assert abs(ref.std() - 0.02) < 0.002 and abs(ref.mean() - 1) < 0.002
    with pytest.raises(NotImplementedError, match="does not exist"):
        normalization.get_normalization(get_continuous_config(LEAF).replace(
            **{"model.normalization": "BatchNorm"}), conditional=True)


@pytest.mark.parametrize("running", [True, False],
                         ids=["running-average", "batch-statistics"])
def test_batchnorm_matches_flax(running):
    """Both modes of the JAX wrapper, the running statistics after one
    update included (Flax: momentum 0.99, the biased batch variance)."""
    C = 5
    x = _x(4, 6, 7, C)
    module = jnorm.BatchNorm(num_features=C, use_running_average=running)
    variables = draw(shapes_of(module, jnp.asarray(x)),
                     np.random.RandomState(3))
    ref, new = module.apply(variables, jnp.asarray(x),
                            mutable=["batch_stats"])
    ours = normalization.BatchNorm(C, use_running_average=running)
    ours.load_state_dict(flax_to_torch(_merge(variables)), strict=True)
    ours.train()
    out = nhwc(ours(nchw(x)))
    assert rel_l2(out, ref) <= REL
    stats = new["batch_stats"]["BatchNorm_0"]
    for key in ("mean", "var"):
        assert rel_l2(getattr(ours.BatchNorm_0, key).numpy(),
                      stats[key]) <= REL
    assert normalization.get_normalization(get_continuous_config(LEAF)
                                           .replace(**{
                                               "model.normalization":
                                               "BatchNorm"})) is \
        normalization.BatchNorm


def _merge(variables):
    out = {}
    for coll in ("params", "batch_stats"):
        for mod, leaves in variables[coll].items():
            out.setdefault(mod, {}).update(leaves)
    return out


# -- layers and blocks --------------------------------------------------------

ELU = (jax.nn.elu, F.elu)


def _pair(jmod, tmod, *inputs, rel=REL):
    """Init the Flax module from shapes, load into the port's, compare on
    the (channel-last) inputs; integer inputs are labels."""
    jin = [jnp.asarray(v) for v in inputs]
    params = flax_params(jmod, *jin)
    ref = np.asarray(jmod.apply({"params": params}, *jin))
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    tin = [torch.from_numpy(v).long() if v.dtype.kind == "i" else nchw(v)
           for v in inputs]
    with torch.no_grad():
        out = nhwc(tmod(*tin))
    assert out.shape == ref.shape
    assert rel_l2(out, ref) <= rel


RES_CASES = {
    "plain": dict(out=6, resample=None, dilation=None, adjust=False),
    "widen": dict(out=8, resample=None, dilation=None, adjust=False),
    "down": dict(out=8, resample="down", dilation=None, adjust=False),
    "dilated": dict(out=6, resample=None, dilation=2, adjust=False),
    "down_dilated": dict(out=8, resample="down", dilation=4, adjust=False),
    "adjust_padding": dict(out=8, resample="down", dilation=None,
                           adjust=True),
}


@pytest.mark.parametrize("case", RES_CASES)
def test_conditional_residual_block_matches_jax(case):
    c = RES_CASES[case]
    jmod = jlayers.ConditionalResidualBlock(
        output_dim=c["out"], normalization=jnorm.ConditionalInstanceNormPlus,
        num_classes=K, act=ELU[0], resample=c["resample"],
        dilation=c["dilation"], adjust_padding=c["adjust"])
    tmod = layers.ConditionalResidualBlock(
        6, c["out"], normalization.ConditionalInstanceNormPlus, K, ELU[1],
        resample=c["resample"], dilation=c["dilation"],
        adjust_padding=c["adjust"])
    _pair(jmod, tmod, _x(3, 13 if c["adjust"] else 12, 12, 6), Y)


@pytest.mark.parametrize("kind", ["MeanPoolConv", "UpsampleConv"])
@pytest.mark.parametrize("k", [1, 3])
def test_resampling_convs_match_jax(kind, k):
    jmod = getattr(jlayers, kind)(features=5, kernel_size=k)
    tmod = getattr(layers, kind)(4, 5, kernel_size=k)
    _pair(jmod, tmod, _x(2, 8, 6, 4))


def _cond_blocks():
    norm = (jnorm.ConditionalInstanceNormPlus,
            normalization.ConditionalInstanceNormPlus)
    return {
        "crp": (lambda: jncsn.CondCRPBlock(
            features=6, n_stages=2, num_classes=K, normalizer=norm[0],
            act=ELU[0]),
            lambda: ncsn.CondCRPBlock(6, 2, K, norm[1], ELU[1]),
            (_x(3, 10, 10, 6), Y)),
        "rcu": (lambda: jncsn.CondRCUBlock(
            features=6, n_blocks=2, n_stages=2, num_classes=K,
            normalizer=norm[0], act=ELU[0]),
            lambda: ncsn.CondRCUBlock(6, 2, 2, K, norm[1], ELU[1]),
            (_x(3, 10, 10, 6), Y)),
    }


@pytest.mark.parametrize("name", ["crp", "rcu"])
def test_cond_pooling_and_residual_units_match_jax(name):
    jmake, tmake, inputs = _cond_blocks()[name]
    _pair(jmake(), tmake(), *inputs)


class _Fused(torch.nn.Module):
    """Calls a multi-input block as msf / refine do: (xs, y, shape)."""

    def __init__(self, block, shape):
        super().__init__()
        self.block, self.shape = block, shape

    def forward(self, x0, x1, y):
        return self.block([x0, x1], y, self.shape)


@pytest.mark.parametrize("name", ["msf", "refine", "refine_end"])
def test_cond_fusion_and_refine_blocks_match_jax(name):
    norm = (jnorm.ConditionalInstanceNormPlus,
            normalization.ConditionalInstanceNormPlus)
    x0, x1 = _x(3, 8, 8, 4), _x(3, 4, 4, 6, seed=2)
    if name == "msf":
        jblock = jncsn.CondMSFBlock(features=5, num_classes=K,
                                    normalizer=norm[0])
        tblock = ncsn.CondMSFBlock([4, 6], 5, K, norm[1])
    else:
        end = name == "refine_end"
        jblock = jncsn.CondRefineBlock(features=5, num_classes=K,
                                       normalizer=norm[0], act=ELU[0],
                                       end=end)
        tblock = ncsn.CondRefineBlock([4, 6], 5, K, norm[1], ELU[1],
                                      end=end)
    jx = (jnp.asarray(x0), jnp.asarray(x1))
    params = draw(jax.eval_shape(
        lambda k, xs, y: jblock.init(k, xs, y, (8, 8)),
        jax.random.PRNGKey(0), list(jx), jnp.asarray(Y))["params"],
        np.random.RandomState(0))
    ref = np.asarray(jblock.apply({"params": params}, list(jx),
                                  jnp.asarray(Y), (8, 8)))
    tblock.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        out = nhwc(_Fused(tblock, (8, 8))(nchw(x0), nchw(x1),
                                          torch.from_numpy(Y).long()))
    assert rel_l2(out, ref) <= REL


# -- the nets -----------------------------------------------------------------

NETS = [("ncsn", 32), ("ncsn", 28), ("ncsn_deeper", 32)]


@pytest.mark.parametrize("name,size", NETS,
                         ids=[f"{n}-{s}px" for n, s in NETS])
def test_ncsn_nets_match_jax(name, size):
    """ngf 8; at 28 px NCSN pre-pads res4_0 (adjust_padding). The leaf's
    net takes the integer ladder label and does not divide by sigma."""
    upd = {"model.ngf": 8, "data.image_size": size, "model.name": name}
    jcfg = jax_get_config(LEAF).replace(**upd)
    cfg = get_continuous_config(LEAF).replace(**upd)
    jmod = (jncsn.NCSN if name == "ncsn" else jncsn.NCSNdeeper)(config=jcfg)
    x = np.random.RandomState(0).rand(2, size, size, 3).astype(np.float32)
    y = np.array([0, 7], np.int32)
    params = flax_params(jmod, jnp.asarray(x), jnp.asarray(y))
    ref = np.asarray(jax.jit(jmod.apply)({"params": params},
                                         jnp.asarray(x), jnp.asarray(y)))
    model = create_model(cfg)
    assert type(model) is {"ncsn": ncsn.NCSN,
                           "ncsn_deeper": ncsn.NCSNdeeper}[name]
    model.load_state_dict(flax_to_torch_ncsn(params, cfg), strict=True)
    with torch.no_grad():
        out = nhwc(model(nchw(x), torch.from_numpy(y)))
    assert rel_l2(out, ref) <= REL
    with pytest.raises(ValueError, match="not an NCSN v1"):
        flax_to_torch_ncsn(params, cfg, name="ncsnv2")


def test_batchnorm_net_converts_with_its_batch_stats():
    """NCSNv2 with normalization BatchNorm (running statistics, the JAX
    wrapper's default): flax_to_torch_ncsnv2 merges the batch_stats tree
    into the state dict, and the net holds to JAX's."""
    from inverseproblemwithdiffusionmodel_tpu.config import (
        load_config as jax_load_config)
    from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
        NCSNv2 as JaxNCSNv2)
    from inverseproblemwithdiffusionmodel_tpu_torch.config import (
        load_config)
    from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import (
        NCSNv2)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        flax_to_torch_ncsnv2)
    upd = {"model.ngf": 8, "data.image_size": 16,
           "model.normalization": "BatchNorm"}
    jmod = JaxNCSNv2(config=jax_load_config("MNIST", **upd))
    x = np.random.RandomState(0).rand(2, 16, 16, 1).astype(np.float32)
    sig = np.array([5.0, 0.5], np.float32)
    variables = draw(shapes_of(jmod, jnp.asarray(x), jnp.asarray(sig)),
                     np.random.RandomState(1))
    ref = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x),
                                         jnp.asarray(sig)))
    model = NCSNv2(load_config("MNIST", **upd))
    with pytest.raises(KeyError, match="missing"):
        flax_to_torch_ncsnv2(variables["params"], model.config)
    model.load_state_dict(flax_to_torch_ncsnv2(
        variables["params"], model.config,
        batch_stats=variables["batch_stats"]), strict=True)
    with torch.no_grad():
        out = nhwc(model(nchw(x), torch.from_numpy(sig)))
    assert rel_l2(out, ref) <= REL


@pytest.mark.parametrize("size,channels", [(16, 1), (32, 3)])
def test_scorenet_matches_jax(size, channels):
    """Channels (4, 8, 16, 32), the Flax 'SAME' convolutions and unflipped
    transposed convolutions, GroupNorm eps 1e-6, the output over the VE
    marginal std."""
    jsde, sde = JaxVESDE(sigma_max=5.0), VESDE(sigma_max=5.0)
    jstd = lambda t: jsde.marginal_prob(jnp.zeros((t.shape[0], 1)), t)[1]
    std = lambda t: sde.marginal_prob(torch.zeros(t.shape[0], 1), t)[1]
    jmod = JaxScoreNet(marginal_prob_std=jstd, channels=(4, 8, 16, 32),
                       embed_dim=16)
    x = _x(2, size, size, channels)
    t = np.array([0.3, 0.9], np.float32)
    params = flax_params(jmod, jnp.asarray(x), jnp.asarray(t))
    ref = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x),
                                         jnp.asarray(t)))
    model = ScoreNet(std, (4, 8, 16, 32), 16, in_channels=channels)
    model.load_state_dict(flax_to_torch_scorenet(params), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert out.shape == ref.shape
    assert rel_l2(out, ref) <= REL
    seeded = seeded_weights(ScoreNet(std, (4, 8, 16, 32), 16,
                                     in_channels=channels), 0)
    with torch.no_grad():
        assert torch.isfinite(seeded(torch.from_numpy(x),
                                     torch.from_numpy(t))).all()


# -- the registry -------------------------------------------------------------

def test_registry_apply_fn_train_flag_and_model_fn():
    # get_model_fn and make_apply_fn against JAX's on small modules: a
    # conditional norm (x, y) and InstanceNorm++ (x)
    C = 6
    x = _x(3, 5, 4, C)
    jnorm_mod = jnorm.ConditionalInstanceNormPlus(num_features=C,
                                                  num_classes=K)
    params = flax_params(jnorm_mod, jnp.asarray(x), jnp.asarray(Y))
    ref = np.asarray(jreg.get_model_fn(jnorm_mod, params, train=True)(
        jnp.asarray(x), jnp.asarray(Y)))
    model = normalization.ConditionalInstanceNormPlus(C, K)
    model.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        for train in (False, True):
            out = nhwc(get_model_fn(model, train=train)(
                nchw(x), torch.from_numpy(Y).long()))
            assert model.training is train
            assert rel_l2(out, ref) <= REL
    jplain = jnorm.InstanceNormPlus(num_features=C)
    params = flax_params(jplain, jnp.asarray(x))
    plain = normalization.InstanceNormPlus(C)
    plain.load_state_dict(flax_to_torch(params), strict=True)
    ref = np.asarray(jreg.make_apply_fn(jplain, params)(jnp.asarray(x)))
    with torch.no_grad():
        assert rel_l2(nhwc(make_apply_fn(plain)(nchw(x))), ref) <= REL

    # which nets depend on train / eval, as the JAX flag says
    ncsnpp = get_continuous_config("vp/cifar10_ddpmpp_continuous").replace(
        **{"data.image_size": 16, "model.nf": 16, "model.ch_mult": (1, 2),
           "model.num_res_blocks": 1, "model.attn_resolutions": (8,)})
    jpp = jax_get_config("vp/cifar10_ddpmpp_continuous").replace(
        **{"data.image_size": 16, "model.nf": 16, "model.ch_mult": (1, 2),
           "model.num_res_blocks": 1, "model.attn_resolutions": (8,)})
    pp = seeded_weights(create_model(ncsnpp), 0)
    std = lambda t: torch.ones_like(t)
    v1 = get_continuous_config(LEAF).replace(**{"model.ngf": 8})
    for port, ref_mod in ((pp, jreg.create_model(jpp)),
                          (create_model(v1), jreg.create_model(
                              jax_get_config(LEAF))),
                          (ScoreNet(std, (4, 8, 16, 32), 16),
                           JaxScoreNet(marginal_prob_std=lambda t: t))):
        assert module_takes_train(port) is jreg.module_takes_train(ref_mod)
    assert module_takes_train(pp)
    # dropout on in train mode only
    xs, ts = torch.rand(2, 16, 16, 3), torch.tensor([0.5, 0.2])
    with torch.no_grad():
        a = get_model_fn(pp, train=False)(xs, ts)
        b = get_model_fn(pp, train=False)(xs, ts)
        c = get_model_fn(pp, train=True)(xs, ts)
    assert torch.equal(a, b) and not torch.equal(a, c)

    # make_apply_fn: the plain forward
    clf = jreg.build_clf()
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        build_clf)
    net = seeded_weights(build_clf(), 0).eval()
    xc = torch.rand(2, 1, 32, 32)
    with torch.no_grad():
        assert torch.equal(make_apply_fn(net)(xc), net(xc))
    assert not module_takes_train(net) and not jreg.module_takes_train(clf)
    with pytest.raises(NotImplementedError, match="unknown model"):
        get_model("ncsn_v3")


# -- one train step -----------------------------------------------------------

def jax_draws(key, shape, sde_T=1.0, eps=1e-5):
    """t and z as JAX's continuous step draws them from its step key."""
    _, key_dsm, _ = jax.random.split(key, 3)
    key_t, key_z = jax.random.split(key_dsm)
    t = jax.random.uniform(key_t, (shape[0],), jnp.float32) * (sde_T - eps) \
        + eps
    z = jax.random.normal(key_z, shape, jnp.float32)
    return np.array(t), np.array(z)


def test_ncsn_v1_discrete_train_step_matches_jax():
    """make_continuous_score_train_step(continuous=False) on a tiny
    ve/ncsn/cifar10 (ngf 8, 16 px): the VE score function hands the net
    round((T - t)(N - 1)), the integer label; same t and z as JAX's step
    draws. Loss 1e-5, gradients 1e-4 rel L2."""
    upd = {"model.ngf": 8, "data.image_size": 16}
    jcfg = jax_get_config(LEAF).replace(**upd)
    cfg = get_continuous_config(LEAF).replace(**upd)
    jsde, sde = jax_make_sde(jcfg), make_sde(cfg)
    jmod = jreg.create_model(jcfg)
    batch = np.random.RandomState(4).rand(3, 16, 16, 3).astype(np.float32)
    params = flax_params(jmod, jnp.asarray(batch),
                         jnp.zeros((3,), jnp.int32), seed=5)
    key = jax.random.PRNGKey(6)
    t, z = jax_draws(key, batch.shape)

    # JAX's step with an optimizer that keeps the gradients as its state
    # and moves nothing: the step's own loss and gradients, one compile
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    jstate = JaxTrainState.create(params, keep, ema_decay=None)
    jstate, jloss = jax_make_step(jmod, jsde, continuous=False)(
        jstate, jnp.asarray(batch), key)
    grads = jax.tree_util.tree_map(np.asarray, jstate.opt_state)
    assert cfg.optim.grad_clip < 0      # no clipping in this recipe

    model = create_model(cfg)
    model.load_state_dict(flax_to_torch_ncsn(params, cfg), strict=True)
    state = TrainState.create(model, get_optimizer(cfg), ema_decay=None)
    step = make_continuous_score_train_step(model, sde, continuous=False)
    state, loss = step(state, batch, t=torch.from_numpy(t),
                       z=torch.from_numpy(z))
    assert state.step == 1
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jg = flax_to_torch_ncsn(grads, cfg)
    names = [k for k, _ in model.named_parameters()]
    port_g = np.concatenate([state.params[k].grad.numpy().ravel()
                             for k in names])
    jax_g = np.concatenate([jg[k].numpy().ravel() for k in names])
    assert rel_l2(port_g, jax_g) <= 1e-4
