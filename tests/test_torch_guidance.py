"""The guidance nets' training in the port (models/classifier.ResNetClf,
losses/guidance, training.make_clf_train_step / make_seg_train_step,
scripts/train_clf, train_seg, the job generators) against the JAX
package's, on the same inputs, weights and draws.

The classifier runs at its only width (the ResNet-18 trunk, 64-512
channels) on 16 and 32 px images; the seg UNet is the general config's
narrowed to (4, 8, 16) channels at 32 px. JAX parameters are drawn with
numpy from `jax.eval_shape` shapes (no Flax init compile); JAX's steps
draw from their keys, and the tests rebuild those draws with jax.random
and hand them to the port. Tolerances, float32:
- the classifier's logits at rel L2 1e-5 (sums of up to 4,608 terms
  through 20 layers and 9 group norms);
- the three losses at rtol 1e-6 (softmaxes and means in another order);
- a train step's loss at rtol 1e-5, its gradient and the parameters after
  two Adam steps at rel L2 1e-5 (as tests/test_torch_train_ncsn.py holds
  the score step).
"""
import contextlib
import io
import os
import stat
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config, load_general_config as jax_general)
from inverseproblemwithdiffusionmodel_tpu.losses import guidance as jguid
from inverseproblemwithdiffusionmodel_tpu.models.classifier import (
    ResNetClf as JaxResNetClf)
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    build_seg_unet as jax_build_seg_unet)
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    get_sigmas as jax_get_sigmas)
from inverseproblemwithdiffusionmodel_tpu.scripts import (
    generate_train_ncsn as jax_gen_ncsn, generate_train_seg as jax_gen_seg)
from inverseproblemwithdiffusionmodel_tpu.training.state import (
    TrainState as JaxTrainState, get_optimizer as jax_get_optimizer)
from inverseproblemwithdiffusionmodel_tpu.training.train import (
    make_clf_train_step as jax_clf_step, make_seg_train_step as jax_seg_step)
from inverseproblemwithdiffusionmodel_tpu.utils import misc as jmisc
from inverseproblemwithdiffusionmodel_tpu_torch.config import (
    Config, load_config, load_general_config)
from inverseproblemwithdiffusionmodel_tpu_torch.losses import guidance
from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
from inverseproblemwithdiffusionmodel_tpu_torch.models.classifier import (
    ResNetClf)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
    get_sigmas)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
    generate_train_ncsn, generate_train_seg, train_clf, train_seg)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts._common import (
    reload_model)
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    Checkpointer, TrainState, get_optimizer, make_clf_train_step,
    make_seg_train_step)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_clf, flax_to_torch_unet, seeded_weights)
from tests.test_torch_ncsnv2 import init_flax
from tests.test_torch_sense_recon import _flags, _paths
from tests.test_torch_train_ncsn import jax_phi

torch.set_num_threads(2)

B = 3
SEG = {"spatial_dims": 2, "in_channels": 1, "out_channels": 2,
       "channels": [4, 8, 16], "strides": [2, 2]}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def draw_clf(tree, rs):
    """Classifier params for a tree of shapes, drawn with numpy: kernels
    and biases U(+-1/sqrt(fan_in)) (the JAX init's bounds), GroupNorm
    scales 1 + 0.1 z and biases 0.1 z (init 1 and 0), so that every
    parameter of a comparison counts."""
    fan_in = (int(np.prod(tree["kernel"].shape[:-1])) if "kernel" in tree
              else None)
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = draw_clf(value, rs)
            continue
        shape = tuple(value.shape)
        if fan_in is not None:
            bound = 1 / np.sqrt(fan_in)
            out[key] = rs.uniform(-bound, bound, shape)
        elif key == "scale":
            out[key] = 1 + 0.1 * rs.randn(*shape)
        else:
            out[key] = 0.1 * rs.randn(*shape)
        out[key] = np.asarray(out[key], np.float32)
    return out


def clf_params(seed=0, channels=1):
    """(the JAX ResNetClf, its params drawn by `draw_clf`, the port's
    ResNetClf on the same weights)."""
    module = JaxResNetClf(config=jax_general())
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, channels)))
    params = draw_clf(shapes["params"], np.random.RandomState(seed))
    model = registry.build_clf(in_channels=channels)
    model.load_state_dict(flax_to_torch_clf(params), strict=True)
    return module, params, model


def nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the classifier ----------------------------------------------------------

@pytest.fixture(scope="module")
def clf():
    module, params, model = clf_params()
    return dict(module=module, params=jax.tree_util.tree_map(jnp.asarray,
                                                             params),
                model=model)


@pytest.mark.parametrize("size", [16, 32])
def test_resnet_clf_forward_matches_flax(clf, size):
    x = np.random.RandomState(size).randn(2, size, size, 1).astype(
        np.float32)
    ref = np.asarray(jax.jit(clf["module"].apply)({"params": clf["params"]},
                                                  jnp.asarray(x)))
    with torch.no_grad():
        out = registry.make_clf_fn(clf["model"])(nhwc(x)).numpy()
    assert out.shape == ref.shape == (2, 10)
    assert rel_l2(out, ref) <= 1e-5


def test_converter_and_seeded_weights_cover_the_classifier(clf):
    model = clf["model"]
    leaves = jax.tree_util.tree_leaves(clf["params"])
    assert len(list(model.parameters())) == len(leaves) == 64
    assert not list(model.buffers())
    assert sum(p.numel() for p in model.parameters()) == sum(
        leaf.size for leaf in leaves)
    assert model.resnet.stage1_block0.downsample.padding == 0
    assert model.resnet.stage0_block0.downsample is None
    assert model.resnet.stem_norm.eps == 1e-6
    # the Flax layouts: (kh, kw, I, O) kernels, (in, out) Dense
    k = clf["params"]["resnet"]["stem"]["kernel"]
    np.testing.assert_array_equal(model.resnet.stem.weight.detach().numpy(),
                                  np.asarray(k).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.resnet.fc.weight.detach().numpy(),
        np.asarray(clf["params"]["resnet"]["fc"]["kernel"]).T)
    bad = dict(clf["params"], extra={"kernel": np.zeros((1, 1, 1, 1))})
    with pytest.raises(KeyError, match="extra"):
        flax_to_torch_clf(bad)
    a = seeded_weights(ResNetClf(load_general_config()), 5)
    b = seeded_weights(ResNetClf(load_general_config()), 5)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q) and p.std() > 0, name
    with torch.no_grad():
        for name, module in a.named_modules():
            if isinstance(module, torch.nn.GroupNorm):
                assert abs(float(module.weight.mean()) - 1) < 0.1, name
                assert abs(float(module.bias.mean())) < 0.1, name


def test_load_model_builds_the_classifier_at_the_jax_shape():
    cfg = load_config("MNIST")
    net, none = registry.load_model(cfg, "Clf", seed=1)
    assert none is None and isinstance(net, ResNetClf)
    x = registry.example_input(cfg, "Clf")
    assert x.shape == (1, 32, 32, 1)
    assert registry.make_clf_fn(net)(x).shape == (1, 10)
    two = registry.load_model(load_config("MNIST", "complex"), "Clf")[0]
    assert two.pre_conv.in_channels == 2


# -- the losses ------------------------------------------------------------

SIGMAS = np.exp(np.linspace(np.log(5.0), np.log(0.1), 7)).astype(np.float32)


def lin_clf(w):
    return (lambda x: jnp.tanh(x.reshape(x.shape[0], -1) @ jnp.asarray(w)),
            lambda x: torch.tanh(x.reshape(x.shape[0], -1)
                                 @ torch.from_numpy(w)))


def test_clf_loss_matches_jax_fed_its_draws():
    rs = np.random.RandomState(1)
    x = rs.rand(4, 5, 5, 1).astype(np.float32)
    y = rs.randint(0, 6, 4)
    w = rs.randn(25, 6).astype(np.float32)
    jfn, tfn = lin_clf(w)
    key = jax.random.PRNGKey(2)
    ref, ref_logits = jguid.clf_loss_with_perturbation(
        jfn, jnp.asarray(x), jnp.asarray(y), jnp.asarray(SIGMAS), key)
    key_l, key_n = jax.random.split(key)
    labels = np.array(jax.random.randint(key_l, (4,), 0, len(SIGMAS)))
    noise = np.array(jax.random.normal(key_n, x.shape))
    out, logits = guidance.clf_loss_with_perturbation(
        tfn, nhwc(x), torch.from_numpy(y), torch.from_numpy(SIGMAS),
        labels=torch.from_numpy(labels), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    # the stand-in classifier's 25-term sums, in another order
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("include_background,squared_pred",
                         [(False, True), (True, True), (False, False)])
def test_dice_ce_loss_matches_jax(include_background, squared_pred):
    rs = np.random.RandomState(3)
    logits = (2 * rs.randn(3, 6, 5, 3)).astype(np.float32)
    y = rs.randint(0, 3, (3, 6, 5))
    kw = dict(include_background=include_background,
              squared_pred=squared_pred)
    ref = jguid.dice_ce_loss(jnp.asarray(logits), jnp.asarray(y), **kw)
    out = guidance.dice_ce_loss(torch.from_numpy(logits),
                                torch.from_numpy(y), **kw)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


@pytest.mark.parametrize("perturb", [False, True])
def test_seg_loss_matches_jax_fed_its_draws(perturb):
    rs = np.random.RandomState(4)
    x = rs.rand(2, 6, 6, 1).astype(np.float32)
    y = rs.randint(0, 2, (2, 6, 6))
    w = rs.randn(2).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref, _ = jguid.seg_loss_with_perturbation(
        lambda v: v * jnp.asarray(w), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(SIGMAS), key, perturb=perturb)
    draws = {}
    if perturb:
        key_l, key_n = jax.random.split(key)
        shared = np.array(jax.random.randint(key_l, (1,), 0, len(SIGMAS)))
        draws = dict(labels=torch.from_numpy(np.repeat(shared, 2)),
                     noise=torch.from_numpy(np.array(
                         jax.random.normal(key_n, x.shape))))
    out, _ = guidance.seg_loss_with_perturbation(
        lambda v: v * torch.from_numpy(w), nhwc(x), torch.from_numpy(y),
        torch.from_numpy(SIGMAS), perturb=perturb, **draws)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_losses_draw_from_the_generator():
    x = torch.rand(3, 4, 4, 1)
    y = torch.tensor([0, 1, 2])
    fn = lambda v: v.reshape(3, -1)[:, :3]
    sig = torch.from_numpy(SIGMAS)
    a, _ = guidance.clf_loss_with_perturbation(
        fn, x, y, sig, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    labels = torch.randint(0, len(SIGMAS), (3,), generator=gen)
    noise = torch.randn(x.shape, generator=gen)
    b, _ = guidance.clf_loss_with_perturbation(fn, x, y, sig, labels=labels,
                                               noise=noise)
    assert torch.equal(a, b)
    # the seg loss draws one label for the batch, and only when perturbing
    gen = torch.Generator().manual_seed(1)
    guidance.seg_loss_with_perturbation(lambda v: v.expand(-1, -1, -1, 2),
                                        x, (y % 2)[:, None, None].expand(3, 4, 4),
                                        sig, gen)
    assert torch.equal(torch.rand(1, generator=gen),
                       torch.rand(1, generator=torch.Generator().manual_seed(
                           1)))


# -- the train steps ---------------------------------------------------------

def clf_draws(key, n, num_sigmas, shape):
    """The clf step's draws as JAX makes them from its step key
    (train.py:201-203, guidance.py:32-35)."""
    _, key = jax.random.split(key)
    key_l, key_n = jax.random.split(key)
    return dict(labels=torch.from_numpy(np.array(jax.random.randint(
        key_l, (n,), 0, num_sigmas))).long(),
        noise=torch.from_numpy(np.array(jax.random.normal(key_n, shape))))


def grads_of(model):
    return np.concatenate([p.grad.detach().double().numpy().ravel()
                           for p in model.parameters()])


def params_of(model):
    return np.concatenate([p.detach().double().numpy().ravel()
                           for p in model.parameters()])


def jax_vector(tree, convert):
    state = convert(tree)
    return lambda model: np.concatenate([
        state[k].double().numpy().ravel() for k, _ in
        model.named_parameters()])


def test_clf_train_step_matches_jax():
    jcfg, cfg = jax_load_config("MNIST"), load_config("MNIST")
    module, params, model = clf_params(seed=7)
    sigmas = np.asarray(jax_get_sigmas(jcfg))
    rs = np.random.RandomState(8)
    batches = [(rs.rand(B, 16, 16, 1).astype(np.float32),
                rs.randint(0, 10, B)) for _ in range(2)]
    keys = [jax.random.PRNGKey(20 + i) for i in range(2)]
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  jax_get_optimizer(jcfg), ema_decay=None)
    jstep = jax_clf_step(module, jnp.asarray(sigmas))
    # JAX's gradient of the first step, by its own loss
    X, y = (jnp.asarray(v) for v in batches[0])
    _, k = jax.random.split(keys[0])
    jgrad = jax.jit(jax.grad(lambda p: jguid.clf_loss_with_perturbation(
        lambda x: module.apply({"params": p}, x), X, y,
        jnp.asarray(sigmas), k)[0]))(jstate.params)

    state = TrainState.create(model, get_optimizer(cfg), ema_decay=None)
    step = make_clf_train_step(model, get_sigmas(cfg))
    for i, (batch, key) in enumerate(zip(batches, keys)):
        jstate, jloss = jstep(jstate, tuple(jnp.asarray(v) for v in batch),
                              key)
        state, loss = step(state, batch, **clf_draws(
            key, B, len(sigmas), batch[0].shape))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        if i == 0:
            assert rel_l2(grads_of(model),
                          jax_vector(jgrad, flax_to_torch_clf)(model)) <= 1e-5
    assert state.step == 2 and state.ema is None
    want = jax_vector(jstate.params, flax_to_torch_clf)(model)
    assert rel_l2(params_of(model), want) <= 1e-5
    assert rel_l2(params_of(model),
                  jax_vector(params, flax_to_torch_clf)(model)) > 1e-5
    with pytest.raises(ValueError, match="single-tensor"):
        make_clf_train_step(model, get_sigmas(cfg), data_mode="real-imag")(
            state, batches[0])
    with pytest.raises(ValueError, match="'data' axis"):
        make_clf_train_step(model, get_sigmas(cfg), mesh=object())


def seg_nets(seed=9):
    gc = jax_general().replace(**{f"Seg.{k}": v for k, v in SEG.items()})
    module = jax_build_seg_unet(gc)
    params = init_flax(module, jnp.zeros((1, 32, 32, 1)), seed=seed)
    rs = np.random.RandomState(seed)
    for name in params:
        if name.startswith("prelu"):
            params[name]["alpha"] = np.float32(0.25 + 0.1 * rs.randn())
    pgc = Config({"Seg": dict(SEG)})
    model = registry.build_seg_unet(pgc)
    model.load_state_dict(flax_to_torch_unet(params, pgc), strict=True)
    return module, params, model, pgc


@pytest.mark.parametrize("mode,centering,perturb", [
    ("real-valued", False, True), ("real-imag", True, False)])
def test_seg_train_step_matches_jax(mode, centering, perturb):
    jcfg, cfg = jax_load_config("ACDC", mode), load_config("ACDC", mode)
    module, params, model, pgc = seg_nets()
    sigmas = np.asarray(jax_get_sigmas(jcfg))
    rs = np.random.RandomState(10)
    batches = [(rs.rand(2, 32, 32, 1).astype(np.float32),
                rs.randint(0, 2, (2, 32, 32))) for _ in range(2)]
    keys = [jax.random.PRNGKey(30 + i) for i in range(2)]
    kw = dict(perturb=perturb, if_centering=centering, data_mode=mode)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  jax_get_optimizer(jcfg), ema_decay=None)
    jstep = jax_seg_step(module, jnp.asarray(sigmas), **kw)

    def jloss(p, batch, key):
        X, y = (jnp.asarray(v) for v in batch)
        X = 2.0 * X - 1.0 if centering else X
        key_collate, key = jax.random.split(key)
        Xc = jmisc.collate_batch(X, mode, key_collate)
        fn = lambda x: module.apply({"params": p}, x)
        if isinstance(Xc, list):
            k_re, k_im = jax.random.split(key)
            return 0.5 * sum(jguid.seg_loss_with_perturbation(
                fn, part, y, jnp.asarray(sigmas), k, perturb=perturb)[0]
                for part, k in zip(Xc, (k_re, k_im)))
        return jguid.seg_loss_with_perturbation(
            fn, Xc, y, jnp.asarray(sigmas), key, perturb=perturb)[0]

    def draws(key, shape):
        key_collate, key = jax.random.split(key)
        out = {}
        if mode == "real-imag":
            out["phi"] = torch.from_numpy(jax_phi(key_collate, shape[0]))
        if perturb:
            key_l, key_n = jax.random.split(key)
            shared = np.array(jax.random.randint(key_l, (1,), 0,
                                                 len(sigmas)))
            out["labels"] = torch.from_numpy(np.repeat(shared, shape[0]))
            out["noise"] = torch.from_numpy(np.array(jax.random.normal(
                key_n, shape)))
        return out

    jgrad = jax.jit(jax.grad(jloss))(jstate.params, batches[0], keys[0])
    state = TrainState.create(model, get_optimizer(cfg), ema_decay=None)
    step = make_seg_train_step(model, get_sigmas(cfg), **kw)
    convert = lambda t: flax_to_torch_unet(t, pgc)
    for i, (batch, key) in enumerate(zip(batches, keys)):
        jstate, jl = jstep(jstate, tuple(jnp.asarray(v) for v in batch), key)
        state, loss = step(state, batch, **draws(key, batch[0].shape))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        if i == 0:
            assert rel_l2(grads_of(model),
                          jax_vector(jgrad, convert)(model)) <= 1e-5
    assert state.step == 2
    assert rel_l2(params_of(model),
                  jax_vector(jstate.params, convert)(model)) <= 1e-5


# -- the scripts -------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = main(argv)
    return result, out.getvalue()


def test_train_clf_trains_and_reload_model_serves_the_checkpoint(tmp_path):
    state, text = _run(train_clf.main, [
        "--device", "cpu", "--batch_size", "4", "--train_mode", "debug",
        "--log_dir", str(tmp_path), "--seed", "3"])
    assert state.step == 2 and "done: 2 steps" in text
    ckpt_dir = tmp_path / "MNIST_Clf" / "ckpts"
    assert Checkpointer(str(ckpt_dir)).all_steps() == [2]
    cfg = load_config("MNIST")
    (model, _), text = _run(lambda a: reload_model(cfg, "Clf", a),
                            str(ckpt_dir))
    assert "Clf: restored step 2 from" in text
    assert isinstance(model, ResNetClf)
    for k, v in model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k
    fresh = seeded_weights(registry.build_clf(), 3)
    assert not torch.equal(fresh.resnet.fc.weight, model.resnet.fc.weight)


def test_train_seg_trains_at_the_config_size(tmp_path, monkeypatch):
    """The general config's UNet at full width on ACDC resized to 32 px
    (the config's image_size overridden through load_config), Re/Im mode,
    centered, perturbed."""
    real = train_seg.load_config
    monkeypatch.setattr(train_seg, "load_config", lambda ds, mode: real(
        ds, mode, **{"data.image_size": 32}))
    seen = []
    inner = train_seg.make_seg_train_step

    def spy(*args, **kwargs):
        step = inner(*args, **kwargs)

        def wrapped(state, batch, generator=None, **draws):
            seen.append(tuple(np.shape(v) for v in batch))
            return step(state, batch, generator, **draws)
        return wrapped

    monkeypatch.setattr(train_seg, "make_seg_train_step", spy)
    state, text = _run(train_seg.main, [
        "--device", "cpu", "--batch_size", "2", "--train_mode", "debug",
        "--mode", "real-imag", "--if_centering", "--perturb",
        "--log_dir", str(tmp_path)])
    assert state.step == 2 and state.ema is None
    assert seen == [((2, 32, 32, 1), (2, 32, 32))] * 2
    assert state.model.down_0.out_channels == 64
    assert Checkpointer(str(tmp_path / "ACDC_Seg" / "ckpts")
                        ).all_steps() == [2]


@pytest.mark.parametrize("name", ["train_clf", "train_seg",
                                  "generate_train_ncsn",
                                  "generate_train_seg"])
def test_script_flags_are_the_jax_scripts(name):
    ours, ref = (_flags(p) for p in _paths(f"{name}.py"))
    extra = {("--device",)} if name.startswith("train") else set()
    assert set(ours) - set(ref) == extra and set(ref) <= set(ours)
    for flags in ref:
        assert ours[flags] == ref[flags], flags


@pytest.mark.parametrize("argv", [[], ["--set_num", "1"],
                                  ["--set_num", "4"],
                                  ["--ds_names", "ACDC", "MNIST", "--mode",
                                   "complex", "--task_name", "Diffusion1D"]])
def test_job_generators_write_the_jax_files(tmp_path, argv):
    for ours, ref in ((generate_train_ncsn, jax_gen_ncsn),
                      (generate_train_seg, jax_gen_seg)):
        if ref is jax_gen_seg:
            argv = [a for a in argv if a not in ("--mode", "complex",
                                                 "--task_name",
                                                 "Diffusion1D", "MNIST")]
        a, b = tmp_path / f"port_{ours.__name__}", tmp_path / "jax"
        _run(ours.main, argv + ["--save_dir", str(a)])
        _run(ref.main, argv + ["--save_dir", str(b)])
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for name in os.listdir(b):
            want = (b / name).read_text().replace(
                "inverseproblemwithdiffusionmodel_tpu.",
                "inverseproblemwithdiffusionmodel_tpu_torch.")
            assert (a / name).read_text() == want
            assert os.stat(a / name).st_mode & stat.S_IXUSR
            (b / name).unlink()
