"""The port's reference-checkpoint import (utils/torch_import.py,
scripts/import_torch_checkpoint.py) held to the JAX package's.

Reference-layout state dicts are built from numpy-drawn JAX parameters: by
JAX's `export_ncsn_state_dict` for the NCSNv2 family, and by inverting
JAX's `ncsnpp_index_map` / `ddpm_index_map` / `cond_ncsn_torch_prefix`
here for NCSN++, DDPM and NCSN v1. The port's import must equal JAX's
`convert_*_state_dict` followed by `utils/convert.flax_to_torch_*` bit for
bit; each family's imported net runs one forward against JAX at NET_TOL;
the converters' refusals and `extract_ema_state_dict`'s three cases; and
`import_torch_checkpoint` end to end on a tiny `.ckpt`, read back by a
port CLI on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.config import (
    load_config as jax_load_config)
from inverseproblemwithdiffusionmodel_tpu.configs_continuous import (
    get_continuous_config as jax_get_config)
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    create_model as jax_create_model, get_model as jax_get_model)
from inverseproblemwithdiffusionmodel_tpu.utils import torch_import as jti
from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
    get_continuous_config)
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    create_model, get_model)
from inverseproblemwithdiffusionmodel_tpu_torch.utils import convert
from inverseproblemwithdiffusionmodel_tpu_torch.utils import (
    torch_import as pti)
from tests.test_torch_ncsnv2 import NET_TOL, _np, draw, nchw, nhwc

torch.set_num_threads(1)

ACDC = {"model.ngf": 8}
CINE = {"model.ngf": 8, "data.channels": 16, "data.image_size": 8}
TINY_PP = {"data.image_size": 16, "model.nf": 16, "model.ch_mult": (1, 2, 2),
           "model.num_res_blocks": 1, "model.attn_resolutions": (8,)}
TINY_DDPM = {"data.image_size": 16, "model.nf": 32, "model.ch_mult": (1, 2),
             "model.num_res_blocks": 1, "model.attn_resolutions": (8,),
             "model.dropout": 0.0}


def shapes_draw(module, *args, seed=0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return draw(shapes["params"], np.random.RandomState(seed))


def gn_draw(module, *args, seed=0):
    """Params for the GroupNorm nets: kernels at fan-in scale, scales
    1 + 0.1 z, other vectors 0.1 z."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rs = np.random.RandomState(seed)

    def go(tree):
        out = {}
        for key, value in tree.items():
            if hasattr(value, "items"):
                out[key] = go(value)
                continue
            z = rs.randn(*value.shape).astype(np.float32)
            if key == "scale":
                out[key] = 1.0 + 0.1 * z
            elif len(value.shape) == 1:
                out[key] = 0.1 * z
            else:
                out[key] = z / np.sqrt(np.prod(value.shape[:-1]))
        return out
    return go(shapes["params"])


def flat(tree, prefix=()):
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from flat(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def to_torch_layout(leaf, arr):
    if leaf in ("kernel", "Conv2d_0_weight"):
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return arr.T
    return arr


def indexed_reference(params, index_map):
    """The reference's all_modules state dict of an NCSN++ / DDPM params
    tree: the inverse of JAX's _convert_indexed_state_dict."""
    sd = {}
    for path, arr in flat(params):
        top, subs, leaf = path[0], path[1:-1], path[-1]
        prefix = [f"all_modules.{index_map[top]}", *subs]
        if leaf in ("Conv2d_0_weight", "Conv2d_0_bias"):
            name = leaf.replace("_weight", ".weight").replace("_bias",
                                                              ".bias")
        else:
            name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        sd[".".join(prefix + [name])] = np.ascontiguousarray(
            to_torch_layout(leaf, arr))
    return sd


def cond_reference(params, sequential=False):
    """The reference's NCSN v1 state dict: conditional-norm embeddings
    concatenated gamma, alpha[, beta] into one Embedding weight; with
    `sequential`, ConvMeanPool convs nested in Sequential(pad, conv)."""
    sd, embeds = {}, {}
    for path, arr in flat(params):
        leaf = path[-1]
        prefix = jti.cond_ncsn_torch_prefix(path[:-1])
        if leaf in jti._EMBED_LEAVES:
            embeds.setdefault(prefix, {})[leaf] = arr
            continue
        if sequential and prefix.endswith(".conv"):
            prefix += ".1"
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        if leaf == "kernel":
            n = arr.ndim - 2
            arr = arr.transpose((n + 1, n) + tuple(range(n)))
        sd[f"{prefix}.{name}"] = np.ascontiguousarray(arr)
    for prefix, parts in embeds.items():
        order = sorted(parts, key=jti._EMBED_LEAVES.get)
        sd[f"{prefix}.embed.weight"] = np.concatenate(
            [parts[k] for k in order], axis=1)
    return sd


# -- the cases: (JAX params, reference sd, JAX import -> port state, port
#    model, port import, forward inputs and JAX's output) ------------------

def discrete_case(name, ds, over, example, adjust_padding=False):
    jmod = jax_get_model(name)(config=jax_load_config(ds, "real-imag",
                                                      **over))
    params = shapes_draw(jmod, jnp.zeros(example), jnp.ones((1,)))
    sd = jti.export_ncsn_state_dict(params, adjust_padding=adjust_padding)
    sd["sigmas"] = np.zeros((10,), np.float32)   # the converter skips it
    cfg = load_config(ds, "real-imag", **over)
    model = get_model(name)(cfg)
    expect = lambda: (convert.flax_to_torch_ncsn3d if "3d" in name
                      else convert.flax_to_torch_ncsnv2)(
        jti.convert_ncsn_state_dict(sd, params), cfg, name)
    rs = np.random.RandomState(3)
    x = _np(rs.rand(2, *example[1:]))
    s = np.array([40.0, 0.37], np.float32)
    return dict(jmod=jmod, params=params, sd=sd, model=model, expect=expect,
                port=lambda: pti.convert_ncsn_state_dict(sd, model),
                forward=lambda m: nhwc(m(nchw(x), torch.from_numpy(s))),
                ref=lambda: np.asarray(jmod.apply({"params": params}, x, s)))


def continuous_case(leaf, over, labels, seed=0, sequential=False):
    jcfg = jax_get_config(leaf).replace(**over)
    cfg = get_continuous_config(leaf).replace(**over)
    jmod = jax_create_model(jcfg)
    size, C = cfg.data.image_size, cfg.data.num_channels
    name = cfg.model.name
    t = (jnp.zeros((1,), jnp.int32) if name in ("ncsn", "ncsn_deeper")
         else jnp.ones((1,)))
    x0 = jnp.zeros((1, size, size, C))
    if name in ("ncsnpp", "ddpm"):
        params = gn_draw(jmod, x0, t, seed=seed)
        index = (jti.ncsnpp_index_map if name == "ncsnpp"
                 else jti.ddpm_index_map)(jcfg)
        sd = indexed_reference(params, index)
        flax_to = (convert.flax_to_torch_ncsnpp if name == "ncsnpp"
                   else convert.flax_to_torch_ddpm)
    elif name.startswith("ncsnv2"):
        params = shapes_draw(jmod, x0, t, seed=seed)
        sd = jti.export_ncsn_state_dict(params)
        flax_to = convert.flax_to_torch_ncsnv2
    else:
        params = shapes_draw(jmod, x0, t, seed=seed)
        sd = cond_reference(params, sequential)
        flax_to = convert.flax_to_torch_ncsn
    model = create_model(cfg)
    rs = np.random.RandomState(4)
    x = _np(rs.rand(2, size, size, C))
    c = np.asarray(labels, np.int32 if t.dtype == jnp.int32 else np.float32)
    nchw_in = name.startswith("ncsn") and name != "ncsnpp"

    def forward(m):
        if nchw_in:
            return nhwc(m(nchw(x), torch.from_numpy(c)))
        return m(torch.from_numpy(x), torch.from_numpy(c)).numpy()

    return dict(
        jmod=jmod, params=params, sd=sd, model=model,
        expect=lambda: flax_to(jti.convert_continuous_state_dict(
            sd, params, jcfg), cfg),
        port=lambda: pti.convert_continuous_state_dict(sd, model, cfg),
        forward=forward,
        ref=lambda: np.asarray(jmod.apply({"params": params}, x, c)))


CASES = {
    "ncsnv2-32px": lambda: discrete_case(
        "ncsnv2", "ACDC", dict(ACDC, **{"data.image_size": 32}),
        (1, 32, 32, 1)),
    "ncsnv2-adjust_padding": lambda: discrete_case(
        "ncsnv2", "ACDC", dict(ACDC, **{"data.image_size": 32}),
        (1, 32, 32, 1), adjust_padding=True),
    "ncsnv2_deepest-64px": lambda: discrete_case(
        "ncsnv2_deepest", "ACDC", dict(ACDC, **{"data.image_size": 64}),
        (1, 64, 64, 1)),
    "ncsn1d": lambda: discrete_case("ncsn1d", "CINE127_1D", CINE,
                                    (1, 8, 16)),
    "ncsn1d-adjust_padding": lambda: discrete_case(
        "ncsn1d", "CINE127_1D", CINE, (1, 8, 16), adjust_padding=True),
    "ncsn3d_shallow": lambda: discrete_case("ncsn3d_shallow", "CINE127_1D",
                                            CINE, (1, 4, 4, 8, 1)),
    "ncsnpp-ffhq": lambda: continuous_case(
        "ve/ffhq_256_ncsnpp_continuous", TINY_PP, [0.5, 40.0]),
    "ncsnpp-cifar10-residual": lambda: continuous_case(
        "ve/cifar10_ncsnpp_continuous", TINY_PP, [0.5, 40.0]),
    "ddpmpp-resblock_ddpm": lambda: continuous_case(
        "vp/cifar10_ddpmpp_continuous",
        dict(TINY_DDPM, **{"model.resblock_type": "ddpm"}), [7.0, 300.0]),
    "ddpm": lambda: continuous_case("vp/ddpm/cifar10", TINY_DDPM,
                                    [0.0, 517.3]),
    "ncsnv2_64-continuous": lambda: continuous_case(
        "ve/ncsnv2/cifar10", {"model.ngf": 8}, [40.0, 0.37]),
    "ncsn-v1": lambda: continuous_case(
        "ve/ncsn/cifar10", {"model.ngf": 8}, [0, 7]),
    "ncsn-v1-28px-sequential": lambda: continuous_case(
        "ve/ncsn/cifar10", {"model.ngf": 8, "data.image_size": 28}, [0, 7],
        sequential=True),
    "ncsn_deeper": lambda: continuous_case(
        "ve/ncsn/cifar10", {"model.ngf": 8, "model.name": "ncsn_deeper"},
        [0, 7]),
}


@pytest.fixture(scope="module")
def cases():
    return {}


def get_case(cases, name):
    if name not in cases:
        cases[name] = CASES[name]()
    return cases[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_equals_jax_import_then_flax_to_torch(cases, name):
    case = get_case(cases, name)
    got, want = case["port"](), case["expect"]()
    assert sorted(got) == sorted(want) == sorted(case["model"].state_dict())
    for key in want:
        assert got[key].dtype == want[key].dtype == torch.float32, key
        assert torch.equal(got[key], want[key]), key


FORWARD = ["ncsnv2_deepest-64px", "ncsn1d", "ncsn3d_shallow", "ncsnpp-ffhq",
           "ddpm", "ncsnv2_64-continuous", "ncsn-v1"]


@pytest.mark.parametrize("name", FORWARD)
def test_imported_net_forward_matches_jax(cases, name):
    case = get_case(cases, name)
    model = case["model"]
    model.load_state_dict(case["port"](), strict=True)
    with torch.no_grad():
        out = case["forward"](model.eval())
    ref = case["ref"]()
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(out, ref, **NET_TOL)


@pytest.mark.parametrize("name,adjust", [("ncsnv2_deepest-64px", False),
                                         ("ncsnv2-adjust_padding", True),
                                         ("ncsn3d_shallow", False)])
def test_export_equals_jax_export(cases, name, adjust):
    case = get_case(cases, name)
    model = case["model"]
    model.load_state_dict(case["port"](), strict=True)
    got = pti.export_ncsn_state_dict(model, adjust_padding=adjust)
    want = jti.export_ncsn_state_dict(case["params"], adjust_padding=adjust)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_flax_layout_maps_back_through_convert(cases):
    """The template's Flax layout equals JAX's params tree in names and
    shapes, and utils/convert maps it back onto the model's state dict."""
    for name in ("ncsnv2_deepest-64px", "ncsn3d_shallow", "ncsnpp-ffhq",
                 "ncsn-v1"):
        case = get_case(cases, name)
        layout = pti.flax_layout(case["model"])
        assert {p: a.shape for p, a in layout.items()} == {
            p: a.shape for p, a in flat(case["params"])}


def test_ncsn_refusals(cases):
    case = get_case(cases, "ncsnv2-32px")
    sd, model = case["sd"], case["model"]
    missing = {k: v for k, v in sd.items() if not k.startswith("end_conv")}
    with pytest.raises(KeyError, match="missing"):
        pti.convert_ncsn_state_dict(missing, model)
    extra = dict(sd, **{"res9.0.conv1.weight": np.zeros((1,), np.float32)})
    with pytest.raises(KeyError, match="unconsumed"):
        pti.convert_ncsn_state_dict(extra, model)
    assert pti.convert_ncsn_state_dict(extra, model, strict_unused=False)
    bad = dict(sd, **{"begin_conv.weight": sd["begin_conv.weight"][:, :, :2]})
    with pytest.raises(ValueError, match="shape mismatch"):
        pti.convert_ncsn_state_dict(bad, model)


@pytest.mark.parametrize("name", ["ncsnpp-ffhq", "ncsn-v1"])
def test_indexed_and_conditional_refusals(cases, name):
    case = get_case(cases, name)
    sd, model = case["sd"], case["model"]
    cfg = get_continuous_config(
        "ve/ffhq_256_ncsnpp_continuous" if name == "ncsnpp-ffhq"
        else "ve/ncsn/cifar10").replace(
        **(TINY_PP if name == "ncsnpp-ffhq" else {"model.ngf": 8}))
    key = sorted(sd)[0]
    missing = {k: v for k, v in sd.items() if k != key}
    with pytest.raises(KeyError, match="missing"):
        pti.convert_continuous_state_dict(missing, model, cfg)
    conv = next(k for k in sorted(sd)
                if sd[k].ndim == 4 and sd[k].shape[-1] > 1)
    bad = dict(sd, **{conv: sd[conv][..., :1]})
    with pytest.raises(ValueError, match="shape mismatch"):
        pti.convert_continuous_state_dict(bad, model, cfg)
    with pytest.raises(KeyError, match="no torch importer"):
        pti.convert_continuous_state_dict(sd, model,
                                          cfg.replace(**{"model.name": "x"}))


def test_extract_ema_state_dict_cases():
    ema = {"model.a": 1, "model.b": 2}
    raw = {"model.a": 3, "model.b": 4}
    both = {"state_dict": raw, "callbacks": {"EMA": {"ema_state_dict": ema}}}
    assert pti.extract_ema_state_dict(both) == {"a": 1, "b": 2}
    assert pti.extract_ema_state_dict({"state_dict": raw,
                                       "callbacks": {"Other": {}}}) == {
        "a": 3, "b": 4}
    assert pti.extract_ema_state_dict({"model.a": 5, "c": 6}) == {"a": 5,
                                                                   "c": 6}
    for ckpt in (both, {"state_dict": raw}, {"model.a": 5}):
        assert pti.extract_ema_state_dict(ckpt) == \
            jti.extract_ema_state_dict(ckpt)
    assert pti.collate_state_dict({"net.x": 1, "y": 2}, "net.") == {
        "x": 1, "y": 2}


def lightning_ckpt(path, model, raw_model):
    """A Lightning-style checkpoint of the port's NCSNv2-family nets:
    `model.`-prefixed keys, the EMA copy under callbacks.EMA."""
    pre = lambda sd: {f"model.{k}": torch.from_numpy(v)
                      for k, v in sd.items()}
    torch.save({"state_dict": pre(pti.export_ncsn_state_dict(raw_model)),
                "callbacks": {"EMA": {"ema_state_dict": pre(
                    pti.export_ncsn_state_dict(model))}},
                "epoch": 3, "global_step": 1234}, path)


def test_load_torch_checkpoint_picks_ema_or_raw(tmp_path):
    cfg = load_config("ACDC", "real-imag", **dict(
        ACDC, **{"data.image_size": 32}))
    ema = convert.seeded_weights(get_model("ncsnv2")(cfg), 1)
    raw = convert.seeded_weights(get_model("ncsnv2")(cfg), 2)
    path = str(tmp_path / "last.ckpt")
    lightning_ckpt(path, ema, raw)
    for use_ema, src in ((True, ema), (False, raw)):
        sd = pti.load_torch_checkpoint(path, use_ema=use_ema)
        assert sd.keys() == jti.load_torch_checkpoint(path, use_ema).keys()
        model = get_model("ncsnv2")(cfg)
        model.load_state_dict(pti.convert_ncsn_state_dict(sd, model))
        for key, value in src.state_dict().items():
            assert torch.equal(model.state_dict()[key], value), key


def test_import_torch_checkpoint_end_to_end(tmp_path, capsys):
    """import_torch_checkpoint on a tiny ACDC .ckpt, then unconditioned
    sampling and the SENSE reconstruction read it back with --ckpt_dir."""
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        acdc_SENSE_real_img, import_torch_checkpoint as itc)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        Checkpointer)
    over = ["--override", "data.image_size=32", "--override", "model.ngf=8"]
    cfg = load_config("ACDC", "real-imag", **{"data.image_size": 32,
                                               "model.ngf": 8})
    ema = convert.seeded_weights(get_model("ncsnv2_deepest")(cfg), 1)
    raw = convert.seeded_weights(get_model("ncsnv2_deepest")(cfg), 2)
    ckpt = str(tmp_path / "last.ckpt")
    lightning_ckpt(ckpt, ema, raw)
    for flag, src in (([], ema), (["--raw_weights"], raw)):
        out = str(tmp_path / ("raw" if flag else "ema"))
        itc.main(["--ckpt_path", ckpt, "--ds_name", "ACDC", "--task_name",
                  "Diffusion", "--out_dir", out, "--device", "cpu"]
                 + flag + over)
        params, step = Checkpointer(out, track_best=False).restore_params()
        assert step == 0
        for key, value in src.state_dict().items():
            assert torch.equal(params[key], value), key
    assert "wrote" in capsys.readouterr().out
    recons = acdc_SENSE_real_img.main(
        ["--ckpt_dir", str(tmp_path / "ema"), "--device", "cpu",
         "--num_samples", "1", "--save_dir", str(tmp_path / "out"),
         "--override", "recons.num_classes=2"] + over)
    assert "restored step 0" in capsys.readouterr().out
    assert np.isfinite(np.asarray(recons)).all()
    with pytest.raises(SystemExit):
        itc.main(["--ckpt_path", ckpt, "--out_dir", str(tmp_path / "x")])


def test_import_torch_checkpoint_continuous(tmp_path, cases, capsys):
    """--continuous on a bare state-dict .pth of the tiny FFHQ NCSN++."""
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        import_torch_checkpoint as itc)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        Checkpointer)
    case = get_case(cases, "ncsnpp-ffhq")
    path = str(tmp_path / "ncsnpp.pth")
    torch.save({k: torch.from_numpy(v) for k, v in case["sd"].items()}, path)
    out = str(tmp_path / "ckpts")
    argv = ["--ckpt_path", path, "--continuous",
            "ve/ffhq_256_ncsnpp_continuous", "--out_dir", out,
            "--device", "cpu"]
    for key, value in TINY_PP.items():
        argv += ["--override", f"{key}={value}"]
    itc.main(argv)
    params, _ = Checkpointer(out, track_best=False).restore_params()
    want = case["expect"]()
    assert sorted(params) == sorted(want)
    assert all(torch.equal(params[k], want[k]) for k in want)
    assert "all leaves matched" in capsys.readouterr().out
