"""The port's Flax msgpack reader and writer (utils/flax_msgpack) against
flax.serialization, and the committed priors through utils/artifacts
against the JAX package's nets.

Bit for bit: the reader's leaves equal msgpack_restore's (dtype, shape
and bytes; bfloat16 leaves by their 16-bit patterns), the writer's bytes
equal msgpack_serialize's. Forwards: the port's nets with a committed
prior loaded by `load_prior` against the JAX nets with the same params,
batch 2 on the CPU, rel L2 <= 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from inverseproblemwithdiffusionmodel_tpu.config import Config as JConfig
from inverseproblemwithdiffusionmodel_tpu.models.ncsn1d import (
    NCSN1D as JNCSN1D)
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2 as JNCSNv2)
from inverseproblemwithdiffusionmodel_tpu_torch.examples import _common
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsn1d import NCSN1D
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.utils import (
    artifacts, flax_msgpack as fm)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    seeded_weights)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIORS = {
    "cine_spatial": "artifacts/cine_priors_128/spatial.msgpack",
    "cine_temporal": "artifacts/cine_priors_128/temporal.msgpack",
    "continuous_ncsnpp": "artifacts/continuous_demo/ncsnpp.msgpack",
}
FWD_RTOL = 1e-5


def _path(rel):
    return os.path.join(ROOT, rel)


def _assert_same(port, ref, where="root"):
    """port (the reader's tree) equals ref (flax's) bit for bit."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), where
        for key in ref:
            _assert_same(port[key], ref[key], f"{where}.{key}")
    elif isinstance(ref, np.ndarray) and ref.dtype == ml_dtypes.bfloat16:
        assert isinstance(port, torch.Tensor), where
        assert port.dtype == torch.bfloat16 and tuple(port.shape) == \
            ref.shape, where
        assert port.view(torch.int16).numpy().tobytes() == ref.tobytes(), \
            where
    elif isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), where
        assert port.dtype == ref.dtype and port.shape == ref.shape, where
        assert port.tobytes() == ref.tobytes(), where
    elif isinstance(ref, np.generic):
        assert type(port) is type(ref) and port.tobytes() == ref.tobytes(), \
            where
    else:
        assert type(port) is type(ref) and port == ref, where


def _seeded_tree(seed):
    rng = np.random.RandomState(seed)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "nested": {
            "f16": rng.randn(5).astype(np.float16),
            "bf16": rng.randn(2, 3).astype(ml_dtypes.bfloat16),
            "i8": rng.randint(-128, 128, (7,)).astype(np.int8),
            "i32": rng.randint(-2 ** 31, 2 ** 31 - 1, (2, 2)).astype(
                np.int32),
            "i64": rng.randint(-2 ** 40, 2 ** 40, (3,)).astype(np.int64),
            "bool": rng.rand(4) > 0.5,
            "c64": (rng.randn(3) + 1j * rng.randn(3)).astype(np.complex64),
            "zero_d": np.array(rng.randn(), np.float32),
            "empty": np.zeros((0, 3), np.float32),
            "scalar_np": np.float32(rng.randn()),
            "scalar_i64": np.int64(-7),
        },
        "py": {"int": 5, "neg": -300, "big": 2 ** 40, "float": 0.25,
               "str": "step", "none": None, "true": True, "complex": 1 - 2j,
               "list": [1, 2.5, "x"]},
        "wide": {str(i): np.float32(i) for i in range(20)},
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_reader_and_writer_equal_flax_on_seeded_trees(seed):
    tree = _seeded_tree(seed)
    blob = serialization.msgpack_serialize(tree)
    port = fm.restore(blob)
    _assert_same(port, serialization.msgpack_restore(blob))
    assert fm.write(port) == blob


@pytest.mark.parametrize("chunk", [8, 64])
def test_chunked_leaves(monkeypatch, chunk):
    """Leaves over MAX_CHUNK_SIZE bytes are chunked as Flax chunks them
    (a small limit, as flax's own tests patch it)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(5, 7).astype(np.float32),
            "b": {"c": rng.randn(33).astype(ml_dtypes.bfloat16),
                  "d": rng.randn(2).astype(np.float32)},
            "e": np.arange(40, dtype=np.int8)}
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    port = fm.restore(blob)
    _assert_same(port, serialization.msgpack_restore(blob))
    assert fm.write(port) == blob
    root = rng.randn(30).astype(np.float32)        # a chunked root
    blob = serialization.msgpack_serialize(root)
    np.testing.assert_array_equal(fm.restore(blob), root)
    assert fm.write(root) == blob


@pytest.mark.parametrize("name", sorted(PRIORS))
def test_committed_priors_read_bit_for_bit(name):
    blob = open(_path(PRIORS[name]), "rb").read()
    port = fm.restore(blob)
    _assert_same(port, serialization.msgpack_restore(blob))
    assert fm.write(port) == blob
    assert fm.count_leaves(port) == {"cine_spatial": 153,
                                     "cine_temporal": 153,
                                     "continuous_ncsnpp": 293}[name]


def _jax_cfg(channels, size, ngf):
    return JConfig({"data": {"channels": channels, "image_size": size,
                             "logit_transform": False, "rescaled": False},
                    "model": {"ngf": ngf, "nonlinearity": "elu",
                              "normalization": "InstanceNorm++"}})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_save_prior_reads_back_in_jax(tmp_path):
    """A port net saved by save_prior (float32 and bfloat16) restores into
    the JAX net's params by serialization.from_bytes, leaf for leaf."""
    model = seeded_weights(NCSNv2(_common.ncsn_config(1, 16, 8)), 0)
    jmod = JNCSNv2(config=_jax_cfg(1, 16, 8))
    template = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)),
                         jnp.ones((1,)))["params"]
    expected = artifacts.prior_tree(model)
    for dtype in (None, "bfloat16"):
        path = str(tmp_path / f"p_{dtype}.msgpack")
        artifacts.save_prior(model, path, dtype)
        restored = serialization.from_bytes(template, open(path, "rb").read())
        flat_r = jax.tree_util.tree_leaves_with_path(restored)
        assert len(flat_r) == len(jax.tree_util.tree_leaves(template))
        for keypath, leaf in flat_r:
            node = expected
            for k in keypath:
                node = node[k.key]
            want = np.asarray(node, np.float32)
            if dtype == "bfloat16":
                want = want.astype(ml_dtypes.bfloat16)
            assert np.asarray(leaf).dtype == want.dtype
            np.testing.assert_array_equal(np.asarray(leaf), want)
        # and back into the port, bit for bit
        again = seeded_weights(NCSNv2(_common.ncsn_config(1, 16, 8)), 1)
        artifacts.load_prior(path, again)
        for (k, a), b in zip(again.state_dict().items(),
                             model.state_dict().values()):
            want = b if dtype is None else b.to(torch.bfloat16).float()
            assert torch.equal(a, want), k


def test_cine_priors_forward_equals_jax():
    """The committed cine priors: the port's NCSNv2 (ngf 64, 128²) and
    NCSN1D (ngf 128, T = 24, 64 channels) loaded by load_prior against the
    JAX nets with the same params, batch 2, rel L2 <= 1e-5."""
    rng = np.random.RandomState(0)
    for rel, channels, size, ngf, port_cls, jax_cls, x_shape in (
            (PRIORS["cine_spatial"], 1, 128, 64, NCSNv2, JNCSNv2,
             (2, 128, 128, 1)),
            (PRIORS["cine_temporal"], 64, 24, 128, NCSN1D, JNCSN1D,
             (2, 24, 64))):
        params = serialization.msgpack_restore(open(_path(rel), "rb").read())
        jmod = jax_cls(_jax_cfg(channels, size, ngf))
        x = rng.rand(*x_shape).astype(np.float32)
        sig = np.array([3.0, 0.2], np.float32)
        ref = np.asarray(jax.jit(jmod.apply)({"params": params}, x, sig))
        model = port_cls(_common.ncsn_config(channels, size, ngf))
        artifacts.load_prior(_path(rel), model)
        with torch.no_grad():
            out = model(torch.from_numpy(x).movedim(-1, 1).contiguous(),
                        torch.from_numpy(sig)).movedim(1, -1).numpy()
        assert _rel(out, ref) <= FWD_RTOL, (rel, _rel(out, ref))


def test_read_train_state(tmp_path):
    """A JAX examples' train_state.ckpt ({step, state}) reads as step,
    params and EMA params."""
    rng = np.random.RandomState(0)
    params = {"conv": {"kernel": rng.randn(3, 3, 1, 2).astype(np.float32)}}
    ema = {"conv": {"kernel": rng.randn(3, 3, 1, 2).astype(np.float32)}}
    blob = serialization.msgpack_serialize(
        {"step": 120, "state": {"step": np.array(120, np.int32),
                                "params": params,
                                "opt_state": {"0": {"count": np.int32(3)}},
                                "ema": {"params": ema}}})
    path = tmp_path / "train_state.ckpt"
    path.write_bytes(blob)
    got = artifacts.read_train_state(str(path))
    assert got["step"] == 120
    np.testing.assert_array_equal(got["params"]["conv"]["kernel"],
                                  params["conv"]["kernel"])
    np.testing.assert_array_equal(got["ema"]["conv"]["kernel"],
                                  ema["conv"]["kernel"])


@pytest.mark.slow
def test_acdc_prior_reads_bit_for_bit():
    """The 188 MB bfloat16 ACDC prior (slow: about 20 s of reading)."""
    for name in ("ema_bf16.msgpack", "raw_bf16.msgpack"):
        blob = open(_path(f"artifacts/acdc_prior/{name}"), "rb").read()
        port = fm.restore(blob)
        _assert_same(port, serialization.msgpack_restore(blob))
        assert fm.write(port) == blob
