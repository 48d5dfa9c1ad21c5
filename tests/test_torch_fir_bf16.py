"""The bf16 forms of the port's FIR resampling (ops/fir_kernels.py) against
the float32 result and against the JAX package's bf16 Pallas kernels
(interpret mode) and dispatchers.

The plain versions compute a bf16 input the way the bf16 CUDA kernels do:
upcast, both axes in float32, one rounding to bf16. The CUDA kernels are
held against them on the card by the `gpu` test at the end and by
chip_smoke.py. Tolerances, in bf16 ulps of the largest |value| of the
reference (ulp(v) = 2^(floor(log2 |v|) - 7)):
- against JAX's float32 Pallas kernel on the same (bf16-valued) input,
  rounded once: 1 ulp (the two sides agree up to float32 rounding before
  the one bf16 rounding, which can then land one ulp apart);
- against JAX's bf16 kernels and dispatchers: 2 ulps. JAX's Pallas kernel
  filters in bf16 (its taps are weakly typed Python floats), so it rounds
  the H-filtered rows as well as the output, and an output can land two
  ulps of the largest value from the port's; its dispatcher's backward is
  the linear transpose of an XLA bf16 convolution. Measured at these
  shapes over the three tap sets: forward up to 1.56e-2 up (largest
  |value| 1.8 to 3.2, one ulp there 7.8e-3 or 1.56e-2) and 7.8e-3 down
  (largest |value| 0.85 to 1.9, 3.9e-3 or 7.8e-3), two ulps once (down,
  taps (1, 3, 3, 1), (1, 12, 8, 24)); the ROADMAP's 7.8e-3 up / 3.9e-3
  down were one ulp at its shape. Backward 0 at every case here.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import inverseproblemwithdiffusionmodel_tpu.ops.pallas_kernels as pk
from inverseproblemwithdiffusionmodel_tpu_torch.ops import fir_kernels as fk

torch.set_num_threads(1)

KERNELS = [(1, 3, 3, 1), (1, 2, 1), (1, 1)]
SHAPES = [(2, 8, 8, 3), (2, 8, 6, 16), (1, 12, 8, 24)]   # C = 3 and 8 k
OPS = {"up": (fk.upsample2x, fk.upsample2x_plain, pk.upsample2x_pallas,
              pk.fir_upsample_2x, 2.0),
       "down": (fk.downsample2x, fk.downsample2x_plain,
                pk.downsample2x_pallas, pk.fir_downsample_2x, 1.0)}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _x(shape, seed=0):
    """A bf16 input, and the same values in float32."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(
        np.float32)).bfloat16()
    return x, x.float().numpy()


def ulp(ref) -> float:
    """One bf16 ulp of the largest |value| of ref."""
    top = float(np.abs(np.asarray(ref, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_within_ulp(out: torch.Tensor, ref, ulps: int = 1) -> None:
    assert out.dtype == torch.bfloat16
    ref = _f32(ref)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= ulps * ulp(ref), (err, ulp(ref))


@pytest.mark.parametrize("op", ["up", "down"])
@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_plain_is_the_f32_result_rounded_once(op, k, shape):
    wrapper, plain, pallas, _, gain = OPS[op]
    x, x32 = _x(shape)
    out = wrapper(x, k)
    assert torch.equal(out, plain(x, fk._sep_kernel_1d(k, gain)))
    ref32 = pallas(jnp.asarray(x32), k)
    _assert_within_ulp(out, jnp.asarray(ref32).astype(jnp.bfloat16))


@pytest.mark.parametrize("op", ["up", "down"])
@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_matches_jax_bf16_kernel_and_dispatcher(op, k, shape):
    wrapper, _, pallas, dispatcher, _ = OPS[op]
    x, x32 = _x(shape)
    xb = jnp.asarray(x32, jnp.bfloat16)
    out = wrapper(x, k)
    for ref in (pallas(xb, k), dispatcher(xb, k)):
        assert ref.dtype == jnp.bfloat16
        _assert_within_ulp(out, ref, ulps=2)


@pytest.mark.parametrize("op", ["up", "down"])
@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_gradients_match_jax_grad_of_the_dispatchers(op, k, shape):
    # the backward of up is the down pass on reversed taps and the reverse,
    # in the cotangent's dtype (bf16)
    wrapper, _, _, dispatcher, _ = OPS[op]
    x, x32 = _x(shape)
    xg = x.clone().requires_grad_()
    y = wrapper(xg, k)
    g = torch.from_numpy(np.random.RandomState(1).randn(*y.shape).astype(
        np.float32)).bfloat16()
    (gx,) = torch.autograd.grad(y, xg, g)
    gb = jnp.asarray(g.float().numpy(), jnp.bfloat16)
    ref = jax.grad(lambda v: jnp.sum(
        (dispatcher(v, k) * gb).astype(jnp.float32)))(
            jnp.asarray(x32, jnp.bfloat16))
    _assert_within_ulp(gx, ref, ulps=2)


def test_bf16_backward_counts_its_kernels_under_bf16_tags(monkeypatch):
    # what the card counts, read through the launch wrappers' callers: a
    # bf16 up pass and its backward reach `_up` and `_down` with bf16
    # tensors and their float32 tags, to which `_launch` appends ".bf16"
    seen = []
    orig_up, orig_down = fk._up, fk._down
    monkeypatch.setattr(fk, "_up", lambda x, t, tag: (
        seen.append((tag, x.dtype)), orig_up(x, t, tag))[1])
    monkeypatch.setattr(fk, "_down", lambda x, t, tag: (
        seen.append((tag, x.dtype)), orig_down(x, t, tag))[1])
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16, requires_grad=True)
    fk.upsample2x(x).sum().backward()
    assert seen == [("up2x", torch.bfloat16),
                    ("down2x.bwd", torch.bfloat16)]
    assert x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("name", ["up2x", "down2x"])
def test_kernel_launch_refuses_other_dtypes(dtype, name):
    # the launch path raises before it touches the card; nothing is cast
    x = torch.zeros(1, 4, 4, 8, dtype=dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fk._launch(name, x, torch.empty_like(x),
                   fk._sep_kernel_1d(None, 1.0), name)


@pytest.mark.gpu
def test_cuda_bf16_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator().manual_seed(0)
    for shape in [(2, 16, 16, 3), (2, 16, 12, 16), (1, 32, 32, 128),
                  (3, 10, 6, 12)]:
        x = torch.randn(*shape, generator=gen).cuda().bfloat16()
        for k in KERNELS:
            fk.LAUNCHES.clear()
            for op in ("up", "down"):
                wrapper, plain, _, _, gain = OPS[op]
                out = wrapper(x, k)
                ref = plain(x, fk._sep_kernel_1d(k, gain))
                err = (out.float() - ref.float()).abs().max().item()
                assert out.dtype == torch.bfloat16
                assert err <= ulp(ref.float().cpu().numpy())
            assert fk.LAUNCHES == {"up2x.bf16": 1, "down2x.bf16": 1}
