"""K5 (ops/int8_kernels.absmax) and what it feeds, on the CPU: the port's
plain int8 chain against the JAX package's on inputs that hold a NaN, a
+inf or a -inf, and K5's host plan (`absmax_plan`) with a numpy emulation
of the kernel's partition and reduction (csrc/int8conv.cu absmax_kernel).

JAX's `quantize_per_tensor` (ops/quant.py) takes jnp.max(jnp.abs(x)) and
jnp.maximum(amax, 1e-12), which both keep a NaN; its int8 convolution's
output is then NaN everywhere (every code 0, times a NaN or inf scale).
The port's plain chain (absmax_plain -> quantize_s8_plain ->
conv_s8s8s32_plain, and quant.int8_conv on the CPU) must do the same; on
the card tests/test_torch_int8_kernels.py holds K5-K7 to that chain.

The plan is held at every K5 input of one NCSNv2Deepest forward at batch
32 and one NCSN1D forward at 2,048 tubes (the sites of
tests/test_torch_int8_plan.py), at tiny sizes and at pointer offsets of 2,
4 and 8 bytes: every element is read exactly once (head, the body's
interleaved 16-byte vectors, tail), the grid is one wave, and the emulated
partial maxima, reduced as the kernel reduces them (an integer max of magnitude
bits, per thread, per block, then across blocks), equal absmax_plain bit
for bit, NaN included.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.models import layers as jlayers
from inverseproblemwithdiffusionmodel_tpu.ops import quant as jquant
from inverseproblemwithdiffusionmodel_tpu_torch.ops import (
    int8_kernels as ik, quant)
from tests.test_torch_int8_kernels import CASES
from tests.test_torch_int8_plan import NCSN1D_SITES, NCSNV2_SITES

torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# a 2-D geometry (3x3, 40 -> 16 channels) and a 1-D one (64 -> 32), from
# the kernels' own CASES
CHAIN_CASES = {"2d": CASES[0], "1d": CASES[7]}
KINDS = {"nan": [np.nan], "+inf": [np.inf], "-inf": [-np.inf],
         "inf_and_nan": [np.inf, np.nan, -np.inf]}


def _chain_inputs(case, kind, seed=0):
    """x (N, C, *spatial) and w (O, C, *k) from a seeded numpy generator,
    with KINDS[kind] written at seeded positions of x."""
    N, C, spatial, O, k, dil, pre, ndim = case
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, C) + spatial) * 3).astype(np.float32)
    w = (rng.standard_normal((O, C) + (k,) * ndim)
         / np.sqrt(C * k ** ndim)).astype(np.float32)
    at = rng.choice(x.size, size=len(KINDS[kind]), replace=False)
    x.flat[at] = KINDS[kind]
    return x, w


def _jax_chain(x, w, case, jdt):
    """JAX's amax (ops/quant.py:96's expression), its quantize_per_tensor
    scale and codes (channels last), and its int8_conv output (channels
    first, float32)."""
    N, C, spatial, O, k, dil, pre, ndim = case
    jx = jnp.asarray(np.moveaxis(x, 1, -1), jdt)
    amax = jnp.max(jnp.abs(jx.astype(jnp.float32)))
    q, scale = jquant.quantize_per_tensor(jx)
    pad = (k // 2) * dil
    pads = [(pad + (pre or (0, 0))[0], pad + (pre or (0, 0))[1])] * ndim
    jw = jnp.asarray(np.transpose(w, tuple(range(2, 2 + ndim)) + (1, 0)), jdt)
    out = jquant.int8_conv(jx, jw, window_strides=(1,) * ndim, padding=pads,
                           rhs_dilation=(dil,) * ndim,
                           dimension_numbers=jlayers._dim_numbers(ndim))
    return (np.float32(amax), np.float32(scale), np.asarray(q),
            np.moveaxis(np.asarray(out.astype(jnp.float32)), -1, 1))


def _same_float(a, b):
    a, b = np.float32(a), np.float32(b)
    return (np.isnan(a) and np.isnan(b)) or a == b


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("geom", sorted(CHAIN_CASES))
def test_plain_chain_is_jax_on_non_finite_inputs(geom, kind, dtype):
    """amax and scale equal JAX's (NaN equal to NaN), the codes too (all
    0), and the output is non-finite, and NaN, exactly where JAX's is:
    everywhere."""
    case = CHAIN_CASES[geom]
    N, C, spatial, O, k, dil, pre, ndim = case
    x, w = _chain_inputs(case, kind)
    tdt, jdt = DTYPES[dtype]
    j_amax, j_scale, j_q, j_out = _jax_chain(x, w, case, jdt)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    qw = quant.QuantWeight.of(wt)
    g = quant.geometry(xt, qw, (k // 2) * dil, dil, ndim, pre)
    amax = ik.absmax_plain(xt)
    codes, scale = ik.quantize_s8_plain(xt, amax, g.Cp)
    out = ik.conv_s8s8s32_plain(codes.reshape(g.N, g.H, g.W, g.Cp), scale,
                                qw.kernel, qw.scale, g, tdt)
    out = out.reshape(out.shape[:2] + out.shape[4 - ndim:]).float().numpy()
    assert _same_float(amax.item(), j_amax)
    assert _same_float(scale.item(), j_scale)
    np.testing.assert_array_equal(codes[..., :C].numpy(), j_q)
    assert not codes.any()
    assert out.shape == j_out.shape
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(j_out))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(j_out))
    assert np.isnan(j_out).all()
    if kind != "nan":
        assert np.isnan(j_amax) == (kind == "inf_and_nan")
    # the whole op on the CPU, as a layer calls it
    whole = quant.int8_conv(xt, wt, padding=(k // 2) * dil, dilation=dil,
                            ndim=ndim, pre_pad=pre).float().numpy()
    np.testing.assert_array_equal(np.isnan(whole), np.isnan(j_out))


# -- K5's plan --------------------------------------------------------------

SM_COUNTS = (132, 114)          # H100 SXM, H100 PCIe
SITE_SIZES = sorted({b * math.prod(s[0]) for b, sites in (
    (32, NCSNV2_SITES), (2048, NCSN1D_SITES)) for s in sites})
TINY = (1, 2, 3, 5, 7, 8, 9, 15, 17, 100, 1001, 4099)
OFFSETS = {"f32": (0, 4, 8, 12), "bf16": (0, 2, 4, 8, 14)}
TDTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pieces(plan, n, size):
    """The element ranges K5 reads, as (kind, start, end): the head and the
    tail (block 0's threads 0, 1, ...) and the body, whose 16-byte vectors
    the grid's threads interleave (`_owner`)."""
    end = plan.head + plan.body_bytes // size
    out = [("head", 0, plan.head), ("body", plan.head, end),
           ("tail", end, end + plan.tail)]
    assert end + plan.tail == n
    return [p for p in out if p[2] > p[1]]


def _owner(plan, vectors):
    """(block, thread, round) of each body vector: global thread g reads
    vectors g, g + G, ... (G = blocks x K5_THREADS), K5_UNROLL of them a
    round."""
    i = np.arange(vectors)
    g = i % (plan.blocks * ik.K5_THREADS)
    return (g // ik.K5_THREADS, g % ik.K5_THREADS,
            i // (plan.blocks * ik.K5_THREADS * ik.K5_UNROLL))


def _check_plan(plan, n, dtype, offset, sm_count):
    size = torch.finfo(dtype).bits // 8
    per_sm = ik.K5_BLOCKS_PER_SM
    assert 0 <= plan.head < 16 // size and 0 <= plan.tail < 16 // size
    assert plan.body_bytes % 16 == 0
    if plan.body_bytes:     # the vectors start on a 16-byte boundary
        assert (offset + plan.head * size) % 16 == 0
    # one wave: no more blocks than the SMs hold at once (the kernel's
    # launch bounds: 8 blocks of 256 threads, 2,048 threads an SM)
    assert 1 <= plan.blocks <= sm_count * per_sm
    assert per_sm * ik.K5_THREADS <= 2048
    assert plan.scratch_words == plan.blocks + 1
    # enough blocks for one round of loads each, up to the wave
    vectors = plan.body_bytes // 16
    rounds = -(-vectors // (plan.blocks * ik.K5_THREADS * ik.K5_UNROLL))
    assert rounds <= 1 or plan.blocks == sm_count * per_sm
    if plan.blocks > 1:     # and no block without a load
        assert (plan.blocks - 1) * ik.K5_THREADS < vectors
    pieces = _pieces(plan, n, size)
    spans = sorted((a, b) for _, a, b in pieces)
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
    return pieces


@pytest.mark.parametrize("sm_count", SM_COUNTS)
@pytest.mark.parametrize("dtype", sorted(TDTYPE))
def test_plan_covers_every_site_once_in_one_wave(dtype, sm_count):
    """Every K5 input of both forwards, at the allocator's alignment and at
    each misaligned offset: the head, the body and the tail tile x, and
    every input of 16 MB or more fills the wave."""
    wave = sm_count * ik.K5_BLOCKS_PER_SM
    for n in SITE_SIZES:
        for offset in OFFSETS[dtype]:
            plan = ik.absmax_plan(n, TDTYPE[dtype], offset, sm_count)
            _check_plan(plan, n, TDTYPE[dtype], offset, sm_count)
            if plan.body_bytes >= wave * ik.K5_THREADS * ik.K5_UNROLL * 16:
                assert plan.blocks == wave


def _magnitude_bits(x: torch.Tensor) -> np.ndarray:
    """|x| as the kernel's integers: float32 bits with the sign cleared,
    bf16's 16 bits with the sign cleared."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16) & 0x7FFF
    return x.view(torch.int32).numpy().view(np.uint32) & 0x7FFFFFFF


def emulate_absmax(x: torch.Tensor, plan) -> np.ndarray:
    """K5's result bits for a 1-D x under `plan`: each thread's running
    max (bf16 words as two 16-bit halves, joined per half), the block's
    max of its threads' finished values, then the max over blocks; every
    element read once (asserted)."""
    bits = _magnitude_bits(x).astype(np.uint32)
    n, size = x.numel(), x.element_size()
    bf16 = x.dtype == torch.bfloat16
    seen = np.zeros(n, np.int64)
    acc = np.zeros((plan.blocks, ik.K5_THREADS, 2), np.uint32)
    for kind, e0, e1 in _pieces(plan, n, size):
        seen[e0:e1] += 1
        if kind != "body":     # block 0's thread t takes element t
            np.maximum.at(acc[0, :, 0], np.arange(e1 - e0), bits[e0:e1])
            continue
        rows = bits[e0:e1].reshape(-1, 16 // size)   # one 16-byte vector
        blk, t, _ = _owner(plan, len(rows))          # a row
        if bf16:     # element 2j in a word's low half, 2j + 1 in its high
            np.maximum.at(acc[..., 0], (blk, t), rows[:, 0::2].max(axis=1))
            np.maximum.at(acc[..., 1], (blk, t), rows[:, 1::2].max(axis=1))
        else:
            np.maximum.at(acc[..., 0], (blk, t), rows.max(axis=1))
    assert (seen == 1).all()
    done = (np.maximum(acc[..., 0], acc[..., 1]) << 16) if bf16 \
        else acc[..., 0]
    return done.max(axis=1).max()    # blocks' partials, then across


def _values(n, dtype, seed, poison=None):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(n) * 2).astype(np.float32))
    if poison is not None:
        x[poison[0]] = poison[1]
    return x.to(TDTYPE[dtype])


def _assert_emulation_is_plain(x, plan):
    got = np.array([emulate_absmax(x, plan)], np.uint32).view(np.float32)[0]
    ref = ik.absmax_plain(x).item()
    if math.isnan(ref):
        assert np.isnan(got)
    else:
        assert got.view(np.uint32) == np.float32(ref).view(np.uint32)


@pytest.mark.parametrize("dtype", sorted(TDTYPE))
@pytest.mark.parametrize("n", TINY)
def test_tiny_inputs_at_every_offset(n, dtype):
    """n below one 16-byte vector, n = 1, n not a multiple of 8: the head,
    body and tail at each offset, the largest value and a NaN in each of
    them in turn."""
    for offset in OFFSETS[dtype]:
        plan = ik.absmax_plan(n, TDTYPE[dtype], offset, SM_COUNTS[0])
        _check_plan(plan, n, TDTYPE[dtype], offset, SM_COUNTS[0])
        for at in sorted({0, n // 2, n - 1}):
            for value in (1e3, -1e3, np.nan, np.inf):
                x = _values(n, dtype, seed=n + offset, poison=(at, value))
                _assert_emulation_is_plain(x, plan)


# (elements, SMs of the card): several blocks and several rounds of loads
# a thread, the last round short, in waves of 8 to 24 blocks
EMULATED = [(300001, 2), (262147, 1), (200003, 1), (600003, 3)]


@pytest.mark.parametrize("dtype", sorted(TDTYPE))
@pytest.mark.parametrize("case", range(len(EMULATED)))
def test_emulated_reduction_is_the_plain_version(case, dtype):
    """Partials reduced as the kernel reduces them equal absmax_plain bit
    for bit, with a NaN, an inf or neither in the last round, the first
    block's first vector, or the tail; at a misaligned offset too."""
    n, sm_count = EMULATED[case]
    for offset in (0, OFFSETS[dtype][1]):
        plan = ik.absmax_plan(n, TDTYPE[dtype], offset, sm_count)
        _check_plan(plan, n, TDTYPE[dtype], offset, sm_count)
        _, _, rounds = _owner(plan, plan.body_bytes // 16)
        assert plan.blocks > 1 and rounds.max() >= 1
        for poison in (None, (n - 1, np.nan), (n // 3, -np.inf),
                       (5, np.nan), (n - 20, 1e4)):
            x = _values(n, dtype, seed=case, poison=poison)
            _assert_emulation_is_plain(x, plan)


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="no plan"):
        ik.absmax_plan(0, torch.float32, 0, 132)
    with pytest.raises(ValueError, match="no plan"):
        ik.absmax_plan(10, torch.float32, 2, 132)   # not a float32 boundary
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ik.absmax_plan(10, torch.float16, 0, 132)
    with pytest.raises(ValueError, match="no plan"):
        ik.absmax_plan(10, torch.bfloat16, 16, 132)  # past the boundary
    args = ik.absmax_launch_args(ik.absmax_plan(10, torch.float32, 0, 132))
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import _build
    # x, amax, scratch, the plan's integers, the scratch's words, stream
    assert len(args) == len(_build._ARGTYPES["int8_absmax_f32"]) - 5
