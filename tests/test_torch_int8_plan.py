"""K7's host-side plan (ops/int8_kernels.conv_plan) and a plain emulation
of the loads it describes, in the port alone (no jax).

The plan is checked at every convolution geometry of one NCSNv2Deepest
forward (ACDC, 256 px, ngf 128, batch 32: 19 geometries, 113 calls) and of
one NCSN1D forward (CINE127_1D, ngf 128, 2,048 tubes: 10 geometries, 75
calls), each built with quant.geometry from shapes alone. The emulation
follows csrc/int8conv.cu's producer: per stage, STAGE_K / cb box pairs, A
by a TMA im2col load (the pixel box from `lower` to (W - 1, H - 1) +
`upper`, traversed w, then h, then n, each pixel at its tap's im2col
offset, zeros outside the image and past the last image), B by a tiled
load of the (O, KH KW Cp) weight codes (zeros past O and past K). Its A
tiles are held element for element against F.unfold of the same codes,
and its products, summed over the K loop, against the plain convolution.
On the card, tests/test_torch_int8_kernels.py holds the kernel itself to
the plain version.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from inverseproblemwithdiffusionmodel_tpu_torch.ops import (
    _build, int8_kernels as ik, quant)

torch.set_num_threads(1)

# (input shape without the batch, weight shape, padding, dilation, calls)
# of every distinct convolution of one forward, at batch 32 and 2,048
NCSNV2_SITES = [
    ((1, 256, 256), (128, 1, 3, 3), 1, 1, 1),
    ((128, 256, 256), (128, 128, 3, 3), 1, 1, 18),
    ((128, 256, 256), (256, 128, 3, 3), 1, 1, 1),
    ((128, 256, 256), (256, 128, 1, 1), 0, 1, 1),
    ((256, 128, 128), (256, 256, 3, 3), 1, 1, 8),
    ((256, 128, 128), (256, 256, 1, 1), 0, 1, 1),
    ((256, 64, 64), (256, 256, 3, 3), 1, 1, 17),
    ((256, 64, 64), (256, 256, 1, 1), 0, 1, 1),
    ((256, 32, 32), (256, 256, 3, 3), 1, 1, 25),
    ((256, 32, 32), (256, 256, 3, 3), 2, 2, 1),
    ((256, 32, 32), (512, 256, 3, 3), 2, 2, 2),
    ((512, 32, 32), (512, 512, 3, 3), 2, 2, 2),
    ((512, 32, 32), (512, 512, 3, 3), 4, 4, 5),
    ((512, 32, 32), (512, 512, 3, 3), 1, 1, 16),
    ((512, 32, 32), (256, 512, 3, 3), 1, 1, 2),
    ((256, 128, 128), (128, 256, 3, 3), 1, 1, 1),
    ((256, 64, 64), (128, 256, 3, 3), 1, 1, 1),
    ((128, 128, 128), (128, 128, 3, 3), 1, 1, 9),
    ((128, 256, 256), (1, 128, 3, 3), 1, 1, 1)]
NCSN1D_SITES = [
    ((64, 24), (128, 64, 3), 1, 1, 1),
    ((128, 24), (128, 128, 3), 1, 1, 18),
    ((128, 24), (256, 128, 3), 1, 1, 1),
    ((128, 24), (256, 128, 1), 0, 1, 1),
    ((256, 12), (256, 256, 3), 1, 1, 32),
    ((256, 12), (256, 256, 3), 2, 2, 5),
    ((256, 12), (256, 256, 3), 4, 4, 5),
    ((256, 12), (128, 256, 3), 1, 1, 2),
    ((128, 12), (128, 128, 3), 1, 1, 9),
    ((128, 24), (64, 128, 3), 1, 1, 1)]
SITES = ([(32, s) for s in NCSNV2_SITES]
         + [(2048, s) for s in NCSN1D_SITES])


def _geometry(batch, site, pre_pad=None):
    shape, wshape, padding, dilation, _ = site
    ndim = len(shape) - 1
    x = torch.empty((batch,) + shape, device="meta")
    qw = quant.QuantWeight(torch.empty(wshape, dtype=torch.int8,
                                       device="meta"), None, None)
    return quant.geometry(x, qw, padding, dilation, ndim, pre_pad)


def test_the_sites_are_one_forward_each():
    assert len(NCSNV2_SITES) == 19
    assert sum(s[-1] for s in NCSNV2_SITES) == 113
    assert len(NCSN1D_SITES) == 10
    assert sum(s[-1] for s in NCSN1D_SITES) == 75


@pytest.mark.parametrize("batch,site", SITES,
                         ids=[f"{b}-{s[0]}-{s[1][0]}-k{s[1][-1]}-d{s[3]}"
                              for b, s in SITES])
def test_plan_at_every_net_geometry(batch, site):
    """The instance, swizzle, corners, offsets, K stages and shared memory
    the host plans for each convolution of the two nets, and the launch
    arguments that carry the plan to the C launcher."""
    g = _geometry(batch, site)
    plan = ik.conv_plan(g)
    O = g.O
    assert plan.bn == {1: 8, 64: 64, 128: 128, 256: 256, 512: 256}[O]
    assert plan.o_tiles == -(-O // plan.bn)
    assert plan.cb == {1: 32, 64: 64}.get(g.C, 128)   # and its swizzle
    assert g.Cp == max(32, g.C)
    # the pixel box: output pixel (ho, wo) starts at (wo - pad, ho - pad)
    # and spans Wo x Ho positions
    assert plan.lower == (-g.pad_w, -g.pad_h)
    assert g.W - plan.lower[0] + plan.upper[0] == g.Wo == g.W
    assert g.H - plan.lower[1] + plan.upper[1] == g.Ho == g.H
    assert all(-128 <= v <= 127 for v in plan.lower + plan.upper)
    # K: box pairs of cb channels, four 32-byte wgmma steps a stage
    assert plan.chunks == g.KH * g.KW * g.Cp // plan.cb
    assert plan.k_iters == -(-g.KH * g.KW * g.Cp // ik.STAGE_K)
    # the producer's walk over the plan's stages: every (tap, channel
    # block) once, tap-major, at the tap's im2col offset (within 8 bits),
    # then spare pairs past K
    pairs = [p for it in range(plan.k_iters)
             for p in stage_pairs(g, plan, it)]
    K = g.KH * g.KW * g.Cp
    real = [p for p in pairs if p[2] < K]
    assert [p[2] for p in real] == list(range(0, K, plan.cb))
    assert [p[1] for p in real] == [(kx * g.dil, ky * g.dil)
                                    for ky in range(g.KH)
                                    for kx in range(g.KW)
                                    for _ in range(g.Cp // plan.cb)]
    assert max(max(p[1]) for p in real) <= ik.IM2COL_OFFSET_MAX
    assert len(pairs) - len(real) < ik.STAGE_K // plan.cb
    assert plan.m_tiles == -(-g.N * g.Ho * g.Wo // ik.BM)
    # the ring: 3 to 6 stages, two blocks an SM below bn 256
    assert plan.stage_bytes == -(-(ik.BM + plan.bn) * ik.STAGE_K
                                 // 1024) * 1024
    assert 3 <= plan.stages <= ik.MAX_STAGES
    assert plan.blocks_per_sm == (1 if plan.bn == 256 else 2)
    budget = ik.SMEM_ONE_BLOCK if plan.blocks_per_sm == 1 else \
        ik.SMEM_TWO_BLOCKS
    assert plan.smem_bytes <= budget
    assert plan.smem_bytes >= ik.SMEM_HEAD + plan.stages * plan.stage_bytes
    assert plan.smem_bytes >= ik.SMEM_HEAD + plan.bn * (ik.BM + 4) * 4
    # the epilogue's runs: 16 bytes of bf16 but where Ho Wo is 12
    assert plan.run == (4 if g.Ho * g.Wo == 12 else 8)
    # what the wrapper hands the C launcher after its six pointers
    for dtype, width in ((torch.bfloat16, 8), (torch.float32, 4)):
        args = ik.conv_launch_args(g, dtype)
        assert len(args) == len(_build._ARGTYPES["int8_conv_bf16"]) - 7
        assert args == (g.N, g.H, g.W, g.Cp, g.O, g.KH, g.KW, g.dil, g.Ho,
                        g.Wo, plan.bn, plan.cb, plan.chunks, plan.k_iters,
                        plan.stages, plan.blocks_per_sm, plan.stage_bytes,
                        plan.m_tiles, plan.o_tiles, min(plan.run, width),
                        *plan.lower, *plan.upper, plan.smem_bytes)


def test_plans_of_the_main_geometries():
    """The 3x3, 128-channel convolution at 256 px (18 of the 113 calls):
    128 x 128 tiles, 9 stages of one tap each, 3 in the ring; the first
    convolution (Cp 32): 4 taps a stage, the last stage's spare pairs
    zero; the end convolution (O 1): the narrow instance."""
    main = ik.conv_plan(_geometry(32, NCSNV2_SITES[1]))
    assert (main.bn, main.cb, main.chunks, main.k_iters, main.stages,
            main.m_tiles, main.smem_bytes) == (128, 128, 9, 9, 3, 16384,
                                               101376)
    first = ik.conv_plan(_geometry(32, NCSNV2_SITES[0]))
    assert (first.bn, first.cb, first.chunks, first.k_iters) == (128, 32, 9,
                                                                  3)
    end = ik.conv_plan(_geometry(32, NCSNV2_SITES[-1]))
    assert (end.bn, end.stages, end.o_tiles) == (8, 6, 1)
    wide = ik.conv_plan(_geometry(32, NCSNV2_SITES[12]))
    assert (wide.bn, wide.o_tiles, wide.stages, wide.lower,
            wide.upper) == (256, 2, 4, (-4, -4), (-4, -4))


def test_geometries_the_maps_cannot_take_are_refused():
    """A pixel box corner outside a rank-4 map's range [-128, 127] (a
    padding past 128, or a dilated kernel's far corner), or an im2col
    offset past 255 with every corner in range, raises
    NotImplementedError naming the geometry, on the plan; int8_conv then
    takes the unfold path instead (ops/quant.int8_conv_unfold), whose K5
    wrapper refuses a tensor on neither the CPU nor a card, before any
    kernel."""
    site = ((16, 40, 40), (16, 16, 3, 3), 200, 1, 1)
    with pytest.raises(NotImplementedError, match="N=2 C=16 .*corners"):
        ik.conv_plan(_geometry(2, site))
    site = ((16, 300, 300), (16, 16, 3, 3), 100, 120, 1)
    with pytest.raises(NotImplementedError, match=r"dil=120: .*\(-140, "):
        ik.conv_plan(_geometry(2, site))
    # corners (-128, -128) both ends, the last tap at offset 256
    site = ((16, 8, 8), (16, 16, 3, 3), 128, 128, 1)
    g = _geometry(2, site)
    assert (g.pad_h, g.pad_h_hi - 2 * g.dil) == (128, -128)
    with pytest.raises(NotImplementedError,
                       match=r"dil=128: im2col offset 256 past 255"):
        ik.conv_plan(g)
    # 1-D: a 5-tap kernel at dilation 64, pads 128 in range
    site = ((16, 20), (16, 16, 5), 128, 64, 1)
    with pytest.raises(NotImplementedError, match="im2col offset 256"):
        ik.conv_plan(_geometry(2, site))
    x = torch.empty(2, 16, 40, 40, device="meta")
    w = torch.ones(16, 16, 3, 3)
    ik.LAUNCHES.clear()
    with pytest.raises(NotImplementedError, match="pixel box corners"):
        ik.conv_plan(quant.geometry(x, quant.QuantWeight.of(w), 200, 1, 2))
    with pytest.raises(ValueError, match="cpu or cuda"):
        quant.int8_conv(x, w, padding=200)
    assert not ik.LAUNCHES
    # the asymmetric pre_pad of the nets' resamplers maps
    plan = ik.conv_plan(_geometry(2, ((16, 8, 8), (16, 16, 3, 3), 1, 1, 1),
                                  pre_pad=(1, 0)))
    assert plan.lower == (-2, -2) and plan.upper == (-1, -1)


# -- the emulation ----------------------------------------------------------

def im2col_box(codes, g, plan, m0, c0, off):
    """The (BM, cb) tile one TMA im2col load delivers: BM pixels of the
    pixel box from output pixel m0 on (w fastest, then h, then the image),
    channels c0 .. c0 + cb of each at offset off = (w, h), zeros outside
    the codes (N, H, W, Cp)."""
    N, H, W, _ = codes.shape
    n, r = divmod(m0, g.Ho * g.Wo)
    ho, wo = divmod(r, g.Wo)
    w, h = wo + plan.lower[0], ho + plan.lower[1]
    w_last, h_last = W - 1 + plan.upper[0], H - 1 + plan.upper[1]
    tile = np.zeros((ik.BM, plan.cb), np.int32)
    for i in range(ik.BM):
        hi, wi = h + off[1], w + off[0]
        if n < N and 0 <= hi < H and 0 <= wi < W:
            tile[i] = codes[n, hi, wi, c0:c0 + plan.cb]
        w += 1
        if w > w_last:
            w, h = plan.lower[0], h + 1
            if h > h_last:
                h, n = plan.lower[1], n + 1
    return tile


def stage_pairs(g, plan, k_iter):
    """(A's channel, A's im2col offset, B's K coordinate) of each box pair
    of stage k_iter, as the producer issues them from the plan's cb and
    chunks."""
    cblocks = g.Cp // plan.cb
    K = g.KH * g.KW * g.Cp
    for j in range(ik.STAGE_K // plan.cb):
        chunk = k_iter * (ik.STAGE_K // plan.cb) + j
        c = chunk if chunk < plan.chunks else 0
        tap, cblk = divmod(c, cblocks)
        ky, kx = divmod(tap, g.KW)
        yield (cblk * plan.cb, (kx * g.dil, ky * g.dil),
               tap * g.Cp + cblk * plan.cb if chunk < plan.chunks else K)


def unfold_rows(codes, g):
    """The implicit GEMM's A (M, KH KW Cp), tap-major, by F.unfold."""
    x = torch.from_numpy(codes).permute(0, 3, 1, 2).double()
    x = F.pad(x, (g.pad_w, g.pad_w_hi, g.pad_h, g.pad_h_hi))
    cols = F.unfold(x, (g.KH, g.KW), dilation=g.dil)   # (N, Cp KH KW, L)
    cols = cols.reshape(g.N, g.Cp, g.KH * g.KW, -1).permute(0, 3, 2, 1)
    return cols.reshape(g.N * g.Ho * g.Wo, -1).round().int().numpy()


# (N, C, spatial, O, kernel size, dilation, pre_pad): dilations 1, 2 and 4,
# an asymmetric pre_pad, 1-D, M not a multiple of 128 (tiles crossing
# images), each channel block width
EMULATED = [(3, 40, (7, 11), 70, 3, 1, None),
            (2, 24, (9, 9), 8, 3, 2, None),
            (2, 130, (8, 8), 9, 3, 4, None),
            (2, 16, (10, 10), 16, 3, 1, (1, 0)),
            (5, 64, (12,), 20, 3, 2, None),
            (7, 33, (13,), 5, 1, 1, None),
            (1, 256, (5, 6), 3, 3, 1, None)]


@pytest.mark.parametrize("case", EMULATED,
                         ids=[str(i) for i in range(len(EMULATED))])
def test_emulated_im2col_equals_unfold_and_the_products_the_plain_conv(case):
    N, C, spatial, O, k, dil, pre = case
    rng = np.random.default_rng(0)
    ndim = len(spatial)
    x = torch.from_numpy(rng.standard_normal((N, C) + spatial)
                         ).float()
    w = torch.from_numpy(rng.standard_normal((O, C) + (k,) * ndim)).float()
    qw = quant.QuantWeight.of(w)
    g = quant.geometry(x, qw, (k // 2) * dil, dil, ndim, pre)
    plan = ik.conv_plan(g)
    codes, sx = ik.quantize_s8(x, ik.absmax(x), g.Cp)
    codes = codes.reshape(g.N, g.H, g.W, g.Cp).numpy().astype(np.int32)
    A = unfold_rows(codes, g)
    M = A.shape[0]
    K = g.KH * g.KW * g.Cp
    B = np.zeros((plan.o_tiles * plan.bn, K + plan.cb), np.int64)
    B[:O, :K] = qw.kernel.reshape(O, K).numpy()   # zeros past O and K
    sums = np.zeros((plan.m_tiles * ik.BM, plan.o_tiles * plan.bn), np.int64)
    Apad = np.zeros((plan.m_tiles * ik.BM, K), np.int32)
    Apad[:M] = A
    for t in range(plan.m_tiles):
        m0 = t * ik.BM
        for it in range(plan.k_iters):
            for c0, off, kb in stage_pairs(g, plan, it):
                a = im2col_box(codes, g, plan, m0, c0, off)
                if kb < K:    # a real pair: the rows F.unfold gives
                    np.testing.assert_array_equal(
                        a, Apad[m0:m0 + ik.BM, kb:kb + plan.cb])
                sums[m0:m0 + ik.BM] += a @ B[:, kb:kb + plan.cb].T
    _, ref = ik.conv_s8s8s32_plain(torch.from_numpy(codes).to(torch.int8),
                                   sx, qw.kernel, qw.scale, g, torch.float32,
                                   with_sums=True)
    ref = ref.permute(0, 2, 3, 1).reshape(M, O).numpy()
    np.testing.assert_array_equal(sums[:M, :O], ref)
