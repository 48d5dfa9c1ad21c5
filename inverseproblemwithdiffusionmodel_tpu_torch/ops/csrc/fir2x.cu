// Factor-2 FIR resampling of channel-last (N, H, W, C) float32 and bf16
// images.
//
// Replaces the TPU kernels upsample2x_pallas (K1) and downsample2x_pallas
// (K2) (inverseproblemwithdiffusionmodel_tpu/ops/pallas_kernels.py:179,
// :199), which run the separable polyphase form one axis at a time on one
// image block in VMEM.
//
// Bound: device-memory bytes. Each output costs 4 (up) or 16 (down)
// multiply-adds, a few FLOP per byte moved, far below the card's ratio of
// compute to bandwidth. The least traffic is every input read once and
// every output written once: 4 (N H W C) (1 + 4) bytes for K1 and
// 4 (N H W C) (1 + 1/4) for K2, 25 us at 3.35 TB/s for the largest
// calls of an FFHQ-256 forward at batch 2 (83.9 MB each). In bf16 the
// bytes halve: 2 (N H W C) (1 + 4) for K1 and 2 (N H W C) (1 + 1/4) for
// K2.
//
// Taps are the 4-tap 1-D kernel of each axis, already normalised and scaled
// by the gain (ops/fir_kernels.py _sep_kernel_1d); they are runtime floats,
// so reversed (backward) and zero-padded (2- and 3-tap) taps need nothing
// else. Per axis:
//   up:   out[2i] = k1 x[i] + k3 x[i-1],   out[2i+1] = k2 x[i] + k0 x[i+1]
//   down: out[i]  = k3 x[2i-1] + k2 x[2i] + k1 x[2i+1] + k0 x[2i+2]
// with zeros outside the image. The H axis is filtered first, then W, as
// the TPU kernel and the plain versions do.
//
// Design. One pass in 2-D: no zero-inserted (up) or full-resolution
// filtered (down) intermediate in device memory.
// - A block owns a strip of columns (32 of the input for K1, 32 of the
//   output for K2) and up to 8 channel vectors of one image, and walks down
//   a chunk of its rows. A thread owns one column (K1) or one column pair
//   (K2) and one channel vector, and keeps its own column's rows in
//   registers as it walks: each input element is loaded once, by one
//   thread, halo aside (one column each side of the strip, one row each
//   side of the chunk, most of them L2 hits of a neighbouring block).
// - The next rows are loaded into registers one step ahead, so their
//   loads are in flight while the current rows are computed and stored.
// - The H pass happens in registers. Its results (the two output rows of
//   K1, the filtered even and odd columns of K2) go to shared memory,
//   double-buffered so one barrier per row suffices, and the W pass reads
//   the neighbouring columns from there. K1's thread writes the 2x2 output
//   quad of its input pixel, K2's thread one output.
// - Loads and stores are 16 bytes along channels (float4, or 8 bf16 in a
//   uint4) where C is a multiple of the vector and both pointers are
//   16-byte aligned; otherwise the same kernel runs on single elements (the
//   C = 3 image pyramids). Neighbouring threads hold neighbouring channel
//   vectors, then neighbouring columns, so a warp touches whole 128-byte
//   lines.
// - bf16 is a storage type only. Each loaded value is converted to float32,
//   the H-filtered rows in shared memory are float32, and the result is
//   rounded to bf16 once, at the store. Registers hold the rows read ahead
//   in their storage form (8 bf16 in 4 registers) and convert them when
//   they are used, so the bf16 form needs no more registers than the
//   float32 one. This is more accurate than the TPU kernel, which (its taps
//   being weakly typed Python floats) filters a bf16 image in bf16 and so
//   rounds the H-filtered rows to bf16 too; the plain version in
//   ops/fir_kernels.py computes what this kernel does and is its oracle.
// - Index math is 32-bit from a 2-D grid (image x row chunk x column tile,
//   channel tile); only the image and row base offsets are 64-bit. Zero
//   borders are a per-thread (column) or per-block (row) predicate on the
//   load, never a test in the arithmetic.
// - The row chunk shrinks (16 -> 1 rows) until the grid has at least 512
//   blocks, so small shapes still spread over the card's 132 SMs, and a
//   block of a small shape waits for one round of loads, not several.
// Why not cp.async or TMA into shared memory: every input element is used
// by exactly one thread for its H pass, so staging the raw input in shared
// memory would add a round trip; only the H-filtered rows are shared.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  float k0, k1, k2, k3;
};

constexpr int kTileCols = 32;    // columns a block emits
constexpr int kVecsPerBlock = 8;  // channel vectors per block, at most
constexpr int kMaxThreads = kVecsPerBlock * (kTileCols + 2);
constexpr int kMinBlocks = 512;   // grid size below which chunks shrink

// Eight float32 values: the arithmetic form of eight bf16 (one uint4).
struct Float8 {
  float4 a, b;
};

// Storage types S (what a thread loads and stores) and their arithmetic
// form F: float -> float, float4 -> float4, bf16 -> float, uint4 (8 bf16)
// -> Float8.
template <typename S> struct Vec;
template <> struct Vec<float> { using F = float; static constexpr int n = 1; };
template <> struct Vec<float4> {
  using F = float4;
  static constexpr int n = 4;
};
template <> struct Vec<__nv_bfloat16> {
  using F = float;
  static constexpr int n = 1;
};
template <> struct Vec<uint4> { using F = Float8; static constexpr int n = 8; };

__device__ __forceinline__ float2 bf2_to_f2(unsigned int u) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned int*>(&h) = u;
  return __bfloat1622float2(h);
}
__device__ __forceinline__ unsigned int f2_to_bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<unsigned int*>(&h);
}

__device__ __forceinline__ float up(float x) { return x; }
__device__ __forceinline__ float4 up(float4 x) { return x; }
__device__ __forceinline__ float up(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ Float8 up(uint4 x) {
  const float2 p = bf2_to_f2(x.x), q = bf2_to_f2(x.y), r = bf2_to_f2(x.z),
               s = bf2_to_f2(x.w);
  return {make_float4(p.x, p.y, q.x, q.y), make_float4(r.x, r.y, s.x, s.y)};
}

// The one rounding of a result to its storage type.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(float4* p, float4 v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(uint4* p, Float8 v) {
  *p = make_uint4(f2_to_bf2(v.a.x, v.a.y), f2_to_bf2(v.a.z, v.a.w),
                  f2_to_bf2(v.b.x, v.b.y), f2_to_bf2(v.b.z, v.b.w));
}

__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __ushort_as_bfloat16(0);
}
__device__ __forceinline__ uint4 zero_of(uint4) {
  return make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 load(const __nv_bfloat16* p) {
  return __ldg(p);
}
__device__ __forceinline__ uint4 load(const uint4* p) { return __ldg(p); }

// a x + b y
__device__ __forceinline__ float lin2(float a, float x, float b, float y) {
  return a * x + b * y;
}
__device__ __forceinline__ float4 lin2(float a, float4 x, float b, float4 y) {
  return make_float4(a * x.x + b * y.x, a * x.y + b * y.y, a * x.z + b * y.z,
                     a * x.w + b * y.w);
}
__device__ __forceinline__ Float8 lin2(float a, Float8 x, float b, Float8 y) {
  return {lin2(a, x.a, b, y.a), lin2(a, x.b, b, y.b)};
}

// s + a x
__device__ __forceinline__ float acc(float s, float a, float x) {
  return s + a * x;
}
__device__ __forceinline__ float4 acc(float4 s, float a, float4 x) {
  return make_float4(s.x + a * x.x, s.y + a * x.y, s.z + a * x.z,
                     s.w + a * x.w);
}
__device__ __forceinline__ Float8 acc(Float8 s, float a, Float8 x) {
  return {acc(s.a, a, x.a), acc(s.b, a, x.b)};
}

// Block shape: blockDim.x channel vectors, blockDim.y = emitted columns + 2
// thread columns. Grid: x = (image * chunks + chunk) * col_tiles + tile,
// y = channel tile. `rows` is the chunk height in input rows.
template <typename S>
__global__ void __launch_bounds__(kMaxThreads, 3)
    fir_up2x_kernel(const S* __restrict__ in, S* __restrict__ out, int H,
                    int W, int Cv, int rows, int chunks, int col_tiles,
                    Taps ty, Taps tx) {
  using F = typename Vec<S>::F;
  extern __shared__ __align__(16) unsigned char smem[];
  F* sm = reinterpret_cast<F*>(smem);   // [buffer][row 2i, 2i+1][col][vec]
  const int nv = blockDim.x, cols = blockDim.y, plane = nv * cols;
  const int v = threadIdx.x, tc = threadIdx.y;
  int b = blockIdx.x;
  const int tile = b % col_tiles;
  b /= col_tiles;
  const int chunk = b % chunks, n = b / chunks;
  const int c = blockIdx.y * nv + v;
  const int j = tile * (cols - 2) - 1 + tc;   // this thread's input column
  const bool has_c = c < Cv;
  const bool live = has_c && j >= 0 && j < W;
  const bool emits = live && tc >= 1 && tc <= cols - 2;
  const long long row = (long long)W * Cv;
  const S* src = in + (long long)n * H * row +
                 (live ? (long long)j * Cv + c : 0);
  S* dst = out + (long long)n * 4 * H * row +
           (emits ? 2LL * j * Cv + c : 0);
  const S z = zero_of(S());
  auto ld = [&](int r) {
    return (live && r >= 0 && r < H) ? load(src + r * row) : z;
  };
  const int r0 = chunk * rows, r1 = min(H, r0 + rows);
  S prev = ld(r0 - 1), cur = ld(r0), next = ld(r0 + 1);
  int buf = 0;
  for (int i = r0; i < r1; ++i) {
    const S ahead = i + 1 < r1 ? ld(i + 2) : z;
    const F fc = up(cur);
    const F e = lin2(ty.k1, fc, ty.k3, up(prev));   // H pass, output row 2i
    const F o = lin2(ty.k2, fc, ty.k0, up(next));   // output row 2i + 1
    F* s = sm + buf * 2 * plane + tc * nv + v;
    s[0] = e;
    s[plane] = o;
    __syncthreads();
    if (emits) {                                      // W pass
      S* d = dst + 2LL * i * 2 * row;
      put(d, lin2(tx.k1, e, tx.k3, s[-nv]));
      put(d + Cv, lin2(tx.k2, e, tx.k0, s[nv]));
      d += 2 * row;
      put(d, lin2(tx.k1, o, tx.k3, s[plane - nv]));
      put(d + Cv, lin2(tx.k2, o, tx.k0, s[plane + nv]));
    }
    buf ^= 1;
    prev = cur;
    cur = next;
    next = ahead;
  }
}

// As above, but a thread column owns the input column pair (2p, 2p+1) of
// output column p, and `rows` is the chunk height in output rows. H and W
// are even.
template <typename S>
__global__ void __launch_bounds__(kMaxThreads, 3)
    fir_down2x_kernel(const S* __restrict__ in, S* __restrict__ out, int H,
                      int W, int Cv, int rows, int chunks, int col_tiles,
                      Taps ty, Taps tx) {
  using F = typename Vec<S>::F;
  extern __shared__ __align__(16) unsigned char smem[];
  F* sm = reinterpret_cast<F*>(smem);   // [buffer][even, odd col][pair][vec]
  const int nv = blockDim.x, cols = blockDim.y, plane = nv * cols;
  const int v = threadIdx.x, tc = threadIdx.y;
  const int Ho = H / 2, Wo = W / 2;
  int b = blockIdx.x;
  const int tile = b % col_tiles;
  b /= col_tiles;
  const int chunk = b % chunks, n = b / chunks;
  const int c = blockIdx.y * nv + v;
  const int p = tile * (cols - 2) - 1 + tc;   // this thread's output column
  const bool inside = c < Cv && p >= 0 && p < Wo;
  const bool live_e = inside && tc != 0;          // left halo: odd col only
  const bool live_o = inside && tc != cols - 1;   // right halo: even only
  const bool emits = inside && tc >= 1 && tc <= cols - 2;
  const long long row = (long long)W * Cv;
  const S* src = in + (long long)n * H * row +
                 (inside ? 2LL * p * Cv + c : 0);
  S* dst = out + (long long)n * Ho * Wo * Cv +
           (emits ? (long long)p * Cv + c : 0);
  const S z = zero_of(S());
  auto load_e = [&](int r) {
    return (live_e && r >= 0 && r < H) ? load(src + r * row) : z;
  };
  auto load_o = [&](int r) {
    return (live_o && r >= 0 && r < H) ? load(src + r * row + Cv) : z;
  };
  const int r0 = chunk * rows, r1 = min(Ho, r0 + rows);
  // k3 x[2i-1] + k2 x[2i] of output row i, then its rows 2i+1 and 2i+2.
  F pe = lin2(ty.k3, up(load_e(2 * r0 - 1)), ty.k2, up(load_e(2 * r0)));
  F po = lin2(ty.k3, up(load_o(2 * r0 - 1)), ty.k2, up(load_o(2 * r0)));
  S ae = load_e(2 * r0 + 1), be = load_e(2 * r0 + 2);
  S ao = load_o(2 * r0 + 1), bo = load_o(2 * r0 + 2);
  int buf = 0;
  for (int i = r0; i < r1; ++i) {
    const bool more = i + 1 < r1;
    const S nae = more ? load_e(2 * i + 3) : z;
    const S nbe = more ? load_e(2 * i + 4) : z;
    const S nao = more ? load_o(2 * i + 3) : z;
    const S nbo = more ? load_o(2 * i + 4) : z;
    const F fae = up(ae), fbe = up(be), fao = up(ao), fbo = up(bo);
    const F he = acc(acc(pe, ty.k1, fae), ty.k0, fbe);   // H pass
    const F ho = acc(acc(po, ty.k1, fao), ty.k0, fbo);
    F* s = sm + buf * 2 * plane + tc * nv + v;
    s[0] = he;
    s[plane] = ho;
    __syncthreads();
    if (emits) {                                          // W pass
      put(dst + (long long)i * Wo * Cv,
          acc(acc(lin2(tx.k3, s[plane - nv], tx.k2, he), tx.k1, ho), tx.k0,
              s[nv]));
    }
    pe = lin2(ty.k3, fae, ty.k2, fbe);
    po = lin2(ty.k3, fao, ty.k2, fbo);
    ae = nae;
    be = nbe;
    ao = nao;
    bo = nbo;
    buf ^= 1;
  }
}

// Grid and block for `emit_cols` emitted columns and `out_rows` rows to
// walk, in tiles of kTileCols columns and up to kVecsPerBlock channel
// vectors; the row chunk halves from 16 until the grid has kMinBlocks
// blocks or the chunk is 1 row.
template <typename S, typename Kernel>
int launch(Kernel kernel, const void* in, void* out, long long N,
           long long H, long long W, long long C, long long emit_cols,
           long long out_rows, Taps ty, Taps tx, cudaStream_t stream) {
  const long long Cv = C / Vec<S>::n;
  if (H >= (1LL << 31) || W >= (1LL << 31) || Cv >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int nv = (int)(Cv < kVecsPerBlock ? Cv : kVecsPerBlock);
  const int tile = (int)(emit_cols < kTileCols ? emit_cols : kTileCols);
  const long long col_tiles = (emit_cols + tile - 1) / tile;
  const long long ch_tiles = (Cv + nv - 1) / nv;
  int rows = 16;
  while (rows > 1 &&
         N * ((out_rows + rows - 1) / rows) * col_tiles * ch_tiles <
             kMinBlocks)
    rows /= 2;
  const long long chunks = (out_rows + rows - 1) / rows;
  const long long gx = N * chunks * col_tiles;
  if (gx >= (1LL << 31) || ch_tiles > 65535 || chunks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 block(nv, tile + 2), grid((unsigned)gx, (unsigned)ch_tiles);
  const size_t smem =
      2 * 2 * (size_t)nv * (tile + 2) * sizeof(typename Vec<S>::F);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const S*>(in), static_cast<S*>(out), (int)H, (int)W,
      (int)Cv, rows, (int)chunks, (int)col_tiles, ty, tx);
  return (int)cudaGetLastError();
}

// 16-byte vectors apply where C fills them and both pointers are aligned.
bool vec16_ok(const void* in, const void* out, long long C, int per_vec) {
  return C % per_vec == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// Up and down in one storage type: the 16-byte vector V or the scalar S.
template <typename S, typename V>
int up2x(const void* in, void* out, long long N, long long H, long long W,
         long long C, Taps ty, Taps tx, cudaStream_t stream) {
  if (N * H * W * C == 0) return (int)cudaSuccess;
  if (vec16_ok(in, out, C, Vec<V>::n))
    return launch<V>(fir_up2x_kernel<V>, in, out, N, H, W, C, W, H, ty, tx,
                     stream);
  return launch<S>(fir_up2x_kernel<S>, in, out, N, H, W, C, W, H, ty, tx,
                   stream);
}

template <typename S, typename V>
int down2x(const void* in, void* out, long long N, long long H, long long W,
           long long C, Taps ty, Taps tx, cudaStream_t stream) {
  if (N * (H / 2) * (W / 2) * C == 0) return (int)cudaSuccess;
  if (H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  if (vec16_ok(in, out, C, Vec<V>::n))
    return launch<V>(fir_down2x_kernel<V>, in, out, N, H, W, C, W / 2, H / 2,
                     ty, tx, stream);
  return launch<S>(fir_down2x_kernel<S>, in, out, N, H, W, C, W / 2, H / 2,
                   ty, tx, stream);
}

}  // namespace

#define FIR_ENTRY(name, impl, S, V)                                         \
  extern "C" int name(const void* in, void* out, long long N, long long H, \
                      long long W, long long C, float ky0, float ky1,      \
                      float ky2, float ky3, float kx0, float kx1,          \
                      float kx2, float kx3, cudaStream_t stream) {         \
    return impl<S, V>(in, out, N, H, W, C, Taps{ky0, ky1, ky2, ky3},       \
                      Taps{kx0, kx1, kx2, kx3}, stream);                   \
  }

FIR_ENTRY(fir_up2x_f32, up2x, float, float4)
FIR_ENTRY(fir_down2x_f32, down2x, float, float4)
FIR_ENTRY(fir_up2x_bf16, up2x, __nv_bfloat16, uint4)
FIR_ENTRY(fir_down2x_bf16, down2x, __nv_bfloat16, uint4)
