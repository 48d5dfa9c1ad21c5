// Factor-2 FIR resampling of channel-last (N, H, W, C) float32 images.
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
// calls of an FFHQ-256 forward at batch 2 (83.9 MB each).
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
// - Loads and stores are 16-byte float4 along channels where C % 4 == 0
//   and both pointers are 16-byte aligned; otherwise the same kernel runs
//   on single floats (the C = 3 image pyramids). Neighbouring threads hold
//   neighbouring channel vectors, then neighbouring columns, so a warp
//   touches whole 128-byte lines.
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

__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// a x + b y
__device__ __forceinline__ float lin2(float a, float x, float b, float y) {
  return a * x + b * y;
}
__device__ __forceinline__ float4 lin2(float a, float4 x, float b, float4 y) {
  return make_float4(a * x.x + b * y.x, a * x.y + b * y.y, a * x.z + b * y.z,
                     a * x.w + b * y.w);
}

// s + a x
__device__ __forceinline__ float acc(float s, float a, float x) {
  return s + a * x;
}
__device__ __forceinline__ float4 acc(float4 s, float a, float4 x) {
  return make_float4(s.x + a * x.x, s.y + a * x.y, s.z + a * x.z,
                     s.w + a * x.w);
}

// Block shape: blockDim.x channel vectors, blockDim.y = emitted columns + 2
// thread columns. Grid: x = (image * chunks + chunk) * col_tiles + tile,
// y = channel tile. `rows` is the chunk height in input rows.
template <typename V>
__global__ void __launch_bounds__(kMaxThreads, 3)
    fir_up2x_kernel(const V* __restrict__ in, V* __restrict__ out, int H,
                    int W, int Cv, int rows, int chunks, int col_tiles,
                    Taps ty, Taps tx) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* sm = reinterpret_cast<V*>(smem);   // [buffer][row 2i, 2i+1][col][vec]
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
  const V* src = in + (long long)n * H * row +
                 (live ? (long long)j * Cv + c : 0);
  V* dst = out + (long long)n * 4 * H * row +
           (emits ? 2LL * j * Cv + c : 0);
  const V z = zero_of(V());
  auto load = [&](int r) {
    return (live && r >= 0 && r < H) ? __ldg(src + r * row) : z;
  };
  const int r0 = chunk * rows, r1 = min(H, r0 + rows);
  V prev = load(r0 - 1), cur = load(r0), next = load(r0 + 1);
  int buf = 0;
  for (int i = r0; i < r1; ++i) {
    const V ahead = i + 1 < r1 ? load(i + 2) : z;
    const V e = lin2(ty.k1, cur, ty.k3, prev);   // H pass, output row 2i
    const V o = lin2(ty.k2, cur, ty.k0, next);   // output row 2i + 1
    V* s = sm + buf * 2 * plane + tc * nv + v;
    s[0] = e;
    s[plane] = o;
    __syncthreads();
    if (emits) {                                  // W pass
      V* d = dst + 2LL * i * 2 * row;
      d[0] = lin2(tx.k1, e, tx.k3, s[-nv]);
      d[Cv] = lin2(tx.k2, e, tx.k0, s[nv]);
      d += 2 * row;
      d[0] = lin2(tx.k1, o, tx.k3, s[plane - nv]);
      d[Cv] = lin2(tx.k2, o, tx.k0, s[plane + nv]);
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
template <typename V>
__global__ void __launch_bounds__(kMaxThreads, 3)
    fir_down2x_kernel(const V* __restrict__ in, V* __restrict__ out, int H,
                      int W, int Cv, int rows, int chunks, int col_tiles,
                      Taps ty, Taps tx) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* sm = reinterpret_cast<V*>(smem);   // [buffer][even, odd col][pair][vec]
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
  const V* src = in + (long long)n * H * row +
                 (inside ? 2LL * p * Cv + c : 0);
  V* dst = out + (long long)n * Ho * Wo * Cv +
           (emits ? (long long)p * Cv + c : 0);
  const V z = zero_of(V());
  auto load_e = [&](int r) {
    return (live_e && r >= 0 && r < H) ? __ldg(src + r * row) : z;
  };
  auto load_o = [&](int r) {
    return (live_o && r >= 0 && r < H) ? __ldg(src + r * row + Cv) : z;
  };
  const int r0 = chunk * rows, r1 = min(Ho, r0 + rows);
  // k3 x[2i-1] + k2 x[2i] of output row i, then its rows 2i+1 and 2i+2.
  V pe = lin2(ty.k3, load_e(2 * r0 - 1), ty.k2, load_e(2 * r0));
  V po = lin2(ty.k3, load_o(2 * r0 - 1), ty.k2, load_o(2 * r0));
  V ae = load_e(2 * r0 + 1), be = load_e(2 * r0 + 2);
  V ao = load_o(2 * r0 + 1), bo = load_o(2 * r0 + 2);
  int buf = 0;
  for (int i = r0; i < r1; ++i) {
    const bool more = i + 1 < r1;
    const V nae = more ? load_e(2 * i + 3) : z;
    const V nbe = more ? load_e(2 * i + 4) : z;
    const V nao = more ? load_o(2 * i + 3) : z;
    const V nbo = more ? load_o(2 * i + 4) : z;
    const V he = acc(acc(pe, ty.k1, ae), ty.k0, be);   // H pass
    const V ho = acc(acc(po, ty.k1, ao), ty.k0, bo);
    V* s = sm + buf * 2 * plane + tc * nv + v;
    s[0] = he;
    s[plane] = ho;
    __syncthreads();
    if (emits) {                                        // W pass
      dst[(long long)i * Wo * Cv] =
          acc(acc(lin2(tx.k3, s[plane - nv], tx.k2, he), tx.k1, ho), tx.k0,
              s[nv]);
    }
    pe = lin2(ty.k3, ae, ty.k2, be);
    po = lin2(ty.k3, ao, ty.k2, bo);
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
template <typename V, typename Kernel>
int launch(Kernel kernel, const float* in, float* out, long long N,
           long long H, long long W, long long C, long long emit_cols,
           long long out_rows, Taps ty, Taps tx, cudaStream_t stream) {
  const long long Cv = C / (long long)(sizeof(V) / sizeof(float));
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
  const size_t smem = 2 * 2 * (size_t)nv * (tile + 2) * sizeof(V);
  kernel<<<grid, block, smem, stream>>>(
      reinterpret_cast<const V*>(in), reinterpret_cast<V*>(out), (int)H,
      (int)W, (int)Cv, rows, (int)chunks, (int)col_tiles, ty, tx);
  return (int)cudaGetLastError();
}

bool float4_ok(const float* in, const float* out, long long C) {
  return C % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace

extern "C" int fir_up2x_f32(const float* in, float* out, long long N,
                            long long H, long long W, long long C, float ky0,
                            float ky1, float ky2, float ky3, float kx0,
                            float kx1, float kx2, float kx3,
                            cudaStream_t stream) {
  if (N * H * W * C == 0) return (int)cudaSuccess;
  const Taps ty{ky0, ky1, ky2, ky3}, tx{kx0, kx1, kx2, kx3};
  if (float4_ok(in, out, C))
    return launch<float4>(fir_up2x_kernel<float4>, in, out, N, H, W, C, W, H,
                          ty, tx, stream);
  return launch<float>(fir_up2x_kernel<float>, in, out, N, H, W, C, W, H, ty,
                       tx, stream);
}

extern "C" int fir_down2x_f32(const float* in, float* out, long long N,
                              long long H, long long W, long long C,
                              float ky0, float ky1, float ky2, float ky3,
                              float kx0, float kx1, float kx2, float kx3,
                              cudaStream_t stream) {
  if (N * (H / 2) * (W / 2) * C == 0) return (int)cudaSuccess;
  if (H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  const Taps ty{ky0, ky1, ky2, ky3}, tx{kx0, kx1, kx2, kx3};
  if (float4_ok(in, out, C))
    return launch<float4>(fir_down2x_kernel<float4>, in, out, N, H, W, C,
                          W / 2, H / 2, ty, tx, stream);
  return launch<float>(fir_down2x_kernel<float>, in, out, N, H, W, C, W / 2,
                       H / 2, ty, tx, stream);
}
