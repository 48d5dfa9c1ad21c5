// The int8 convolution of the score nets' serving mode: K5 absmax, K6
// quantize_s8 and K7 conv_s8s8s32, float32 and bf16.
//
// Replaces no TPU kernel. The JAX package lowers its int8 convolution
// through XLA (inverseproblemwithdiffusionmodel_tpu/ops/quant.py:82
// quantize_per_channel, :93 quantize_per_tensor, :102 int8_conv, the
// lax.conv_general_dilated with preferred_element_type=int32 at :113). No
// PyTorch call computes an s8 x s8 -> s32 convolution on a CUDA tensor, so
// the port's int8 mode needs kernels of its own.
//
//   K5  absmax:      amax = max |x| over the whole tensor (the batch too),
//                    NaN where x holds a NaN, as jnp.max
//   K6  quantize_s8: scale = max(amax, 1e-12) / 127 (float32; NaN stays
//                    NaN, as jnp.maximum keeps it),
//                    q = clip(rint(x / scale), -127, 127), written
//                    channels-last (N, H, W, Cp) with C padded by zero codes
//                    to Cp, a multiple of 32
//   K7  conv_s8s8s32: acc[n, o, p] = sum over taps and channels of
//                    q[n, p + tap, c] * wq[o, tap, c] in int32; out = (float)
//                    acc * (scale * sw[o]), rounded once to the output type
//
// Every rounding is the JAX package's: x / scale is a true division
// (__fdiv_rn), rint rounds half to even as jnp.round does, the two scales
// are multiplied first and then applied, and int32 -> float32 and float32
// -> bf16 round to nearest even. The zeros of the padding are added after
// the quantization, as quantized zeros, and do not move amax. Int32 sums
// are exact in any order, so K7's sums and its dequantized output equal the
// plain version (a float64 convolution of the same codes, exact since |sum|
// <= 127^2 * K < 2^53) bit for bit.
//
// Bounds. K5 and K6 move bytes: one read of x (K6 also writes a quarter or
// half of x's bytes as codes). K7 is an implicit GEMM of M = N * Ho * Wo
// output pixels by O output channels over K = KH * KW * Cp; at the score
// nets' 3x3 convolutions of 128 channels and more its 2 M O K operations on
// the int8 tensor cores (1,979 TOP/s dense on an H100 SXM) outweigh its
// bytes.
//
// K5 is one launch a call and writes amax itself (no zero fill): one wave
// of blocks (8 of 256 threads on each SM, fewer for a small x, as
// int8_kernels.absmax_plan says), each thread with eight independent
// 16-byte loads in flight before it joins any (neighbouring threads on
// neighbouring vectors, the grid striding over x), an integer max of
// magnitude bits per thread, warp (redux) and block, then one partial per
// block in a per-device scratch and a ticket: the block that draws the
// last ticket, after a __threadfence, reduces the partials and writes
// amax; the ticket (atomicInc, limit gridDim.x - 1) wraps back to 0 by
// itself at that draw. No block waits on another; the grid is one
// wave for speed (no second, partly idle wave). The head and tail of a
// misaligned or ragged x (under 16 bytes each) go through scalar loads of
// block 0. Bound: one read of x at 3.35 TB/s. At NCSN1D's 6-13 MB inputs a
// call is mostly fixed cost (a launch, a load's latency, the ticket's round
// trips), which
// the old form paid twice (a zero-fill kernel, then a grid of up to 2,112
// blocks in two waves and 2,112 atomicMax on one word). A ring of 1-D bulk
// copies (TMA) per block over a contiguous chunk measured slower at every
// geometry (PERF.md section 6): its single issuing thread and per-stage
// barriers cost more than they save on a read-only stream. K5 must not
// run on two streams of one device at once: the calls would share the
// ticket and mix their partials, and amax would come out wrong with no
// error (the wrapping ticket keeps such a fault to the calls that
// overlapped). The port launches K5 on one stream (each engine on the current
// stream), and a CUDA graph replays its launches in order on its stream.
//
// K6 is a tiled transpose through shared memory: a block takes 32 channels
// by 32 16-byte vectors of flattened pixels m = n P + p (256 bf16 or 128
// float32 pixels, several images where P is small), the blocks of one run
// of pixels' channel groups in a row so that they fill whole lines of the
// codes. Warp w reads channels 4w..4w+3, each lane one 16-byte vector of
// each (neighbouring lanes on neighbouring addresses), quantizes in
// registers and packs each pixel's 4 codes into one word, written to a
// [pixel][8 words] tile whose word slot is XOR-swizzled by the writing lane
// (4-way bank conflicts instead of 32-way). Each pixel's 32 codes then leave
// as two 16-byte stores. Rows that are only 8-byte aligned (P a multiple of
// half the vector) take two 8-byte loads a lane; other rows, and the last
// pixels of x, scalar loads, in the same kernel. The division x / scale is
// a product by 1 / scale wherever that cannot change the code (quantize).
//
// K7 is a warp-specialised implicit GEMM on Hopper's wgmma, fed by TMA:
// - A block computes a tile of 128 output pixels (consecutive in N, Ho, Wo
//   order, so a tile may cross images) by BN output channels, BN a
//   template argument: 8 (O <= 8, the end convolutions), 64, 128 or 256.
// - The K loop runs tap-major in box pairs of cb channels (cb = 128, 64 or
//   32, the largest that divides Cp), each pair one tap's A box of 128
//   pixels x cb bytes and its B box of BN rows x cb bytes, both in the
//   cb-byte swizzle. A stage of the ring holds 128 bytes of K (128 / cb
//   pairs), so every stage is four wgmma K steps whatever cb is; the last
//   stage's spare pairs load B past K, zeros.
// - Warp 8 is the producer: one thread issues, per pair, one TMA im2col
//   load of A (the channels-last codes; the tap's offset (kx dil, ky dil)
//   in the load's im2col offsets, the padding in the pixel box's corners,
//   so the TMA fills zeros outside the image and past the last image) and
//   one tiled TMA load of B (the weight codes as (O, KH KW Cp), rows past O
//   zero), onto the stage's full mbarrier; it waits on the stage's empty
//   mbarrier before reusing it. Being one warp, it leaves the registers to
//   the consumers without setmaxnreg (whose count ptxas does not use for
//   the code after it: the wgmma of BN = 128 needs more than the 80 that
//   a 384-thread block at two blocks an SM would compile with).
// - Warps 0-7, two warpgroups, are the consumers: each runs
//   wgmma.mma_async.m64nBNk32.s32.s8.s8 on its 64-row half of the tile,
//   straight from the swizzled shared stages, keeps one wgmma group in
//   flight and releases a stage when the group that read it is done.
// - The epilogue dequantizes in registers, stages the tile as float32 in
//   the ring, transposed to [channel][pixel], and writes runs of R
//   neighbouring pixels of one channel (R a power of 2 dividing Ho Wo, at
//   most 16 bytes) as single stores into the channels-first (N, O, Ho, Wo)
//   output: a run never crosses an image. The int32 sums are written only
//   when asked.
// - The ring holds 3 to 6 stages; BN <= 128 leaves room for two blocks on
//   an SM, so one block's epilogue overlaps the other's loads and products.
// The host plan (ops/int8_kernels.py conv_plan) is the one owner of the
// tiling: BN, cb, the K loop's box pairs and stages, the ring, the grid,
// the run, the corners and the shared memory size reach the kernel as
// planned, the launcher only checking that the instance and its buffers
// hold them. The launcher encodes the two tensor maps
// (cuTensorMapEncodeIm2col / Tiled, reached through
// cudaGetDriverEntryPointByVersion, so the library needs no -lcuda) and
// passes them by value as __grid_constant__ parameters, which a CUDA graph
// captures.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// -- K5: the per-tensor |x| maximum ----------------------------------------

// ops/int8_kernels.py K5_THREADS, K5_BLOCKS_PER_SM and K5_UNROLL hold the
// same numbers for absmax_plan.
constexpr int K5_THREADS = 256;
constexpr int K5_BLOCKS_PER_SM = 8;   // 2,048 threads: 32 registers each
constexpr int K5_UNROLL = 8;          // 16-byte loads in flight a thread

// Magnitudes as bit patterns. With its sign bit cleared a float32 orders as
// its unsigned bits, NaN above +inf, and so does a bf16 in 16 bits; an
// integer max therefore keeps a NaN at every level, where fmaxf drops it
// (jnp.max propagates NaN). bf16 words hold two magnitudes, kept as a pair
// of 16-bit maxima (__vmaxu2) until finish() widens the larger one to the
// float32 bits of the same value.
template <typename T>
struct AbsBits;

template <>
struct AbsBits<float> {
  static __device__ __forceinline__ unsigned int vec(uint4 v) {
    return max(max(v.x & 0x7fffffffu, v.y & 0x7fffffffu),
               max(v.z & 0x7fffffffu, v.w & 0x7fffffffu));
  }
  static __device__ __forceinline__ unsigned int one(float v) {
    return __float_as_uint(v) & 0x7fffffffu;
  }
  static __device__ __forceinline__ unsigned int join(unsigned int a,
                                                      unsigned int b) {
    return max(a, b);
  }
  static __device__ __forceinline__ unsigned int finish(unsigned int a) {
    return a;
  }
};

template <>
struct AbsBits<__nv_bfloat16> {
  static __device__ __forceinline__ unsigned int vec(uint4 v) {
    return __vmaxu2(__vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu),
                    __vmaxu2(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu));
  }
  static __device__ __forceinline__ unsigned int one(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v) & 0x7fffu;
  }
  static __device__ __forceinline__ unsigned int join(unsigned int a,
                                                      unsigned int b) {
    return __vmaxu2(a, b);
  }
  static __device__ __forceinline__ unsigned int finish(unsigned int a) {
    return max(a & 0xffffu, a >> 16) << 16;
  }
};

// The block's maximum of m over its threads, valid in thread 0.
__device__ __forceinline__ unsigned int block_max(unsigned int m,
                                                  unsigned int* warp_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < K5_THREADS / 32 ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
  }
  return m;
}

// Block 0's share of x's head and tail (scalar loads), joined into m.
template <typename T>
__device__ __forceinline__ unsigned int head_tail(unsigned int m, const T* x,
                                                  long long head,
                                                  long long body_bytes,
                                                  long long tail) {
  using A = AbsBits<T>;
  const int tid = threadIdx.x;
  if (blockIdx.x == 0) {
    if (tid < head) m = A::join(m, A::one(x[tid]));
    if (tid < tail) {
      m = A::join(m,
                  A::one(x[head + body_bytes / (long long)sizeof(T) + tid]));
    }
  }
  return m;
}

// The grid's finish: block b writes its partial to scratch[1 + b] and
// takes a ticket (scratch[0]); the block that draws the last ticket
// reduces the partials and writes amax. The ticket is drawn by atomicInc
// with the limit gridDim.x - 1, so the last draw wraps it to 0 for the
// next launch by itself: a ticket left over by a launch that never
// finished spoils at most the one launch after it.
__device__ __forceinline__ void finish_absmax(unsigned int m,
                                              unsigned int* scratch,
                                              float* amax,
                                              unsigned int* warp_max) {
  __shared__ bool last;
  const int tid = threadIdx.x;
  m = block_max(m, warp_max);
  if (tid == 0) {
    scratch[1 + blockIdx.x] = m;
    __threadfence();
    last = atomicInc(&scratch[0], gridDim.x - 1u) == gridDim.x - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();   // the other blocks' partials, fenced before their tickets
  // eight independent loads a thread: one round trip to L2 for up to
  // 2,048 partials (joining each before the next load would cost one
  // round trip for each partial a thread reads)
  m = 0;
  for (int i0 = tid; i0 < (int)gridDim.x; i0 += 8 * K5_THREADS) {
    unsigned int p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * K5_THREADS;
      p[j] = i < (int)gridDim.x ? __ldcg(&scratch[1 + i]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) m = max(m, p[j]);
  }
  m = block_max(m, warp_max);
  if (tid == 0) *amax = __uint_as_float(m);
}

// x is head scalars, then body_bytes of 16-byte vectors from a 16-byte
// boundary, then tail scalars (ops/int8_kernels.py absmax_plan). Thread g
// of the grid's G threads reads vectors g, g + G, ... (neighbouring
// threads on neighbouring vectors), K5_UNROLL independent 16-byte loads in
// flight before it joins any of them; block 0 also takes the head and the
// tail.
template <typename T>
__global__ void __launch_bounds__(K5_THREADS, K5_BLOCKS_PER_SM)
absmax_kernel(const T* __restrict__ x, long long head, long long body_bytes,
              long long tail, unsigned int* __restrict__ scratch,
              float* __restrict__ amax) {
  using A = AbsBits<T>;
  __shared__ unsigned int warp_max[K5_THREADS / 32];
  const uint4* v = reinterpret_cast<const uint4*>(x + head);
  const long long n_vec = body_bytes / 16;
  const long long stride = (long long)gridDim.x * K5_THREADS;
  unsigned int m = 0;
  for (long long i = (long long)blockIdx.x * K5_THREADS + threadIdx.x;
       i < n_vec; i += K5_UNROLL * stride) {
    uint4 r[K5_UNROLL];
#pragma unroll
    for (int j = 0; j < K5_UNROLL; ++j) {
      const long long k = i + j * stride;
      r[j] = k < n_vec ? __ldg(v + k) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < K5_UNROLL; ++j) m = A::join(m, A::vec(r[j]));
  }
  m = head_tail(m, x, head, body_bytes, tail);
  finish_absmax(A::finish(m), scratch, amax, warp_max);
}

// -- K6: x -> channels-last int8 codes -------------------------------------

// 16 bytes of x as float32 values: 4 float32 or 8 bf16.
__device__ __forceinline__ void unpack16(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ float2 bf2_to_f2(unsigned int u) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned int*>(&h) = u;
  return __bfloat1622float2(h);
}
__device__ __forceinline__ void unpack16(uint4 v, float (&f)[8]) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = bf2_to_f2(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ unsigned int pick(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The code clip(rint(v / scale), -127, 127) of the true quotient (a
// division rounded to nearest), computed with a product where that cannot
// change the code: c = v * (1 / scale) is within 128 * 2^-23 of v / scale,
// and the rounded quotient within 2^-24 * 128 of it, so where c is more
// than 1e-4 from every half-integer (the only places rint and the clip at
// +-127.5 can part, i.e. |c - rint(c)| < 0.4999), rint(c) equals rint of
// the rounded quotient. Elsewhere (about 2e-4 of the values) it divides.
// Non-finite x never reaches it: K5 makes amax NaN (a NaN in x) or +inf
// (an inf and no NaN), so the scale is NaN or +inf, and then every code
// of the plain version and of XLA is 0 (a NaN quotient casts to 0, a
// finite v over +inf is 0), which quantize_kernel writes without
// reading x. K7's output is then 0 * scale = NaN everywhere, as the JAX
// package's.
__device__ __forceinline__ int quantize(float v, float scale, float inv) {
  const float c = __fmul_rn(v, inv);
  float r = rintf(c);
  if (fabsf(c - r) > 0.4999f) r = rintf(__fdiv_rn(v, scale));
  return (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

// 8 bytes of x as float32 values: 2 float32 or 4 bf16.
__device__ __forceinline__ void unpack8(uint2 v, float (&f)[2]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
}
__device__ __forceinline__ void unpack8(uint2 v, float (&f)[4]) {
  const float2 a = bf2_to_f2(v.x), b = bf2_to_f2(v.y);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// x is (N, C, P) contiguous, P the flattened spatial size; q is (N, P, Cp),
// i.e. (M, Cp) over the flattened pixels m = n P + p. Block b covers
// channel group b % G (32 channels; G = Cp / 32) of pixels (b / G) PX ..
// + PX - 1 (several images where P is small): the G blocks of a run of
// pixels run together and fill whole lines of the codes. Channels c >= C
// get code 0. Block 0's first thread also writes the scale for K7.
// vec: 2 where every image row of x is 16-byte aligned (16-byte loads),
// 1 where it is 8-byte aligned (two 8-byte loads a lane, each half of the
// lane's pixels in one row), 0 otherwise (scalar loads). Four blocks an
// SM hold it at 64 registers a thread; the bounds keep ptxas there (70
// registers, three blocks, read 20 % slower at the score nets' inputs).
template <typename T>
__global__ void __launch_bounds__(256, 4)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ amax,
                int8_t* __restrict__ q, float* __restrict__ scale_out, int C,
                long long P, long long M, int Cp, int vec) {
  constexpr int VEC = 16 / sizeof(T);   // pixels per 16-byte vector
  constexpr int PX = 32 * VEC;          // pixels per block
  __shared__ __align__(16) unsigned int tile[PX * 8];
  // max(amax, 1e-12) / 127 with jnp.maximum's NaN (fmaxf would drop it)
  const float a = *amax;
  const float scale = __fdiv_rn(a < 1e-12f ? 1e-12f : a, 127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const int groups = Cp / 32;
  const int g = blockIdx.x % groups;
  const long long mx0 = (long long)(blockIdx.x / groups) * PX;
  if (!isfinite(scale)) {
    // amax NaN or +inf (x holds a NaN or an inf): every code is 0, as the
    // division and the cast give (quantize's note); x is not read
    for (int k = threadIdx.x; k < 2 * PX; k += blockDim.x) {
      const long long m = mx0 + (k >> 1);
      if (m >= M) break;
      *reinterpret_cast<uint4*>(q + m * Cp + g * 32 + 16 * (k & 1)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const float inv = __frcp_rn(scale);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long m0 = mx0 + lane * VEC;
  const long long n0 = m0 / P;
  const long long p0 = m0 - n0 * P;
  // the lane's VEC pixels, whole, in one aligned 16-byte vector of one row
  const bool v16 = vec == 2 && p0 + VEC <= P && m0 + VEC <= M;
  // or its two halves each in one aligned 8-byte vector of one row
  const bool v8 = vec == 1 && m0 + VEC <= M;
  const long long p1 = p0 + VEC / 2 < P ? p0 + VEC / 2 : p0 + VEC / 2 - P;
  const long long n1 = p0 + VEC / 2 < P ? n0 : n0 + 1;

  // Warp w: channels 4w .. 4w + 3 of the group, lane l: pixels m0 ..
  // m0 + VEC - 1; words[e] packs pixel e's four codes, channel 4w + i in
  // byte i.
  unsigned int words[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) words[e] = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = g * 32 + warp * 4 + i;
    float v[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = 0.0f;
    if (c < C && m0 < M) {
      if (v16) {
        const T* row = x + (n0 * C + c) * P;
        unpack16(__ldg(reinterpret_cast<const uint4*>(row + p0)), v);
      } else if (v8) {
        float lo[VEC / 2], hi[VEC / 2];
        unpack8(__ldg(reinterpret_cast<const uint2*>(x + (n0 * C + c) * P +
                                                     p0)),
                lo);
        unpack8(__ldg(reinterpret_cast<const uint2*>(x + (n1 * C + c) * P +
                                                     p1)),
                hi);
#pragma unroll
        for (int e = 0; e < VEC / 2; ++e) {
          v[e] = lo[e];
          v[VEC / 2 + e] = hi[e];
        }
      } else {
        long long n = n0, p = p0;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (m0 + e < M) v[e] = to_f32(x[(n * C + c) * P + p]);
          if (++p == P) {   // P >= 1: a pixel past the image's last
            p = 0;
            ++n;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      words[e] |= (unsigned int)(quantize(v[e], scale, inv) & 0xff)
                  << (8 * i);
    }
  }
  // Pixel pl's word of channel quad w sits in slot w ^ s, s = the writing
  // lane's low 3 bits (= (pl / VEC) & 7).
  const int slot = warp ^ (lane & 7);
#pragma unroll
  for (int e = 0; e < VEC; ++e) tile[(lane * VEC + e) * 8 + slot] = words[e];
  __syncthreads();

  // Chunk k: the 16 bytes of channels 16h .. 16h + 15 of pixel k / 2,
  // h = k % 2, read back from slots 4 (h ^ (s >> 2)) .. + 3 and put back in
  // channel order (word m is slot 4 (h ^ (s >> 2)) + (m ^ (s & 3))).
  const uint4* tile4 = reinterpret_cast<const uint4*>(tile);
  for (int k = threadIdx.x; k < 2 * PX; k += blockDim.x) {
    const int pl = k >> 1, h = k & 1;
    const long long m = mx0 + pl;
    if (m >= M) break;
    const int s = (pl / VEC) & 7;
    const uint4 w = tile4[pl * 2 + (h ^ (s >> 2))];
    const int t = s & 3;
    const uint4 o = make_uint4(pick(w, t), pick(w, 1 ^ t), pick(w, 2 ^ t),
                               pick(w, 3 ^ t));
    *reinterpret_cast<uint4*>(q + m * Cp + g * 32 + 16 * h) = o;
  }
}

// -- K7: warp-specialised implicit GEMM on wgmma, fed by TMA ----------------

constexpr int BM = 128;          // output pixels per tile
constexpr int ROW = BM + 4;      // floats: the epilogue tile's row pitch
constexpr int STAGE_K = 128;     // bytes of K per stage: four wgmma K steps
constexpr int THREADS = 288;     // two consumer warpgroups + producer warp
constexpr int RING_SLOTS = 8;    // mbarrier pairs: the deepest ring
constexpr int HEAD = 2048;       // mbarriers [0, 128), scales [1024, 2048)

// One convolution and the host plan's launch of it (ops/int8_kernels.py
// conv_plan), by value.
struct ConvShape {
  int N, Cp, O, KH, KW, dil, Wo, HWo, M;
  int lower_w, lower_h;   // tensor coordinates of output pixel (0, 0)
  int cb;                 // channels (bytes) per TMA box: 32, 64 or 128
  int chunks;             // box pairs of the K loop: KH KW Cp / cb
  int k_iters;            // ring stages per tile
  int stage_bytes;        // at least (BM + BN) STAGE_K, a multiple of 1 KB
  int run;                // output pixels per store: a power of 2 dividing
                          // Ho Wo, at most 16 bytes
  int stages;             // ring depth
  int o_tiles;            // output-channel tiles of BN
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that never
// ends (a phase or byte count out of step) traps after about 2^26 tries,
// so that a fault fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  int tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (++tries == (1 << 26)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// A: pixels_per_column pixels of cb channels from the im2col tensor map,
// starting at pixel (w, h, n) of the pixel box, each at its tap's offset.
__device__ __forceinline__ void tma_im2col(void* dst, const CUtensorMap* map,
                                           uint64_t* bar, int c, int w,
                                           int h, int n, uint16_t off_w,
                                           uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(off_w), "h"(off_h)
      : "memory");
}

// B: a (rows, cb) box of the (O, K) weight codes at (k, row).
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row)
      : "memory");
}

// The wgmma shared-memory descriptor of a K-major tile whose rows are cb
// bytes in the cb-byte swizzle: 8-row groups cb * 8 bytes apart (the
// stride byte offset), the leading byte offset unused (1), layout 1 / 2 /
// 3 for the 128- / 64- / 32-byte swizzle. The tile starts on a multiple of
// its 8-row pattern, so the base offset is 0; a K step of 32 bytes inside
// the row adds 2 to the start address field.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int cb) {
  const uint64_t layout = cb == 128 ? 1 : cb == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * cb) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma.mma_async.sync.aligned.m64nNk32.s32.s8.s8, D += A B with both
// operands from shared memory (K-major, the only layout 8-bit operands
// take); d is the thread's N / 2 int32 sums: d[4 q + 2 i + j] is row
// 16 warp + lane / 4 + 8 i, column 8 q + 2 (lane % 4) + j of the 64 x N
// tile.
__device__ __forceinline__ void wgmma_n8(int (&d)[4], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 8) wgmma_n8(d, da, db);
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  if constexpr (BN == 128) wgmma_n128(d, da, db);
  if constexpr (BN == 256) wgmma_n256(d, da, db);
}

// Two blocks an SM below BN = 256 (112 registers a thread), one at 256
// (224: the 128 sums of m64n256 and the epilogue's addresses).
template <int BN>
constexpr int blocks_per_sm() {
  return BN == 256 ? 1 : 2;
}

// run consecutive floats from shared memory to run consecutive OutT in
// global memory, one store of run * sizeof(OutT) bytes (run a power of 2,
// the destination aligned to it)
template <typename OutT, int R>
__device__ __forceinline__ void store_run(OutT* dst, const float* src) {
  float f[R];
#pragma unroll
  for (int e = 0; e < R; ++e) f[e] = src[e];
  if constexpr (sizeof(OutT) == 4) {
    if constexpr (R == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
    } else if constexpr (R == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(f[0], f[1]);
    } else {
      *dst = f[0];
    }
  } else {
    if constexpr (R == 1) {
      *dst = __float2bfloat16_rn(f[0]);
    } else {
      unsigned int u[R / 2];
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        u[i] = *reinterpret_cast<const unsigned int*>(&h2);
      }
      if constexpr (R == 8) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
      } else if constexpr (R == 4) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(u[0], u[1]);
      } else {
        *reinterpret_cast<unsigned int*>(dst) = u[0];
      }
    }
  }
}

// The tile's channel rows (the first `rows`) from shared memory to the
// channels-first output, runs of R pixels: R divides Ho Wo, so a run never
// crosses an image and starts R-aligned. Thread t takes runs t, t + 256,
// ...: neighbouring threads write neighbouring runs of one channel.
template <typename OutT, int R>
__device__ __forceinline__ void store_tile(OutT* __restrict__ out,
                                           const float* tile,
                                           const ConvShape& s, int m0,
                                           int o0, int rows, int tid) {
  constexpr int RUNS = BM / R;   // runs per channel row
  for (int r = tid; r < rows * RUNS; r += 256) {
    const int o = r / RUNS, v = r % RUNS;
    const int m = m0 + v * R;
    if (m >= s.M) continue;
    const int n = m / s.HWo;
    store_run<OutT, R>(
        out + ((long long)n * s.O + o0 + o) * s.HWo + (m - n * s.HWo),
        tile + o * ROW + v * R);
  }
}

template <typename OutT, int BN>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<BN>())
conv_s8_wgmma(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const float* __restrict__ sx, const float* __restrict__ sw,
              OutT* __restrict__ out, int* __restrict__ acc_out,
              const ConvShape s) {
  extern __shared__ uint8_t smem_raw[];
  // 1 KB alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + RING_SLOTS;
  float* scales = reinterpret_cast<float*>(smem + 1024);
  uint8_t* ring = smem + HEAD;
  const int tid = threadIdx.x;
  const int o0 = (blockIdx.x % s.o_tiles) * BN;
  const int m0 = (blockIdx.x / s.o_tiles) * BM;
  const int cblocks = s.Cp / s.cb;       // box pairs of one tap
  const int per_stage = STAGE_K / s.cb;  // box pairs a stage holds

  if (tid == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // -- producer: warp 8 -----------------------------------------------------
    if (tid == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      const int n0 = m0 / s.HWo;
      const int r = m0 - n0 * s.HWo;
      const int ho0 = r / s.Wo;
      const int w = r - ho0 * s.Wo + s.lower_w;
      const int h = ho0 + s.lower_h;
      const int a_box = BM * s.cb, b_box = BN * s.cb;
      const int K = s.KH * s.KW * s.Cp;
      int stage = 0, phase = 0, chunk = 0;
      for (int it = 0; it < s.k_iters; ++it) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* a = ring + stage * s.stage_bytes;
        uint8_t* b = a + BM * STAGE_K;
        mbar_expect_tx(&full[stage], (BM + BN) * STAGE_K);
        for (int j = 0; j < per_stage; ++j, ++chunk) {
          // a box pair past K: A at tap 0, B past K's end, zeros
          const int c = chunk < s.chunks ? chunk : 0;
          const int tap = c / cblocks;
          const int ky = tap / s.KW, kx = tap - ky * s.KW;
          const int ch = (c - tap * cblocks) * s.cb;
          tma_im2col(a + j * a_box, &map_a, &full[stage], ch, w, h, n0,
                     (uint16_t)(kx * s.dil), (uint16_t)(ky * s.dil));
          tma_tile(b + j * b_box, &map_b, &full[stage],
                   chunk < s.chunks ? tap * s.Cp + ch : K, o0);
        }
        if (++stage == s.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // -- consumers: warps 0-7, two warpgroups ---------------------------------
    const int half = tid >> 7;      // this warpgroup's 64-row half
    const int lane = tid & 31;
    for (int i = tid; i < BN; i += 256) {
      scales[i] = o0 + i < s.O ? __fmul_rn(*sx, __ldg(sw + o0 + i)) : 0.0f;
    }
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // K step kk (32 bytes) of a stage lies in box pair 32 kk / cb, at byte
    // 32 kk % cb of its rows.
    uint32_t a_off[4], b_off[4];
    const int shift = s.cb == 128 ? 7 : s.cb == 64 ? 6 : 5;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = (32 * kk) >> shift, byte = (32 * kk) & (s.cb - 1);
      a_off[kk] = j * BM * s.cb + half * 64 * s.cb + byte;
      b_off[kk] = BM * STAGE_K + j * BN * s.cb + byte;
    }
    int stage = 0, phase = 0, prev = 0;
    for (int it = 0; it < s.k_iters; ++it) {
      mbar_wait(&full[stage], phase);
      const uint32_t base = smem_u32(ring + stage * s.stage_bytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma<BN>(acc, smem_desc(base + a_off[kk], s.cb),
                  smem_desc(base + b_off[kk], s.cb));
      }
      wgmma_commit();
      if (it > 0) {
        wgmma_wait<1>();   // the previous stage's products are done
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == s.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();

    // -- epilogue --------------------------------------------------------------
    // Every consumer is past the ring (and the scales are written) before
    // the ring becomes the [channel][pixel] float32 tile.
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* tile = reinterpret_cast<float*>(ring);
    const int row0 = half * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int col0 = 2 * (lane & 3);
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * q + col0 + j, row = row0 + 8 * i;
          tile[col * ROW + row] =
              __fmul_rn(__int2float_rn(acc[4 * q + 2 * i + j]), scales[col]);
        }
      }
    }
    if (acc_out != nullptr) {
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int o = o0 + 8 * q + col0 + j, m = m0 + row0 + 8 * i;
            if (o < s.O && m < s.M) {
              const int n = m / s.HWo;
              acc_out[((long long)n * s.O + o) * s.HWo + (m - n * s.HWo)] =
                  acc[4 * q + 2 * i + j];
            }
          }
        }
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int rows = min(BN, s.O - o0);
    switch (s.run) {
      case 8:
        if constexpr (sizeof(OutT) == 2) {
          store_tile<OutT, 8>(out, tile, s, m0, o0, rows, tid);
        }
        break;
      case 4:
        store_tile<OutT, 4>(out, tile, s, m0, o0, rows, tid);
        break;
      case 2:
        store_tile<OutT, 2>(out, tile, s, m0, o0, rows, tid);
        break;
      default:
        store_tile<OutT, 1>(out, tile, s, m0, o0, rows, tid);
    }
  }
}

// -- host side ---------------------------------------------------------------

template <typename T>
int launch_quantize(const void* x, const void* amax, void* q, void* scale,
                    long long N, long long C, long long P, long long Cp,
                    void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PX = 32 * VEC;
  const long long M = N * P;
  const long long m_tiles = (M + PX - 1) / PX;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  const int vec = P % VEC == 0 && base % 16 == 0       ? 2
                  : P % (VEC / 2) == 0 && base % 8 == 0 ? 1
                                                        : 0;
  quantize_kernel<T><<<(unsigned int)(m_tiles * (Cp / 32)), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(amax),
      static_cast<int8_t*>(q), static_cast<float*>(scale), (int)C, P, M,
      (int)Cp, vec);
  return (int)cudaGetLastError();
}

// Error codes past the CUDA runtime's: the driver's tensor-map encoders not
// found, an encoder's CUresult (+ ENCODE_A or ENCODE_B), no K7 instance for
// the plan's BN, or a plan the launcher does not take.
constexpr int ERR_NO_DRIVER_FN = 3000;
constexpr int ERR_ENCODE_A = 1000;
constexpr int ERR_ENCODE_B = 2000;
constexpr int ERR_NO_INSTANCE = 4000;
constexpr int ERR_BAD_PLAN = 5000;

// K5 at the host plan's launch (ops/int8_kernels.py absmax_plan). The
// launcher only checks that the plan covers x with its body on a 16-byte
// boundary, and that the scratch of `scratch_words` holds the ticket and
// one partial per block.
template <typename T>
int launch_absmax(const void* x, void* amax, void* scratch, long long head,
                  long long body_bytes, long long tail, long long blocks,
                  long long scratch_words, void* stream) {
  constexpr long long VEC = 16 / sizeof(T);
  const uintptr_t body =
      reinterpret_cast<uintptr_t>(x) + (uintptr_t)head * sizeof(T);
  if (blocks < 1 || blocks > scratch_words - 1 || head < 0 || head >= VEC ||
      tail < 0 || tail >= VEC || body_bytes < 0 || body_bytes % 16 != 0 ||
      (body_bytes > 0 && body % 16 != 0)) {
    return ERR_BAD_PLAN;
  }
  absmax_kernel<T><<<(unsigned int)blocks, K5_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), head, body_bytes, tail,
      static_cast<unsigned int*>(scratch), static_cast<float*>(amax));
  return (int)cudaGetLastError();
}

void* driver_fn(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &fn, 12000, cudaEnableDefault, &status);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &status);
#endif
  return err == cudaSuccess && status == cudaDriverEntryPointSuccess ? fn
                                                                     : nullptr;
}

using EncodeIm2col = decltype(&cuTensorMapEncodeIm2col);
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

CUtensorMapSwizzle swizzle_of(int cb) {
  return cb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : cb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <typename OutT, int BN>
int launch_conv_bn(const CUtensorMap& map_a, const CUtensorMap& map_b,
                   const void* sx, const void* sw, void* out, void* acc,
                   const ConvShape& s, int m_tiles, int blocks_per_sm_plan,
                   int smem, cudaStream_t stream) {
  // The plan's shared-memory budget assumed this instance's occupancy,
  // and its buffers must hold the ring and the epilogue's tile.
  if (blocks_per_sm_plan != blocks_per_sm<BN>() ||
      s.stage_bytes < (BM + BN) * STAGE_K ||
      smem < 1024 + HEAD + s.stages * s.stage_bytes ||
      smem < 1024 + HEAD + BN * ROW * 4 || (long long)m_tiles * BM < s.M ||
      (long long)s.o_tiles * BN < s.O) {
    return ERR_BAD_PLAN;
  }
  auto kernel = conv_s8_wgmma<OutT, BN>;
  // The shared memory cap above 48 KB, once per instance and device.
  static int cap_set[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cap_set[dev] < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cap_set[dev] = smem;
  }
  kernel<<<(unsigned int)(m_tiles * s.o_tiles), THREADS, smem, stream>>>(
      map_a, map_b, static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<OutT*>(out),
      static_cast<int*>(acc), s);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_conv(const void* xq, const void* wq, const void* sx,
                const void* sw, void* out, void* acc, long long N,
                long long H, long long W, long long Cp, long long O,
                long long KH, long long KW, long long dil, long long Ho,
                long long Wo, long long bn, long long cb, long long chunks,
                long long k_iters, long long stages, long long blocks_per_sm,
                long long stage_bytes, long long m_tiles, long long o_tiles,
                long long run, long long lower_w, long long lower_h,
                long long upper_w, long long upper_h, long long smem,
                void* stream) {
  static EncodeIm2col encode_im2col =
      reinterpret_cast<EncodeIm2col>(driver_fn("cuTensorMapEncodeIm2col"));
  static EncodeTiled encode_tiled =
      reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
  if (encode_im2col == nullptr || encode_tiled == nullptr) {
    return ERR_NO_DRIVER_FN;
  }
  const long long K = KH * KW * Cp;
  if (stages < 2 || stages > RING_SLOTS || Cp % cb != 0 ||
      (cb != 32 && cb != 64 && cb != 128) || chunks * cb != K ||
      k_iters * (STAGE_K / cb) < chunks || stage_bytes % 1024 != 0 ||
      run < 1 || run * (long long)sizeof(OutT) > 16 ||
      (run & (run - 1)) != 0 || (Ho * Wo) % run != 0) {
    return ERR_BAD_PLAN;
  }
  const CUtensorMapSwizzle swizzle = swizzle_of((int)cb);

  // A: the codes (N, H, W, Cp) as a rank-4 im2col map, innermost first.
  CUtensorMap map_a, map_b;
  const cuuint64_t a_dim[4] = {(cuuint64_t)Cp, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)N};
  const cuuint64_t a_stride[3] = {(cuuint64_t)Cp, (cuuint64_t)(W * Cp),
                                  (cuuint64_t)(H * W * Cp)};
  const int lower[2] = {(int)lower_w, (int)lower_h};
  const int upper[2] = {(int)upper_w, (int)upper_h};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult res = encode_im2col(
      &map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(xq), a_dim,
      a_stride, lower, upper, (cuuint32_t)cb, (cuuint32_t)BM, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return ERR_ENCODE_A + (int)res;
  // B: the weight codes as (O, K), a (bn, cb) box.
  const cuuint64_t b_dim[2] = {(cuuint64_t)K, (cuuint64_t)O};
  const cuuint64_t b_stride[1] = {(cuuint64_t)K};
  const cuuint32_t b_box[2] = {(cuuint32_t)cb, (cuuint32_t)bn};
  res = encode_tiled(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                     const_cast<void*>(wq), b_dim, b_stride, b_box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return ERR_ENCODE_B + (int)res;

  ConvShape s;
  s.N = (int)N;
  s.Cp = (int)Cp;
  s.O = (int)O;
  s.KH = (int)KH;
  s.KW = (int)KW;
  s.dil = (int)dil;
  s.Wo = (int)Wo;
  s.HWo = (int)(Ho * Wo);
  s.M = (int)(N * Ho * Wo);
  s.lower_w = (int)lower_w;
  s.lower_h = (int)lower_h;
  s.cb = (int)cb;
  s.chunks = (int)chunks;
  s.k_iters = (int)k_iters;
  s.stage_bytes = (int)stage_bytes;
  s.run = (int)run;
  s.stages = (int)stages;
  s.o_tiles = (int)o_tiles;
  const int tiles = (int)m_tiles, bps = (int)blocks_per_sm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8:
      return launch_conv_bn<OutT, 8>(map_a, map_b, sx, sw, out, acc, s,
                                     tiles, bps, (int)smem, st);
    case 64:
      return launch_conv_bn<OutT, 64>(map_a, map_b, sx, sw, out, acc, s,
                                      tiles, bps, (int)smem, st);
    case 128:
      return launch_conv_bn<OutT, 128>(map_a, map_b, sx, sw, out, acc, s,
                                       tiles, bps, (int)smem, st);
    case 256:
      return launch_conv_bn<OutT, 256>(map_a, map_b, sx, sw, out, acc, s,
                                       tiles, bps, (int)smem, st);
    default:
      return ERR_NO_INSTANCE;
  }
}

}  // namespace

// C launchers (ops/_build.py _ARGTYPES). Each returns a cudaError_t, or one
// of the ERR_* codes above.

#define INT8_ABSMAX_ARGS                                                    \
  const void *x, void *amax, void *scratch, long long head,                 \
      long long body_bytes, long long tail, long long blocks,               \
      long long scratch_words, void *stream
#define INT8_ABSMAX_PASS                                                    \
  x, amax, scratch, head, body_bytes, tail, blocks, scratch_words, stream

extern "C" int int8_absmax_f32(INT8_ABSMAX_ARGS) {
  return launch_absmax<float>(INT8_ABSMAX_PASS);
}
extern "C" int int8_absmax_bf16(INT8_ABSMAX_ARGS) {
  return launch_absmax<__nv_bfloat16>(INT8_ABSMAX_PASS);
}

extern "C" int int8_quantize_f32(const void* x, const void* amax, void* q,
                                 void* scale, long long N, long long C,
                                 long long P, long long Cp, void* stream) {
  return launch_quantize<float>(x, amax, q, scale, N, C, P, Cp, stream);
}
extern "C" int int8_quantize_bf16(const void* x, const void* amax, void* q,
                                  void* scale, long long N, long long C,
                                  long long P, long long Cp, void* stream) {
  return launch_quantize<__nv_bfloat16>(x, amax, q, scale, N, C, P, Cp,
                                        stream);
}

#define INT8_CONV_ARGS                                                      \
  const void *xq, const void *wq, const void *sx, const void *sw, void *out, \
      void *acc, long long N, long long H, long long W, long long Cp,        \
      long long O, long long KH, long long KW, long long dil, long long Ho,  \
      long long Wo, long long bn, long long cb, long long chunks,            \
      long long k_iters, long long stages, long long blocks_per_sm,          \
      long long stage_bytes, long long m_tiles, long long o_tiles,           \
      long long run, long long lower_w, long long lower_h,                   \
      long long upper_w, long long upper_h, long long smem, void *stream
#define INT8_CONV_PASS                                                       \
  xq, wq, sx, sw, out, acc, N, H, W, Cp, O, KH, KW, dil, Ho, Wo, bn, cb,     \
      chunks, k_iters, stages, blocks_per_sm, stage_bytes, m_tiles, o_tiles, \
      run, lower_w, lower_h, upper_w, upper_h, smem, stream

extern "C" int int8_conv_f32(INT8_CONV_ARGS) {
  return launch_conv<float>(INT8_CONV_PASS);
}
extern "C" int int8_conv_bf16(INT8_CONV_ARGS) {
  return launch_conv<__nv_bfloat16>(INT8_CONV_PASS);
}
