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
//   K5  absmax:      amax = max |x| over the whole tensor (the batch too)
//   K6  quantize_s8: scale = max(amax, 1e-12) / 127 (float32),
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
// the quantization, as quantized zeros, and do not move amax. So K7's int32
// sums and its dequantized output equal the plain version (a float64
// convolution of the same codes, exact since |sum| <= 127^2 * K < 2^53) bit
// for bit.
//
// Bounds. K5 and K6 move bytes: one read of x (K6 also writes a quarter or
// half of x's bytes as codes). K7 is an implicit GEMM of M = N * Ho * Wo
// output pixels by O output channels over K = KH * KW * Cp; at the score
// nets' 3x3 convolutions of 128 channels its 2 M O K operations on the int8
// tensor cores (1,979 TOP/s dense on an H100 SXM) outweigh its bytes.
//
// Design of K7, a first simple form (wgmma and TMA are later work): a block
// computes a 128 x 128 tile of (pixels, output channels) with 8 warps of
// 64 x 32, each issuing mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on
// fragments loaded by ldmatrix (one instruction per 16 x 32-byte A or two
// 8 x 32-byte B fragments); the K loop steps 64 bytes at a time through a
// two-stage cp.async ring in shared memory. A row of a tile is 64 bytes of
// one tap of one pixel, gathered from the channels-last codes (a 16-byte
// chunk never straddles a tap, since Cp is a multiple of 32); a chunk
// outside the image or past K is filled with zeros by cp.async's source
// size. Shared rows are 80 bytes apart, so the eight rows each ldmatrix
// phase reads fall in distinct banks. The epilogue dequantizes in
// registers and writes the output channels-first (N, O, Ho, Wo), the
// port's layout, and optionally the int32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// -- K5: the per-tensor |x| maximum ----------------------------------------

// The largest |value| of 16 bytes of float32 (4 values) or bf16 (8 values).
__device__ __forceinline__ float absmax16(uint4 v, float) {
  return fmaxf(fmaxf(fabsf(__uint_as_float(v.x)), fabsf(__uint_as_float(v.y))),
               fmaxf(fabsf(__uint_as_float(v.z)), fabsf(__uint_as_float(v.w))));
}
__device__ __forceinline__ float absmax_bf2(unsigned int u) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned int*>(&h) = u;
  const float2 f = __bfloat1622float2(h);
  return fmaxf(fabsf(f.x), fabsf(f.y));
}
__device__ __forceinline__ float absmax16(uint4 v, __nv_bfloat16) {
  return fmaxf(fmaxf(absmax_bf2(v.x), absmax_bf2(v.y)),
               fmaxf(absmax_bf2(v.z), absmax_bf2(v.w)));
}

// Grid-stride over 16-byte vectors, then the scalar tail; a warp and then
// a block reduction, and one atomicMax per block on the float's bits (a
// non-negative float orders as its int bits). amax starts at 0.
template <typename T>
__global__ void __launch_bounds__(256)
absmax_kernel(const T* __restrict__ x, long long n, long long n_vec,
              float* __restrict__ amax) {
  constexpr int VEC = 16 / sizeof(T);
  float m = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (long long i = first; i < n_vec; i += stride) {
    m = fmaxf(m, absmax16(xv[i], T()));
  }
  for (long long i = n_vec * VEC + first; i < n; i += stride) {
    m = fmaxf(m, fabsf(to_f32(x[i])));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  __shared__ float warp_max[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) atomicMax(reinterpret_cast<int*>(amax), __float_as_int(m));
  }
}

// -- K6: x -> channels-last int8 codes -------------------------------------

__device__ __forceinline__ int quantize(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

// x is (N, C, P) contiguous, P the flattened spatial size. One thread per
// (pixel, 32-channel group): reads 32 channels (neighbouring threads read
// neighbouring pixels) and writes the group's 32 codes as two 16-byte
// stores, a whole sector. Channels c >= C get code 0. Block 0's first
// thread also writes the scale for K7.
template <typename T>
__global__ void __launch_bounds__(256)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ amax,
                int8_t* __restrict__ q, float* __restrict__ scale_out,
                long long N, long long C, long long P, long long Cp) {
  const float scale = __fdiv_rn(fmaxf(*amax, 1e-12f), 127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const long long groups = Cp / 32;
  const long long total = N * P * groups;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long p = i % P;
    const long long rest = i / P;
    const long long n = rest % N;
    const long long g = rest / N;
    const T* xp = x + n * C * P + p;
    unsigned int words[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      unsigned int word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const long long c = g * 32 + w * 4 + b;
        const int code = c < C ? quantize(to_f32(xp[c * P]), scale) : 0;
        word |= (unsigned int)(code & 0xff) << (8 * b);
      }
      words[w] = word;
    }
    uint4* dst = reinterpret_cast<uint4*>(q + (n * P + p) * Cp + g * 32);
    dst[0] = make_uint4(words[0], words[1], words[2], words[3]);
    dst[1] = make_uint4(words[4], words[5], words[6], words[7]);
  }
}

// -- K7: implicit-GEMM convolution on the int8 tensor cores ----------------

constexpr int BM = 128;        // output pixels per block
constexpr int BN = 128;        // output channels per block
constexpr int BK = 64;         // bytes of K per stage
constexpr int LDS = BK + 16;   // shared row pitch: 80 bytes, no bank conflicts
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Four 8 x 16-byte matrices from shared memory, one register each: lanes
// 8i..8i+7 give the row addresses of matrix i, and lane l receives bytes
// 4 (l % 4) .. 4 (l % 4) + 3 of row l / 4 of every matrix, the fragment
// layout of mma.m16n8k32's int8 operands.
__device__ __forceinline__ void ldmatrix_x4(unsigned int* r,
                                            const int8_t* p) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned int* a,
                                       const unsigned int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
conv_s8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
               const float* __restrict__ sx, const float* __restrict__ sw,
               OutT* __restrict__ out, int* __restrict__ acc_out, int N,
               int H, int W, int Cp, int O, int KH, int KW, int pad_h,
               int pad_w, int dil, int Ho, int Wo) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int wm = warp & 1, wn = warp >> 1;     // warp tile 64 x 32
  const long long HWo = (long long)Ho * Wo;
  const long long M = (long long)N * HWo;
  const int K = KH * KW * Cp;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // This thread's A row (one output pixel), B row (one output channel),
  // and the two 16-byte chunks of each it copies per stage.
  const int row = tid >> 1;
  const int chunk0 = (tid & 1) * 2;
  const long long am = m0 + row;
  const bool a_ok = am < M;
  int a_n = 0, a_ho = 0, a_wo = 0;
  if (a_ok) {
    a_n = (int)(am / HWo);
    const int r = (int)(am - (long long)a_n * HWo);
    a_ho = r / Wo;
    a_wo = r - a_ho * Wo;
  }
  const bool b_ok = n0 + row < O;
  const int8_t* b_src = wq + (long long)(b_ok ? n0 + row : 0) * K;

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int chunk = chunk0 + j;
      const int kk = k0 + chunk * 16;
      const int8_t* src = xq;
      int bytes = 0;
      if (a_ok && kk < K) {
        const int tap = kk / Cp;
        const int c = kk - tap * Cp;
        const int ky = tap / KW;
        const int kx = tap - ky * KW;
        const int hi = a_ho - pad_h + ky * dil;
        const int wi = a_wo - pad_w + kx * dil;
        if (hi >= 0 && hi < H && wi >= 0 && wi < W) {
          src = xq + (((long long)a_n * H + hi) * W + wi) * Cp + c;
          bytes = 16;
        }
      }
      cp_async16(&As[stage][row * LDS + chunk * 16], src, bytes);
      const bool bk = b_ok && kk < K;
      cp_async16(&Bs[stage][row * LDS + chunk * 16], bk ? b_src + kk : wq,
                 bk ? 16 : 0);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8.
  const int lm = lane >> 3, lr = lane & 7;
  const int a_off = (wm * 64 + (lm & 1) * 8 + lr) * LDS + (lm >> 1) * 16;
  const int b_off = (wn * 32 + (lm >> 1) * 8 + lr) * LDS + (lm & 1) * 16;

  const int nk = (K + BK - 1) / BK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int8_t* as = As[kt & 1];
    const int8_t* bs = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned int a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldmatrix_x4(a[mi], as + a_off + mi * 16 * LDS + ks);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned int r[4];
        ldmatrix_x4(r, bs + b_off + p * 16 * LDS + ks);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  const float sxv = *sx;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + wn * 32 + ni * 8 + t * 2 + j;
      if (o >= O) continue;
      const float s = __fmul_rn(sxv, __ldg(sw + o));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + wm * 64 + mi * 16 + g + h * 8;
          if (m >= M) continue;
          const long long n = m / HWo;
          const long long idx = (n * O + o) * HWo + (m - n * HWo);
          const int v = acc[mi][ni][h * 2 + j];
          store(out + idx, __fmul_rn(__int2float_rn(v), s));
          if (acc_out != nullptr) acc_out[idx] = v;
        }
      }
    }
  }
}

int blocks_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  if (b > 132LL * 16) b = 132LL * 16;   // 16 blocks of 256 per SM, then loop
  return b < 1 ? 1 : (int)b;
}

template <typename T>
int launch_absmax(const void* x, long long n, void* amax, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long n_vec =
      (reinterpret_cast<uintptr_t>(x) % 16 == 0) ? n / VEC : 0;
  absmax_kernel<T><<<blocks_for(n_vec ? n_vec : n, 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), n, n_vec, static_cast<float*>(amax));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quantize(const void* x, const void* amax, void* q, void* scale,
                    long long N, long long C, long long P, long long Cp,
                    void* stream) {
  quantize_kernel<T><<<blocks_for(N * P * (Cp / 32), 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(amax),
      static_cast<int8_t*>(q), static_cast<float*>(scale), N, C, P, Cp);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_conv(const void* xq, const void* wq, const void* sx,
                const void* sw, void* out, void* acc, long long N,
                long long H, long long W, long long Cp, long long O,
                long long KH, long long KW, long long pad_h, long long pad_w,
                long long dil, long long Ho, long long Wo, void* stream) {
  const long long M = N * Ho * Wo;
  const dim3 grid((unsigned int)((M + BM - 1) / BM),
                  (unsigned int)((O + BN - 1) / BN));
  conv_s8_kernel<OutT><<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<OutT*>(out), static_cast<int*>(acc), (int)N, (int)H,
      (int)W, (int)Cp, (int)O, (int)KH, (int)KW, (int)pad_h, (int)pad_w,
      (int)dil, (int)Ho, (int)Wo);
  return (int)cudaGetLastError();
}

}  // namespace

// C launchers (ops/_build.py _ARGTYPES). Each returns a cudaError_t.

extern "C" int int8_absmax_f32(const void* x, long long n, void* amax,
                               void* stream) {
  return launch_absmax<float>(x, n, amax, stream);
}
extern "C" int int8_absmax_bf16(const void* x, long long n, void* amax,
                                void* stream) {
  return launch_absmax<__nv_bfloat16>(x, n, amax, stream);
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

extern "C" int int8_conv_f32(const void* xq, const void* wq, const void* sx,
                             const void* sw, void* out, void* acc,
                             long long N, long long H, long long W,
                             long long Cp, long long O, long long KH,
                             long long KW, long long pad_h, long long pad_w,
                             long long dil, long long Ho, long long Wo,
                             void* stream) {
  return launch_conv<float>(xq, wq, sx, sw, out, acc, N, H, W, Cp, O, KH, KW,
                            pad_h, pad_w, dil, Ho, Wo, stream);
}
extern "C" int int8_conv_bf16(const void* xq, const void* wq, const void* sx,
                              const void* sw, void* out, void* acc,
                              long long N, long long H, long long W,
                              long long Cp, long long O, long long KH,
                              long long KW, long long pad_h, long long pad_w,
                              long long dil, long long Ho, long long Wo,
                              void* stream) {
  return launch_conv<__nv_bfloat16>(xq, wq, sx, sw, out, acc, N, H, W, Cp, O,
                                    KH, KW, pad_h, pad_w, dil, Ho, Wo, stream);
}
