// Fused bias + leaky ReLU on rows x C (channel innermost), float32 and
// bf16, forward and backward.
//
// Replaces the TPU kernel fused_leaky_relu_pallas
// (inverseproblemwithdiffusionmodel_tpu/ops/pallas_kernels.py:61): its
// forward body _flr_fwd_kernel (:50) and the backward body _flr_bwd_kernel
// (:55) of its VJP (_flr_bwd, :84). The TPU kernels hold the whole array in
// VMEM and run one elementwise pass, in the input's dtype.
//
//   forward:  v = x + b[c],  y  = scale * (v >= 0 ? v : slope * v)
//   backward: v = x + b[c],  dx = g * (v >= 0 ? scale : scale * slope)
//
// The bias gradient db = sum over rows of dx stays a torch reduction, as it
// is an XLA reduction outside the TPU kernel (:98).
//
// Bound: device-memory bytes. A few operations per element against 8
// (forward: read x, write y) or 12 (backward: read x and g, write dx) bytes
// in float32, half that in bf16, plus the bias, far below the card's ratio
// of compute to bandwidth.
//
// Design: one pass, a grid-stride loop with 64-bit indexing; v is
// recomputed from x and b in the backward rather than saved. Where C is a
// multiple of the vector and every pointer is 16-byte aligned, each thread
// moves 16 bytes per operand: a float4 (four channels of one row) or a
// uint4 of 8 bf16; otherwise one element per thread. The bias is read
// through the read-only cache. bf16 is a storage type only: each value is
// widened to float32, the arithmetic is the float32 form's, and the result
// is rounded to bf16 once, at the store, so the kernel is bit-equal to its
// plain version (ops/fused_act.py and ops/flr_kernels.py, float32 inside).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float act(float v, float slope, float scale) {
  return scale * (v >= 0.0f ? v : slope * v);
}

// The backward takes scale and scale * slope as two numbers, multiplied on
// the host as the JAX package does, so that dx matches it bit for bit.
__device__ __forceinline__ float dact(float v, float pos, float neg) {
  return v >= 0.0f ? pos : neg;
}

__global__ void flr_fwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ b,
                               float* __restrict__ y, long long n, long long C,
                               float slope, float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = act(x[i] + __ldg(b + i % C), slope, scale);
  }
}

__global__ void flr_fwd_kernel4(const float4* __restrict__ x,
                                const float* __restrict__ b,
                                float4* __restrict__ y, long long n4,
                                long long C, float slope, float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const long long c = (4 * i) % C;
    const float4 v = x[i];
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b + c));
    y[i] = make_float4(act(v.x + bb.x, slope, scale),
                       act(v.y + bb.y, slope, scale),
                       act(v.z + bb.z, slope, scale),
                       act(v.w + bb.w, slope, scale));
  }
}

__global__ void flr_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ b,
                               const float* __restrict__ g,
                               float* __restrict__ dx, long long n,
                               long long C, float pos, float neg) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    dx[i] = g[i] * dact(x[i] + __ldg(b + i % C), pos, neg);
  }
}

__global__ void flr_bwd_kernel4(const float4* __restrict__ x,
                                const float* __restrict__ b,
                                const float4* __restrict__ g,
                                float4* __restrict__ dx, long long n4,
                                long long C, float pos, float neg) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const long long c = (4 * i) % C;
    const float4 v = x[i];
    const float4 gg = g[i];
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b + c));
    dx[i] = make_float4(gg.x * dact(v.x + bb.x, pos, neg),
                        gg.y * dact(v.y + bb.y, pos, neg),
                        gg.z * dact(v.z + bb.z, pos, neg),
                        gg.w * dact(v.w + bb.w, pos, neg));
  }
}

// -- bf16: widened to float32, rounded once at the store ------------------

__device__ __forceinline__ float2 bf2_to_f2(unsigned int u) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned int*>(&h) = u;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ unsigned int f2_to_bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<unsigned int*>(&h);
}

// Two neighbouring channels: packed bf16 x and b in, packed bf16 y out.
__device__ __forceinline__ unsigned int act2(unsigned int x, unsigned int b,
                                             float slope, float scale) {
  const float2 xv = bf2_to_f2(x), bv = bf2_to_f2(b);
  return f2_to_bf2(act(xv.x + bv.x, slope, scale),
                   act(xv.y + bv.y, slope, scale));
}

__device__ __forceinline__ unsigned int dact2(unsigned int x, unsigned int b,
                                              unsigned int g, float pos,
                                              float neg) {
  const float2 xv = bf2_to_f2(x), bv = bf2_to_f2(b), gv = bf2_to_f2(g);
  return f2_to_bf2(gv.x * dact(xv.x + bv.x, pos, neg),
                   gv.y * dact(xv.y + bv.y, pos, neg));
}

__global__ void flr_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                    const __nv_bfloat16* __restrict__ b,
                                    __nv_bfloat16* __restrict__ y,
                                    long long n, long long C, float slope,
                                    float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = __float2bfloat16_rn(act(
        __bfloat162float(x[i]) + __bfloat162float(__ldg(b + i % C)), slope,
        scale));
  }
}

// Eight channels of one row per thread: one uint4 of x, of b and of y.
__global__ void flr_fwd_bf16_kernel8(const uint4* __restrict__ x,
                                     const __nv_bfloat16* __restrict__ b,
                                     uint4* __restrict__ y, long long n8,
                                     long long C, float slope, float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += stride) {
    const long long c = (8 * i) % C;
    const uint4 v = x[i];
    const uint4 bb = __ldg(reinterpret_cast<const uint4*>(b + c));
    y[i] = make_uint4(act2(v.x, bb.x, slope, scale),
                      act2(v.y, bb.y, slope, scale),
                      act2(v.z, bb.z, slope, scale),
                      act2(v.w, bb.w, slope, scale));
  }
}

__global__ void flr_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                    const __nv_bfloat16* __restrict__ b,
                                    const __nv_bfloat16* __restrict__ g,
                                    __nv_bfloat16* __restrict__ dx,
                                    long long n, long long C, float pos,
                                    float neg) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    dx[i] = __float2bfloat16_rn(
        __bfloat162float(g[i]) *
        dact(__bfloat162float(x[i]) + __bfloat162float(__ldg(b + i % C)),
             pos, neg));
  }
}

__global__ void flr_bwd_bf16_kernel8(const uint4* __restrict__ x,
                                     const __nv_bfloat16* __restrict__ b,
                                     const uint4* __restrict__ g,
                                     uint4* __restrict__ dx, long long n8,
                                     long long C, float pos, float neg) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += stride) {
    const long long c = (8 * i) % C;
    const uint4 v = x[i];
    const uint4 gg = g[i];
    const uint4 bb = __ldg(reinterpret_cast<const uint4*>(b + c));
    dx[i] = make_uint4(dact2(v.x, bb.x, gg.x, pos, neg),
                       dact2(v.y, bb.y, gg.y, pos, neg),
                       dact2(v.z, bb.z, gg.z, pos, neg),
                       dact2(v.w, bb.w, gg.w, pos, neg));
  }
}

int grid_for(long long total, int threads) {
  // Enough blocks to fill the card several times over; the grid-stride
  // loop covers the rest.
  const long long max_blocks = 132LL * 32;
  const long long blocks = (total + threads - 1) / threads;
  return (int)(blocks < max_blocks ? blocks : max_blocks);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int flr_fwd_f32(const float* x, const float* b, float* y,
                           long long rows, long long C, float slope,
                           float scale, cudaStream_t stream) {
  const long long n = rows * C;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  if (C % 4 == 0 && aligned16(x) && aligned16(b) && aligned16(y)) {
    flr_fwd_kernel4<<<grid_for(n / 4, threads), threads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), b, reinterpret_cast<float4*>(y),
        n / 4, C, slope, scale);
  } else {
    flr_fwd_kernel<<<grid_for(n, threads), threads, 0, stream>>>(
        x, b, y, n, C, slope, scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int flr_bwd_f32(const float* x, const float* b, const float* g,
                           float* dx, long long rows, long long C, float pos,
                           float neg, cudaStream_t stream) {
  const long long n = rows * C;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  if (C % 4 == 0 && aligned16(x) && aligned16(b) && aligned16(g) &&
      aligned16(dx)) {
    flr_bwd_kernel4<<<grid_for(n / 4, threads), threads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), b,
        reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(dx),
        n / 4, C, pos, neg);
  } else {
    flr_bwd_kernel<<<grid_for(n, threads), threads, 0, stream>>>(
        x, b, g, dx, n, C, pos, neg);
  }
  return (int)cudaGetLastError();
}

extern "C" int flr_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* b,
                            __nv_bfloat16* y, long long rows, long long C,
                            float slope, float scale, cudaStream_t stream) {
  const long long n = rows * C;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  if (C % 8 == 0 && aligned16(x) && aligned16(b) && aligned16(y)) {
    flr_fwd_bf16_kernel8<<<grid_for(n / 8, threads), threads, 0, stream>>>(
        reinterpret_cast<const uint4*>(x), b, reinterpret_cast<uint4*>(y),
        n / 8, C, slope, scale);
  } else {
    flr_fwd_bf16_kernel<<<grid_for(n, threads), threads, 0, stream>>>(
        x, b, y, n, C, slope, scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int flr_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* b,
                            const __nv_bfloat16* g, __nv_bfloat16* dx,
                            long long rows, long long C, float pos, float neg,
                            cudaStream_t stream) {
  const long long n = rows * C;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  if (C % 8 == 0 && aligned16(x) && aligned16(b) && aligned16(g) &&
      aligned16(dx)) {
    flr_bwd_bf16_kernel8<<<grid_for(n / 8, threads), threads, 0, stream>>>(
        reinterpret_cast<const uint4*>(x), b,
        reinterpret_cast<const uint4*>(g), reinterpret_cast<uint4*>(dx),
        n / 8, C, pos, neg);
  } else {
    flr_bwd_bf16_kernel<<<grid_for(n, threads), threads, 0, stream>>>(
        x, b, g, dx, n, C, pos, neg);
  }
  return (int)cudaGetLastError();
}
