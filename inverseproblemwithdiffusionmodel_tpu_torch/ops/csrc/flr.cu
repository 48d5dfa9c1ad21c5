// Fused bias + leaky ReLU on rows x C float32 (channel innermost), forward
// and backward.
//
// Replaces the TPU kernel fused_leaky_relu_pallas
// (inverseproblemwithdiffusionmodel_tpu/ops/pallas_kernels.py:61): its
// forward body _flr_fwd_kernel (:50) and the backward body _flr_bwd_kernel
// (:55) of its VJP (_flr_bwd, :84). The TPU kernels hold the whole array in
// VMEM and run one elementwise pass.
//
//   forward:  v = x + b[c],  y  = scale * (v >= 0 ? v : slope * v)
//   backward: v = x + b[c],  dx = g * (v >= 0 ? scale : scale * slope)
//
// The bias gradient db = sum over rows of dx stays a torch reduction, as it
// is an XLA reduction outside the TPU kernel (:98).
//
// Bound: device-memory bytes. A few operations per element against 8
// (forward: read x, write y) or 12 (backward: read x and g, write dx) bytes,
// plus 4 C for the bias, far below the card's ratio of compute to bandwidth.
//
// Design: one pass, a grid-stride loop with 64-bit indexing; v is
// recomputed from x and b in the backward rather than saved. Where C is a
// multiple of 4 and every pointer is 16-byte aligned, each thread moves one
// float4 (four channels of one row, one 16-byte load per operand); otherwise
// one float per thread. The bias is read through the read-only cache.

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
