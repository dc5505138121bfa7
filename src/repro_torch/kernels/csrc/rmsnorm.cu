// RMSNorm over rows for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `rmsnorm` / `_rmsnorm_kernel` in
// src/repro/kernels/rmsnorm.py. Per row of x (R, d):
//
//   y = x * rsqrt(mean(x^2) + eps) * scale
//
// with the sum of squares in float32 and y stored in x's type (float32 or
// bfloat16); scale (d,) is float32 or bfloat16 on its own.
//
// What bounds it on the H100: bytes. It does ~4 operations per element
// read, far below the ~20 operations per byte at which float32 FMA would
// limit it, so the least time is x read once and y written once at 3.35
// TB/s. At decode sizes (8 rows) it is one launch's latency.
//
// What this design does about that: one block per row, one thread per
// 16-byte vector of the row (8 bf16 or 4 float32 values; up to 1024
// threads, looping past that), so each element is loaded once in a 16-byte
// access by neighbouring threads on neighbouring addresses. The row's
// squares are summed in registers, then across the warp by shuffles and
// across warps through shared memory; the second pass reads the row again
// (from L1/L2, it was just read) to scale and store it. A row whose width,
// stride or base is not 16-byte aligned takes the same code one element at
// a time, so any d works. The TPU kernel's (256, d) row tile and its row
// padding have no counterpart: a block never needs more than one row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ y, long long row_stride, int d,
                   float eps) {
  __shared__ float warp_sum[MAX_THREADS / 32];
  const T* X = x + blockIdx.x * row_stride;
  T* Y = y + (long long)blockIdx.x * d;
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    const Vec<T, VEC> p = reinterpret_cast<const Vec<T, VEC>*>(X)[c];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f32(p.v[e]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    ss = lane < nwarps ? warp_sum[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) warp_sum[0] = ss;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_sum[0] / (float)d + eps);

  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    const Vec<T, VEC> p = reinterpret_cast<const Vec<T, VEC>*>(X)[c];
    Vec<T, VEC> q;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      from_f32(to_f32(p.v[e]) * inv * to_f32(scale[c * VEC + e]), &q.v[e]);
    reinterpret_cast<Vec<T, VEC>*>(Y)[c] = q;
  }
}

template <typename T, typename S>
cudaError_t launch(const T* x, const S* scale, T* y, long long rows,
                   long long row_stride, int d, float eps,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && row_stride % V == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const int nvec = vec ? d / V : d;
  const int threads = min(MAX_THREADS, max(32, (nvec + 31) / 32 * 32));
  if (vec)
    rmsnorm_kernel<T, S, V>
        <<<(unsigned)rows, threads, 0, stream>>>(x, scale, y, row_stride, d,
                                                 eps);
  else
    rmsnorm_kernel<T, S, 1>
        <<<(unsigned)rows, threads, 0, stream>>>(x, scale, y, row_stride, d,
                                                 eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_s(const void* x, const void* scale, void* y,
                     long long rows, long long row_stride, int d, float eps,
                     int scale_dtype, cudaStream_t stream) {
  if (scale_dtype == 0)
    return launch<T, float>((const T*)x, (const float*)scale, (T*)y, rows,
                            row_stride, d, eps, stream);
  if (scale_dtype == 1)
    return launch<T, __nv_bfloat16>((const T*)x, (const __nv_bfloat16*)scale,
                                    (T*)y, rows, row_stride, d, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype / scale_dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal
// of the tensors, made current for the launch. x: rows of d elements at
// row_stride elements apart (unit stride inside a row); y: contiguous
// (rows, d) in x's type. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a type or size it does not take).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y,
                           long long rows, long long row_stride, int d,
                           float eps, int dtype, int scale_dtype, int device,
                           void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_s<float>(x, scale, y, rows, row_stride, d, eps,
                                scale_dtype, st);
  if (dtype == 1)
    return (int)launch_s<__nv_bfloat16>(x, scale, y, rows, row_stride, d, eps,
                                        scale_dtype, st);
  return (int)cudaErrorInvalidValue;
}
