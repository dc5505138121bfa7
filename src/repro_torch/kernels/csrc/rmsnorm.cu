// RMSNorm over rows for Hopper (sm_90a), hand-written CUDA C++, with the
// row it normalises formed inside the same launch.
//
// Replaces the Pallas TPU kernel `rmsnorm` / `_rmsnorm_kernel` in
// src/repro/kernels/rmsnorm.py. Per row of s (R, d):
//
//   y = s * rsqrt(mean(s^2) + eps) * scale
//
// with the sum of squares in float32 and y stored in the row's type T
// (float32 or bfloat16); scale (d,) is float32 or bfloat16 on its own. The
// row s is formed by a compile-time prologue from what the model holds:
//
//   PLAIN    s = x
//   ADD      s = round_T(x + delta), also written out (the new residual
//            stream, bit-identical to PyTorch's x + delta: a float32 sum
//            rounded once); the norm reads the rounded s
//   CAT      s = [x | e], two segments of d1 and d2 read through their
//            own base pointers and row strides (Zamba2's shared block);
//            no concatenated tensor is ever written
//   ADD_CAT  s = [round_T(x + delta) | e], x + delta written out
//   GATE     s = round_T(y * silu(z)), y and z float32, silu(z) = z / (1 +
//            expf(-z)) in float32 as F.silu computes it (Mamba2's gate;
//            built without --use_fast_math)
//
// What bounds it on the H100: bytes. It does a few operations per element
// read, far below the ~20 operations per byte at which float32 FMA would
// limit it, so the least time is each input read once and each output
// written once at 3.35 TB/s. At decode sizes (8 rows) it is one launch's
// latency; what the engine loses there lies around the call, in the
// separate elementwise launches that formed the row in device memory.
//
// What this design does about that: the row is formed in a prologue (one
// launch instead of two to four) and kept in registers, so the inputs are
// read once (one pass; the earlier kernel read the row twice). One block
// per row, one thread per 16-byte vector of it (8 bf16 or 4 float32
// values), up to 1,024 threads and then NV vectors a thread: measured
// against fewer, fuller warps (one warp holding 8 vectors a thread at d
// 2048 bf16), this was faster at every main-path shape (PERF.md). Vector c
// of the row belongs to thread c % blockDim at slot c / blockDim, whatever
// segment it comes from, so a formed row is summed in the same order as the
// same row already in memory. Loads of every slot are issued before the
// first store or sum; the squares are summed in registers, across the warp
// by shuffles (every lane ends with the same total) and across warps
// through shared memory. scale is read in 16-byte vectors. A row wider
// than MAX_THREADS x NV vectors, or one whose width, segments, strides or
// bases are not 16-byte aligned, takes the two-pass loop (the row formed
// again in the second pass; one element at a time where unaligned), so
// any d works. The TPU kernel's (256, d) row tile has no counterpart: a
// block never needs more than one row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int NV = 2;   // 16-byte vectors a thread keeps past 1,024 of them

enum Prologue : int { PLAIN = 0, ADD = 1, CAT = 2, ADD_CAT = 3, GATE = 4 };

// the row's pointers and shapes; strides are in elements between rows
// (unit stride inside a row), s and y are contiguous
struct Row {
  const void* a;      // x (GATE: y, float32)
  const void* b;      // delta (GATE: z, float32)
  const void* e;      // second segment (CAT, ADD_CAT)
  const void* scale;  // (d1 + d2,)
  void* s;            // (R, d1) x + delta (ADD, ADD_CAT)
  void* y;            // (R, d1 + d2) output
  long long sa, sb, se;
  int d1, d2;
  float eps;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as PyTorch's cast
}

// N elements of E in one access of up to 16 bytes (two for 32 bytes)
template <typename E, int N>
struct alignas(N * sizeof(E) < 16 ? N * sizeof(E) : 16) Pack {
  E v[N];
};

template <typename E, int N>
__device__ __forceinline__ Pack<E, N> load(const E* p) {
  return *reinterpret_cast<const Pack<E, N>*>(p);
}

template <typename E, int N>
__device__ __forceinline__ void store(E* p, const Pack<E, N>& v) {
  *reinterpret_cast<Pack<E, N>*>(p) = v;
}

__host__ __device__ constexpr bool adds(int pro) {
  return pro == ADD || pro == ADD_CAT;
}
__host__ __device__ constexpr bool cats(int pro) {
  return pro == CAT || pro == ADD_CAT;
}

// vector c (V elements) of row r of the formed row s; n1 = d1 / V
template <typename T, int PRO, int V>
__device__ __forceinline__ Pack<T, V> form(const Row& p, long long r, int c,
                                           int n1) {
  Pack<T, V> out;
  if constexpr (PRO == GATE) {
    const long long oy = r * p.sa + (long long)c * V;
    const long long oz = r * p.sb + (long long)c * V;
    const Pack<float, V> y = load<float, V>((const float*)p.a + oy);
    const Pack<float, V> z = load<float, V>((const float*)p.b + oz);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float silu = z.v[e] / (1.f + expf(-z.v[e]));
      out.v[e] = from_f32<T>(y.v[e] * silu);
    }
    return out;
  }
  if (cats(PRO) && c >= n1)
    return load<T, V>((const T*)p.e + r * p.se + (long long)(c - n1) * V);
  out = load<T, V>((const T*)p.a + r * p.sa + (long long)c * V);
  if constexpr (adds(PRO)) {
    const Pack<T, V> dl =
        load<T, V>((const T*)p.b + r * p.sb + (long long)c * V);
#pragma unroll
    for (int e = 0; e < V; ++e)
      out.v[e] = from_f32<T>(to_f32(out.v[e]) + to_f32(dl.v[e]));
  }
  return out;
}

template <typename T, int V>
__device__ __forceinline__ float sum_sq(const Pack<T, V>& v, float ss) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float f = to_f32(v.v[e]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

// x + delta, vector c of row r, into s (R, d1)
template <typename T, int PRO, int V>
__device__ __forceinline__ void write_s(const Row& p, long long r, int c,
                                        int n1, const Pack<T, V>& v) {
  if constexpr (adds(PRO))
    if (c < n1) store<T, V>((T*)p.s + r * p.d1 + (long long)c * V, v);
}

template <typename T, typename S, int V>
__device__ __forceinline__ void write_y(const Row& p, long long r, int c,
                                        const Pack<T, V>& v, float inv) {
  const int d = p.d1 + p.d2;
  const Pack<S, V> sc = load<S, V>((const S*)p.scale + (long long)c * V);
  Pack<T, V> q;
#pragma unroll
  for (int e = 0; e < V; ++e)
    q.v[e] = from_f32<T>(to_f32(v.v[e]) * inv * to_f32(sc.v[e]));
  store<T, V>((T*)p.y + r * d + (long long)c * V, q);
}

// the block's total of ss, the same value in every thread
__device__ __forceinline__ float block_sum(float ss, float* warp_sum) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (blockDim.x == 32) return ss;
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = ss;
  __syncthreads();
  float t = 0.f;
  const int nw = blockDim.x >> 5;
  for (int w = 0; w < nw; ++w) t += warp_sum[w];
  return t;
}

// REG: the one-pass register path (NV vectors a thread at most);
// otherwise the two-pass loop
template <typename T, typename S, int PRO, int V, bool REG>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_kernel(const Row p) {
  __shared__ float warp_sum[MAX_THREADS / 32];
  const long long r = blockIdx.x;
  const int d = p.d1 + p.d2;
  const int n1 = p.d1 / V, nvec = d / V;
  float ss = 0.f;
  if constexpr (REG) {
    Pack<T, V> row[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {   // every load before any store
      const int c = threadIdx.x + k * blockDim.x;
      if (c < nvec) row[k] = form<T, PRO, V>(p, r, c, n1);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < nvec) {
        write_s<T, PRO, V>(p, r, c, n1, row[k]);
        ss = sum_sq<T, V>(row[k], ss);
      }
    }
    const float inv = rsqrtf(block_sum(ss, warp_sum) / (float)d + p.eps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < nvec) write_y<T, S, V>(p, r, c, row[k], inv);
    }
  } else {
    for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
      const Pack<T, V> v = form<T, PRO, V>(p, r, c, n1);
      write_s<T, PRO, V>(p, r, c, n1, v);
      ss = sum_sq<T, V>(v, ss);
    }
    const float inv = rsqrtf(block_sum(ss, warp_sum) / (float)d + p.eps);
    for (int c = threadIdx.x; c < nvec; c += blockDim.x)
      write_y<T, S, V>(p, r, c, form<T, PRO, V>(p, r, c, n1), inv);
  }
}

bool aligned(const void* q) { return (uintptr_t)q % 16 == 0; }

template <typename T, typename S, int PRO>
cudaError_t launch(const Row& p, long long rows, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int d = p.d1 + p.d2;
  bool vec = d % V == 0 && p.d1 % V == 0 && p.sa % V == 0 &&
             aligned(p.a) && aligned(p.scale) && aligned(p.y);
  if (PRO != PLAIN && PRO != CAT)   // delta, or z
    vec = vec && p.sb % V == 0 && aligned(p.b);
  if (adds(PRO)) vec = vec && aligned(p.s);
  if (cats(PRO)) vec = vec && p.se % V == 0 && aligned(p.e);
  const unsigned grid = (unsigned)rows;
  if (vec) {
    const int nvec = d / V;
    const int threads = min(MAX_THREADS, (nvec + 31) / 32 * 32);
    if (nvec <= MAX_THREADS * NV)
      rmsnorm_kernel<T, S, PRO, V, true><<<grid, threads, 0, st>>>(p);
    else
      rmsnorm_kernel<T, S, PRO, V, false><<<grid, threads, 0, st>>>(p);
  } else {
    const int threads = min(MAX_THREADS, (d + 31) / 32 * 32);
    rmsnorm_kernel<T, S, PRO, 1, false><<<grid, threads, 0, st>>>(p);
  }
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t by_prologue(int pro, const Row& p, long long rows,
                        cudaStream_t st) {
  switch (pro) {
    case PLAIN: return launch<T, S, PLAIN>(p, rows, st);
    case ADD: return launch<T, S, ADD>(p, rows, st);
    case CAT: return launch<T, S, CAT>(p, rows, st);
    case ADD_CAT: return launch<T, S, ADD_CAT>(p, rows, st);
    case GATE: return launch<T, S, GATE>(p, rows, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_scale(int scale_dtype, int pro, const Row& p, long long rows,
                     cudaStream_t st) {
  if (scale_dtype == 0) return by_prologue<T, float>(pro, p, rows, st);
  if (scale_dtype == 1) return by_prologue<T, __nv_bfloat16>(pro, p, rows, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// prologue: 0 PLAIN, 1 ADD, 2 CAT, 3 ADD_CAT, 4 GATE (above). dtype: the
// row's and y's type (and x, delta, e's), 0 = float32, 1 = bfloat16; GATE
// reads a = y and b = z in float32 whatever dtype is; scale_dtype the
// same codes. a, b, e: rows at sa, sb, se elements apart (unit stride
// inside a row); pointers a prologue does not read may be null. s: (rows,
// d1) contiguous, written by ADD and ADD_CAT; y: (rows, d1 + d2)
// contiguous. d2 > 0 exactly for CAT and ADD_CAT. device: the CUDA ordinal
// of the tensors, made current for the launch. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a code or size it does not
// take).
extern "C" int rmsnorm_fwd(int prologue, const void* a, const void* b,
                           const void* e, const void* scale, void* s, void* y,
                           long long rows, long long sa, long long sb,
                           long long se, int d1, int d2, float eps, int dtype,
                           int scale_dtype, int device, void* stream) {
  const bool two = prologue == CAT || prologue == ADD_CAT;
  if (rows < 1 || rows > 0x7fffffffLL || d1 < 1 || (two ? d2 < 1 : d2 != 0) ||
      (long long)d1 + d2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Row p{a, b, e, scale, s, y, sa, sb, se, d1, d2, eps};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)by_scale<float>(scale_dtype, prologue, p, rows, st);
  if (dtype == 1)
    return (int)by_scale<__nv_bfloat16>(scale_dtype, prologue, p, rows, st);
  return (int)cudaErrorInvalidValue;
}
