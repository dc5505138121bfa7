// Decode attention over a contiguous (ring) KV cache for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `decode_attention` / `_decode_kernel` in
// src/repro/kernels/decode_attention.py: one query token per sequence
// against its cache slot, mask 0 <= k_pos <= q_pos (+ window / chunk),
// finite -1e9 for masked scores, f32 softmax and accumulation, output in
// the input type. k_pos is the cache's pos_ids row in slot order: once the
// ring wraps it is not sorted, and -1 marks empty slots and right-padded
// prompt tokens, which stay masked for good.
//
// What bounds it on the H100: bytes. Each cached key and value is used for
// 2*group multiply-adds per element, far below the ~295 operations per
// byte at which the tensor cores would become the limit, so the least
// time is the valid K/V bytes over 3.35 TB/s.
//
// What this design does about that: one block per (batch, kv head) holds
// the whole GQA group's queries in shared memory, so every K/V row is read
// from device memory once per group, not once per query head. The TPU's
// sequential kv grid axis becomes a loop over 128-key tiles inside the
// block. Each tile's K and V rows are staged in shared memory with
// coalesced 16-byte loads, all issued before any is used; the running max
// is block-wide, while l and the output partials stay in registers and are
// reduced once at the end. A tile whose positions are all masked is
// skipped before any K/V byte is read, and inside a tile masked rows are
// not loaded, so the bytes moved follow the valid keys, not the cache
// width. K and V are read through their
// strides: the model passes cache["k"].transpose(1, 2), a view of the
// (B, W, Hkv, hd) cache, and no copy is made.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TK = 128;       // keys per tile, one per thread in scoring
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF_SCORE = -1e9f;

struct DecodeArgs {
  const void* q;     // (B, Hq, hd) contiguous
  const void* k;     // (B, Hkv, W, hd), element strides below, d stride 1
  const void* v;     // (B, Hkv, W, hd_v), d stride 1
  const int* qpos;   // (B,)
  const int* kpos;   // (B, W) contiguous
  void* out;         // (B, Hq, hd_v) contiguous
  long long sk_b, sk_h, sk_s, sv_b, sv_h, sv_s;
  int B, Hq, Hkv, W, window, chunk;
  float scale;
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
  return __float2bfloat16(x);
}

// one 16-byte load of VEC elements, widened to f32
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    o[0] = f.x;
    o[1] = f.y;
    o[2] = f.z;
    o[3] = f.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ bool allowed(int qp, int kp, int window,
                                        int chunk) {
  bool ok = (kp >= 0) && (kp <= qp);
  if (window > 0) ok = ok && (kp > qp - window);
  if (chunk > 0) ok = ok && (kp / chunk == qp / chunk);
  return ok;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD, int G>
constexpr size_t decode_smem_bytes() {
  return (size_t)TK * (HD + Vec16<T>::N) * sizeof(T)      // K tile, padded
         + (size_t)TK * HD * sizeof(T)                     // V tile
         + (size_t)(G * HD + G * TK + (THREADS / HD) * G * HD) * sizeof(float)
         + (size_t)TK * sizeof(int);
}

// HD: q/k head dim (= hd_v here); G: GQA group (query heads per kv head)
template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS) decode_kernel(DecodeArgs a) {
  constexpr int NSLICE = THREADS / HD;  // key slices in the P.V phase
  constexpr int VEC = Vec16<T>::N;
  constexpr int CH = HD / VEC;          // 16-byte chunks per K/V row
  constexpr int KROW = HD + VEC;        // K row pitch: +16 bytes, no bank
                                        // conflicts when thread t reads row t
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                  // [TK][KROW]
  T* v_s = k_s + TK * KROW;                             // [TK][HD]
  float* q_s = reinterpret_cast<float*>(v_s + TK * HD); // [G][HD]
  float* p_s = q_s + G * HD;                            // [G][TK]
  float* acc_s = p_s + G * TK;                          // [NSLICE][G][HD]
  int* valid_s = reinterpret_cast<int*>(acc_s + NSLICE * G * HD);  // [TK]
  __shared__ float red_s[WARPS][G];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int d = tid % HD, slice = tid / HD;

  const T* Q = (const T*)a.q + ((long long)b * a.Hq + (long long)hk * G) * HD;
  const T* K = (const T*)a.k + b * a.sk_b + hk * a.sk_h;
  const T* V = (const T*)a.v + b * a.sv_b + hk * a.sv_h;
  const int* KP = a.kpos + (long long)b * a.W;
  const int qp = a.qpos[b];

  for (int i = tid; i < G * HD; i += THREADS) q_s[i] = to_f32(Q[i]);
  __syncthreads();

  float m[G], lp[G], acc[G];  // m is block-uniform; lp, acc per thread
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lp[g] = 0.f;
    acc[g] = 0.f;
  }

  for (int k0 = 0; k0 < a.W; k0 += TK) {
    const int w = k0 + tid;
    const bool in = w < a.W;
    const bool ok = allowed(qp, in ? KP[w] : -1, a.window, a.chunk);
    valid_s[tid] = ok;
    if (!__syncthreads_or(ok)) continue;  // positions prove the tile empty

    // stage the tile's VALID K and V rows with coalesced 16-byte loads,
    // all issued before any is used; masked rows are never read
    for (int i = tid; i < TK * CH; i += THREADS) {
      const int j = i / CH, c = i % CH;
      if (valid_s[j]) {
        const long long row = k0 + j;
        *reinterpret_cast<uint4*>(k_s + j * KROW + c * VEC) =
            *reinterpret_cast<const uint4*>(K + row * a.sk_s + c * VEC);
        *reinterpret_cast<uint4*>(v_s + j * HD + c * VEC) =
            *reinterpret_cast<const uint4*>(V + row * a.sv_s + c * VEC);
      }
    }
    __syncthreads();

    float s[G];
    if (ok) {
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float kv[VEC];
        Vec16<T>::load(k_s + tid * KROW + c * VEC, kv);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dot[g] = fmaf(q_s[g * HD + c * VEC + e], kv[e], dot[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = dot[g] * a.scale;
    } else {
      // masked keys: with a valid key in the tile their weight
      // exp(-1e9 - m) is exactly 0; past the edge they get none
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = in ? NEG_INF_SCORE : -INFINITY;
    }

#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float x = warp_max(s[g]);
      if (lane == 0) red_s[warp][g] = x;
    }
    __syncthreads();
    float corr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = red_s[0][g];
#pragma unroll
      for (int i = 1; i < WARPS; ++i) mt = fmaxf(mt, red_s[i][g]);
      // the tile holds a valid key, so mt is finite and the first
      // correction exp(-inf - finite) is exactly 0, never NaN
      const float m_new = fmaxf(m[g], mt);
      corr[g] = expf(m[g] - m_new);
      const float p = expf(s[g] - m_new);
      p_s[g * TK + tid] = p;
      lp[g] = lp[g] * corr[g] + p;
      m[g] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= corr[g];
    for (int j = slice; j < TK; j += NSLICE) {
      if (!valid_s[j]) continue;  // uniform across the warp
      const float vv = to_f32(v_s[j * HD + d]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(p_s[g * TK + j], vv, acc[g]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float x = warp_sum(lp[g]);
    if (lane == 0) red_s[warp][g] = x;
    acc_s[(slice * G + g) * HD + d] = acc[g];
  }
  __syncthreads();
  if (slice == 0) {
    T* O = (T*)a.out + ((long long)b * a.Hq + (long long)hk * G) * HD;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float l = 0.f, o = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) l += red_s[i][g];
#pragma unroll
      for (int sl = 0; sl < NSLICE; ++sl) o += acc_s[(sl * G + g) * HD + d];
      // a row with no valid key at all has l = 0: the clamp gives 0
      O[g * HD + d] = from_f32<T>(o / fmaxf(l, 1e-30f));
    }
  }
}

template <typename T, int HD, int G>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<T, HD, G>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, a.B);
  decode_kernel<T, HD, G><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_group(const DecodeArgs& a, int group,
                         cudaStream_t stream) {
  switch (group) {
    case 1: return launch<T, HD, 1>(a, stream);
    case 2: return launch<T, HD, 2>(a, stream);
    case 4: return launch<T, HD, 4>(a, stream);
    case 8: return launch<T, HD, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the
// tensors, made current for the launch. strides: element strides (b, h, s) of
// k then v. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim, group or type it does not take).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const int* qpos,
                                    const int* kpos, void* out,
                                    const long long* strides, int B, int Hq,
                                    int Hkv, int W, int hd, int hd_v,
                                    int window, int chunk, int dtype,
                                    int device, void* stream) {
  if (hd != hd_v || Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.qpos = qpos;
  a.kpos = kpos;
  a.out = out;
  a.sk_b = strides[0];
  a.sk_h = strides[1];
  a.sk_s = strides[2];
  a.sv_b = strides[3];
  a.sv_h = strides[4];
  a.sv_s = strides[5];
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.W = W;
  a.window = window;
  a.chunk = chunk;
  a.scale = 1.0f / sqrtf((float)hd);
  const int group = Hq / Hkv;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 32) return (int)launch_group<float, 32>(a, group, st);
  if (dtype == 0 && hd == 64) return (int)launch_group<float, 64>(a, group, st);
  if (dtype == 0 && hd == 128)
    return (int)launch_group<float, 128>(a, group, st);
  if (dtype == 1 && hd == 32)
    return (int)launch_group<__nv_bfloat16, 32>(a, group, st);
  if (dtype == 1 && hd == 64)
    return (int)launch_group<__nv_bfloat16, 64>(a, group, st);
  if (dtype == 1 && hd == 128)
    return (int)launch_group<__nv_bfloat16, 128>(a, group, st);
  return (int)cudaErrorInvalidValue;
}
