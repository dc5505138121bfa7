// Prefill flash attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py: causal attention by explicit
// positions (-1 = invalid slot), optional sliding window and chunked
// (local) attention, GQA by the uniform divide kv_head = h / group, f32
// accumulation, output in the input type.
//
// What bounds it on the H100: at long S the work is 4*S^2*hd operations
// against ~4*S*hd*2 bytes of q/k/v/o per head, so past a few hundred
// tokens it is bound by operations, not bytes.
//
// What this design does about that: one block owns a (batch, q head,
// 64-query tile); the TPU's sequential kv grid axis becomes a loop inside
// the block, with the running softmax state (m, l, acc) in registers. The
// q tile stays in shared memory for the whole loop and every K/V tile is
// read from device memory once per q tile. A kv tile is skipped only when
// the positions prove every (query, key) pair of it masked, so a causal
// prefill does about half the work. This first kernel multiplies with f32
// FMA on the CUDA cores (exact enough for the 1e-4 float32 check); moving
// the two products onto tensor cores (mma.sync, then wgmma + TMA) is the
// next step toward the operations bound.
//
// Layout: q (B,Hq,Sq,hd), k/v (B,Hkv,Sk,hd), out (B,Hq,Sq,hd), each given
// by four element strides, so the caller passes head-transposed views of
// (B,S,H,hd) projections without copies. Ragged Sq/Sk edges are masked
// here; nothing is padded on the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 128;  // 16 row groups (4 rows each) x 8 column lanes
constexpr float NEG_INF_SCORE = -1e9f;  // finite mask value of the oracle

struct Strides4 {
  long long b, h, s, d;
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;  // (B, Sq)
  const int* kpos;  // (B, Sk)
  void* out;
  Strides4 sq, sk, sv, so;
  int B, Hq, Hkv, Sq, Sk, group, window, chunk;
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

// 0 <= kp <= qp, plus window / chunk when > 0 (the && chain keeps the
// integer divisions on non-negative operands only).
__device__ __forceinline__ bool allowed(int qp, int kp, int window,
                                        int chunk) {
  bool ok = (kp >= 0) && (kp <= qp);
  if (window > 0) ok = ok && (kp > qp - window);
  if (chunk > 0) ok = ok && (kp / chunk == qp / chunk);
  return ok;
}

template <int HD>
constexpr size_t flash_smem_bytes() {
  return (size_t)(BQ * (HD + 1) + HD * (BK + 1) + BK * HD + BQ * (BK + 1)) *
             sizeof(float) +
         (size_t)(BK + BQ) * sizeof(int);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FlashArgs a) {
  constexpr int DJ = HD / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                         // [BQ][HD+1]
  float* kt_s = q_s + BQ * (HD + 1);         // [HD][BK+1], K transposed
  float* v_s = kt_s + HD * (BK + 1);         // [BK][HD]
  float* p_s = v_s + BK * HD;                // [BQ][BK+1]
  int* kpos_s = (int*)(p_s + BQ * (BK + 1)); // [BK]
  int* qpos_s = kpos_s + BK;                 // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // column lane: keys / dims tx + 8*j
  const int ty = tid >> 3;  // row group: queries ty*4 .. ty*4+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;

  const T* Q = (const T*)a.q + b * a.sq.b + h * a.sq.h;
  const T* K = (const T*)a.k + b * a.sk.b + hk * a.sk.h;
  const T* V = (const T*)a.v + b * a.sv.b + hk * a.sv.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    q_s[r * (HD + 1) + d] =
        qi < a.Sq ? to_f32(Q[qi * a.sq.s + d * a.sq.d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    const int qi = q0 + r;
    qpos_s[r] = qi < a.Sq ? a.qpos[(long long)b * a.Sq + qi] : -1;
  }
  __syncthreads();

  int qp[4];
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qp[i] = qpos_s[ty * 4 + i];
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (a.Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    for (int c = tid; c < BK; c += THREADS) {
      const int kj = k0 + c;
      kpos_s[c] = kj < a.Sk ? a.kpos[(long long)b * a.Sk + kj] : -1;
    }
    __syncthreads();
    // skip the tile only when the positions prove every pair masked
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        any |= allowed(qp[i], kpos_s[tx + 8 * j], a.window, a.chunk);
    if (!__syncthreads_or(any)) continue;

    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD, kj = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kj < a.Sk) {
        kv = to_f32(K[kj * a.sk.s + d * a.sk.d]);
        vv = to_f32(V[kj * a.sv.s + d * a.sv.d]);
      }
      kt_s[d * (BK + 1) + c] = kv;
      v_s[c * HD + d] = vv;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float kr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kr[j] = kt_s[d * (BK + 1) + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = q_s[(ty * 4 + i) * (HD + 1) + d];
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv, kr[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        float sc;
        if (k0 + c >= a.Sk)
          sc = -INFINITY;  // past the ragged edge: no weight at all
        else if (allowed(qp[i], kpos_s[c], a.window, a.chunk))
          sc = s[i][j] * a.scale;
        else
          sc = NEG_INF_SCORE;
        s[i][j] = sc;
        mx = fmaxf(mx, sc);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // column k0 is in range, so mx >= NEG_INF_SCORE is finite and the
      // first tile's correction exp(-inf - finite) is exactly 0, never NaN
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty * 4 + i) * (BK + 1) + tx + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float vr[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vr[j] = v_s[c * HD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vr[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // a row no tile reached (a pad query, q_pos = -1) has l = 0: the 1e-30
  // clamp gives 0, finite
  T* O = (T*)a.out + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      O[qi * a.so.s + (tx + 8 * j) * a.so.d] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the
// tensors, made current for the launch. strides: 16 element strides, (b, h, s,
// d) for q, k, v, out in that order. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a head dim or type it does not take).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* qpos,
                                   const int* kpos, void* out,
                                   const long long* strides, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int hd,
                                   int window, int chunk, int dtype,
                                   int device, void* stream) {
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.qpos = qpos;
  a.kpos = kpos;
  a.out = out;
  a.sq = {strides[0], strides[1], strides[2], strides[3]};
  a.sk = {strides[4], strides[5], strides[6], strides[7]};
  a.sv = {strides[8], strides[9], strides[10], strides[11]};
  a.so = {strides[12], strides[13], strides[14], strides[15]};
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.group = Hq / Hkv;
  a.window = window;
  a.chunk = chunk;
  a.scale = 1.0f / sqrtf((float)hd);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 32) return (int)launch<float, 32>(a, st);
  if (dtype == 0 && hd == 64) return (int)launch<float, 64>(a, st);
  if (dtype == 0 && hd == 112) return (int)launch<float, 112>(a, st);
  if (dtype == 0 && hd == 128) return (int)launch<float, 128>(a, st);
  if (dtype == 1 && hd == 32) return (int)launch<__nv_bfloat16, 32>(a, st);
  if (dtype == 1 && hd == 64) return (int)launch<__nv_bfloat16, 64>(a, st);
  if (dtype == 1 && hd == 112) return (int)launch<__nv_bfloat16, 112>(a, st);
  if (dtype == 1 && hd == 128) return (int)launch<__nv_bfloat16, 128>(a, st);
  return (int)cudaErrorInvalidValue;
}
