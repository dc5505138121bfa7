// Prefill flash attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py: causal attention by explicit
// positions (-1 = invalid slot), optional sliding window and chunked
// (local) attention, GQA by the uniform divide kv_head = h / group, f32
// accumulation, output in the input type; a pad query writes 0. On
// request (flash_attention_fwd_lse) it also writes each query row's
// logsumexp, the one statistic the backward pass needs (autograd.py).
//
// What bounds it on the H100: at the main paths' prompts (S = 512,
// right-padded, hd 64 and 112) the q/k/v/o bytes over 3.35 TB/s exceed the
// causal pairs' 4*hd operations each over 989 TFLOP/s, so bytes on paper;
// past a few thousand tokens it is bound by operations.
//
// What this design does about that: bf16 runs the shared tensor-core tile
// core of attention_tile.cuh (mma.sync products, cp.async double-buffered
// K/V tiles, tiles the positions prove masked skipped); this file gives it
// only where a key row lives: row kj of (batch, kv head) at
// k + b*sk.b + hk*sk.h + kj*sk.s, d stride 1. The float32 instance keeps
// the first kernel's f32 FMA body on the CUDA cores (the 1e-4 float32
// check, which TF32 could not meet): one block per (batch, q head,
// 64-query tile), the q tile in shared memory, each K/V tile staged
// transposed in f32.
//
// Layout: q (B,Hq,Sq,hd), k/v (B,Hkv,Sk,hd), out (B,Hq,Sq,hd), each given
// by four element strides, so the caller passes head-transposed views of
// (B,S,H,hd) projections without copies. Ragged Sq/Sk edges are masked
// here; nothing is padded on the host.
#include "attention_tile.cuh"

namespace {

using namespace attn;

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 128;  // float32: 16 row groups (4 rows) x 8 lanes

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;  // (B, Sq)
  const int* kpos;  // (B, Sk)
  void* out;
  float* lse;       // (B, Hq, Sq) contiguous, or nullptr: none written
  Strides4 sq, sk, sv, so;
  int B, Hq, Hkv, Sq, Sk, group, window, chunk;
  float scale;
};

// ---- bf16: the shared tensor-core core, keys from a strided tensor

struct ContiguousKeys {
  const tc::bf16* k;  // row 0 of (batch, kv head)
  const tc::bf16* v;
  long long sk, sv;   // row strides
  __device__ __forceinline__ int locate(int) const { return 0; }
  __device__ __forceinline__ void rows(int kj, int, const tc::bf16*& kr,
                                       const tc::bf16*& vr) const {
    kr = k + kj * sk;
    vr = v + kj * sv;
  }
};

template <int HD>
__global__ void __launch_bounds__(tc::THREADS, 2)
    flash_tc_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.group;
  tc::Tile p;
  p.q = (const tc::bf16*)a.q + b * a.sq.b + h * a.sq.h;
  p.out = (tc::bf16*)a.out + b * a.so.b + h * a.so.h;
  p.q_s = a.sq.s;
  p.o_s = a.so.s;
  p.qpos = a.qpos + (long long)b * a.Sq;
  p.kpos = a.kpos + (long long)b * a.Sk;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.window = a.window;
  p.chunk = a.chunk;
  p.scale_log2 = a.scale * tc::LOG2E;
  p.lse = a.lse == nullptr ? nullptr : a.lse + ((long long)b * a.Hq + h) * a.Sq;
  const ContiguousKeys keys{
      (const tc::bf16*)a.k + b * a.sk.b + hk * a.sk.h,
      (const tc::bf16*)a.v + b * a.sv.b + hk * a.sv.h, a.sk.s, a.sv.s};
  tc::attention_tile<HD>(p, keys, tc_smem);
}

template <int HD>
cudaError_t launch_bf16(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = tc::Layout<HD>::bytes((a.Sk + tc::BK - 1) / tc::BK);
  cudaError_t err = allow_smem<flash_tc_kernel<HD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + tc::BQ - 1) / tc::BQ, a.Hq, a.B);
  flash_tc_kernel<HD><<<grid, tc::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- float32: f32 FMA on the CUDA cores

template <int HD>
constexpr size_t flash_smem_bytes() {
  return (size_t)(BQ * (HD + 1) + HD * (BK + 1) + BK * vcols<HD>() +
                  BQ * (BK + 1)) *
             sizeof(float) +
         (size_t)(BK + BQ) * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FlashArgs a) {
  constexpr int DJ = (HD + 7) / 8;  // output columns per thread
  constexpr int HV = vcols<HD>();   // V row in shared memory
  extern __shared__ float smem[];
  float* q_s = smem;                         // [BQ][HD+1]
  float* kt_s = q_s + BQ * (HD + 1);         // [HD][BK+1], K transposed
  float* v_s = kt_s + HD * (BK + 1);         // [BK][HV]
  float* p_s = v_s + BK * HV;                // [BQ][BK+1]
  int* kpos_s = (int*)(p_s + BQ * (BK + 1)); // [BK]
  int* qpos_s = kpos_s + BK;                 // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // column lane: keys / dims tx + 8*j
  const int ty = tid >> 3;  // row group: queries ty*4 .. ty*4+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.group;

  const float* Q = (const float*)a.q + b * a.sq.b + h * a.sq.h;
  const float* K = (const float*)a.k + b * a.sk.b + hk * a.sk.h;
  const float* V = (const float*)a.v + b * a.sv.b + hk * a.sv.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    q_s[r * (HD + 1) + d] = qi < a.Sq ? Q[qi * a.sq.s + d * a.sq.d] : 0.f;
  }
  zero_v_tail<HD, BK, THREADS>(v_s, tid);
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
        kv = K[kj * a.sk.s + d * a.sk.d];
        vv = V[kj * a.sv.s + d * a.sv.d];
      }
      kt_s[d * (BK + 1) + c] = kv;
      v_s[c * HV + d] = vv;
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
      for (int j = 0; j < DJ; ++j) vr[j] = v_s[c * HV + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vr[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // a pad query (q_pos = -1) writes 0; a row no tile reached has l = 0
  // and the 1e-30 clamp keeps it finite
  float* O = (float*)a.out + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const bool pad = qp[i] < 0;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (tx + 8 * j < HD)
        O[qi * a.so.s + (tx + 8 * j) * a.so.d] =
            pad ? 0.f : acc[i][j] / denom;
    // every masked score is NEG_INF_SCORE: a row whose max is no larger
    // saw no valid key
    if (a.lse != nullptr && tx == 0)
      a.lse[((long long)b * a.Hq + h) * a.Sq + qi] =
          pad || !(m[i] > NEG_INF_SCORE) ? INFINITY : m[i] + logf(l[i]);
  }
}

template <int HD>
cudaError_t launch_f32(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<HD>();
  cudaError_t err = allow_smem<flash_fwd_kernel<HD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the
// tensors, made current for the launch. strides: 16 element strides, (b, h, s,
// d) for q, k, v, out in that order. lse: nullptr, or a contiguous float32
// (B, Hq, Sq) buffer that receives each query row's logsumexp of its scaled
// scores (natural log; +inf where the row sees no valid key: a pad query,
// or every key masked), which the backward pass reads. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// dim or type it does not take).
extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, const int* qpos,
                                       const int* kpos, void* out, float* lse,
                                       const long long* strides, int B,
                                       int Hq, int Hkv, int Sq, int Sk,
                                       int hd, int window, int chunk,
                                       int dtype, int device, void* stream) {
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.qpos = qpos;
  a.kpos = kpos;
  a.out = out;
  a.lse = lse;
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
  if (dtype == 0 && hd == 8) return (int)launch_f32<8>(a, st);
  if (dtype == 0 && hd == 16) return (int)launch_f32<16>(a, st);
  if (dtype == 0 && hd == 20) return (int)launch_f32<20>(a, st);
  if (dtype == 0 && hd == 32) return (int)launch_f32<32>(a, st);
  if (dtype == 0 && hd == 64) return (int)launch_f32<64>(a, st);
  if (dtype == 0 && hd == 100) return (int)launch_f32<100>(a, st);
  if (dtype == 0 && hd == 112) return (int)launch_f32<112>(a, st);
  if (dtype == 0 && hd == 128) return (int)launch_f32<128>(a, st);
  if (dtype == 0 && hd == 160) return (int)launch_f32<160>(a, st);
  if (dtype == 1 && hd == 8) return (int)launch_bf16<8>(a, st);
  if (dtype == 1 && hd == 16) return (int)launch_bf16<16>(a, st);
  if (dtype == 1 && hd == 32) return (int)launch_bf16<32>(a, st);
  if (dtype == 1 && hd == 64) return (int)launch_bf16<64>(a, st);
  if (dtype == 1 && hd == 100) return (int)launch_bf16<100>(a, st);
  if (dtype == 1 && hd == 112) return (int)launch_bf16<112>(a, st);
  if (dtype == 1 && hd == 128) return (int)launch_bf16<128>(a, st);
  if (dtype == 1 && hd == 160) return (int)launch_bf16<160>(a, st);
  return (int)cudaErrorInvalidValue;
}

// The serving entry: flash_attention_fwd_lse with no lse (the ABI of the
// sources before it, which chip_kernel_ab.py binds).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* qpos,
                                   const int* kpos, void* out,
                                   const long long* strides, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int hd,
                                   int window, int chunk, int dtype,
                                   int device, void* stream) {
  return flash_attention_fwd_lse(q, k, v, qpos, kpos, out, nullptr, strides,
                                 B, Hq, Hkv, Sq, Sk, hd, window, chunk, dtype,
                                 device, stream);
}
