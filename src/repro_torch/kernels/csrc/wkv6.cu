// RWKV6 (WKV6) recurrence kernel for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `wkv6` / `_wkv6_kernel` in
// src/repro/kernels/wkv6.py. Per (batch, head), with an hd x hd float32
// state S:
//
//   out_t = r_t . (S + u (x) k_t v_t)        (row vector times matrix)
//   S     = diag(w_t) S + k_t (x) v_t
//
// in float32 whatever the input type: r, k, v float32 or bfloat16; the
// decay w and the bonus u each float32 or the type of r, k and v, widened to
// float32 as they are loaded (the model keeps w in float32: w ~ 0.9975 at
// its initial decay rounds to 0.996 or 1.0 in bf16); the state float32.
//
// What bounds it on the H100: operations, and before them latency. A step
// is about 4 hd^2 float32 operations on 4 hd inputs, so at hd 64 it is
// ~16 operations per byte read (bf16 r/k/v), near the ~20 at which the 67
// TFLOP/s of float32 FMA become the limit. But the time loop is
// sequential: one (batch, head) is one chain of T dependent steps, and at
// batch 1 there are only H = 32 of them, so the kernel is a latency-bound
// walk over T whatever it does per step.
//
// What this design does about that (the usual one for this recurrence):
// one block per (batch, head) and hd threads; thread j owns column j of S
// in hd registers, so a step touches no memory for the state. A tile of
// TT time steps of r, k, v and w is staged in shared memory at once (each
// thread loads element j of each row: coalesced), then the block walks the
// tile with no further global loads; u sits in shared memory for the whole
// run. The output row sum uses four partial sums to shorten the FMA chain;
// the state update rounds each product and sum as the plain version does.
// S is read at the start and written at the end column by column (for a
// fixed row i the threads touch contiguous floats: coalesced), and every
// thread reads its column before it writes it, so the final state may alias
// the initial one: decode updates the cache's state in place.
//
// Layout: r, k, v, w (B,H,T,hd), each read through (b, h, t) element
// strides with unit feature stride, so the model passes transposed views of
// its (B,T,H,hd) projections; u (H,hd) contiguous; s0 and
// s_out (B,H,hd,hd) contiguous float32. out is written contiguous as (B,T,H,hd) float32 (the
// wrapper returns its (B,H,T,hd) view).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TT = 32;  // time steps staged per tile

struct WkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const void* u;
  const float* s0;
  float* s_out;
  float* out;
  long long sr[3], sk[3], sv[3], sw[3];  // (b, h, t) element strides
  int B, H, T;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// T: the type of r, k, v; TW: of w; TU: of u. HD threads a block: at hd 8
// and 16 a block is part of one warp, so the kernel uses block barriers
// only, no warp-wide primitive.
template <typename T, typename TW, typename TU, int HD>
__global__ void __launch_bounds__(HD) wkv6_kernel(WkvArgs a) {
  __shared__ float r_s[TT][HD], k_s[TT][HD], v_s[TT][HD], w_s[TT][HD];
  __shared__ float u_s[HD];
  const int j = threadIdx.x;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;

  const T* R = (const T*)a.r + b * a.sr[0] + h * a.sr[1];
  const T* K = (const T*)a.k + b * a.sk[0] + h * a.sk[1];
  const T* V = (const T*)a.v + b * a.sv[0] + h * a.sv[1];
  const TW* W = (const TW*)a.w + b * a.sw[0] + h * a.sw[1];
  const long long bh = (long long)b * a.H + h;

  float S[HD];  // column j of the state
  const float* S0 = a.s0 + bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = S0[i * HD + j];
  u_s[j] = to_f32(((const TU*)a.u)[h * HD + j]);

  // out[b, t, h, j]
  float* O = a.out + ((long long)b * a.T * a.H + h) * HD + j;
  const long long o_step = (long long)a.H * HD;

  for (int t0 = 0; t0 < a.T; t0 += TT) {
    const int nt = min(TT, a.T - t0);
    __syncthreads();  // the previous tile is consumed (and u_s written)
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      const long long t = t0 + tt;
      r_s[tt][j] = to_f32(R[t * a.sr[2] + j]);
      k_s[tt][j] = to_f32(K[t * a.sk[2] + j]);
      v_s[tt][j] = to_f32(V[t * a.sv[2] + j]);
      w_s[tt][j] = to_f32(W[t * a.sw[2] + j]);
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = v_s[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        // rounded as the plain version rounds (no contraction into FMA),
        // so the state stays the plain version's bit for bit
        const float kv = __fmul_rn(k_s[tt][i], vj);
        const float se = __fadd_rn(S[i], __fmul_rn(u_s[i], kv));
        acc[i & 3] = fmaf(r_s[tt][i], se, acc[i & 3]);
        S[i] = __fadd_rn(__fmul_rn(w_s[tt][i], S[i]), kv);
      }
      O[(t0 + tt) * o_step] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }

  float* SO = a.s_out + bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) SO[i * HD + j] = S[i];
}

template <typename T, typename TW, typename TU>
cudaError_t launch(const WkvArgs& a, int hd, cudaStream_t stream) {
  const dim3 grid(a.B * a.H);
  switch (hd) {
    case 8:
      wkv6_kernel<T, TW, TU, 8><<<grid, 8, 0, stream>>>(a);
      break;
    case 16:
      wkv6_kernel<T, TW, TU, 16><<<grid, 16, 0, stream>>>(a);
      break;
    case 32:
      wkv6_kernel<T, TW, TU, 32><<<grid, 32, 0, stream>>>(a);
      break;
    case 64:
      wkv6_kernel<T, TW, TU, 64><<<grid, 64, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k and v share it); wdtype, udtype:
// the same codes for w and for u (float32, or dtype); s0, s_out and out are
// float32;
// device: the CUDA ordinal of the tensors, made current for the launch. strides: 12 element strides, (b, h, t) of r, k,
// v, w in that order (the feature dim has stride 1). s_out may be s0.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head dim or type it does not take).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const float* s0,
                        float* s_out, float* out, const long long* strides,
                        int B, int H, int T, int hd, int dtype, int wdtype,
                        int udtype, int device, void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  WkvArgs a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = w;
  a.u = u;
  a.s0 = s0;
  a.s_out = s_out;
  a.out = out;
  for (int i = 0; i < 3; ++i) {
    a.sr[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.sw[i] = strides[9 + i];
  }
  a.B = B;
  a.H = H;
  a.T = T;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && wdtype == 0 && udtype == 0)
    return (int)launch<float, float, float>(a, hd, st);
  if (dtype != 1 || wdtype < 0 || wdtype > 1 || udtype < 0 || udtype > 1)
    return (int)cudaErrorInvalidValue;
  if (wdtype == 0 && udtype == 0)
    return (int)launch<bf16, float, float>(a, hd, st);
  if (wdtype == 0) return (int)launch<bf16, float, bf16>(a, hd, st);
  if (udtype == 0) return (int)launch<bf16, bf16, float>(a, hd, st);
  return (int)launch<bf16, bf16, bf16>(a, hd, st);
}
