// Mamba2 SSD within-chunk kernel for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `ssd_chunk` / `_ssd_kernel` in
// src/repro/kernels/ssd.py. Per (batch, head, chunk), with cum[t] the
// inclusive prefix sum of dt*A over the chunk:
//
//   y_intra[t] = sum_{s<=t} exp(cum[t]-cum[s]) (C_t . B_s) dt_s x_s
//   h_chunk    = sum_s exp(cum[end]-cum[s]) dt_s x_s (x) B_s     (P x N)
//   decay      = exp(cum[end])
//
// in float32 whatever the input type (float32 or bfloat16). The cross-chunk
// recurrence and the y_cross term stay in PyTorch (kernels/ops.py
// ssd_scan), as in the reference.
//
// What bounds it on the H100: operations. A chunk of cl steps does about
// cl*(cl+1)*(N+P) + 2*cl*P*N multiply-adds' worth of operations on
// (2*cl*(P+N) + cl) inputs: at cl 256, P = N = 64 that is ~45 operations
// per float32 byte read, above the ~20 of the CUDA cores' float32 FMA
// (67 TFLOP/s) but far under the ~150 of TF32 tensor cores (495 TFLOP/s)
// and the ~295 of bf16 ones (989 TFLOP/s), so on the tensor cores it
// approaches the bytes' bound.
//
// What this design does about it: the chunk's three products run on the
// tensor cores with mma.sync, in float32 sums.
// - A block of four warps owns one 64-row tile of t (grid x); each warp 16
//   t rows. It walks the 64-row s tiles up to the diagonal (the s > t half
//   is never computed): the score S = C_t . B_s^T, then S * dt_s
//   exp(cum_t - cum_s) under s <= t in the accumulator's registers, then
//   y += score . x_s, like flash attention without the softmax. The
//   exponent runs on the special-function unit in base 2 (cum is kept
//   times log2 e).
// - bf16 inputs: m16n8k16 bf16 products (attention_tile.cuh's fragments and
//   ldmatrix loads; C's fragments stay in registers for the whole walk).
//   C . B^T of bf16 values is exact per product. The score enters
//   score . x as hi + lo bf16 terms (hi = bf16(v), lo = bf16(v - hi)) and
//   x exactly, as P enters P . V in the attention tile.
// - float32 inputs: m16n8k8 TF32 products, each as three terms hi.hi +
//   hi.lo + lo.hi (hi the value cut to TF32's 10-bit mantissa, lo the cut
//   rest): ~21 bits of each factor, where one TF32 pass puts outputs past
//   the 1e-4 the kernel is held to. Fragments come from shared memory by
//   scalar and float2 loads, the k order of each 8-wide step permuted
//   (k = t4 -> 2 t4, t4 + 4 -> 2 t4 + 1) so that an accumulator tile is
//   the next product's A fragment as it stands.
// - h_chunk = x^T . (B o dt emit) is spread over the chunk's blocks by
//   columns: the block of t tile i computes h's n8 column tiles
//   [i NQ / n_t, (i + 1) NQ / n_t) over every s tile, walking on past its
//   diagonal for h alone, so no block waits for another and nothing is
//   summed across blocks (summing each block's own s range in a cluster
//   held every block's SM until the chunk's longest walk ended, and was
//   slower on the H100). B's scaled rows enter as hi + lo (bf16) or three
//   TF32 terms. One launch a call, no workspace, no atomics: safe inside
//   a CUDA graph.
// - s tiles of B and x arrive by cp.async (16 bytes a copy where the
//   pointers and strides allow, else element loads) in two stages: tile
//   j + 1 loads while tile j multiplies. Every block computes the chunk's
//   cumsum itself (a warp-shuffle scan of <= 256 values). Feature widths
//   under 16 (the reference sweep's P 8, N 4 and 8) are zero-filled to 16
//   in shared memory and their extra outputs never written.
//
// Layout: x (B,H,nc,cl,P), dt (B,H,nc,cl), B/C (B,H,nc,cl,N), each read
// through (b, h, c, t) element strides with unit feature stride, so the
// caller passes permuted views of its (B,T,H,*) projections (a head stride
// of 0 broadcasts one B/C group over the heads); A (H,) float32.
// Outputs are contiguous float32: y (B,H,nc,cl,P), h (B,H,nc,P,N),
// decay (B,H,nc).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::exp2_approx;
using attn::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;       // t rows a block, s rows a tile
constexpr int THREADS = 128;   // four warps, 16 t rows each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CL = 256;    // longest chunk: four t tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct SsdArgs {
  const void* x;
  const void* dt;
  const float* A;
  const void* b;
  const void* c;
  float* y;
  float* h;
  float* dec;
  long long sx[4], sdt[4], sb[4], sc[4];  // (b, h, c, t) element strides
  int B, H, nc, cl;
  int vec_x, vec_b, vec_c;  // 1: that input's rows copy as 16-byte chunks
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0.f);
}
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16(0.f);
}

__host__ __device__ constexpr int at_least16(int n) { return n < 16 ? 16 : n; }

// Shared memory of one instance (byte offsets): cum * log2 e, dt and
// dt exp(cum_end - cum) of the chunk's steps; the C rows of the t tile; two
// stages of B and x rows. Rows are padded so that the fragment loads hit
// distinct banks: bf16 rows an odd number of 16-byte chunks (ldmatrix),
// float32 rows 8 words past a multiple of 32 (B, C: float2 by row g) or 4
// (x: scalar by rows 2 t4).
template <typename T, int P, int N>
struct Smem {
  static constexpr bool BF = sizeof(T) == 2;
  static constexpr int NK = at_least16(N);  // depth of C . B^T
  static constexpr int PP = at_least16(P);  // columns of y
  static constexpr int LDN = NK + 8;
  static constexpr int LDP = BF ? PP + 8 : PP + 4;
  static constexpr size_t CUM = 0;                                // [MAX_CL]
  static constexpr size_t DT = CUM + MAX_CL * 4;                  // [MAX_CL]
  static constexpr size_t FW = DT + MAX_CL * 4;                   // [MAX_CL]
  static constexpr size_t CS = FW + MAX_CL * 4;          // [TILE][LDN]
  static constexpr size_t BS = CS + (size_t)TILE * LDN * sizeof(T);  // [2]
  static constexpr size_t XS = BS + (size_t)2 * TILE * LDN * sizeof(T);
  static constexpr size_t bytes = XS + (size_t)2 * TILE * LDP * sizeof(T);
  static_assert((LDN * sizeof(T)) % 16 == 0 && (LDP * sizeof(T)) % 16 == 0,
                "16-byte rows");
};

// rows [row0, row0 + TILE) of one (.., cl, n) input into a [TILE][LD] tile,
// zero past the chunk's cl rows and past its n columns up to W
template <typename T, int W, int LD>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long st,
                                          int row0, int cl, int n, bool vec) {
  constexpr int PER = 16 / (int)sizeof(T);
  constexpr int CPR = W / PER;  // 16-byte chunks of a padded row
  static_assert(W % PER == 0, "whole chunks");
  if (vec) {
    for (int q = threadIdx.x; q < TILE * CPR; q += THREADS) {
      const int r = q / CPR, ch = q % CPR;
      const bool in = row0 + r < cl && ch * PER < n;
      cp_async16(smem_u32(dst + r * LD + ch * PER),
                 src + (in ? (long long)(row0 + r) * st + ch * PER : 0), in);
    }
  } else {
    for (int q = threadIdx.x; q < TILE * W; q += THREADS) {
      const int r = q / W, col = q % W;
      dst[r * LD + col] = row0 + r < cl && col < n
                              ? src[(long long)(row0 + r) * st + col]
                              : zero_of<T>();
    }
  }
}

// ---- TF32: three-term products --------------------------------------------

// the TF32 value the tensor cores read: the float32 mantissa cut to 10 bits
__device__ __forceinline__ uint32_t tf32_hi(float v) {
  return __float_as_uint(v) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_hi(v);
  lo = tf32_hi(v - __uint_as_float(hi));
}

// d += a . b on one m16n8k8 tile, TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b as hi.hi + hi.lo + lo.hi; a given as four float32 values in
// fragment order, b as two
__device__ __forceinline__ void mma3(float (&d)[4], const float (&a)[4],
                                     float b0, float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// One block: t tile blockIdx.x of chunk (blockIdx.z % nc) of batch
// (blockIdx.z / nc), head blockIdx.y.
template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(SsdArgs a) {
  static_assert((P == 8 || P % 16 == 0) && P <= 64 &&
                    (N == 4 || N == 8 || N % 16 == 0) && N <= 64,
                "P in 8, 16, 32, 64; N in 4, 8, 16, 32, 64");
  using L = Smem<T, P, N>;
  constexpr bool BF = L::BF;
  constexpr int NK = L::NK, PP = L::PP, LDN = L::LDN, LDP = L::LDP;
  constexpr int NN = N < 8 ? 8 : N;  // columns of the h partial (n8 tiles)
  extern __shared__ __align__(16) unsigned char smem[];
  float* cum2 = reinterpret_cast<float*>(smem + L::CUM);
  float* dts = reinterpret_cast<float*>(smem + L::DT);
  float* fws = reinterpret_cast<float*>(smem + L::FW);
  T* c_s = reinterpret_cast<T*>(smem + L::CS);
  T* b_s = reinterpret_cast<T*>(smem + L::BS);
  T* x_s = reinterpret_cast<T*>(smem + L::XS);
  __shared__ float warp_tot[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int ti = blockIdx.x, hh = blockIdx.y;
  const int b = blockIdx.z / a.nc, c = blockIdx.z % a.nc;
  const int cl = a.cl, t0 = ti * TILE;

  const T* X = (const T*)a.x + b * a.sx[0] + hh * a.sx[1] + c * a.sx[2];
  const T* DT = (const T*)a.dt + b * a.sdt[0] + hh * a.sdt[1] + c * a.sdt[2];
  const T* Bp = (const T*)a.b + b * a.sb[0] + hh * a.sb[1] + c * a.sb[2];
  const T* Cp = (const T*)a.c + b * a.sc[0] + hh * a.sc[1] + c * a.sc[2];
  const long long bhc = ((long long)b * a.H + hh) * a.nc + c;

  // the C rows of the t tile and the first s tile, one copy group
  copy_tile<T, NK, LDN>(c_s, Cp, a.sc[3], t0, cl, N, a.vec_c);
  auto load_s = [&](int st) {
    const int stage = st & 1;
    copy_tile<T, NK, LDN>(b_s + stage * TILE * LDN, Bp, a.sb[3], st * TILE,
                          cl, N, a.vec_b);
    copy_tile<T, PP, LDP>(x_s + stage * TILE * LDP, X, a.sx[3], st * TILE,
                          cl, P, a.vec_x);
  };
  load_s(0);
  cp_async_commit();

  // cum = inclusive prefix sum of dt*A: thread i holds steps 2i and 2i + 1;
  // a shuffle scan inside each warp, then the warps' totals
  {
    const float A = a.A[hh];
    const int s0 = 2 * tid;
    const float d0 = s0 < cl ? to_f32(DT[s0 * a.sdt[3]]) : 0.f;
    const float d1 = s0 + 1 < cl ? to_f32(DT[(s0 + 1) * a.sdt[3]]) : 0.f;
    const float v0 = d0 * A, v1 = d1 * A;
    float incl = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float nb = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += nb;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    float pre = 0.f;
    for (int w = 0; w < warp; ++w) pre += warp_tot[w];
    const float c0 = pre + (incl - (v0 + v1)) + v0, c1 = c0 + v1;
    cum2[s0] = c0 * LOG2E;
    cum2[s0 + 1] = c1 * LOG2E;
    dts[s0] = d0;
    dts[s0 + 1] = d1;
    __syncthreads();
    // dt_s exp(cum_end - cum_s), 0 past the chunk (dt 0 there)
    const float cend2 = cum2[cl - 1];
    fws[s0] = d0 * exp2_approx(cend2 - cum2[s0]);
    fws[s0 + 1] = d1 * exp2_approx(cend2 - cum2[s0 + 1]);
  }

  // this thread's two t rows and their cum
  const int r0 = t0 + warp * 16 + g, r1 = r0 + 8;
  const float ct0 = r0 < cl ? cum2[r0] : 0.f, ct1 = r1 < cl ? cum2[r1] : 0.f;

  constexpr int KS = NK / 16;  // bf16 k16 steps of C . B^T
  uint32_t cf[BF ? KS : 1][4];
  float o[PP / 8][4];
#pragma unroll
  for (int q = 0; q < PP / 8; ++q) o[q][0] = o[q][1] = o[q][2] = o[q][3] = 0.f;
  float hacc[NN / 8][4];  // this block's n8 tiles of h
#pragma unroll
  for (int q = 0; q < NN / 8; ++q)
    hacc[q][0] = hacc[q][1] = hacc[q][2] = hacc[q][3] = 0.f;

  // h's n8 column tiles of this block: [q_lo, q_hi) of NN / 8
  constexpr int NQ = NN / 8;
  const int n_t = (cl + TILE - 1) / TILE;
  const int q_lo = ti * NQ / n_t, q_hi = (ti + 1) * NQ / n_t;
  // the diagonal's s tile, then the rest of the chunk for h alone
  const int n_s = q_lo < q_hi ? n_t : ti + 1;
  for (int st = 0; st < n_s; ++st) {
    if (st + 1 < n_s) load_s(st + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile st (and, first, the C rows)
    __syncthreads();
    const T* bt = b_s + (st & 1) * TILE * LDN;
    const T* xt = x_s + (st & 1) * TILE * LDP;
    const int s0 = st * TILE;
    if (st <= ti) {
      // S = C_t . B_s^T: 16 t rows x 64 s columns a warp
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (BF) {
        using namespace attn::tc;
        if (st == 0) {
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            ldsm_x4(cf[kk], smem_u32(c_s + (warp * 16 + (lane & 15)) * LDN +
                                     kk * 16 + (lane >> 4) * 8));
        }
        const uint32_t bb = smem_u32(bt);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            uint32_t f[4];
            const int r = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
            const int col = kk * 16 + ((lane >> 3) & 1) * 8;
            ldsm_x4(f, bb + (r * LDN + col) * 2);
            mma(s[2 * jp], cf[kk], f[0], f[1]);
            mma(s[2 * jp + 1], cf[kk], f[2], f[3]);
          }
        }
      } else {
        const float* cr0 = reinterpret_cast<const float*>(c_s) +
                           (warp * 16 + g) * LDN + 2 * t4;
        const float* bsf = reinterpret_cast<const float*>(bt);
#pragma unroll 1
        for (int k0 = 0; k0 < NK; k0 += 8) {
          const float2 u0 = *reinterpret_cast<const float2*>(cr0 + k0);
          const float2 u1 =
              *reinterpret_cast<const float2*>(cr0 + 8 * LDN + k0);
          const float af[4] = {u0.x, u1.x, u0.y, u1.y};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 bv = *reinterpret_cast<const float2*>(
                bsf + (8 * j + g) * LDN + k0 + 2 * t4);
            mma3(s[j], af, bv.x, bv.y);
          }
        }
      }

      // score = S dt_s exp(cum_t - cum_s) where s <= t < cl, else 0
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int sc = s0 + 8 * j + 2 * t4;
        const float2 cs = *reinterpret_cast<const float2*>(cum2 + sc);
        const float2 ds = *reinterpret_cast<const float2*>(dts + sc);
        const bool in0 = r0 < cl, in1 = r1 < cl;
        s[j][0] = sc <= r0 && in0 ? s[j][0] * (ds.x * exp2_approx(ct0 - cs.x))
                                  : 0.f;
        s[j][1] = sc < r0 && in0 ? s[j][1] * (ds.y * exp2_approx(ct0 - cs.y))
                                 : 0.f;
        s[j][2] = sc <= r1 && in1 ? s[j][2] * (ds.x * exp2_approx(ct1 - cs.x))
                                  : 0.f;
        s[j][3] = sc < r1 && in1 ? s[j][3] * (ds.y * exp2_approx(ct1 - cs.y))
                                 : 0.f;
      }

      // y += score . x_s
      if constexpr (BF) {
        using namespace attn::tc;
        const uint32_t xb = smem_u32(xt);
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          uint32_t ah[4], al[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
          for (int dp = 0; dp < PP / 16; ++dp) {
            uint32_t f[4];
            const int r = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
            const int col = dp * 16 + (lane >> 4) * 8;
            ldsm_x4_trans(f, xb + (r * LDP + col) * 2);
            mma(o[2 * dp], ah, f[0], f[1]);
            mma(o[2 * dp], al, f[0], f[1]);
            mma(o[2 * dp + 1], ah, f[2], f[3]);
            mma(o[2 * dp + 1], al, f[2], f[3]);
          }
        }
      } else {
        const float* xf = reinterpret_cast<const float*>(xt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // accumulator tile j is the A fragment of k step j (k permuted)
          const float af[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
          const float* xr = xf + (8 * j + 2 * t4) * LDP + g;
#pragma unroll
          for (int q = 0; q < PP / 8; ++q)
            mma3(o[q], af, xr[8 * q], xr[LDP + 8 * q]);
        }
      }

    }  // st <= ti

    // this block's columns of h = x^T . (B o dt emit) over s tile st
    if (q_lo < q_hi && warp * 16 < PP) {
      const int p0 = warp * 16;
      if constexpr (BF) {
        using namespace attn::tc;
        const uint32_t xb = smem_u32(xt);
        const bf16* bsb = reinterpret_cast<const bf16*>(bt);
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          uint32_t af[4];
          const int r = kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
          const int col = p0 + ((lane >> 3) & 1) * 8;
          ldsm_x4_trans(af, xb + (r * LDP + col) * 2);
          const int sk = kk * 16 + 2 * t4;  // rows sk, sk+1, sk+8, sk+9
          const float f0 = fws[s0 + sk], f1 = fws[s0 + sk + 1];
          const float f8 = fws[s0 + sk + 8], f9 = fws[s0 + sk + 9];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            if (q < q_lo || q >= q_hi) continue;
            const int n = 8 * q + g;
            uint32_t h0, l0, h1, l1;
            split_bf16(__bfloat162float(bsb[sk * LDN + n]) * f0,
                       __bfloat162float(bsb[(sk + 1) * LDN + n]) * f1, h0,
                       l0);
            split_bf16(__bfloat162float(bsb[(sk + 8) * LDN + n]) * f8,
                       __bfloat162float(bsb[(sk + 9) * LDN + n]) * f9, h1,
                       l1);
            mma(hacc[q], af, h0, h1);
            mma(hacc[q], af, l0, l1);
          }
        }
      } else {
        const float* xf = reinterpret_cast<const float*>(xt);
        const float* bsf = reinterpret_cast<const float*>(bt);
#pragma unroll 1
        for (int k0 = 0; k0 < TILE; k0 += 8) {
          const int sk = k0 + 2 * t4;  // rows sk and sk + 1 (k permuted)
          const float* xr = xf + sk * LDP + p0 + g;
          const float af[4] = {xr[0], xr[8], xr[LDP], xr[LDP + 8]};
          const float f0 = fws[s0 + sk], f1 = fws[s0 + sk + 1];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            if (q < q_lo || q >= q_hi) continue;
            const int n = 8 * q + g;
            mma3(hacc[q], af, bsf[sk * LDN + n] * f0,
                 bsf[(sk + 1) * LDN + n] * f1);
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();

  // y rows r0 and r1, columns 8q + 2 t4 (+1) below P
  float* Y = a.y + bhc * cl * P;
#pragma unroll
  for (int q = 0; q < PP / 8; ++q) {
    const int p = 8 * q + 2 * t4;
    if (p >= P) continue;
    if (r0 < cl)
      *reinterpret_cast<float2*>(Y + (long long)r0 * P + p) =
          make_float2(o[q][0], o[q][1]);
    if (r1 < cl)
      *reinterpret_cast<float2*>(Y + (long long)r1 * P + p) =
          make_float2(o[q][2], o[q][3]);
  }

  // h: rows p and p + 8 of each warp, this block's columns, below P and N
  float* Hout = a.h + bhc * P * N;
  if (warp * 16 < PP) {
    const int p = warp * 16 + g;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (q < q_lo || q >= q_hi) continue;
      const int n = 8 * q + 2 * t4;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (n + e >= N) continue;
        if (p < P) Hout[p * N + n + e] = hacc[q][e];
        if (p + 8 < P) Hout[(p + 8) * N + n + e] = hacc[q][2 + e];
      }
    }
  }
  if (ti == 0 && tid == 0) a.dec[bhc] = exp2_approx(cum2[cl - 1]);
}

template <typename T, int P, int N>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  constexpr auto kernel = ssd_chunk_kernel<T, P, N>;
  constexpr size_t smem = Smem<T, P, N>::bytes;
  cudaError_t err = attn::allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.cl + TILE - 1) / TILE, a.H, a.B * a.nc);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_n(const SsdArgs& a, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, P, 4>(a, stream);
    case 8: return launch<T, P, 8>(a, stream);
    case 16: return launch<T, P, 16>(a, stream);
    case 32: return launch<T, P, 32>(a, stream);
    case 64: return launch<T, P, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_pn(const SsdArgs& a, int P, int N, cudaStream_t stream) {
  switch (P) {
    case 8: return launch_n<T, 8>(a, N, stream);
    case 16: return launch_n<T, 16>(a, N, stream);
    case 32: return launch_n<T, 32>(a, N, stream);
    case 64: return launch_n<T, 64>(a, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

// rows of n elements of es bytes, read through strides st (b, h, c, t),
// copy as whole 16-byte chunks from 16-byte aligned addresses
bool chunks16(const void* p, const long long* st, int n, size_t es) {
  if (reinterpret_cast<uintptr_t>(p) % 16 || (n * es) % 16) return false;
  for (int i = 0; i < 4; ++i)
    if ((st[i] * (long long)es) % 16) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B and C share it; A is float32);
// device: the CUDA ordinal of the tensors, made current for the launch.
// strides: 16 element strides, (b, h, c, t) of x, dt, B, C in that order
// (the feature dims P and N have stride 1). y, h and dec are contiguous
// float32. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a chunk length, P, N or type it does not take).
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const float* A,
                             const void* bm, const void* cm, float* y,
                             float* h, float* dec, const long long* strides,
                             int B, int H, int nc, int cl, int P, int N,
                             int dtype, int device, void* stream) {
  if (cl < 1 || cl > MAX_CL || B < 1 || H < 1 || nc < 1 || H > 65535 ||
      (long long)B * nc > 65535 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  SsdArgs a;
  a.x = x;
  a.dt = dt;
  a.A = A;
  a.b = bm;
  a.c = cm;
  a.y = y;
  a.h = h;
  a.dec = dec;
  for (int i = 0; i < 4; ++i) {
    a.sx[i] = strides[i];
    a.sdt[i] = strides[4 + i];
    a.sb[i] = strides[8 + i];
    a.sc[i] = strides[12 + i];
  }
  a.B = B;
  a.H = H;
  a.nc = nc;
  a.cl = cl;
  const size_t es = dtype == 0 ? 4 : 2;
  a.vec_x = chunks16(x, a.sx, P, es);
  a.vec_b = chunks16(bm, a.sb, N, es);
  a.vec_c = chunks16(cm, a.sc, N, es);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_pn<float>(a, P, N, st);
  return (int)launch_pn<bf16>(a, P, N, st);
}
