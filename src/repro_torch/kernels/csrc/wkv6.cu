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
// What bounds it on the H100: the time loop. A step is about 4 hd^2
// float32 operations on 4 hd inputs (~16 operations a byte in bf16, under
// the ~20 at which the 67 TFLOP/s of float32 FMA become the limit), but one
// (batch, head) is a chain of T dependent steps, and at batch 1 there are
// only H = 32 chains: one block of hd threads per chain would keep 32
// blocks of two warps on a 132-SM card, each step a 64-row dependent
// chain.
//
// What this design does about it, keeping the reference's numerics (no
// exp(-cumsum log w) factorisation: the decay enters only as products of
// values in (0, 1], never a division):
// - Rows over threads. A (batch, head) gets 4 hd threads: thread (g, j)
//   keeps rows [g R, g R + R) of column j of S in registers (R = hd / 4),
//   and a warp holds the four row groups of eight columns, so a column's
//   partial outputs meet by two xor shuffles at every head dim (hd 8 is
//   one warp). The output is r.S + (r.(u o k)) v_j: the scalar r.(u o k)
//   of each step is formed once a tile, so a state element costs four
//   operations a step; the update S = w S + k v keeps the plain version's
//   rounding (__fmul_rn / __fadd_rn, no contraction). At most 128
//   registers a thread, so two blocks of 256 threads share an SM (bf16
//   inputs; a float32 instance's tiles take an SM's shared memory alone).
// - Time over blocks. A cluster of C blocks per (batch, head) splits T
//   into C spans of whole steps, at most 192 a block a round (a longer T
//   loops in rounds with the state carried): C = 1 up to 32 steps, else
//   one block per 16 steps, 2 to 6 (measured on the H100 at B1 H32: at
//   T 17-32 one block beats two, and 8 blocks, two to an SM, were slower
//   than 6 from T 119 up). Each block walks its span from a zero state:
//   its local outputs (written to out), its end state dS, and r_t o D_t,
//   with D_t the product of w over the span's steps before t (kept in
//   shared memory, one row per step). After cluster.sync() the prefix
//   combine S_in(0) = the round's state, S_in(i+1) = D_end(i) o S_in(i) +
//   dS(i) runs elementwise over the state, each block folding 1/C of its
//   entries across the cluster through distributed shared memory and
//   writing every block's S_in there and the round's end state to s_out
//   (each block moves 3 hd^2 floats remotely, where every block folding
//   the whole state would read C hd^2). Each block then adds the cross
//   term (r_t o D_t) . S_in to its outputs: a
//   (span x hd) . (hd x hd) product in float32 FMA, 4 x 4 outputs a
//   thread.
// - C = 1 walks from s0 and skips the split. T = 1 (decode) reads the
//   step's r, k, w and u rows once a block, one element a thread, and no
//   tile.
// - Loads. r, k, v, w tiles of 16 steps are staged by cp.async (16 bytes a
//   copy where pointers and strides allow, else element loads) in two
//   stages: tile i + 1 is in flight while tile i is walked. A tile is
//   widened to float32 once, into row-group-padded rows that each thread
//   reads as float4s without bank conflicts.
// - s_out may alias s0 (decode updates the cache in place): every entry
//   of s0 is read by the one thread that later writes it. One launch a
//   call, no workspace: safe inside a CUDA graph.
//
// Layout: r, k, v, w (B,H,T,hd), each read through (b, h, t) element
// strides with unit feature stride, so the model passes transposed views of
// its (B,T,H,hd) projections; u (H,hd) contiguous; s0 and
// s_out (B,H,hd,hd) contiguous float32. out is written contiguous as
// (B,T,H,hd) float32 (the wrapper returns its (B,H,T,hd) view).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int G = 4;             // row groups of a column
constexpr int CW = 32 / G;       // columns a warp
constexpr int TT = 16;           // steps a tile
constexpr int SPAN = 192;        // most steps a block walks in one round
constexpr int MIN_SPAN = 16;     // fewest steps a block is given
constexpr int ONE_BLOCK = 32;    // ... and up to this many, one block
constexpr int MAX_C = 6;         // blocks a (batch, head) at most
constexpr unsigned FULL = 0xffffffffu;

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
  int C, rounds, L;  // blocks a (batch, head), rounds, steps a span
  int vec;           // 1: every row copy is 16-byte aligned (cp.async)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Shared memory of one instance, byte offsets. The cross-term buffers
// (rD, dS, D_end) exist only in a launch with C > 1.
template <typename T, typename TW, int HD>
struct Smem {
  static constexpr int NT = G * HD;                    // threads
  static constexpr int R = HD / G;                     // rows a thread
  static constexpr int WG = R == 16 ? R + 4 : R;       // padded row group
  static constexpr int WLD = G * WG;                   // widened row
  static constexpr int LDT = SPAN + 4;                 // rD row (steps)
  static constexpr size_t RAW = (size_t)TT * HD * (3 * sizeof(T) + sizeof(TW));
  static constexpr size_t STAGE0 = 0;                  // [2] raw tiles
  static constexpr size_t WORK = 2 * RAW;              // r, k, w [TT][WLD]
  static constexpr size_t WV = WORK + (size_t)3 * TT * WLD * 4;  // v [TT][HD]
  static constexpr size_t RUK = WV + (size_t)TT * HD * 4;        // [TT]
  static constexpr size_t U = RUK + (size_t)TT * 4;              // [HD]
  static constexpr size_t RD = U + (size_t)HD * 4;     // [HD][LDT]
  static constexpr size_t DS = RD + (size_t)HD * LDT * 4;        // [HD][HD]
  static constexpr size_t DEND = DS + (size_t)HD * HD * 4;       // [HD]
  static constexpr size_t DECODE = (size_t)4 * WLD * 4;  // r, k, w, u
  static constexpr size_t bytes(int C) {
    return C > 1 ? DEND + (size_t)HD * 4 : RD;
  }
  static_assert(RAW % 16 == 0 && (TT * WLD * 4) % 16 == 0, "alignment");
};

// rows [t0, t0 + rows) of one (B,H,T,hd) input into a raw stage [TT][HD]
template <int HD, typename E>
__device__ __forceinline__ void stage_rows(const E* base, long long st, int t0,
                                           int rows, E* dst, bool vec) {
  constexpr int NT = G * HD;
  constexpr int PER = 16 / (int)sizeof(E);  // elements a 16-byte copy
  constexpr int CPR = HD / PER;             // copies a row
  static_assert(HD % PER == 0, "a row is whole 16-byte chunks");
  if (vec) {
    for (int q = threadIdx.x; q < rows * CPR; q += NT) {
      const int row = q / CPR, ch = q % CPR;
      cp_async16(smem_u32(dst + row * HD + ch * PER),
                 base + (long long)(t0 + row) * st + ch * PER, true);
    }
  } else {
    for (int q = threadIdx.x; q < rows * HD; q += NT) {
      const int row = q / HD, col = q % HD;
      dst[q] = base[(long long)(t0 + row) * st + col];
    }
  }
}

template <int R>
__device__ __forceinline__ void ld_rows(const float* p, float (&x)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const float2 f = reinterpret_cast<const float2*>(p)[q];
      x[2 * q] = f.x;
      x[2 * q + 1] = f.y;
    }
  }
}

// T: the type of r, k, v; TW: of w; TU: of u. G * HD threads a block (two
// blocks an SM at hd 64); the block's rank in the cluster of its (batch,
// head) is blockIdx.x.
template <typename T, typename TW, typename TU, int HD>
__global__ void __launch_bounds__(G* HD, 2) wkv6_kernel(WkvArgs a) {
  using S_ = Smem<T, TW, HD>;
  constexpr int NT = S_::NT, R = S_::R, WG = S_::WG, WLD = S_::WLD;
  constexpr int LDT = S_::LDT, E = HD * HD;
  constexpr int TPS = NT / TT;  // threads a step when forming r.(u o k)
  static_assert(TPS * TT == NT && HD / TPS == 4 && TPS <= 32, "tile shape");
  static_assert(2 * S_::RAW >= (size_t)E * 4, "S_in fits the raw stages");
  extern __shared__ __align__(16) unsigned char smem[];
  float* work_r = reinterpret_cast<float*>(smem + S_::WORK);
  float* work_k = work_r + TT * WLD;
  float* work_w = work_k + TT * WLD;
  float* work_v = reinterpret_cast<float*>(smem + S_::WV);
  float* ruk_s = reinterpret_cast<float*>(smem + S_::RUK);
  float* u_s = reinterpret_cast<float*>(smem + S_::U);
  float* rd_s = reinterpret_cast<float*>(smem + S_::RD);
  float* ds_s = reinterpret_cast<float*>(smem + S_::DS);
  float* dend_s = reinterpret_cast<float*>(smem + S_::DEND);
  // S_in [HD][HD], written by the cluster's folds into the raw stages,
  // which are free once every block's span is walked
  float* sin_s = reinterpret_cast<float*>(smem + S_::STAGE0);
  auto raw = [&](int stage) { return smem + S_::STAGE0 + stage * S_::RAW; };

  const int C = a.C, rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / CW, c = lane % CW;
  const int j = warp * CW + c;  // state column
  const int i0 = g * R;         // first state row
  const bool vec = a.vec != 0;

  const T* Rp = (const T*)a.r + b * a.sr[0] + h * a.sr[1];
  const T* Kp = (const T*)a.k + b * a.sk[0] + h * a.sk[1];
  const T* Vp = (const T*)a.v + b * a.sv[0] + h * a.sv[1];
  const TW* Wp = (const TW*)a.w + b * a.sw[0] + h * a.sw[1];
  const TU* Up = (const TU*)a.u + h * HD;
  const long long bh = (long long)b * a.H + h;
  const float* S0 = a.s0 + bh * E;
  float* SO = a.s_out + bh * E;
  float* O = a.out + ((long long)b * a.T * a.H + h) * HD;  // out[b, t, h, :]
  const long long o_step = (long long)a.H * HD;

  if (a.T == 1) {
    // decode: one step. The step's r, k, w and u rows are read once a
    // block, one element a thread, into shared memory (padded row groups,
    // as the tiles below); the thread's partial of o_j is r.S + v_j
    // (r.(u o k)) over its rows
    float* rows_s = reinterpret_cast<float*>(smem);  // r, k, w, u [WLD]
    {
      const int which = tid / HD, i = tid % HD;
      const float x = which == 0   ? to_f32(Rp[i])
                      : which == 1 ? to_f32(Kp[i])
                      : which == 2 ? to_f32(Wp[i])
                                   : to_f32(Up[i]);
      rows_s[which * WLD + (i / R) * WG + i % R] = x;
    }
    float S[R];
#pragma unroll
    for (int m = 0; m < R; ++m) S[m] = S0[(i0 + m) * HD + j];
    const float vj = to_f32(Vp[j]);
    __syncthreads();
    float rv[R], kv[R];
    ld_rows<R>(rows_s + g * WG, rv);
    ld_rows<R>(rows_s + WLD + g * WG, kv);
    float acc[2] = {0.f, 0.f}, ruk[2] = {0.f, 0.f};
    {
      float uv[R];
      ld_rows<R>(rows_s + 3 * WLD + g * WG, uv);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        acc[m & 1] = fmaf(rv[m], S[m], acc[m & 1]);
        ruk[m & 1] = fmaf(rv[m] * uv[m], kv[m], ruk[m & 1]);
      }
    }
    {
      float wv[R];
      ld_rows<R>(rows_s + 2 * WLD + g * WG, wv);
#pragma unroll
      for (int m = 0; m < R; ++m)
        S[m] = __fadd_rn(__fmul_rn(wv[m], S[m]), __fmul_rn(kv[m], vj));
    }
    float o = fmaf(vj, ruk[0] + ruk[1], acc[0] + acc[1]);
    o += __shfl_xor_sync(FULL, o, CW);
    o += __shfl_xor_sync(FULL, o, 2 * CW);
    if (g == 0) O[j] = o;
#pragma unroll
    for (int m = 0; m < R; ++m) SO[(i0 + m) * HD + j] = S[m];
    return;
  }

  if (tid < HD) u_s[tid] = to_f32(Up[tid]);

  for (int round = 0; round < a.rounds; ++round) {
    const int lo = (round * C + rank) * a.L;
    const int n = max(0, min(a.T, lo + a.L) - lo);
    const int n_tiles = (n + TT - 1) / TT;
    float S[R];
#pragma unroll
    for (int m = 0; m < R; ++m) S[m] = C == 1 ? S0[(i0 + m) * HD + j] : 0.f;
    float D = 1.f;  // thread tid < HD: product of w of row tid so far

    auto fetch = [&](int tile) {
      unsigned char* st = raw(tile & 1);
      T* rr = reinterpret_cast<T*>(st);
      T* kk = rr + TT * HD;
      T* vv = kk + TT * HD;
      TW* ww = reinterpret_cast<TW*>(vv + TT * HD);
      const int t0 = lo + tile * TT, rows = min(TT, n - tile * TT);
      stage_rows<HD>(Rp, a.sr[2], t0, rows, rr, vec);
      stage_rows<HD>(Kp, a.sk[2], t0, rows, kk, vec);
      stage_rows<HD>(Vp, a.sv[2], t0, rows, vv, vec);
      stage_rows<HD>(Wp, a.sw[2], t0, rows, ww, vec);
    };
    if (n_tiles > 0) fetch(0);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
      if (it + 1 < n_tiles) fetch(it + 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile it
      __syncthreads();     // its copies and element loads, and u_s
      const int nt = min(TT, n - it * TT);
      const unsigned char* st = raw(it & 1);
      const T* rr = reinterpret_cast<const T*>(st);
      const T* kk = rr + TT * HD;
      const T* vv = kk + TT * HD;
      const TW* ww = reinterpret_cast<const TW*>(vv + TT * HD);
      // widen the tile to float32, rows padded per row group
      for (int e = tid; e < nt * HD; e += NT) {
        const int tt = e / HD, i = e % HD;
        const int x = tt * WLD + (i / R) * WG + i % R;
        work_r[x] = to_f32(rr[e]);
        work_k[x] = to_f32(kk[e]);
        work_w[x] = to_f32(ww[e]);
        work_v[e] = to_f32(vv[e]);
      }
      // r_t.(u o k_t) of each step: TPS threads a step, four rows each
      {
        const int tt = tid / TPS, q = tid % TPS;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          part = fmaf(to_f32(rr[tt * HD + i]) * u_s[i], to_f32(kk[tt * HD + i]),
                      part);
        }
#pragma unroll
        for (int o = TPS / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(FULL, part, o);
        if (q == 0) ruk_s[tt] = part;
      }
      // rD[i][t] = r_t,i D_t,i for the cross term, D the running product
      if (C > 1 && tid < HD) {
        float* rd = rd_s + tid * LDT + it * TT;
        for (int tt = 0; tt < nt; ++tt) {
          rd[tt] = to_f32(rr[tt * HD + tid]) * D;
          D *= to_f32(ww[tt * HD + tid]);
        }
      }
      __syncthreads();

      // four steps in flight: a step's loads and update overlap the
      // previous step's reduction and store
#pragma unroll 4
      for (int tt = 0; tt < nt; ++tt) {
        float rv[R], kv[R], wv[R];
        ld_rows<R>(work_r + tt * WLD + g * WG, rv);
        ld_rows<R>(work_k + tt * WLD + g * WG, kv);
        ld_rows<R>(work_w + tt * WLD + g * WG, wv);
        const float vj = work_v[tt * HD + j];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m = 0; m < R; ++m) {
          acc[m & 3] = fmaf(rv[m], S[m], acc[m & 3]);
          // rounded as the plain version rounds (no contraction into FMA)
          S[m] = __fadd_rn(__fmul_rn(wv[m], S[m]), __fmul_rn(kv[m], vj));
        }
        float o = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        o += __shfl_xor_sync(FULL, o, CW);
        o += __shfl_xor_sync(FULL, o, 2 * CW);
        if (g == 0)
          O[(long long)(lo + it * TT + tt) * o_step + j] =
              fmaf(vj, ruk_s[tt], o);
      }
    }
    cp_async_wait<0>();

    if (C == 1) {  // one round over all T steps from s0
#pragma unroll
      for (int m = 0; m < R; ++m) SO[(i0 + m) * HD + j] = S[m];
      return;
    }

    // the prefix combine, elementwise over the state: block `rank` folds
    // its share of the entries over the cluster's spans, S_in(c) = the
    // state entering span c, S_in(c + 1) = D_end(c) o S_in(c) + dS(c),
    // writing each S_in(c) into block c's shared memory and the round's
    // end state into s_out (the next round's state, read back by the same
    // thread; the final state after the last round). Block `rank` reads s0
    // only at the entries it writes, so s_out may alias s0.
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int m = 0; m < R; ++m) ds_s[(i0 + m) * HD + j] = S[m];
    if (tid < HD) dend_s[tid] = D;
    cluster.sync();
    for (int e = rank * NT + tid; e < E; e += C * NT) {
      float Se = round == 0 ? S0[e] : SO[e];
      const int i = e / HD;
#pragma unroll
      for (int cb = 0; cb < MAX_C; ++cb) {
        if (cb < C) {
          cluster.map_shared_rank(sin_s, cb)[e] = Se;
          Se = __fadd_rn(__fmul_rn(cluster.map_shared_rank(dend_s, cb)[i], Se),
                         cluster.map_shared_rank(ds_s, cb)[e]);
        }
      }
      SO[e] = Se;
    }
    cluster.sync();  // every S_in written; every dS and D_end read

    // out[t] += (r_t o D_t) . S_in over the span, 4 steps x 4 columns a
    // thread, 64 steps a pass; the local outputs written above are read
    // before the products so their latency overlaps them
    {
      constexpr int JG = HD / 4;            // column quads
      constexpr int TG = NT / JG;           // step quads a pass (16)
      const int jq = tid % JG, tq = tid / JG;
      for (int p0 = 0; p0 < n; p0 += 4 * TG) {
        const int t0 = p0 + 4 * tq;
        if (t0 >= n) continue;
        float4 prev[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t0 + e < n)
            prev[e] = *reinterpret_cast<const float4*>(
                O + (long long)(lo + t0 + e) * o_step + 4 * jq);
        float acc[4][4] = {};
#pragma unroll 8
        for (int i = 0; i < HD; ++i) {
          const float4 av =
              *reinterpret_cast<const float4*>(rd_s + i * LDT + t0);
          const float4 bv =
              *reinterpret_cast<const float4*>(sin_s + i * HD + 4 * jq);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int f = 0; f < 4; ++f)
              acc[e][f] = fmaf(ar[e], br[f], acc[e][f]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (t0 + e >= n) break;
          float4 x = prev[e];
          x.x += acc[e][0];
          x.y += acc[e][1];
          x.z += acc[e][2];
          x.w += acc[e][3];
          *reinterpret_cast<float4*>(
              O + (long long)(lo + t0 + e) * o_step + 4 * jq) = x;
        }
      }
    }
    __syncthreads();  // S_in (the raw stages) and rD are rewritten next round
  }
}

template <typename T, typename TW, typename TU, int HD>
cudaError_t launch_hd(const WkvArgs& a, cudaStream_t stream) {
  constexpr auto kernel = wkv6_kernel<T, TW, TU, HD>;
  // decode (T = 1) stages only its step's r, k, w and u rows
  const size_t smem = a.T == 1 ? Smem<T, TW, HD>::DECODE
                               : Smem<T, TW, HD>::bytes(a.C);
  cudaError_t err = attn::allow_smem<kernel>(Smem<T, TW, HD>::bytes(2));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C, a.H, a.B);
  cfg.blockDim = dim3(G * HD);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename TW, typename TU>
cudaError_t launch(const WkvArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch_hd<T, TW, TU, 8>(a, stream);
    case 16: return launch_hd<T, TW, TU, 16>(a, stream);
    case 32: return launch_hd<T, TW, TU, 32>(a, stream);
    case 64: return launch_hd<T, TW, TU, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Blocks a (batch, head) for T steps: one up to ONE_BLOCK steps, else one
// per MIN_SPAN steps, from 2 up to MAX_C.
int cluster_size(int T) {
  if (T <= ONE_BLOCK) return 1;
  const int c = (T + MIN_SPAN - 1) / MIN_SPAN;
  return c < 2 ? 2 : c > MAX_C ? MAX_C : c;
}

bool aligned16(const void* p, const long long* st, size_t es) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if ((st[i] * (long long)es) % 16) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k and v share it); wdtype, udtype:
// the same codes for w and for u (float32, or dtype); s0, s_out and out are
// float32; device: the CUDA ordinal of the tensors, made current for the
// launch. strides: 12 element strides, (b, h, t) of r, k, v, w in that
// order (the feature dim has stride 1). s_out may be s0. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head dim
// or type it does not take).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const float* s0,
                        float* s_out, float* out, const long long* strides,
                        int B, int H, int T, int hd, int dtype, int wdtype,
                        int udtype, int device, void* stream) {
  if (B < 1 || H < 1 || T < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 1 || wdtype < 0 || wdtype > 1 || udtype < 0 ||
      udtype > 1 || (dtype == 0 && (wdtype != 0 || udtype != 0)))
    return (int)cudaErrorInvalidValue;
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
  a.C = cluster_size(T);
  a.rounds = (T + a.C * SPAN - 1) / (a.C * SPAN);
  a.L = (T + a.C * a.rounds - 1) / (a.C * a.rounds);
  const size_t es = dtype == 0 ? 4 : 2, ws = wdtype == 0 ? 4 : 2;
  a.vec = aligned16(r, a.sr, es) && aligned16(k, a.sk, es) &&
          aligned16(v, a.sv, es) && aligned16(w, a.sw, ws);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float, float, float>(a, hd, st);
  if (wdtype == 0 && udtype == 0)
    return (int)launch<bf16, float, float>(a, hd, st);
  if (wdtype == 0) return (int)launch<bf16, float, bf16>(a, hd, st);
  if (udtype == 0) return (int)launch<bf16, bf16, float>(a, hd, st);
  return (int)launch<bf16, bf16, bf16>(a, hd, st);
}
