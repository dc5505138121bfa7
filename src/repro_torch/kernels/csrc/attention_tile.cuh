// The shared tile core of the two prefill attention kernels for Hopper
// (sm_90a), hand-written CUDA C++: flash_attention.cu (keys in a strided
// contiguous tensor) and chunked_prefill_attention.cu (keys in a paged pool
// found through a block table). Both compute flash attention by positions;
// they differ only in where a key row lives, which each file gives the core
// as a small policy type:
//
//   struct Keys {
//     // what finding row kj needs from memory (the paged table entry),
//     // read one tile ahead of the copy
//     __device__ int locate(int kj) const;
//     // element pointers to K and V row kj (kj in [0, Sk)), unit d stride
//     __device__ void rows(int kj, int loc, const bf16*& k,
//                          const bf16*& v) const;
//   };
//
// Semantics (the JAX oracle's): a (query, key) pair is valid iff
// 0 <= k_pos <= q_pos, plus window (k_pos > q_pos - window) and chunk
// (k_pos / chunk == q_pos / chunk) when > 0. A masked score is the finite
// -1e9 and a key past the ragged edge scores -inf; the running max starts at
// -inf; softmax and accumulation are f32; the denominator is clamped at
// 1e-30; a pad query (q_pos = -1) writes 0. Where the caller gives
// Tile::lse, each row's logsumexp is written beside its output.
//
// What bounds the kernels on the H100: at the main paths' shapes (S = 256
// chunk queries over <= 1k history keys at hd 64; S = 512 causal prompts at
// hd 64 and 112) the function's bytes over 3.35 TB/s exceed its valid
// pairs' operations over 989 TFLOP/s, so both are bound by bytes on paper.
// In practice a block's 64 x 64 score tile is bound by the latency of its
// four warps' instruction streams: the chunk shape gives 128 blocks, one
// per SM, and flash's registers allow three blocks an SM at hd 64.
//
// What this design does about it (FlashAttention-2's shape):
// - One block of four warps per (64-query tile, q head, batch); each warp
//   owns 16 query rows. Tiles run in reverse so the causal tiles with the
//   most keys start first.
// - Both products run on the tensor cores with
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32. Q·Kᵀ: Q's A fragments are
//   loaded once with ldmatrix and stay in registers for the whole key loop;
//   K's B fragments come from shared memory with ldmatrix. P·V: the S
//   accumulator of two adjacent n8 tiles is exactly the A fragment of one
//   k16 step, so P never touches shared memory; V's B fragments come with
//   ldmatrix.trans. O accumulates in f32 registers.
// - P enters P·V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so
//   the product keeps ~16 bits of p: one bf16 rounding of p puts a few
//   outputs of the main-path cases past the check against the float32
//   plain version (2e-3 absolute + 1e-2 relative), where a weight near 0.5
//   multiplies a value of a few units and the output cancels to ~0. The lo
//   term costs a third more tensor work and no extra bytes.
// - K and V tiles of 64 keys arrive by cp.async.cg (16 bytes a copy),
//   double-buffered: tile j+1 loads while tile j multiplies. Two threads
//   copy a row, one 32-byte sector a step, and the paged kernel's table
//   entry for a row is read one tile before its copy. Rows past the ragged
//   edge are zero-filled (src-size 0) and never read. Shared rows are
//   padded to depth + 8 bf16, an odd number of 16-byte chunks at every
//   head dim (hd 112, and hd 100 zero-filled to 112: 240 bytes, 15 chunks;
//   hd 16, and hd 8 zero-filled to 16: 48 bytes, 3 chunks), so ldmatrix is
//   free of bank conflicts.
// - hd 100 (LLaMA-3B): a bf16 row is 200 bytes, and the rows of a (B, S,
//   H, 100) projection start on 8-byte boundaries only, so that instance
//   copies 8-byte pieces (cp.async.ca, 25 a row, two threads a 16-byte
//   step) and zero-fills the row to depth 112 in the same copies; the
//   products run 7 k16 steps and 14 n8 tiles of O, whose columns past 100
//   are never stored. Its registers are hd 112's; it issues twice the
//   copies.
// - hd 160 (StableLM-2-12B): 10 k16 steps and 20 n8 tiles of O, 16-byte
//   pieces (a 320-byte row, 20 pieces). The warp's live arrays grow to
//   Q's fragments (40 registers), O (80) and S (32); ptxas fits them in
//   245 registers (flash) and 240 (chunked prefill) with no spill, under
//   the 255 that __launch_bounds__(128, 2) leaves, so the instance is the
//   same code as the others. (Reading Q's fragments from shared memory
//   each k16 step instead took 219 / 211 registers and was no faster on
//   the H100: chip_kernel_ab.py, PERF.md.)
// - Before the key loop the block marks the tiles that hold a key some
//   valid query of the block may see (0 <= k_pos <= max q_pos, and inside
//   the window or chunk of the smallest q_pos); the loop visits only those,
//   so a tile is skipped only when the positions prove every pair masked,
//   never because of its index, and a causal prompt does about half the
//   work. The per-pair mask is then applied exactly, per accumulator
//   element, as each row's key range first_key(q_pos) <= k_pos <= q_pos:
//   two compares, where the pair test with its chunk division cost a tile
//   more than both products. The exponentials run on the special-function
//   unit (ex2.approx).
// - Shared memory per block: Q 64 x (hd+8) bf16, two stages of K and V
//   64 x (hd+8) each, two stages of 64 key positions, 8 ints of reduction,
//   the tile bits. At hd 128: 17,408 + 69,632 + 512 + 32 + 4 per 32 tiles
//   ~ 87.6 KB, at hd 160 (rows of 168): 21,504 + 86,016 + 548 ~ 108.1 KB,
//   so two blocks fit an SM (227 KB); __launch_bounds__(128, 2) leaves
//   each thread up to 255 registers.
// Next step: wgmma with TMA loads into a ring of stages and, for flash, a
// producer warp that keeps the loads in flight.
//
// The float32 instances of both kernels keep their FMA bodies (in their own
// files); the helpers they share are in the first part of this header.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF_SCORE = -1e9f;  // finite mask value of the oracle

struct Strides4 {
  long long b, h, s, d;
};

// 0 <= kp <= qp, plus window / chunk when > 0 (the && chain keeps the
// integer divisions on non-negative operands only).
__device__ __forceinline__ bool allowed(int qp, int kp, int window,
                                        int chunk) {
  bool ok = (kp >= 0) && (kp <= qp);
  if (window > 0) ok = ok && (kp > qp - window);
  if (chunk > 0) ok = ok && (kp / chunk == qp / chunk);
  return ok;
}

// Raise ``Kernel``'s dynamic shared memory limit to ``bytes`` once per
// device (and again only when a launch needs more), so a launch inside a
// CUDA graph capture makes no attribute call. One cache per kernel: every
// instance has the same function type.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  set[dev] = bytes;
  return cudaSuccess;
}

// cp.async copies (16 bytes, 8 or 4), global -> shared
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 8 bytes (rows that start on 8-byte boundaries only); zero-filled when !in
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

// Bytes of one cp.async piece of a row of HD elements of E bytes: 16, or
// 8 where a row is not a whole number of 16-byte pieces (bf16 hd 100: 200
// bytes). The wrappers' row checks (flash_attention.piece_bytes) mirror it.
template <int HD, int E = 2>
__host__ __device__ constexpr int piece_bytes() {
  return (HD * E) % 16 == 0 ? 16 : 8;
}

// a CB-byte piece (16 or 8)
template <int CB>
__device__ __forceinline__ void cp_async_piece(uint32_t dst, const void* src,
                                               bool in) {
  static_assert(CB == 16 || CB == 8, "cp.async piece of 16 or 8 bytes");
  if constexpr (CB == 16)
    cp_async16(dst, src, in);
  else
    cp_async8(dst, src, in);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The keys query position qp may see are exactly lo <= k_pos <= qp with
// lo = first_key(qp): 0, raised to qp - window + 1 (window) and to the
// start of qp's chunk (chunk) when those are > 0; an empty range for a pad
// query (qp < 0 <= lo). The same set as allowed(qp, .), in two compares.
__device__ __forceinline__ int first_key(int qp, int window, int chunk) {
  int lo = 0;
  if (window > 0) lo = max(lo, qp - window + 1);
  if (chunk > 0 && qp >= 0) lo = max(lo, qp - qp % chunk);
  return lo;
}

// 2^x on the special-function unit; a result below 2^-126 flushes to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The float32 FMA bodies of flash and chunked prefill: the columns of a V
// row in shared memory, whole groups of 8 (a thread's output columns are
// tx + 8j), zero past hd (hd 100: 104)
template <int HD>
__host__ __device__ constexpr int vcols() {
  return (HD + 7) / 8 * 8;
}

// Zero the columns past hd of a [rows][vcols] V tile (hd 100: 100-103),
// read by each thread's last j and never written by the tile copies: once
// a block, before the key loop
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void zero_v_tail(float* v_s, int tid) {
  constexpr int HV = vcols<HD>(), PAD = HV - HD;
  if constexpr (PAD > 0)
    for (int i = tid; i < ROWS * PAD; i += THREADS)
      v_s[(i / PAD) * HV + HD + i % PAD] = 0.f;
}

// ------------------------------------------------------------------------
// bf16 tensor-core tile core
// ------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // queries per block, 16 per warp
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // four warps
constexpr int STAGES = 2;     // K/V tiles in flight
constexpr float LOG2E = 1.4426950408889634f;

// The depth the products run at: whole m16n8k16 steps, so hd 8 rows are
// zero-filled to 16 and hd 100 rows to 112 in shared memory (see
// attention_tile)
template <int HD>
__host__ __device__ constexpr int depth() {
  return (HD + 15) / 16 * 16;
}

// Byte offsets of the dynamic shared memory of one block.
template <int HD>
struct Layout {
  static constexpr int LD = depth<HD>() + 8;  // padded row, bf16 elements
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + (size_t)BQ * LD * 2;
  static constexpr size_t V = K + (size_t)STAGES * BK * LD * 2;
  static constexpr size_t KPOS = V + (size_t)STAGES * BK * LD * 2;
  static constexpr size_t RED = KPOS + (size_t)STAGES * BK * 4;
  static constexpr size_t LIVE = RED + 8 * 4;
  __host__ __device__ static constexpr size_t bytes(int n_kt) {
    return LIVE + (size_t)4 * ((n_kt + 31) / 32);
  }
};

// What the core reads and writes for one (batch, q head): pointers already
// offset to the pair, d stride 1 everywhere.
struct Tile {
  const bf16* q;      // row qi at q + qi * q_s
  bf16* out;          // row qi at out + qi * o_s
  long long q_s, o_s;
  const int* qpos;    // (Sq,), -1 = pad query
  const int* kpos;    // (Sk,)
  int Sq, Sk, window, chunk;
  float scale_log2;   // softmax scale * log2(e)
  // row qi's logsumexp of the scaled scores at lse[qi] (natural log,
  // float32; +inf where the row sees no key); none where nullptr
  float* lse = nullptr;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a · b on one m16n8k16 tile, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> packed bf16 hi = bf16(x, y) (x in the low half) and lo =
// bf16 of what hi leaves out
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// first tile >= from whose bit is set, or n_kt
__device__ __forceinline__ int next_live(const uint32_t* live, int from,
                                         int n_kt) {
  for (int w = from >> 5; (w << 5) < n_kt; ++w) {
    uint32_t bits = live[w];
    if (w == (from >> 5)) bits &= ~0u << (from & 31);
    if (bits) return (w << 5) + __ffs(bits) - 1;
  }
  return n_kt;
}

// One block: the 64-query tile (reversed blockIdx.x) of one (batch, q head)
// against every live key tile. 128 threads; dynamic shared memory
// Layout<HD>::bytes(ceil(Sk / 64)).
//
// hd 8 runs this core at depth 16 (one k16 step): its Q, K and V rows are
// copied into the lower half of 16-wide shared rows and the upper half is
// zero-filled by the same cp.async (src-size 0, nothing read), so Q·Kᵀ adds
// exact zeros and the upper 8 output columns, never written, are 0. That
// keeps one bf16 body for every head dim, where an FMA body would be a
// second one for a shape off the main paths. hd 100 runs it the same way at
// depth 112, its rows copied in 8-byte pieces (piece_bytes); the softmax
// scale is the caller's 1/sqrt(hd), never the depth's.
template <int HD, class Keys>
__device__ __forceinline__ void attention_tile(const Tile& p, const Keys& keys,
                                               unsigned char* smem) {
  constexpr int HDP = depth<HD>();
  static_assert(HDP <= 160, "head dim <= 160");
  using L = Layout<HD>;
  constexpr int LD = L::LD;
  constexpr int KSTEPS = HDP / 16;  // k16 steps of Q·Kᵀ
  constexpr int DT = HDP / 8;       // n8 tiles of O
  constexpr int CB = piece_bytes<HD>();
  constexpr int CE = CB / 2;        // bf16 elements a copied piece
  constexpr int CPR = HDP / CE;     // pieces per shared row
  constexpr int CIN = HD / CE;      // ... of them present in device memory
  static_assert(HD % CE == 0 && CPR % 2 == 0, "head dim");
  static_assert(THREADS == 2 * BQ && THREADS == 2 * BK, "two threads a row");
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::K);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::V);
  int* kpos_s = reinterpret_cast<int*>(smem + L::KPOS);
  int* red_s = reinterpret_cast<int*>(smem + L::RED);
  uint32_t* live_s = reinterpret_cast<uint32_t*>(smem + L::LIVE);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int n_kt = (p.Sk + BK - 1) / BK;
  // copies: thread tid moves row cr's pieces 2i + cs, so a pair of threads
  // reads one 32-byte sector a step (16 bytes with 8-byte pieces) and a
  // row's address (a table lookup in the paged kernel) is found once per
  // tile
  const int cr = tid >> 1, cs = tid & 1;

  // Q tile, zero rows past Sq (its own copy group)
  {
    const int qi = q0 + cr;
    const bool in = qi < p.Sq;
    const bf16* src = p.q + (in ? qi : 0) * p.q_s;
#pragma unroll
    for (int i = 0; i < CPR / 2; ++i) {
      const int c = 2 * i + cs;
      const bool got = in && c < CIN;
      cp_async_piece<CB>(smem_u32(q_s + cr * LD + c * CE),
                         src + (got ? c * CE : 0), got);
    }
  }
  cp_async_commit();

  // this thread's row of tile kt (row 0 past the edge or the last tile),
  // and its location (the paged kernel's table entry), looked up one tile
  // ahead of the copy so the lookup's latency hides behind a tile's math
  auto row_of = [&](int kt) {
    const int kj = kt * BK + cr;
    return kt < n_kt && kj < p.Sk ? kj : 0;
  };
  // one key tile's K, V rows and positions into a stage
  auto load_tile = [&](int kt, int stage, int loc) {
    const int kj = kt * BK + cr;
    const bool in = kj < p.Sk;
    const bf16 *kr, *vr;
    keys.rows(row_of(kt), loc, kr, vr);
    bf16* ks = k_s + (stage * BK + cr) * LD;
    bf16* vs = v_s + (stage * BK + cr) * LD;
#pragma unroll
    for (int i = 0; i < CPR / 2; ++i) {
      const int c = 2 * i + cs;
      const bool got = in && c < CIN;
      const int off = got ? c * CE : 0;
      cp_async_piece<CB>(smem_u32(ks + c * CE), kr + off, got);
      cp_async_piece<CB>(smem_u32(vs + c * CE), vr + off, got);
    }
    if (tid < BK) {
      const int kk = kt * BK + tid;
      const bool kin = kk < p.Sk;
      cp_async4(smem_u32(kpos_s + stage * BK + tid), p.kpos + (kin ? kk : 0),
                kin);
    }
  };
  // 8 key positions a thread for the tile marking below
  int kp[8];
  auto load_kpos = [&](int base) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int kj = base + u * THREADS + tid;
      kp[u] = kj < p.Sk ? __ldg(p.kpos + kj) : -1;
    }
  };

  // the loads the prologue waits on, in flight together: this thread's
  // two query positions and the first key positions
  const int row0 = warp * 16 + g;
  const int qp0 = q0 + row0 < p.Sq ? p.qpos[q0 + row0] : -1;
  const int qp1 = q0 + row0 + 8 < p.Sq ? p.qpos[q0 + row0 + 8] : -1;
  load_kpos(0);

  // the block's smallest and largest valid query positions
  const int lo0 = first_key(qp0, p.window, p.chunk);
  const int lo1 = first_key(qp1, p.window, p.chunk);
  int qmin = min(qp0 >= 0 ? qp0 : INT_MAX, qp1 >= 0 ? qp1 : INT_MAX);
  int qmax = max(qp0, qp1);
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  qmax = __reduce_max_sync(0xffffffffu, qmax);
  if (lane == 0) {
    red_s[warp] = qmin;
    red_s[4 + warp] = qmax;
  }
  for (int i = tid; i < (n_kt + 31) / 32; i += THREADS) live_s[i] = 0;
  __syncthreads();
  qmin = min(min(red_s[0], red_s[1]), min(red_s[2], red_s[3]));
  qmax = max(max(red_s[4], red_s[5]), max(red_s[6], red_s[7]));

  // mark the key tiles that some valid query of the block may see: first_key
  // grows with the position, so a key outside [first_key(qmin), qmax] is
  // masked for every query of the block
  const int kmin = first_key(qmin, p.window, p.chunk);
  for (int base = 0; base < p.Sk; base += 8 * THREADS) {
    if (base > 0) load_kpos(base);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool live = kp[u] >= kmin && kp[u] <= qmax;
      const unsigned any = __ballot_sync(0xffffffffu, live);
      if (lane == 0 && any) {
        const int tile = (base + u * THREADS + warp * 32) / BK;
        atomicOr(live_s + (tile >> 5), 1u << (tile & 31));
      }
    }
  }
  __syncthreads();

  // the i-th live tile is computed from stage i % STAGES; the tile
  // STAGES - 1 live tiles ahead of it is in flight meanwhile
  int cur = next_live(live_s, 0, n_kt), fetch = cur;
  int loc = keys.locate(row_of(fetch));
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (fetch < n_kt) load_tile(fetch, st, loc);
    cp_async_commit();
    fetch = next_live(live_s, fetch + 1, n_kt);
    loc = keys.locate(row_of(fetch));
  }
  cp_async_wait<STAGES - 1>();  // the Q group
  __syncthreads();

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldsm_x4(qf[kk], smem_u32(q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                             (lane >> 4) * 8));

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = 0; cur < n_kt; ++i) {
    const int stage = i % STAGES;
    // the stage computed last iteration is refilled
    if (fetch < n_kt) load_tile(fetch, (i + STAGES - 1) % STAGES, loc);
    cp_async_commit();
    fetch = next_live(live_s, fetch + 1, n_kt);
    loc = keys.locate(row_of(fetch));
    cp_async_wait<STAGES - 1>();  // tile cur
    __syncthreads();

    // S = Q·Kᵀ, 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t kb = smem_u32(k_s + stage * BK * LD);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        const int r = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(b, kb + (r * LD + c) * 2);
        mma(s[2 * jp], qf[kk], b[0], b[1]);
        mma(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // mask per element: rows row0 / row0 + 8, columns 8j + 2t + {0, 1}
    const int lim = p.Sk - cur * BK;  // columns >= lim are past the edge
    const int* kp_s = kpos_s + stage * BK;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;
      const int2 kp = *reinterpret_cast<const int2*>(kp_s + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpe = e ? kp.y : kp.x;
        const bool edge = c + e >= lim;  // no weight at all
        s[j][e] = edge                          ? -INFINITY
                  : kpe >= lo0 && kpe <= qp0 ? s[j][e] * p.scale_log2
                                                : NEG_INF_SCORE;
        s[j][2 + e] = edge                         ? -INFINITY
                      : kpe >= lo1 && kpe <= qp1 ? s[j][2 + e] * p.scale_log2
                                                    : NEG_INF_SCORE;
      }
    }

    // online softmax in base 2; key k0 is in range, so each row's max is
    // finite and the first tile's correction exp2(-inf) is exactly 0
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2_approx(m0 - mn0), c1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2_approx(s[j][0] - mn0);
      s[j][1] = exp2_approx(s[j][1] - mn0);
      s[j][2] = exp2_approx(s[j][2] - mn1);
      s[j][3] = exp2_approx(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + rs0;  // this thread's columns; the quad sums at the end
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }

    // O += P·V: n8 tiles 2kk and 2kk+1 of S are the A fragment of k16
    // step kk
    const uint32_t vb = smem_u32(v_s + stage * BK * LD);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        const int r = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int c = dp * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(b, vb + (r * LD + c) * 2);
        mma(o[2 * dp], ah, b[0], b[1]);
        mma(o[2 * dp], al, b[0], b[1]);
        mma(o[2 * dp + 1], ah, b[2], b[3]);
        mma(o[2 * dp + 1], al, b[2], b[3]);
      }
    }
    __syncthreads();  // the stage is refilled next iteration
    cur = next_live(live_s, cur + 1, n_kt);
  }
  cp_async_wait<0>();

  // epilogue: a row's sum over its quad, clamp, pad queries to 0, bf16
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = qp0 < 0 ? 0.f : 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = qp1 < 0 ? 0.f : 1.f / fmaxf(l1, 1e-30f);
  const int qi0 = q0 + row0, qi1 = qi0 + 8;
  if (p.lse != nullptr && t == 0) {
    // m is in units of log2 and every masked score is NEG_INF_SCORE, so a
    // row whose max is no larger saw no valid key
    if (qi0 < p.Sq)
      p.lse[qi0] = qp0 < 0 || !(m0 > NEG_INF_SCORE)
                       ? INFINITY
                       : (m0 + log2f(l0)) * 0.69314718055994531f;
    if (qi1 < p.Sq)
      p.lse[qi1] = qp1 < 0 || !(m1 > NEG_INF_SCORE)
                       ? INFINITY
                       : (m1 + log2f(l1)) * 0.69314718055994531f;
  }
#pragma unroll
  for (int j = 0; j < (HD + 7) / 8; ++j) {  // zero-filled columns unwritten
    const int c = j * 8 + 2 * t;
    if (c >= HD) continue;
    if (qi0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(p.out + qi0 * p.o_s + c) =
          __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
    if (qi1 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(p.out + qi1 * p.o_s + c) =
          __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
  }
}

}  // namespace tc
}  // namespace attn
