// The shared split-KV core of the two decode attention kernels for Hopper
// (sm_90a), hand-written CUDA C++: decode_attention.cu (keys in a strided
// ring cache) and paged_decode_attention.cu (keys in a paged pool found
// through a block table). One query token per slot against its cache;
// the two files differ only in where a key row lives, which each gives the
// core as a small policy type, the interface of attention_tile.cuh's Keys
// on rows of either element type:
//
//   struct Rows {
//     // what finding row w needs from memory (the paged table entry),
//     // read one tile ahead of the row's copy
//     __device__ int locate(int w) const;
//     // element pointers to K and V row w (w in [0, W)), unit d stride
//     __device__ void rows(int w, int loc, const T*& k, const T*& v) const;
//   };
//
// Semantics (the JAX oracle's, as the kernels had them before): a key is
// valid iff 0 <= k_pos <= q_pos, plus window (k_pos > q_pos - window) and
// chunk (k_pos / chunk == q_pos / chunk) when > 0. A masked key scores the
// finite -1e9, a key past the edge -inf; running maxima start at -inf;
// softmax and accumulation are f32; the denominator is clamped at 1e-30; a
// query with no valid key at all writes 0 (the oracle would average the
// masked values; the documented difference).
//
// The value rows may be narrower than the key rows (HDV < HD: MLA's latent
// values beside [latent | rope] keys): q·k runs over HD, p·V, the merges
// and the output over HDV, in the same pieces on the same lanes of a row,
// so a lane still reads back only what its own copies wrote. Every caller
// but decode_attention.cu's (24, 16) instances has HDV == HD.
//
// What bounds the kernels on the H100: bytes. Each K/V element feeds 2*G
// multiply-adds (G = query heads per kv head; both main paths are MHA,
// G 1), far below the CUDA cores' ridge (~20 operations a byte) and the
// tensor cores' (~295): the least time is the valid K/V bytes over
// 3.35 TB/s. Holding that rate at ~1 us of memory latency needs ~3.4 MB in
// flight across the card, ~26 KB an SM. mma.sync would pay only from G 4
// up; that is later work.
//
// What this design does about it:
// - Split-KV across a thread-block cluster. Grid (C, Hkv, B), a cluster of
//   the C <= 8 blocks of one (batch, kv head); C is one block per 512 keys
//   of the cache or table width (or per tile, if a tile is wider), capped
//   at 8, so B8 x 32 kv heads x 2,048 keys runs 1,024 blocks, not 256. The
//   blocks split the slot's live tiles (below) into C equal contiguous
//   shares of whole tiles. Each warp keeps its own running (m, l,
//   o[G][hd]) over its rows of each tile, in f32 registers;
//   the block merges its four warps in shared memory, and after
//   cluster.sync() the cluster's block 0 reads the other blocks' partials
//   through distributed shared memory (map_shared_rank), merges them and
//   writes the output. A span with no valid key contributes m = -inf,
//   l = 0, o = 0, and a merge weight is exp2(m - M) only where m is finite
//   (0 otherwise), so no exp(-inf - -inf) is formed. One launch a call: no
//   combine kernel, no workspace, no atomics, nothing to zero; safe inside
//   a CUDA graph.
// - Bytes in flight. K and V tiles arrive by cp.async.cg, 16 bytes a copy,
//   into a ring of two stages: tile j+1 loads while tile j is scored. A
//   stage holds 16 KB (14 KB at hd 112, 12.8 KB at hd 100; half that from
//   group 4 up): every thread copies 64 bytes of K and 64 of V a tile
//   (four 16-byte chunks; two rows of two chunks at hd 112), so a tile is
//   64 keys at hd 64 bf16, 32 at hd 128 bf16 or hd 64 f32, 16 at hd 128
//   f32, 512 at hd 8 bf16. A bf16 row of hd 100 is 200 bytes and starts on
//   an 8-byte boundary only, so it comes in 8-byte chunks (cp.async.ca, 25
//   a row on 16 lanes, nine lanes with two): four rows of two chunks a
//   lane, 32 keys a tile (16 from group 4 up), the cluster split as at the
//   other head dims (one block per 512 keys). float32 hd 100 rows (400
//   bytes) keep 16-byte chunks. Two
//   stages, q in f32 and nothing else (the merge's partials reuse the
//   stages where they fit): at most 33 KB a block, so the shared memory of
//   one SM holds six blocks (96 KB of copies in flight). A tile's
//   positions and its table entries are read into registers one tile
//   ahead of its copy (two ahead of its use). Only valid rows are read: a
//   masked or absent row is zero-filled (src-size 0), so the bytes moved
//   follow the valid keys, not the width.
// - No block barrier in the key loop. A thread owns (key rows, 16-byte
//   chunks): LPR lanes split a row's chunks (LPR = the largest power of two
//   <= its chunk count, at most 32; hd 112 bf16: 14 chunks on 8 lanes, six
//   lanes with two and two with one, so no lane idles a phase), scores
//   reduce over them with xor shuffles, and the same thread later reads
//   the same chunks of V. Every thread reads back only the bytes its own
//   cp.async wrote, so cp.async.wait_group alone orders the loop. hd 160
//   bf16 (StableLM-2-12B): 20 chunks on 16 lanes, so 12 lanes idle on the
//   second chunk (as hd 100's 25 on 16), two rows a lane, 16 keys a tile
//   below group 4; float32: 40 chunks on 32 lanes.
// - Two compares a key: with k_pos <= q_pos the conditions reduce to
//   lo <= k_pos <= q_pos, lo = first_key(q_pos) computed once a block. No
//   division per key; the paged policy finds a row's page with a shift
//   (page size a power of two) or a multiply-high (any other).
// - Work follows the valid keys. Every block first reads all W positions
//   (L2-resident after the first block) and finds the slot's live tiles,
//   from the first to the last tile holding a valid key; the cluster
//   splits those, not the width. In serving most slots are short and one
//   is long: splitting the width left the long slot's walk to the two or
//   three blocks its keys reach, while the others had nothing to do.
//   Inside the walk, a warp skips its part of a tile when its positions
//   prove every row masked. Neither ever decides from an index or a table
//   entry: a shared page can be mapped and still hold rows that are -1 for
//   this slot.
// - Why 512 keys a block (chip_kernel_ab.py on the H100, PERF.md): at 256
//   (2,048 blocks) the core took 1.6x the time at a serving step's fills
//   and was slower at long fills too; 1,024 keys a block, splitting the
//   width, was up to 9% faster at long fills and up to 1.9x slower at
//   serving fills than this core.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace attn {
namespace dec {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;       // four warps
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;          // K/V tiles in flight
constexpr int MAX_CLUSTER = 8;     // portable cluster size
constexpr int KEYS_PER_BLOCK = 512;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// one chunk of N elements of T in shared memory (16 bytes, or 8 for a
// bf16 row that is no whole number of 16-byte pieces), widened to f32
template <typename T, int N>
struct Chunk;
template <>
struct Chunk<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    o[0] = f.x;
    o[1] = f.y;
    o[2] = f.z;
    o[3] = f.w;
  }
};
template <int N>
struct Chunk<bf16, N> {
  static_assert(N == 8 || N == 4, "16- or 8-byte bf16 chunk");
  using Word = typename std::conditional<N == 8, uint4, uint2>::type;
  __device__ __forceinline__ static void load(const bf16* p, float* o) {
    const Word u = *reinterpret_cast<const Word*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

__host__ __device__ constexpr int pow2_floor(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

// How one instance cuts a tile across the block's threads. A lane copies
// 64 bytes of K a tile (four 16-byte chunks, or eight 8-byte ones), in
// NCH chunks of each of NK rows. From group 4 up a lane takes half the rows
// a tile: its scores (rows x G) and K chunks otherwise push those
// instances past ptxas' register tiers into spills. Group 3 takes the
// lower groups' tier (s[NK][3], o[3][NCH][VEC]), group 5 the upper one;
// nothing here assumes G is a power of two (the shuffles reduce over a row's LPR lanes and a warp's
// row groups, never over G).
template <typename T, int HD, int G, int HDV = HD>
struct Geom {
  static constexpr int CB = piece_bytes<HD, (int)sizeof(T)>();  // bytes
  static constexpr int VEC = CB / (int)sizeof(T);    // elements a chunk
  static constexpr int CH = HD / VEC;                // chunks a row
  static constexpr int LPR = CH >= 32 ? 32 : pow2_floor(CH);  // lanes a row
  static constexpr int NCH = (CH + LPR - 1) / LPR;   // chunks a lane
  static constexpr int RPW = 32 / LPR;               // rows a warp at once
  static constexpr int NK = (G >= 4 ? 2 : 4) * (16 / CB) / NCH;  // rows a
                                                     // lane a tile
  static constexpr int KW = RPW * NK;                // rows a warp a tile
  static constexpr int TK = WARPS * KW;              // keys a tile
  static constexpr size_t STAGE = (size_t)TK * (HD + HDV) * sizeof(T);  // K
                                                     // + V
  // V rows (HDV elements) in the same pieces, on the same LPR lanes a row
  static constexpr int CHV = HDV / VEC;              // chunks a V row
  static constexpr int NCHV = (CHV + LPR - 1) / LPR; // V chunks a lane
  static constexpr bool V_EVEN = CHV == LPR * NCHV;  // every lane has them
  static_assert(HD % VEC == 0 && VEC % 4 == 0 && NCH <= 2 && NK >= 1,
                "head dim");
  static_assert(piece_bytes<HDV, (int)sizeof(T)>() == CB && HDV % VEC == 0 &&
                    NCHV <= NCH,
                "value head dim: the key rows' pieces, at most their count");
};

// Dynamic shared memory of one block: the K/V stages, then q in f32. The
// merge's partials (four warps', then the block's) reuse the stages.
template <typename T, int HD, int G, int HDV = HD>
struct Smem {
  using Gm = Geom<T, HD, G, HDV>;
  // warps: m[WARPS][G], l[WARPS][G], o[WARPS][G][HDV]; block: m[G], l[G],
  // o[G][HDV]
  static constexpr size_t PARTIALS =
      (size_t)(2 * WARPS * G + WARPS * G * HDV + 2 * G + G * HDV) * 4;
  static constexpr size_t RING = STAGES * Gm::STAGE;
  // q's float4 reads: a 16-byte boundary (group 3's partials are not)
  static constexpr size_t Q = ((RING > PARTIALS ? RING : PARTIALS) + 15) /
                              16 * 16;
  static constexpr size_t bytes = Q + (size_t)G * HD * 4;
};

// Blocks in the cluster of one (batch, kv head) for a width of W keys.
template <typename T, int HD, int G>
inline int cluster_size(int W) {
  constexpr int TK = Geom<T, HD, G>::TK;
  const int per = TK > KEYS_PER_BLOCK ? TK : KEYS_PER_BLOCK;
  const int c = (W + per - 1) / per;
  return c < 1 ? 1 : c > MAX_CLUSTER ? MAX_CLUSTER : c;
}

// What the core reads and writes for one (batch, kv head): pointers
// already offset to the slot and to the group's first query head.
template <typename T>
struct Tile {
  const T* q;         // (G, hd) contiguous
  T* out;             // (G, hd_v) contiguous
  const int* kpos;    // (W,) logical positions of the slot, -1 = empty
  int W, qpos, window, chunk;
  float scale_log2;   // softmax scale * log2(e)
};

// One block of the cluster of one (batch, kv head): blockIdx.x is its rank
// in the cluster (grid.x = cluster size). THREADS threads; dynamic shared
// memory Smem<T, HD, G, HDV>::bytes. q·k runs over HD, p·V and the output
// over HDV (MLA's latent value, HDV < HD; every other caller HDV == HD).
template <typename T, int HD, int G, int HDV = HD, class Rows>
__device__ __forceinline__ void decode_tile(const Tile<T>& p, const Rows& kv,
                                            unsigned char* smem) {
  using Gm = Geom<T, HD, G, HDV>;
  using S = Smem<T, HD, G, HDV>;
  constexpr int CB = Gm::CB, VEC = Gm::VEC, CH = Gm::CH, LPR = Gm::LPR;
  constexpr int NCH = Gm::NCH, CHV = Gm::CHV, NCHV = Gm::NCHV;
  constexpr bool V_EVEN = Gm::V_EVEN;
  using Ch = Chunk<T, VEC>;
  constexpr int RPW = Gm::RPW, NK = Gm::NK, KW = Gm::KW, TK = Gm::TK;
  constexpr unsigned FULL = 0xffffffffu;
  T* k_s = reinterpret_cast<T*>(smem);               // [STAGES][TK][HD]
  T* v_s = k_s + STAGES * TK * HD;                   // [STAGES][TK][HDV]
  float* q_s = reinterpret_cast<float*>(smem + S::Q);  // [G][HD]

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane / LPR, j = lane % LPR;  // row group, chunk lane
  const int W = p.W;
  const int qp = p.qpos, lo = first_key(qp, p.window, p.chunk);

  for (int i = tid; i < G * HD; i += THREADS) q_s[i] = to_f32(p.q[i]);

  // The slot's live tiles, from its first to its last tile holding a valid
  // key, found from the positions alone: every block of the cluster reads
  // all W positions (L2-resident after the first) and gets the same range,
  // then takes an equal share of it. So the blocks split the keys the
  // slot holds, not the width: a long slot's walk is shared by all C
  // blocks, and a slot with no valid key skips the key loop everywhere
  // (m = -inf, l = 0, o = 0).
  __shared__ int live_s[2 * WARPS];
  const int n_all = (W + TK - 1) / TK;
  int t_lo = n_all, t_hi = -1;
  auto see = [&](int x, int kp) {
    if (kp >= lo && kp <= qp) {
      t_lo = min(t_lo, x / TK);
      t_hi = max(t_hi, x / TK);
    }
  };
  // 16 bytes a load where the row allows it: at 2,048 keys, four loads a
  // thread, all in flight at once
  if (((reinterpret_cast<uintptr_t>(p.kpos) | (uintptr_t)W * 4) & 15) == 0) {
    const int4* kp4 = reinterpret_cast<const int4*>(p.kpos);
#pragma unroll 4
    for (int x = tid; x < W / 4; x += THREADS) {
      const int4 k4 = __ldg(kp4 + x);
      see(4 * x, k4.x);
      see(4 * x + 1, k4.y);
      see(4 * x + 2, k4.z);
      see(4 * x + 3, k4.w);
    }
  } else {
#pragma unroll 4
    for (int x = tid; x < W; x += THREADS) see(x, __ldg(p.kpos + x));
  }
  t_lo = __reduce_min_sync(FULL, t_lo);
  t_hi = __reduce_max_sync(FULL, t_hi);
  if (lane == 0) {
    live_s[warp] = t_lo;
    live_s[WARPS + warp] = t_hi;
  }
  __syncthreads();  // live_s and q_s
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    t_lo = min(t_lo, live_s[w]);
    t_hi = max(t_hi, live_s[WARPS + w]);
  }
  // this block's share: tiles [t_lo, t_end), empty past the live range
  const int per = (max(0, t_hi - t_lo + 1) + n_blocks - 1) / n_blocks;
  t_lo += rank * per;
  const int t_end = min(t_hi + 1, t_lo + per);

  // this lane's i-th key of tile t (local to the block's span) and its
  // shared-memory row
  auto key_of = [&](int t, int i) {
    return t * TK + warp * KW + rg + RPW * i;
  };
  auto row_of = [&](int i) { return warp * KW + rg + RPW * i; };

  // positions and table entries of tile t, read a tile ahead of its copy
  auto load_pos = [&](int t, int (&kp)[NK], int (&loc)[NK]) {
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int w = key_of(t, i);
      const bool in = t < t_end && w < W;
      kp[i] = in ? __ldg(p.kpos + w) : -1;
      loc[i] = in ? kv.locate(w) : 0;
    }
  };
  // tile t's valid K and V rows into a stage; the rest zero-filled
  auto copy_tile = [&](int t, int stage, const int (&kp)[NK],
                       const int (&loc)[NK]) {
    if (t >= t_end) return;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int w = key_of(t, i);
      const bool ok = w < W && kp[i] >= lo && kp[i] <= qp;
      const T *kr, *vr;
      kv.rows(ok ? w : 0, ok ? loc[i] : 0, kr, vr);
      T* ks = k_s + (stage * TK + row_of(i)) * HD;
      T* vs = v_s + (stage * TK + row_of(i)) * HDV;
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        const int c = j + LPR * n;
        if (NCH == 1 || c < CH)
          cp_async_piece<CB>(smem_u32(ks + c * VEC), kr + (ok ? c * VEC : 0),
                             ok);
        if (n < NCHV && (V_EVEN || c < CHV))
          cp_async_piece<CB>(smem_u32(vs + c * VEC), vr + (ok ? c * VEC : 0),
                             ok);
      }
    }
  };

  float m[G], l[G], o[G][NCHV][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int n = 0; n < NCHV; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[g][n][e] = 0.f;
  }

  int kp_cur[NK], kp_next[NK], kp_far[NK], loc_next[NK], loc_far[NK];
  load_pos(t_lo, kp_cur, loc_next);
  copy_tile(t_lo, t_lo % STAGES, kp_cur, loc_next);
  cp_async_commit();
  load_pos(t_lo + 1, kp_next, loc_next);

  for (int t = t_lo; t < t_end; ++t) {
    const int stage = t % STAGES;
    // this thread read the stage refilled here two tiles ago; order those
    // reads before the refill's writes
    __syncwarp();
    copy_tile(t + 1, (t + 1) % STAGES, kp_next, loc_next);
    cp_async_commit();
    load_pos(t + 2, kp_far, loc_far);
    cp_async_wait<1>();  // tile t's copies (this thread's own)

    bool valid[NK], any = false;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      valid[i] = key_of(t, i) < W && kp_cur[i] >= lo && kp_cur[i] <= qp;
      any |= valid[i];
    }
    if (__any_sync(FULL, any)) {
      const T* kt = k_s + stage * TK * HD;
      const T* vt = v_s + stage * TK * HDV;
      // scores: this lane's chunks of its rows, then summed over the row's
      // LPR lanes
      float s[NK][G];
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) s[i][g] = 0.f;
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        const int c = j + LPR * n;
        if (NCH == 1 || c < CH) {
          float kc[NK][VEC];
#pragma unroll
          for (int i = 0; i < NK; ++i)
            Ch::load(kt + row_of(i) * HD + c * VEC, kc[i]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float qc[VEC];
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 f =
                  *reinterpret_cast<const float4*>(q_s + g * HD + c * VEC + e);
              qc[e] = f.x;
              qc[e + 1] = f.y;
              qc[e + 2] = f.z;
              qc[e + 3] = f.w;
            }
#pragma unroll
            for (int i = 0; i < NK; ++i)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                s[i][g] = fmaf(qc[e], kc[i][e], s[i][g]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            s[i][g] += __shfl_xor_sync(FULL, s[i][g], off);

      // mask, then the online softmax of this row group's keys (base 2)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mt = -INFINITY;
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          s[i][g] = key_of(t, i) >= W ? -INFINITY
                    : valid[i]        ? s[i][g] * p.scale_log2
                                      : NEG_INF_SCORE;
          mt = fmaxf(mt, s[i][g]);
        }
        const float mn = fmaxf(m[g], mt);
        // all rows past the edge so far: subtract 0, every weight is 0
        const float ms = mn == -INFINITY ? 0.f : mn;
        const float corr = exp2_approx(m[g] - ms);
        float ls = 0.f;
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          s[i][g] = exp2_approx(s[i][g] - ms);
          ls += s[i][g];
        }
        l[g] = l[g] * corr + ls;
        m[g] = mn;
#pragma unroll
        for (int n = 0; n < NCHV; ++n)
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[g][n][e] *= corr;
      }

      // o += p · V on the chunks of the same rows this lane copied
#pragma unroll
      for (int n = 0; n < NCHV; ++n) {
        const int c = j + LPR * n;
        if (V_EVEN || c < CHV) {
#pragma unroll
          for (int i = 0; i < NK; ++i) {
            float vc[VEC];
            Ch::load(vt + row_of(i) * HDV + c * VEC, vc);
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                o[g][n][e] = fmaf(s[i][g], vc[e], o[g][n][e]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < NK; ++i) {
      kp_cur[i] = kp_next[i];
      kp_next[i] = kp_far[i];
      loc_next[i] = loc_far[i];
    }
  }
  cp_async_wait<0>();

  // merge 1: the warp's row groups (lanes of one chunk lane j), by shuffles
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mw = m[g];
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(FULL, mw, off));
    const float f = m[g] == -INFINITY ? 0.f : exp2_approx(m[g] - mw);
    l[g] *= f;
#pragma unroll
    for (int n = 0; n < NCHV; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[g][n][e] *= f;
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int n = 0; n < NCHV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[g][n][e] += __shfl_xor_sync(FULL, o[g][n][e], off);
    }
    m[g] = mw;
  }

  // merge 2: the block's four warps, through the (now idle) stages
  float* wm = reinterpret_cast<float*>(smem);  // [WARPS][G]
  float* wl = wm + WARPS * G;                  // [WARPS][G]
  float* wo = wl + WARPS * G;                  // [WARPS][G][HDV]
  float* bm = wo + WARPS * G * HDV;            // [G]
  float* bl = bm + G;                          // [G]
  float* bo = bl + G;                          // [G][HDV]
  __syncthreads();  // every warp is done with the stages
  if (rg == 0) {
#pragma unroll
    for (int n = 0; n < NCHV; ++n) {
      const int c = j + LPR * n;
      if (V_EVEN || c < CHV)
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            wo[(warp * G + g) * HDV + c * VEC + e] = o[g][n][e];
    }
    if (j == 0)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
  }
  __syncthreads();
  for (int x = tid; x < G * HDV; x += THREADS) {
    const int g = x / HDV, d = x % HDV;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w * G + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = wm[w * G + g];
      const float f = mw == -INFINITY ? 0.f : exp2_approx(mw - M);
      L += f * wl[w * G + g];
      O += f * wo[(w * G + g) * HDV + d];
    }
    bo[x] = O;
    if (d == 0) {
      bm[g] = M;
      bl[g] = L;
    }
  }

  // merge 3: the cluster's blocks, read by block 0 through distributed
  // shared memory
  cluster.sync();
  if (rank == 0) {
    for (int x = tid; x < G * HDV; x += THREADS) {
      const int g = x / HDV;
      float M = -INFINITY;
      for (int c = 0; c < n_blocks; ++c)
        M = fmaxf(M, cluster.map_shared_rank(bm, c)[g]);
      float L = 0.f, O = 0.f;
      for (int c = 0; c < n_blocks; ++c) {
        const float mc = cluster.map_shared_rank(bm, c)[g];
        const float f = mc == -INFINITY ? 0.f : exp2_approx(mc - M);
        L += f * cluster.map_shared_rank(bl, c)[g];
        O += f * cluster.map_shared_rank(bo, c)[x];
      }
      // no valid key anywhere: L = O = 0, and the clamp writes 0
      p.out[x] = from_f32<T>(O / fmaxf(L, 1e-30f));
    }
  }
  cluster.sync();  // the other blocks' partials stay until block 0 is done
}

// Launch ``Kernel`` (one instance of a file's decode kernel) on grid (C,
// Hkv, B) in clusters of C blocks along x: one cudaLaunchKernelEx, no
// attribute call after the first launch on a device (allow_smem).
template <auto Kernel, typename T, int HD, int G, int HDV = HD,
          typename Args>
cudaError_t launch_cluster(const Args& a, int W, int Hkv, int B,
                           cudaStream_t stream) {
  constexpr size_t smem = Smem<T, HD, G, HDV>::bytes;
  cudaError_t err = allow_smem<Kernel>(smem);
  if (err != cudaSuccess) return err;
  const int C = cluster_size<T, HD, G>(W);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instances every decode kernel takes: hd {8, 16, 32, 64, 100, 112,
// 128, 160} x group {1, 2, 3, 4, 5, 8} x {float32, bf16}, and hd 20 in
// float32 (hd 100: LLaMA-3B; group 3: InternLM2-20B's 48 query heads on
// 16 kv heads; hd 160: StableLM-2-12B, group 2; group 5: Llama-4
// Maverick's 40 real query heads on one copy of each of its 8 kv heads;
// hd 20: examples/serve_e2e_torch.py). Launch<T, HD, G>::run(a, stream)
// is the file's launch of one instance.
template <template <typename, int, int> class Launch, typename T, int HD,
          typename Args>
cudaError_t by_group(const Args& a, int group, cudaStream_t stream) {
  switch (group) {
    case 1: return Launch<T, HD, 1>::run(a, stream);
    case 2: return Launch<T, HD, 2>::run(a, stream);
    case 3: return Launch<T, HD, 3>::run(a, stream);
    case 4: return Launch<T, HD, 4>::run(a, stream);
    case 5: return Launch<T, HD, 5>::run(a, stream);
    case 8: return Launch<T, HD, 8>::run(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename, int, int> class Launch, typename T,
          typename Args>
cudaError_t by_head_dim(const Args& a, int hd, int group,
                        cudaStream_t stream) {
  switch (hd) {
    case 8: return by_group<Launch, T, 8>(a, group, stream);
    case 16: return by_group<Launch, T, 16>(a, group, stream);
    case 20:  // float32 only: examples/serve_e2e_torch.py's 8 heads of 20
      if constexpr (std::is_same<T, float>::value)
        return by_group<Launch, T, 20>(a, group, stream);
      return cudaErrorInvalidValue;
    case 32: return by_group<Launch, T, 32>(a, group, stream);
    case 64: return by_group<Launch, T, 64>(a, group, stream);
    case 100: return by_group<Launch, T, 100>(a, group, stream);
    case 112: return by_group<Launch, T, 112>(a, group, stream);
    case 128: return by_group<Launch, T, 128>(a, group, stream);
    case 160: return by_group<Launch, T, 160>(a, group, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename, int, int> class Launch, typename Args>
cudaError_t by_instance(const Args& a, int dtype, int hd, int group,
                        cudaStream_t stream) {
  if (dtype == 0) return by_head_dim<Launch, float>(a, hd, group, stream);
  if (dtype == 1) return by_head_dim<Launch, bf16>(a, hd, group, stream);
  return cudaErrorInvalidValue;
}

}  // namespace dec
}  // namespace attn
