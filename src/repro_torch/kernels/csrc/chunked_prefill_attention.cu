// Chunked-prefill attention through a block table over a shared KV page
// pool, for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `chunked_prefill_attention` /
// `_chunked_prefill_kernel` in src/repro/kernels/chunked_prefill.py: S
// prompt queries per slot score the slot's whole LOGICAL history, whose
// page lp lives at physical page tbl[b, lp] of a (Hkv, P+1, ps, hd) pool
// (-1 = unmapped -> trash page P). The chunk's own keys are written to the
// pool before the call, so the one mask 0 <= k_pos <= q_pos (+ window /
// chunk) gives both the history and causality inside the chunk. Masked
// scores are the finite -1e9, the running max starts at -inf, softmax and
// accumulation are f32, the denominator is clamped at 1e-30, output is in
// the input type; a pad query (q_pos = -1) gets an output of 0.
//
// What bounds it on the H100: at the main path's chunk of S = 256 queries
// per slot over a history of up to ~1k keys, 4*S*keys*hd operations per
// head against (S + 2*keys)*hd*2 bytes: ~100 operations per byte in bf16,
// under the ~295 of the ridge, so bound by bytes.
//
// What this design does about that: the TPU kernel keeps the whole
// (group*S, hd) query chunk resident in VMEM, which does not fit one
// Hopper block; here the queries are tiled across blocks, grid (ceil(S /
// 64), Hq, B), and the TPU's sequential grid axis over logical pages
// becomes the key loop of the block. bf16 runs the shared tensor-core tile
// core of attention_tile.cuh (mma.sync products, cp.async double-buffered
// K/V tiles, tiles the positions prove masked skipped, so a causal chunk at
// the head of a long table reads only its history's pages); this file gives
// it only where a key row lives: logical key kj of slot b at physical page
// tbl[b, kj / ps] (-1 or out of range -> the trash page P1 - 1), row kj %
// ps, read by the block itself. The float32 instance keeps the first
// kernel's f32 FMA body on the CUDA cores (the 1e-4 float32 check): each
// key tile loads its positions and its rows' 64-bit pool offsets, then
// stages K transposed and V in f32 shared memory.
#include "attention_tile.cuh"

namespace {

using namespace attn;

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // logical keys per kv tile
constexpr int THREADS = 128;  // float32: 16 row groups (4 rows) x 8 lanes

struct ChunkArgs {
  const void* q;     // (B, Hq, S, hd), strides sq
  const void* k;     // (Hkv, P+1, ps, hd): head/page/row strides, d stride 1
  const void* v;
  const int* tbl;    // (B, M) contiguous, -1 = unmapped
  const int* qpos;   // (B, S) contiguous, -1 = pad
  const int* kpos;   // (B, M*ps) contiguous, logical
  void* out;         // (B, Hq, S, hd), strides so
  Strides4 sq, so;
  long long sk_h, sk_p, sk_r, sv_h, sv_p, sv_r;
  int B, Hq, Hkv, S, P1, ps, M, group, window, chunk;
  float scale;
};

// ---- bf16: the shared tensor-core core, keys through the block table

struct PagedKeys {
  const tc::bf16* k;  // page 0, row 0 of the kv head
  const tc::bf16* v;
  const int* tbl;     // (M,) of the slot
  long long sk_p, sk_r, sv_p, sv_r;
  int ps, P1;
  __device__ __forceinline__ int locate(int kj) const {
    return __ldg(tbl + kj / ps);
  }
  __device__ __forceinline__ void rows(int kj, int pg, const tc::bf16*& kr,
                                       const tc::bf16*& vr) const {
    if (pg < 0 || pg >= P1) pg = P1 - 1;  // unmapped: the trash page
    const long long r = kj % ps;
    kr = k + pg * sk_p + r * sk_r;
    vr = v + pg * sv_p + r * sv_r;
  }
};

template <int HD>
__global__ void __launch_bounds__(tc::THREADS, 2)
    chunk_tc_kernel(ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.group;
  const int W = a.M * a.ps;
  tc::Tile p;
  p.q = (const tc::bf16*)a.q + b * a.sq.b + h * a.sq.h;
  p.out = (tc::bf16*)a.out + b * a.so.b + h * a.so.h;
  p.q_s = a.sq.s;
  p.o_s = a.so.s;
  p.qpos = a.qpos + (long long)b * a.S;
  p.kpos = a.kpos + (long long)b * W;
  p.Sq = a.S;
  p.Sk = W;
  p.window = a.window;
  p.chunk = a.chunk;
  p.scale_log2 = a.scale * tc::LOG2E;
  const PagedKeys keys{(const tc::bf16*)a.k + hk * a.sk_h,
                       (const tc::bf16*)a.v + hk * a.sv_h,
                       a.tbl + (long long)b * a.M,
                       a.sk_p, a.sk_r, a.sv_p, a.sv_r, a.ps, a.P1};
  tc::attention_tile<HD>(p, keys, tc_smem);
}

template <int HD>
cudaError_t launch_bf16(const ChunkArgs& a, cudaStream_t stream) {
  const int W = a.M * a.ps;
  const size_t smem = tc::Layout<HD>::bytes((W + tc::BK - 1) / tc::BK);
  cudaError_t err = allow_smem<chunk_tc_kernel<HD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + tc::BQ - 1) / tc::BQ, a.Hq, a.B);
  chunk_tc_kernel<HD><<<grid, tc::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- float32: f32 FMA on the CUDA cores

template <int HD>
constexpr size_t chunk_smem_bytes() {
  return (size_t)BK * 2 * sizeof(long long) +           // row offsets
         (size_t)(BQ * (HD + 1) + HD * (BK + 1) + BK * vcols<HD>() +
                  BQ * (BK + 1)) *
             sizeof(float) +
         (size_t)(BK + BQ) * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(THREADS) chunk_fwd_kernel(ChunkArgs a) {
  constexpr int DJ = (HD + 7) / 8;  // output columns per thread
  constexpr int HV = vcols<HD>();   // V row in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  long long* koff_s = reinterpret_cast<long long*>(smem);  // [BK]
  long long* voff_s = koff_s + BK;                         // [BK]
  float* q_s = reinterpret_cast<float*>(voff_s + BK);      // [BQ][HD+1]
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
  const int W = a.M * a.ps;

  const float* Q = (const float*)a.q + b * a.sq.b + h * a.sq.h;
  const float* K = (const float*)a.k + hk * a.sk_h;
  const float* V = (const float*)a.v + hk * a.sv_h;
  const int* TB = a.tbl + (long long)b * a.M;
  const int* KP = a.kpos + (long long)b * W;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    q_s[r * (HD + 1) + d] = qi < a.S ? Q[qi * a.sq.s + d * a.sq.d] : 0.f;
  }
  zero_v_tail<HD, BK, THREADS>(v_s, tid);
  for (int r = tid; r < BQ; r += THREADS) {
    const int qi = q0 + r;
    qpos_s[r] = qi < a.S ? a.qpos[(long long)b * a.S + qi] : -1;
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

  const int n_kt = (W + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    for (int c = tid; c < BK; c += THREADS) {
      const int kj = k0 + c;
      kpos_s[c] = kj < W ? KP[kj] : -1;
      if (kj < W) {
        // the key's physical row: its logical page through the table,
        // unmapped (or out-of-range) entries to the trash page
        int pg = TB[kj / a.ps];
        if (pg < 0 || pg >= a.P1) pg = a.P1 - 1;
        const long long r = kj % a.ps;
        koff_s[c] = (long long)pg * a.sk_p + r * a.sk_r;
        voff_s[c] = (long long)pg * a.sv_p + r * a.sv_r;
      }
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
      if (kj < W) {
        kv = K[koff_s[c] + d];
        vv = V[voff_s[c] + d];
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
        if (k0 + c >= W)
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

  float* O = (float*)a.out + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= a.S) continue;
    // a pad query (q_pos = -1) writes 0; a valid one always has its own
    // key in the pool, so l > 0 and the clamp never bites
    const float denom = fmaxf(l[i], 1e-30f);
    const bool pad = qp[i] < 0;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (tx + 8 * j < HD)
        O[qi * a.so.s + (tx + 8 * j) * a.so.d] =
            pad ? 0.f : acc[i][j] / denom;
  }
}

template <int HD>
cudaError_t launch_f32(const ChunkArgs& a, cudaStream_t stream) {
  const size_t smem = chunk_smem_bytes<HD>();
  cudaError_t err = allow_smem<chunk_fwd_kernel<HD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, a.B);
  chunk_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the
// tensors, made current for the launch. strides: 14 element strides,
// 64-bit: (b, h, s, d) of q, (head, page, row) of the k pool, (head, page,
// row) of the v pool, (b, h, s, d) of out. P1 = pages in the pool
// including the trash page; M = block-table width; ps = page size.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head dim, group or type it does not take).
extern "C" int chunked_prefill_attention_fwd(
    const void* q, const void* k, const void* v, const int* tbl,
    const int* qpos, const int* kpos, void* out, const long long* strides,
    int B, int Hq, int Hkv, int S, int P1, int ps, int M, int hd, int hd_v,
    int window, int chunk, int dtype, int device, void* stream) {
  if (hd != hd_v || Hkv <= 0 || Hq % Hkv || ps <= 0 || P1 <= 0)
    return (int)cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  // group 5: Llama-4 Maverick's 40 real q heads over one copy of each of
  // its 8 kv heads (the pool's kv heads ::2, through the head stride)
  if (group != 1 && group != 2 && group != 3 && group != 4 && group != 5 &&
      group != 8)
    return (int)cudaErrorInvalidValue;
  ChunkArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.tbl = tbl;
  a.qpos = qpos;
  a.kpos = kpos;
  a.out = out;
  a.sq = {strides[0], strides[1], strides[2], strides[3]};
  a.sk_h = strides[4];
  a.sk_p = strides[5];
  a.sk_r = strides[6];
  a.sv_h = strides[7];
  a.sv_p = strides[8];
  a.sv_r = strides[9];
  a.so = {strides[10], strides[11], strides[12], strides[13]};
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.P1 = P1;
  a.ps = ps;
  a.M = M;
  a.group = group;
  a.window = window;
  a.chunk = chunk;
  a.scale = 1.0f / sqrtf((float)hd);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && hd == 16) return (int)launch_f32<16>(a, st);
  if (dtype == 0 && hd == 32) return (int)launch_f32<32>(a, st);
  if (dtype == 0 && hd == 64) return (int)launch_f32<64>(a, st);
  if (dtype == 0 && hd == 100) return (int)launch_f32<100>(a, st);
  if (dtype == 0 && hd == 128) return (int)launch_f32<128>(a, st);
  if (dtype == 0 && hd == 160) return (int)launch_f32<160>(a, st);
  if (dtype == 1 && hd == 16) return (int)launch_bf16<16>(a, st);
  if (dtype == 1 && hd == 32) return (int)launch_bf16<32>(a, st);
  if (dtype == 1 && hd == 64) return (int)launch_bf16<64>(a, st);
  if (dtype == 1 && hd == 100) return (int)launch_bf16<100>(a, st);
  if (dtype == 1 && hd == 128) return (int)launch_bf16<128>(a, st);
  if (dtype == 1 && hd == 160) return (int)launch_bf16<160>(a, st);
  return (int)cudaErrorInvalidValue;
}
