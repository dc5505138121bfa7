// Decode attention through a block table over a shared KV page pool, for
// Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` /
// `_paged_decode_kernel` in src/repro/kernels/decode_attention.py: one
// query token per slot against the slot's LOGICAL cache, whose page lp
// lives at physical page tbl[b, lp] of a (Hkv, P+1, ps, hd) pool; -1 means
// unmapped and reads the trash page P. Mask 0 <= k_pos <= q_pos (+ window
// / chunk) on logical positions, finite -1e9 for masked scores, running
// max from -inf, f32 softmax and accumulation, denominator clamped at
// 1e-30, output in the input type.
//
// What bounds it on the H100, and what the design does about it: see the
// shared split-KV core, decode_tile.cuh (bytes; a cluster of up to eight
// blocks per (batch, kv head) splits the table, cp.async double-buffered
// K/V tiles, two compares a key, one launch a call). This file gives the
// core only where a key row lives: logical key w of slot b at physical
// page tbl[b, w / ps] (-1 or out of range -> the trash page P1 - 1), row
// w % ps, with the table entry read by the block itself a tile ahead of
// the row's copy (the TPU prefetched the table as scalars). The page and
// row come from a shift where ps is a power of two, else from one
// multiply-high by a reciprocal computed on the host: no division per key.
// Every flat pool offset is 64-bit. Only the positions decide which rows
// are read: a shared prefix page can be mapped and still hold rows that
// are -1 for this slot.
#include "decode_tile.cuh"

namespace {

using namespace attn;

struct PagedArgs {
  const void* q;     // (B, Hq, hd) contiguous
  const void* k;     // (Hkv, P+1, ps, hd): element strides below, d stride 1
  const void* v;     // (Hkv, P+1, ps, hd_v)
  const int* tbl;    // (B, M) contiguous, -1 = unmapped
  const int* qpos;   // (B,)
  const int* kpos;   // (B, M*ps) contiguous, logical
  void* out;         // (B, Hq, hd) contiguous
  long long sk_h, sk_p, sk_r, sv_h, sv_p, sv_r;
  int B, Hq, Hkv, P1, ps, M, window, chunk;
  int ps_shift;          // log2(ps) when ps is a power of two, else -1
  unsigned ps_magic;     // ceil(2^32 / ps) otherwise
  float scale;
};

// logical row w of one (slot, kv head), through the slot's table
template <typename T>
struct PagedRows {
  const T* k;  // page 0, row 0 of the kv head
  const T* v;
  const int* tbl;  // (M,) of the slot
  long long sk_p, sk_r, sv_p, sv_r;
  int ps, ps_shift, P1;
  unsigned ps_magic;
  __device__ __forceinline__ int page(int w) const {
    return ps_shift >= 0 ? w >> ps_shift : (int)__umulhi((unsigned)w, ps_magic);
  }
  __device__ __forceinline__ int locate(int w) const {
    return __ldg(tbl + page(w));
  }
  __device__ __forceinline__ void rows(int w, int pg, const T*& kr,
                                       const T*& vr) const {
    const long long r = w - page(w) * ps;
    if (pg < 0 || pg >= P1) pg = P1 - 1;  // unmapped: the trash page
    kr = k + pg * sk_p + r * sk_r;
    vr = v + pg * sv_p + r * sv_r;
  }
};

template <typename T, int HD, int G>
__global__ void __launch_bounds__(dec::THREADS)
    paged_decode_kernel(PagedArgs a) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int hk = blockIdx.y, b = blockIdx.z;
  const int W = a.M * a.ps;
  dec::Tile<T> p;
  p.q = (const T*)a.q + ((long long)b * a.Hq + (long long)hk * G) * HD;
  p.out = (T*)a.out + ((long long)b * a.Hq + (long long)hk * G) * HD;
  p.kpos = a.kpos + (long long)b * W;
  p.W = W;
  p.qpos = a.qpos[b];
  p.window = a.window;
  p.chunk = a.chunk;
  p.scale_log2 = a.scale * dec::LOG2E;
  const PagedRows<T> rows{(const T*)a.k + hk * a.sk_h,
                          (const T*)a.v + hk * a.sv_h,
                          a.tbl + (long long)b * a.M,
                          a.sk_p, a.sk_r, a.sv_p, a.sv_r,
                          a.ps, a.ps_shift, a.P1, a.ps_magic};
  dec::decode_tile<T, HD, G>(p, rows, dec_smem);
}

template <typename T, int HD, int G>
struct Launch {
  static cudaError_t run(const PagedArgs& a, cudaStream_t stream) {
    return dec::launch_cluster<paged_decode_kernel<T, HD, G>, T, HD, G>(
        a, a.M * a.ps, a.Hkv, a.B, stream);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the
// tensors, made current for the launch. strides: element strides (head,
// page, row) of the k pool then the v pool, 64-bit. P1 = pages in the pool
// including the trash page; M = block-table width; ps = page size
// (M * ps * ps < 2^32). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim, group or type it does not take).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* tbl,
    const int* qpos, const int* kpos, void* out, const long long* strides,
    int B, int Hq, int Hkv, int P1, int ps, int M, int hd, int hd_v,
    int window, int chunk, int dtype, int device, void* stream) {
  if (hd != hd_v || Hkv <= 0 || Hq % Hkv || ps <= 0 || P1 <= 0 || M <= 0 ||
      (unsigned long long)M * ps * ps >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  PagedArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.tbl = tbl;
  a.qpos = qpos;
  a.kpos = kpos;
  a.out = out;
  a.sk_h = strides[0];
  a.sk_p = strides[1];
  a.sk_r = strides[2];
  a.sv_h = strides[3];
  a.sv_p = strides[4];
  a.sv_r = strides[5];
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.P1 = P1;
  a.ps = ps;
  a.M = M;
  a.window = window;
  a.chunk = chunk;
  a.ps_shift = -1;
  a.ps_magic = 0;
  if ((ps & (ps - 1)) == 0) {
    a.ps_shift = 0;
    while ((1 << a.ps_shift) < ps) ++a.ps_shift;
  } else {
    // floor(w * ceil(2^32 / ps) / 2^32) == w / ps for w * ps < 2^32
    a.ps_magic = (unsigned)(((1ull << 32) + ps - 1) / ps);
  }
  a.scale = 1.0f / sqrtf((float)hd);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)dec::by_instance<Launch>(a, dtype, hd, Hq / Hkv,
                                       (cudaStream_t)stream);
}
