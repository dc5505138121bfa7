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
// What bounds it on the H100, and what the design does about it: see the
// shared split-KV core, decode_tile.cuh (bytes; a cluster of up to eight
// blocks per (batch, kv head) splits the cache, cp.async double-buffered
// K/V tiles, two compares a key, one launch a call). This file gives the
// core only where a key row lives: ring row w of (batch, kv head) at
// k + b*sk_b + hk*sk_h + w*sk_s, d stride 1. The ring's unsorted positions
// need nothing else: every row is masked by its own position. K and V are
// read through their strides: the model passes cache["k"].transpose(1, 2),
// a view of the (B, W, Hkv, hd) cache, and no copy is made.
//
// The value head dim may differ from the key's (the reference takes hd_v):
// MLA decode runs as one kv head of [latent | rope] keys whose values are
// the latent alone (kernels/ops.py mla_decode_attention). q·k runs over hd,
// p·V and the output over hd_v; the pair the reference's MLA sweep uses,
// (24, 16) at group 4, has instances of its own, and every other instance
// keeps hd_v == hd.
#include "decode_tile.cuh"

namespace {

using namespace attn;

struct DecodeArgs {
  const void* q;     // (B, Hq, hd) contiguous
  const void* k;     // (B, Hkv, W, hd), element strides below, d stride 1
  const void* v;     // (B, Hkv, W, hd_v), element strides below, d stride 1
  const int* qpos;   // (B,)
  const int* kpos;   // (B, W) contiguous
  void* out;         // (B, Hq, hd_v) contiguous
  long long sk_b, sk_h, sk_s, sv_b, sv_h, sv_s;
  int B, Hq, Hkv, W, window, chunk;
  float scale;
};

// ring row w of one (batch, kv head)
template <typename T>
struct RingRows {
  const T* k;  // row 0
  const T* v;
  long long sk, sv;  // row strides
  __device__ __forceinline__ int locate(int) const { return 0; }
  __device__ __forceinline__ void rows(int w, int, const T*& kr,
                                       const T*& vr) const {
    kr = k + w * sk;
    vr = v + w * sv;
  }
};

template <typename T, int HD, int G, int HDV>
__global__ void __launch_bounds__(dec::THREADS) decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int hk = blockIdx.y, b = blockIdx.z;
  dec::Tile<T> p;
  p.q = (const T*)a.q + ((long long)b * a.Hq + (long long)hk * G) * HD;
  p.out = (T*)a.out + ((long long)b * a.Hq + (long long)hk * G) * HDV;
  p.kpos = a.kpos + (long long)b * a.W;
  p.W = a.W;
  p.qpos = a.qpos[b];
  p.window = a.window;
  p.chunk = a.chunk;
  p.scale_log2 = a.scale * dec::LOG2E;
  const RingRows<T> rows{(const T*)a.k + b * a.sk_b + hk * a.sk_h,
                         (const T*)a.v + b * a.sv_b + hk * a.sv_h, a.sk_s,
                         a.sv_s};
  dec::decode_tile<T, HD, G, HDV>(p, rows, dec_smem);
}

template <typename T, int HD, int G, int HDV = HD>
cudaError_t launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  return dec::launch_cluster<decode_kernel<T, HD, G, HDV>, T, HD, G, HDV>(
      a, a.W, a.Hkv, a.B, stream);
}

template <typename T, int HD, int G>
struct Launch {
  static cudaError_t run(const DecodeArgs& a, cudaStream_t stream) {
    return launch_decode<T, HD, G>(a, stream);
  }
};

// hd != hd_v: the reference MLA sweep's pair, (24, 16) at group 4
cudaError_t launch_mla(const DecodeArgs& a, int dtype, int hd, int hd_v,
                       int group, cudaStream_t stream) {
  if (hd != 24 || hd_v != 16 || group != 4) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_decode<float, 24, 4, 16>(a, stream);
  if (dtype == 1) return launch_decode<dec::bf16, 24, 4, 16>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the
// tensors, made current for the launch. strides: element strides (b, h, s) of
// k then v. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim pair, group or type it does not
// take: hd == hd_v in 8-160, or (24, 16) at group 4).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const int* qpos,
                                    const int* kpos, void* out,
                                    const long long* strides, int B, int Hq,
                                    int Hkv, int W, int hd, int hd_v,
                                    int window, int chunk, int dtype,
                                    int device, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || W <= 0) return (int)cudaErrorInvalidValue;
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hd != hd_v)
    return (int)launch_mla(a, dtype, hd, hd_v, Hq / Hkv, (cudaStream_t)stream);
  return (int)dec::by_instance<Launch>(a, dtype, hd, Hq / Hkv,
                                       (cudaStream_t)stream);
}
