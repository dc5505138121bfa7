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
// cl*(cl+1)*(N+P) + 2*cl*P*N operations on (2*cl*(P+N) + cl) inputs, so at
// cl 256, P = N = 64 in float32 that is ~45 operations per byte read,
// above the ~20 at which the 67 TFLOP/s of float32 FMA on the CUDA cores
// become the limit (this kernel does not use the tensor cores).
//
// What this design does about that: the TPU keeps a whole (cl, cl) score
// tile resident per chunk; at cl 256 that is 256 KB of float32, more than a
// block's 227 KB of shared memory. Here a block owns one 64-row tile of t
// (grid z), loops over the 64-row tiles of s up to the diagonal only (the
// s > t half is never computed), and per s tile forms C_t.B_s^T, scales it
// by the decay under the s <= t mask and multiplies by dt_s x_s, like
// flash attention without the softmax, accumulating in registers. One more
// block per chunk (the last z index) computes h_chunk and decay. Every block
// computes the chunk's cumsum itself (one warp-shuffle scan of <= 256
// values), so blocks share nothing. Products are f32 FMA on the CUDA cores;
// tensor cores (mma.sync, then wgmma + TMA) are later work.
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

namespace {

constexpr int TT = 64;        // t rows per tile (4 per row group)
constexpr int TS = 64;        // s rows per tile (4 per column lane)
constexpr int MAX_CL = 256;   // longest chunk: one cumsum value per thread
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
// columns of a feature dim below 16 (the reference sweep's P 8, N 4 and 8)
// leave lanes idle: a lane's columns are tx + 16 j < the dim, and every
// shuffle (the cumsum's) is over the chunk's steps, never over features
__host__ __device__ constexpr int lanes16(int n) { return (n + 15) / 16; }
constexpr int WARPS = THREADS / 32;

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
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int P, int N>
constexpr size_t ssd_smem_bytes() {
  return (size_t)(2 * MAX_CL + TT * (N + 1) + N * (TS + 1) + TS * P +
                  TT * (TS + 1)) *
         sizeof(float);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(SsdArgs a) {
  static_assert((P == 8 || P % 16 == 0) && P <= 64 &&
                    (N == 4 || N == 8 || N % 16 == 0) && N <= 64,
                "P in 8, 16, 32, 64; N in 4, 8, 16, 32, 64");
  constexpr int PJ = lanes16(P);  // y columns per thread: p = tx + 16*j < P
  extern __shared__ float smem[];
  float* cum_s = smem;                   // [MAX_CL] inclusive cumsum of dt*A
  float* dt_s = cum_s + MAX_CL;          // [MAX_CL] dt in f32
  float* c_s = dt_s + MAX_CL;            // [TT][N+1] C rows of the t tile
  float* bt_s = c_s + TT * (N + 1);      // [N][TS+1] B of an s tile, transposed
  float* x_s = bt_s + N * (TS + 1);      // [TS][P] dt_s x_s of an s tile
  float* w_s = x_s + TS * P;             // [TT][TS+1] decay-weighted scores
  __shared__ float warp_tot[WARPS], warp_pre[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / a.nc, c = blockIdx.x % a.nc;
  const int hh = blockIdx.y, tile = blockIdx.z;
  const int cl = a.cl, n_t = (cl + TT - 1) / TT;

  const T* X = (const T*)a.x + b * a.sx[0] + hh * a.sx[1] + c * a.sx[2];
  const T* DT = (const T*)a.dt + b * a.sdt[0] + hh * a.sdt[1] + c * a.sdt[2];
  const T* Bp = (const T*)a.b + b * a.sb[0] + hh * a.sb[1] + c * a.sb[2];
  const T* Cp = (const T*)a.c + b * a.sc[0] + hh * a.sc[1] + c * a.sc[2];
  const long long bhc = ((long long)b * a.H + hh) * a.nc + c;

  // cum = inclusive prefix sum of dt*A: thread i holds step i; a shuffle
  // scan inside each warp, then the warps' totals
  {
    const float d = tid < cl ? to_f32(DT[tid * a.sdt[3]]) : 0.f;
    float v = d * a.A[hh];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += n;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        warp_pre[w] = run;
        run += warp_tot[w];
      }
    }
    __syncthreads();
    if (tid < cl) {
      cum_s[tid] = v + warp_pre[warp];
      dt_s[tid] = d;
    }
    __syncthreads();
  }

  if (tile == n_t) {
    // the chunk's emitted state and decay: h[p][n] over all s; thread owns
    // rows p = ty + 16*i < P, columns n = tx + 16*j < N
    constexpr int PR = lanes16(P), NJ = lanes16(N);
    float acc[PR][NJ];
#pragma unroll
    for (int i = 0; i < PR; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    const float cend = cum_s[cl - 1];
    for (int s0 = 0; s0 < cl; s0 += TS) {
      __syncthreads();  // the previous tile's reads are done
      for (int i = tid; i < TS * P; i += THREADS) {
        const int r = i / P, p = i % P, s = s0 + r;
        x_s[i] = s < cl ? to_f32(X[s * a.sx[3] + p]) * dt_s[s] *
                              expf(cend - cum_s[s])
                        : 0.f;
      }
      for (int i = tid; i < TS * N; i += THREADS) {
        const int r = i / N, n = i % N, s = s0 + r;
        bt_s[i] = s < cl ? to_f32(Bp[s * a.sb[3] + n]) : 0.f;  // [TS][N]
      }
      __syncthreads();
      const int rows = min(TS, cl - s0);
      for (int r = 0; r < rows; ++r) {
        float xv[PR], bv[NJ];
#pragma unroll
        for (int i = 0; i < PR; ++i)
          xv[i] = ty + 16 * i < P ? x_s[r * P + ty + 16 * i] : 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          bv[j] = tx + 16 * j < N ? bt_s[r * N + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < PR; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
    }
    float* Hout = a.h + bhc * P * N;
#pragma unroll
    for (int i = 0; i < PR; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (ty + 16 * i < P && tx + 16 * j < N)
          Hout[(ty + 16 * i) * N + tx + 16 * j] = acc[i][j];
    if (tid == 0) a.dec[bhc] = expf(cend);
    return;
  }

  // y_intra for t rows t0 + ty*4 + i
  const int t0 = tile * TT;
  for (int i = tid; i < TT * N; i += THREADS) {
    const int r = i / N, n = i % N, t = t0 + r;
    c_s[r * (N + 1) + n] = t < cl ? to_f32(Cp[t * a.sc[3] + n]) : 0.f;
  }
  float ct[4], acc[4][PJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    ct[i] = t < cl ? cum_s[t] : 0.f;
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
  }

  for (int s0 = 0; s0 <= t0; s0 += TS) {  // s tiles up to the diagonal
    __syncthreads();  // c_s staged / the previous tile's reads are done
    for (int i = tid; i < TS * N; i += THREADS) {
      const int r = i / N, n = i % N, s = s0 + r;
      bt_s[n * (TS + 1) + r] = s < cl ? to_f32(Bp[s * a.sb[3] + n]) : 0.f;
    }
    for (int i = tid; i < TS * P; i += THREADS) {
      const int r = i / P, p = i % P, s = s0 + r;
      x_s[i] = s < cl ? to_f32(X[s * a.sx[3] + p]) * dt_s[s] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; ++n) {
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bt_s[n * (TS + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float cv = c_s[(ty * 4 + i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv, bv[j], sc[i][j]);
      }
    }
    // decay under the causal mask; t < cl and s <= t imply s < cl. The
    // exponent is evaluated only where s <= t, where it is <= 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx + 16 * j;
        w_s[(ty * 4 + i) * (TS + 1) + tx + 16 * j] =
            (s <= t && t < cl) ? sc[i][j] * expf(ct[i] - cum_s[s]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int r = 0; r < TS; ++r) {
      float xv[PJ];
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        xv[j] = tx + 16 * j < P ? x_s[r * P + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = w_s[(ty * 4 + i) * (TS + 1) + r];
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(w, xv[j], acc[i][j]);
      }
    }
  }

  float* Y = a.y + bhc * cl * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= cl) continue;
#pragma unroll
    for (int j = 0; j < PJ; ++j)
      if (tx + 16 * j < P) Y[(long long)t * P + tx + 16 * j] = acc[i][j];
  }
}

template <typename T, int P, int N>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes<P, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.nc, a.H, (a.cl + TT - 1) / TT + 1);
  ssd_chunk_kernel<T, P, N><<<grid, THREADS, smem, stream>>>(a);
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
  if (cl < 1 || cl > MAX_CL || B < 1 || H < 1 || nc < 1)
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_pn<float>(a, P, N, st);
  if (dtype == 1) return (int)launch_pn<__nv_bfloat16>(a, P, N, st);
  return (int)cudaErrorInvalidValue;
}
