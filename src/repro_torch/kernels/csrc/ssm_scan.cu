// Mamba-2 selective scan (the SSD chunked form), written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py:68 (ssm_scan: a
// pallas_call over a (B, H, T / block_t) grid whose minor axis walks the
// time blocks in order, carrying the (P, N) state in VMEM scratch).  For
// x (B, T, H, P), dt (B, T, H) float32, A and D (H,) float32, B and C
// (B, T, N) (one group, shared by all heads) and an optional state0
// (B, H, P, N) float32 it computes, per (b, h), chunk by chunk of kQ steps
// with cum the inclusive sum of A dt over the chunk:
//
//     L[t, s] = exp(cum[t] - cum[s]) for s <= t, else 0
//     y       = (L o (C B^T)) (dt o x) + exp(cum) o (C h^T) + D x
//     h      <- exp(cum[-1]) h + (exp(cum[-1] - cum) o dt o x)^T B
//
// and returns y (B, T, H, P) in x's type (contiguous) and the final state
// (B, H, P, N) in float32.  Every product runs in float32.  The exponent is
// formed only where s <= t, so it is never positive: for s > t, with A down
// to -16, exp(cum[t] - cum[s]) would overflow to inf (and 0 * inf is NaN).
//
// x, dt, B and C are read in place through their strides (the model hands
// x and B, C as column slices of the convolution's output); the TPU
// version's transpose to (B, H, T, P) and padding of T on the host are
// gone.  Rows t >= T of the last chunk are staged as dt = x = B = C = 0,
// which keeps cum flat and adds nothing, and no padded row is written.
//
// What bounds it on this card: bytes.  At Zamba2's prefill shape (B 4,
// T 2048, H 80, P 64, N 64, bf16) it reads x once and writes y once
// (84 MB each), reads dt, B and C (7 MB) and writes the state (5 MB):
// 53 us at 3.35 TB/s; its ~32 GFLOP in the 128-step chunk form would take
// 33 us at the bf16 tensor-core peak.
//
// Design (a simple one that is right first): one block of 256 threads per
// (head, batch row), looping over the chunks in order; the state in shared
// memory; each chunk's x, dt, B and C staged in shared memory as float32;
// cum by a warp scan; the three products (C B^T masked and scaled, the
// intra- and inter-chunk terms of y, the state update) as float32 FMA over
// a 16 x 16 grid of threads, each holding a register tile.  Shared rows are
// padded by one float so that the rows a warp reads fall in distinct banks.
// Tensor cores for C B^T, C B^T shared by the 80 heads (B and C are), and
// a split over chunks with a state-passing pass at small B are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;          // chunk length
constexpr int kGrid = 16;       // threads form a kGrid x kGrid grid for every product
constexpr int kThreads = kGrid * kGrid;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  const float* D;
  const float* h0;  // nullptr: the state starts at 0
  void* y;
  float* h_out;
  int T, H;
  long long xs_b, xs_t, xs_h, xs_p;
  long long ds_b, ds_t, ds_h;
  long long bs_b, bs_t, bs_n;
  long long cs_b, cs_t, cs_n;
};

template <int P, int N>
struct Smem {
  float x[kQ][P + 1];
  float b[kQ][N + 1];
  float c[kQ][N + 1];
  float g[kQ][kQ + 1];  // L o (C B^T) o dt[s]
  float h[P][N + 1];
  float dt[kQ];
  float cum[kQ];
  float ec[kQ];  // exp(cum[t])
  float ws[kQ];  // exp(cum[-1] - cum[s]) dt[s]
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(Params p) {
  static_assert(kQ == 64, "the warp scan takes two steps a lane");
  static_assert(P % kGrid == 0 && N % kGrid == 0, "P and N are multiples of 16");
  extern __shared__ float smem_raw[];
  Smem<P, N>& s = *reinterpret_cast<Smem<P, N>*>(smem_raw);

  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / kGrid, tx = tid % kGrid;
  const float A = p.A[h], Dh = p.D[h];
  const long long st = ((long long)bi * p.H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads) s.h[i / N][i % N] = p.h0 ? p.h0[st + i] : 0.f;

  const T* xb = static_cast<const T*>(p.x) + bi * p.xs_b + h * p.xs_h;
  const float* dtb = p.dt + bi * p.ds_b + h * p.ds_h;
  const T* bb = static_cast<const T*>(p.b) + bi * p.bs_b;
  const T* cb = static_cast<const T*>(p.c) + bi * p.cs_b;
  T* yb = static_cast<T*>(p.y) + ((long long)bi * p.T * p.H + h) * P;
  const long long y_row = (long long)p.H * P;

  for (int t0 = 0; t0 < p.T; t0 += kQ) {
    const int len = min(kQ, p.T - t0);

    // Stage the chunk as float32; rows past the end read as 0.
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int t = i / P, c = i % P;
      s.x[t][c] = t < len ? to_f32(xb[(t0 + t) * p.xs_t + c * p.xs_p]) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const bool in = t < len;
      s.b[t][n] = in ? to_f32(bb[(t0 + t) * p.bs_t + n * p.bs_n]) : 0.f;
      s.c[t][n] = in ? to_f32(cb[(t0 + t) * p.cs_t + n * p.cs_n]) : 0.f;
    }
    if (tid < kQ) s.dt[tid] = tid < len ? dtb[(t0 + tid) * p.ds_t] : 0.f;
    __syncthreads();

    // cum: the inclusive sum of A dt, by warp 0, two steps a lane.
    if (tid < 32) {
      const float a0 = A * s.dt[2 * tid], a1 = A * s.dt[2 * tid + 1];
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      s.cum[2 * tid] = incl - a1;
      s.cum[2 * tid + 1] = incl;
    }
    __syncthreads();
    if (tid < kQ) {
      s.ec[tid] = expf(s.cum[tid]);
      s.ws[tid] = expf(s.cum[kQ - 1] - s.cum[tid]) * s.dt[tid];
    }

    // G[t][s] = (C_t . B_s) exp(cum[t] - cum[s]) dt[s] for s <= t, else 0.
    {
      constexpr int R = kQ / kGrid;
      float acc[R][R] = {};
      for (int n = 0; n < N; ++n) {
        float cv[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) cv[i] = s.c[ty + kGrid * i][n];
#pragma unroll
        for (int j = 0; j < R; ++j) bv[j] = s.b[tx + kGrid * j][n];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int t = ty + kGrid * i, u = tx + kGrid * j;
          s.g[t][u] = u <= t ? acc[i][j] * expf(s.cum[t] - s.cum[u]) * s.dt[u] : 0.f;
        }
    }
    __syncthreads();

    // y[t][c] = exp(cum[t]) sum_n C[t][n] h[c][n] + sum_s G[t][s] x[s][c] + D x[t][c]
    {
      constexpr int RT = kQ / kGrid, RC = P / kGrid;
      float acc[RT][RC] = {};
      for (int n = 0; n < N; ++n) {
        float cv[RT], hv[RC];
#pragma unroll
        for (int i = 0; i < RT; ++i) cv[i] = s.c[ty + kGrid * i][n];
#pragma unroll
        for (int j = 0; j < RC; ++j) hv[j] = s.h[tx + kGrid * j][n];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RC; ++j) acc[i][j] *= s.ec[ty + kGrid * i];
      for (int u = 0; u < kQ; ++u) {
        float gv[RT], xv[RC];
#pragma unroll
        for (int i = 0; i < RT; ++i) gv[i] = s.g[ty + kGrid * i][u];
#pragma unroll
        for (int j = 0; j < RC; ++j) xv[j] = s.x[u][tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int t = ty + kGrid * i;
        if (t >= len) continue;
#pragma unroll
        for (int j = 0; j < RC; ++j) {
          const int c = tx + kGrid * j;
          yb[(t0 + t) * y_row + c] = from_f32<T>(fmaf(Dh, s.x[t][c], acc[i][j]));
        }
      }
    }
    __syncthreads();

    // h[c][n] <- exp(cum[-1]) h[c][n] + sum_s ws[s] x[s][c] B[s][n]
    {
      constexpr int RC = P / kGrid, RN = N / kGrid;
      float acc[RC][RN] = {};
      for (int u = 0; u < kQ; ++u) {
        const float w = s.ws[u];
        float xv[RC], bv[RN];
#pragma unroll
        for (int i = 0; i < RC; ++i) xv[i] = s.x[u][ty + kGrid * i] * w;
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = s.b[u][tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < RC; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float decay = s.ec[kQ - 1];
#pragma unroll
      for (int i = 0; i < RC; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int c = ty + kGrid * i, n = tx + kGrid * j;
          s.h[c][n] = decay * s.h[c][n] + acc[i][j];
        }
    }
    __syncthreads();
  }

  for (int i = tid; i < P * N; i += kThreads) p.h_out[st + i] = s.h[i / N][i % N];
}

template <typename T, int P, int N>
int launch(const Params& p, int B, void* stream) {
  const int bytes = (int)sizeof(Smem<P, N>);
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_kernel<T, P, N><<<dim3(p.H, B), kThreads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shape(const Params& p, int B, int P, int N, void* stream) {
  if (P == 64 && N == 64) return launch<T, 64, 64>(p, B, stream);
  if (P == 128 && N == 16) return launch<T, 128, 16>(p, B, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, T, H, P) and b, c (B, T, N): bf16 (is_bf16 nonzero) or float32, any
// strides (in elements); dt (B, T, H) float32, any strides; A, D (H,) and
// h0 (B, H, P, N, or null) contiguous float32; y (B, T, H, P) contiguous in
// x's type; h_out (B, H, P, N) contiguous float32.  (P, N) is (64, 64) or
// (128, 16).
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* A, const void* b,
                            const void* c, const void* D, const void* h0, void* y, void* h_out,
                            int is_bf16, int B, int T, int H, int P, int N,
                            long long xs_b, long long xs_t, long long xs_h, long long xs_p,
                            long long ds_b, long long ds_t, long long ds_h,
                            long long bs_b, long long bs_t, long long bs_n,
                            long long cs_b, long long cs_t, long long cs_n, void* stream) {
  if (B == 0 || H == 0) return 0;
  const Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), b, c,
                 static_cast<const float*>(D), static_cast<const float*>(h0), y,
                 static_cast<float*>(h_out), T, H,
                 xs_b, xs_t, xs_h, xs_p, ds_b, ds_t, ds_h, bs_b, bs_t, bs_n, cs_b, cs_t, cs_n};
  return is_bf16 ? launch_shape<__nv_bfloat16>(p, B, P, N, stream)
                 : launch_shape<float>(p, B, P, N, stream);
}
