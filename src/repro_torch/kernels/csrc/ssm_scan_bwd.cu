// Mamba-2 selective scan, backward (K6b), written for Hopper (sm_90a).
//
// The reference has no TPU kernel for it: its gradient is autodiff through
// the chunked jnp form src/repro/kernels/_ssm_chunked.py:18 (what
// repro.kernels.ops.ssm_scan runs off the TPU).  This kernel computes the
// same gradients of K6's function, chunk by chunk of kQ steps.  Per (b, h)
// and chunk, with a = A dt, cum the inclusive sum of a over the chunk, h the
// state entering the chunk and dh the cotangent of the state leaving it:
//
//     L[t, s] = exp(cum[t] - cum[s]) for s <= t, else 0
//     G = L o (C B^T) o dt[s]              (the forward's intra-chunk matrix)
//     F = L o (dY X^T) o dt[s]
//     ws[s] = exp(cum[-1] - cum[s]) dt[s]
//
//     dX  = G^T dY + D dY + ws o (B dh^T)
//     dC  = F B + exp(cum) o (dY h)                         (one head's share)
//     dB  = F^T C + ws o (X dh)                             (one head's share)
//     dh <- exp(cum[-1]) dh + (exp(cum) o dY)^T C           (carried backwards)
//     dD += sum dY o X
//
// and the cotangent da of a = A dt, which reaches a_j through every
// exponent that sums it: L[t, s] for s < j <= t, ws[s] for s < j, exp(cum[t])
// for j <= t and exp(cum[-1]) for all j.  With E = L o (C B^T) o (dY X^T)
// o dt[s] below the diagonal and dws[s] = B_s . (X dh)_s,
//
//     da[j] = sum_{t >= j, s < j} E[t, s] + sum_{s < j} dws[s] ws[s]
//           + sum_{t >= j} exp(cum[t]) (dY_t . h C_t) + exp(cum[-1]) sum(dh o h),
//
// each sum over terms taken as they are: the rectangle of E from column
// suffix sums, the rest by prefix and suffix sums.  (The form autodiff
// takes, row sums of E at t minus column sums at s and then a reverse
// cumulative sum, cancels the diagonal and every term with j <= s in
// rounding; under strong decay, where da is small, that noise is most of
// it.)  Then dA += sum da dt and
//
//     ddt[s] = sum_t (L o C B^T o dY X^T)[t, s] + dws[s] exp(cum[-1] - cum[s]) + A da[s].
//
// The exponent is formed only where s <= t, so it is never positive (for
// s > t it can overflow to inf, and 0 * inf is NaN).
//
// What bounds it on this card: operations.  At Zamba2's training shape
// (B 2, T 1024, H 80, P 64, N 64, bf16) the chunked formulas are 13.5
// GFLOP, 13.6 us at the bf16 tensor-core peak, against 42 MB of operands
// (12.6 us at 3.35 TB/s).
//
// Two routes, chosen by dtype and (P, N) alone (`ssm_scan_bwd` and
// `ssm_scan_bwd_tc` below, `bwd_route` in ssm_scan.py):
//
//  * tensor cores (namespace tc, below), bf16 at P = N = 64: the chunks in
//    parallel, four launches a call.  The state entering each chunk and the
//    cotangent leaving it are the only sequential quantities: each chunk's
//    local increments come first, in parallel, then one float32 pass per
//    (b, h) over the chunks combines them, then the chunk bodies run in
//    parallel over (b, chunk, group of heads), then the sums.  Bound in
//    practice by the body's latency (barriers, a head's loads between its
//    products; two blocks an SM) and by the float32 states' round trip
//    through device memory (2 x 42 MB written, read, written and read).
//  * float32 FMA (the first design), float32 and P 128 / N 16, two
//    launches a call.  The states entering each chunk are recomputed, not
//    saved by the forward: a first pass walks the chunks forward (the
//    forward's state update alone, a third of its products) and writes them
//    to a float32 scratch (B, H, T / kQ, P, N), for one layer at a time;
//    saving them in the forward would hold 1.9 GB over Zamba2's 45 layers
//    from the forward to the backward.  The second pass walks the chunks in
//    reverse, carrying dh in shared memory.  B and C are one group shared by
//    all heads, and A and D are per head, so dB, dC, dA and dD are sums over
//    blocks: each block writes its float32 partials (dB and dC per head),
//    and a second launch sums them in a fixed order and rounds dB and dC to
//    their dtype.  One block of 256 threads per (head, batch row), as K6's
//    FMA route; each chunk's operands staged as float32 in shared memory;
//    every product float32 FMA over a 16 x 16 grid of threads, each holding
//    a register tile; the row sums by shuffles within a half-warp, the
//    column sums through shared memory, the cumulative sums by one warp, all
//    in a fixed order.  The reference's float32 tolerance leaves no room for
//    bf16 operands there.
//
// On both routes every sum over heads, rows and chunks is taken in a fixed
// order, without atomics: the gradients are the same bit for bit from run
// to run.
//
// Operands: x, dt, B and C are read through their strides (the model hands
// x, B and C as column views); dy, dh_fin and the outputs are contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQ = 64;     // chunk length (K6's)
constexpr int kGrid = 16;  // threads form a kGrid x kGrid grid for every product
constexpr int kThreads = kGrid * kGrid;
constexpr int kR = kQ / kGrid;  // rows of a chunk a thread holds

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  const float* D;
  const float* h0;      // nullptr: the state starts at 0
  const void* dy;       // (B, T, H, P) contiguous, x's type
  const float* dh_fin;  // nullptr: no cotangent on the final state
  void* dx;             // (B, T, H, P) contiguous, x's type
  float* ddt;           // (B, T, H) contiguous
  float* dh0;           // nullptr: not wanted
  float* states;        // (B, H, nc, P, N): the state entering each chunk
  float* dB_part;       // (B, H, T, N)
  float* dC_part;       // (B, H, T, N)
  float* dA_part;       // (B, H)
  float* dD_part;       // (B, H)
  int T, H, drop_carry;
  long long xs_b, xs_t, xs_h, xs_p;
  long long ds_b, ds_t, ds_h;
  long long bs_b, bs_t, bs_n;
  long long cs_b, cs_t, cs_n;
};

template <int P, int N>
struct Smem {
  float x[kQ][P + 1];
  float dy[kQ][P + 1];
  float b[kQ][N + 1];
  float c[kQ][N + 1];
  float h[P][N + 1];   // the state entering the chunk
  float dh[P][N + 1];  // the cotangent of the state leaving it
  float g[kQ][kQ + 1];  // G = L o (C B^T) o dt[s]
  float f[kQ][kQ + 1];  // F = L o (dY X^T) o dt[s]
  float e[kQ][kQ + 1];  // E below the diagonal, then its column suffix sums
  float colpart[kGrid][kQ];
  float dt[kQ], cum[kQ], ec[kQ], ws[kQ];
  float direct[kQ], inter[kQ], dws[kQ], diag[kQ];
  float red[kThreads / 32];
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

// Sum over the 16 lanes of a half-warp (the tx of one ty), in a fixed order.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 1; off < kGrid; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cum (inclusive sum of A dt over the chunk) by warp 0, two steps a lane;
// then exp(cum) and ws.  Ends on a barrier.
template <int P, int N>
__device__ void chunk_decay(Smem<P, N>& s, float A, int tid) {
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
  __syncthreads();
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_bwd_kernel(Params p) {
  static_assert(kQ == 64, "the warp scans take two steps a lane");
  static_assert(P % kGrid == 0 && N % kGrid == 0, "P and N are multiples of 16");
  constexpr int RP = P / kGrid, RN = N / kGrid;
  extern __shared__ float smem_raw[];
  Smem<P, N>& s = *reinterpret_cast<Smem<P, N>*>(smem_raw);

  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / kGrid, tx = tid % kGrid;
  const int lane = tid % 32, warp = tid / 32;
  const int steps = p.T, H = p.H, nc = (steps + kQ - 1) / kQ;
  const float A = p.A[h], Dh = p.D[h];
  const long long bh = (long long)bi * H + h;

  const T* xb = static_cast<const T*>(p.x) + bi * p.xs_b + h * p.xs_h;
  const float* dtb = p.dt + bi * p.ds_b + h * p.ds_h;
  const T* bb = static_cast<const T*>(p.b) + bi * p.bs_b;
  const T* cb = static_cast<const T*>(p.c) + bi * p.cs_b;
  const long long row = (long long)H * P;  // dy and dx: one step of (B, T, H, P)
  const T* dyb = static_cast<const T*>(p.dy) + (long long)bi * steps * row + (long long)h * P;
  T* dxb = static_cast<T*>(p.dx) + (long long)bi * steps * row + (long long)h * P;
  float* states = p.states + bh * nc * P * N;
  float* dBp = p.dB_part + bh * steps * N;
  float* dCp = p.dC_part + bh * steps * N;

  // ---- pass 1: the state entering every chunk, walking forward
  for (int i = tid; i < P * N; i += kThreads) s.h[i / N][i % N] = p.h0 ? p.h0[bh * P * N + i] : 0.f;
  __syncthreads();
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * kQ, len = min(kQ, steps - t0);
    float* st = states + (long long)ci * P * N;
    for (int i = tid; i < P * N; i += kThreads) st[i] = s.h[i / N][i % N];
    if (ci == nc - 1) break;
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int t = i / P, cc = i % P;
      s.x[t][cc] = t < len ? to_f32(xb[(t0 + t) * p.xs_t + cc * p.xs_p]) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int t = i / N, n = i % N;
      s.b[t][n] = t < len ? to_f32(bb[(t0 + t) * p.bs_t + n * p.bs_n]) : 0.f;
    }
    if (tid < kQ) s.dt[tid] = tid < len ? dtb[(t0 + tid) * p.ds_t] : 0.f;
    __syncthreads();
    chunk_decay(s, A, tid);
    // h[c][n] <- exp(cum[-1]) h[c][n] + sum_s ws[s] x[s][c] B[s][n]
    float acc[RP][RN] = {};
    for (int u = 0; u < kQ; ++u) {
      const float w = s.ws[u];
      float xv[RP], bv[RN];
#pragma unroll
      for (int i = 0; i < RP; ++i) xv[i] = s.x[u][ty + kGrid * i] * w;
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = s.b[u][tx + kGrid * j];
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
    const float decay = s.ec[kQ - 1];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int cc = ty + kGrid * i, n = tx + kGrid * j;
        s.h[cc][n] = decay * s.h[cc][n] + acc[i][j];
      }
    __syncthreads();
  }

  // ---- pass 2: the chunks in reverse, carrying dh
  for (int i = tid; i < P * N; i += kThreads)
    s.dh[i / N][i % N] = p.dh_fin ? p.dh_fin[bh * P * N + i] : 0.f;
  float dA_acc = 0.f, dD_acc = 0.f;  // warp 0's lanes

  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * kQ, len = min(kQ, steps - t0);
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int t = i / P, cc = i % P;
      const bool in = t < len;
      s.x[t][cc] = in ? to_f32(xb[(t0 + t) * p.xs_t + cc * p.xs_p]) : 0.f;
      s.dy[t][cc] = in ? to_f32(dyb[(t0 + t) * row + cc]) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const bool in = t < len;
      s.b[t][n] = in ? to_f32(bb[(t0 + t) * p.bs_t + n * p.bs_n]) : 0.f;
      s.c[t][n] = in ? to_f32(cb[(t0 + t) * p.cs_t + n * p.cs_n]) : 0.f;
    }
    const float* st = states + (long long)ci * P * N;
    for (int i = tid; i < P * N; i += kThreads) s.h[i / N][i % N] = st[i];
    if (tid < kQ) s.dt[tid] = tid < len ? dtb[(t0 + tid) * p.ds_t] : 0.f;
    __syncthreads();
    chunk_decay(s, A, tid);

    // C B^T and dY X^T, then G, F, E, the column sums of
    // L o (C B^T) o (dY X^T), and the diagonal of dY X^T.
    {
      float cbm[kR][kR] = {}, mm[kR][kR] = {};
      for (int n = 0; n < N; ++n) {
        float cv[kR], bv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) cv[i] = s.c[ty + kGrid * i][n];
#pragma unroll
        for (int j = 0; j < kR; ++j) bv[j] = s.b[tx + kGrid * j][n];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) cbm[i][j] = fmaf(cv[i], bv[j], cbm[i][j]);
      }
      for (int q = 0; q < P; ++q) {
        float dv[kR], xv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) dv[i] = s.dy[ty + kGrid * i][q];
#pragma unroll
        for (int j = 0; j < kR; ++j) xv[j] = s.x[tx + kGrid * j][q];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) mm[i][j] = fmaf(dv[i], xv[j], mm[i][j]);
      }
      float colp[kR] = {};
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int t = ty + kGrid * i, u = tx + kGrid * j;
          float g = 0.f, f = 0.f, e = 0.f;
          if (u <= t) {
            const float L = expf(s.cum[t] - s.cum[u]), dtu = s.dt[u];
            const float lcm = L * cbm[i][j] * mm[i][j];
            if (u < t) e = lcm * dtu;
            colp[j] += lcm;
            g = cbm[i][j] * L * dtu;
            f = mm[i][j] * L * dtu;
          }
          s.g[t][u] = g;
          s.f[t][u] = f;
          s.e[t][u] = e;
          if (t == u) s.diag[t] = mm[i][j];
        }
#pragma unroll
      for (int j = 0; j < kR; ++j) s.colpart[ty][tx + kGrid * j] = colp[j];
    }
    __syncthreads();
    if (tid < kQ) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < kGrid; ++i) v += s.colpart[i][tid];
      s.direct[tid] = v;
      v = 0.f;  // column tid's suffix sums of E, in place
      for (int t = kQ - 1; t > tid; --t) {
        v += s.e[t][tid];
        s.e[t][tid] = v;
      }
    }

    // dX[s][c] = sum_t G[t][s] dY[t][c] + D dY[s][c] + ws[s] sum_n B[s][n] dh[c][n]
    {
      float acc[kR][RP] = {}, acc2[kR][RP] = {};
      for (int t = 0; t < kQ; ++t) {
        float gv[kR], dv[RP];
#pragma unroll
        for (int i = 0; i < kR; ++i) gv[i] = s.g[t][ty + kGrid * i];
#pragma unroll
        for (int j = 0; j < RP; ++j) dv[j] = s.dy[t][tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < RP; ++j) acc[i][j] = fmaf(gv[i], dv[j], acc[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float bv[kR], hv[RP];
#pragma unroll
        for (int i = 0; i < kR; ++i) bv[i] = s.b[ty + kGrid * i][n];
#pragma unroll
        for (int j = 0; j < RP; ++j) hv[j] = s.dh[tx + kGrid * j][n];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < RP; ++j) acc2[i][j] = fmaf(bv[i], hv[j], acc2[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int u = ty + kGrid * i;
        if (u >= len) continue;
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const int cc = tx + kGrid * j;
          const float v = fmaf(s.ws[u], acc2[i][j], fmaf(Dh, s.dy[u][cc], acc[i][j]));
          dxb[(t0 + u) * row + cc] = from_f32<T>(v);
        }
      }
    }

    // dC[t][n] = sum_s F[t][s] B[s][n] + exp(cum[t]) (dY h)[t][n]; and
    // inter[t] = exp(cum[t]) sum_n C[t][n] (dY h)[t][n]
    {
      float acc[kR][RN] = {}, dyh[kR][RN] = {};
      for (int u = 0; u < kQ; ++u) {
        float fv[kR], bv[RN];
#pragma unroll
        for (int i = 0; i < kR; ++i) fv[i] = s.f[ty + kGrid * i][u];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = s.b[u][tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(fv[i], bv[j], acc[i][j]);
      }
      for (int q = 0; q < P; ++q) {
        float dv[kR], hv[RN];
#pragma unroll
        for (int i = 0; i < kR; ++i) dv[i] = s.dy[ty + kGrid * i][q];
#pragma unroll
        for (int j = 0; j < RN; ++j) hv[j] = s.h[q][tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) dyh[i][j] = fmaf(dv[i], hv[j], dyh[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int t = ty + kGrid * i;
        const float e = s.ec[t];
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int n = tx + kGrid * j;
          part = fmaf(s.c[t][n], dyh[i][j], part);
          if (t < len) dCp[(long long)(t0 + t) * N + n] = fmaf(e, dyh[i][j], acc[i][j]);
        }
        part = half_warp_sum(part);
        if (tx == 0) s.inter[t] = e * part;
      }
    }

    // dB[s][n] = sum_t F[t][s] C[t][n] + ws[s] (X dh)[s][n]; and
    // dws[s] = sum_n B[s][n] (X dh)[s][n]
    {
      float acc[kR][RN] = {}, xdh[kR][RN] = {};
      for (int t = 0; t < kQ; ++t) {
        float fv[kR], cv[RN];
#pragma unroll
        for (int i = 0; i < kR; ++i) fv[i] = s.f[t][ty + kGrid * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) cv[j] = s.c[t][tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(fv[i], cv[j], acc[i][j]);
      }
      for (int q = 0; q < P; ++q) {
        float xv[kR], hv[RN];
#pragma unroll
        for (int i = 0; i < kR; ++i) xv[i] = s.x[ty + kGrid * i][q];
#pragma unroll
        for (int j = 0; j < RN; ++j) hv[j] = s.dh[q][tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) xdh[i][j] = fmaf(xv[i], hv[j], xdh[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int u = ty + kGrid * i;
        const float w = s.ws[u];
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int n = tx + kGrid * j;
          part = fmaf(s.b[u][n], xdh[i][j], part);
          if (u < len) dBp[(long long)(t0 + u) * N + n] = fmaf(w, xdh[i][j], acc[i][j]);
        }
        part = half_warp_sum(part);
        if (tx == 0) s.dws[u] = part;
      }
    }

    // dh_in[c][n] = exp(cum[-1]) dh[c][n] + sum_t exp(cum[t]) dY[t][c] C[t][n]
    // (kept in registers until every product above has read dh), and
    // sum(dh o h) for the exponent at the chunk's last step.
    float dhn[RP][RN] = {};
    {
      for (int t = 0; t < kQ; ++t) {
        const float e = s.ec[t];
        float dv[RP], cv[RN];
#pragma unroll
        for (int i = 0; i < RP; ++i) dv[i] = s.dy[t][ty + kGrid * i] * e;
#pragma unroll
        for (int j = 0; j < RN; ++j) cv[j] = s.c[t][tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) dhn[i][j] = fmaf(dv[i], cv[j], dhn[i][j]);
      }
      const float decay = s.ec[kQ - 1];
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int cc = ty + kGrid * i, n = tx + kGrid * j;
          const float d = s.dh[cc][n];
          part = fmaf(d, s.h[cc][n], part);
          dhn[i][j] = fmaf(decay, d, dhn[i][j]);
        }
      part = warp_sum(part);
      if (lane == 0) s.red[warp] = part;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        s.dh[ty + kGrid * i][tx + kGrid * j] = p.drop_carry ? 0.f : dhn[i][j];

    // da, ddt, dA and dD: warp 0, steps 2 lane and 2 lane + 1.
    if (warp == 0) {
      float dhh = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) dhh += s.red[w];
      float d[2], q[2], rect[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 2 * lane + e;
        q[e] = s.dws[t] * s.ws[t];
        d[e] = s.inter[t];
        float v = 0.f;  // the rectangle t' >= t, s < t of E: row t of the suffix sums
        for (int u = 0; u < t; ++u) v += s.e[t][u];
        rect[e] = v;
      }
      if (lane == 31) d[1] += s.ec[kQ - 1] * dhh;
      // suffix sums of d and exclusive prefix sums of q
      float suf = d[0] + d[1], pre = q[0] + q[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += v;
        const float w = __shfl_up_sync(0xffffffffu, pre, off);
        if (lane >= off) pre += w;
      }
      pre -= q[0] + q[1];
      const float da[2] = {suf + rect[0] + pre, (suf - d[0]) + rect[1] + (pre + q[0])};
      float da_dt = 0.f, dgd = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 2 * lane + e;
        if (t < len) {
          const float g = s.direct[t] + s.dws[t] * expf(s.cum[kQ - 1] - s.cum[t]) + A * da[e];
          p.ddt[((long long)bi * steps + t0 + t) * H + h] = g;
        }
        da_dt = fmaf(da[e], s.dt[t], da_dt);
        dgd += s.diag[t];
      }
      dA_acc += warp_sum(da_dt);
      dD_acc += warp_sum(dgd);
    }
  }
  __syncthreads();
  if (p.dh0)
    for (int i = tid; i < P * N; i += kThreads) p.dh0[bh * P * N + i] = s.dh[i / N][i % N];
  if (tid == 0) {
    p.dA_part[bh] = dA_acc;
    p.dD_part[bh] = dD_acc;
  }
}

// dB and dC: the heads' partials summed in order and rounded to their type;
// dA and dD: the batch rows' partials summed.  One thread an output.
template <typename T>
__global__ void reduce_kernel(const float* dB_part, const float* dC_part, const float* dA_part,
                              const float* dD_part, T* dB, T* dC, float* dA, float* dD, int B,
                              int T_, int H, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long tn = (long long)T_ * N, total = B * tn;
  if (i < total) {
    const long long bi = i / tn, r = i % tn;
    const float* pb = dB_part + bi * H * tn + r;
    const float* pc = dC_part + bi * H * tn + r;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += pb[h * tn];
      sc += pc[h * tn];
    }
    dB[i] = from_f32<T>(sb);
    dC[i] = from_f32<T>(sc);
  } else if (i - total < H) {
    const int h = (int)(i - total);
    float sa = 0.f, sd = 0.f;
    for (int bi = 0; bi < B; ++bi) {
      sa += dA_part[bi * H + h];
      sd += dD_part[bi * H + h];
    }
    dA[h] = sa;
    dD[h] = sd;
  }
}

template <typename T, int P, int N>
int launch(const Params& p, int B, void* dB, void* dC, float* dA, float* dD, void* stream) {
  const int bytes = (int)sizeof(Smem<P, N>);
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  ssm_scan_bwd_kernel<T, P, N><<<dim3(p.H, B), kThreads, bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * p.T * N + p.H;
  const int threads = 256;
  reduce_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      p.dB_part, p.dC_part, p.dA_part, p.dD_part, static_cast<T*>(dB), static_cast<T*>(dC), dA,
      dD, B, p.T, p.H, N);
  return (int)cudaGetLastError();
}

// The FMA route: (64, 64) in float32 only (bf16 there takes the tensor cores).
template <typename T>
int launch_shape(const Params& p, int B, int P, int N, void* dB, void* dC, float* dA, float* dD,
                 void* stream) {
  if constexpr (std::is_same_v<T, float>) {
    if (P == 64 && N == 64) return launch<T, 64, 64>(p, B, dB, dC, dA, dD, stream);
  }
  if (P == 128 && N == 16) return launch<T, 128, 16>(p, B, dB, dC, dA, dD, stream);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------- tensor-core route
// bf16 at P = N = 64 (Zamba2's shape): the chunks in parallel, every product
// on tensor cores.  Four launches a call:
//
//  1. chunk_states, grid (chunks, H, B): each chunk's local state increment
//     S_c = (ws o X)^T B and cotangent increment R_c = (exp(cum) o dY)^T C,
//     and its decay exp(cum[-1]), into float32 scratch (B, H, chunks, P, N).
//  2. combine: one thread a float4 of a (b, h) state walks the chunks,
//     forward h_c = decay h_{c-1} + S_{c-1} (from state0), another in
//     reverse dh_c = decay dh_{c+1} + R_{c+1} (from the final state's
//     cotangent), in float32, sixteen chunks' loads in flight, overwriting S_c with the state entering chunk c and R_c
//     with the cotangent of the state leaving it; dstate0 is what enters
//     chunk 0.  The planted fault (drop_carry) sets the carried cotangent
//     to 0 at each step, as the first design's does.
//  3. body, grid (H / group, chunks, B): a block owns one (b, chunk) and a
//     group of heads, which share C B^T (computed once) and sum their dB and
//     dC in registers, in head order; it walks its heads one after another.
//     A head's chunk is the first design's body (the formulas at the top)
//     with h and dh read from the combine's output.  Products, all
//     mma.sync m16n8k16 (bf16 in, float32 accumulate), warp w owning rows
//     16 w .. 16 w + 15: C B^T and dY X^T (exact: bf16 operands); G^T dY,
//     F B, F^T C (G and F split); dY h, X dh, B dh^T (h and dh split); and
//     RP = E U, U[s][j] = [s < j], whose masked column sums give E's
//     rectangle (E split).  A float32 operand v enters as its bf16 high part
//     and the bf16 rounding of v - hi, two products that keep float32's
//     accuracy where one rounding would move the gradient by ~2^-9 (K6's
//     split).  G and F reach the products that contract over their rows
//     through shared memory (bf16 hi / lo tiles, read transposed by
//     ldmatrix); E stays in registers.  Column sums of L o (C B^T) o
//     (dY X^T) and of RP reduce by shuffles within each warp and over the
//     four warps in order; da, ddt and the per-head dA and dD partials by
//     warp 0, as the first design's last step.
//  4. reduce: dB and dC over the head groups, dA and dD over batch rows and
//     chunks, each in a fixed order: the gradients are the same bit for bit
//     from launch to launch.
namespace tc {

#include "bf16_mma.cuh"

constexpr int kP = 64, kN = 64;  // the route's (P, N); kQ steps a chunk
constexpr int kWarps = 4, kThreadsTc = 32 * kWarps;
constexpr int kTile = kQ * 64;  // elements of one 64 x 64 bf16 tile
constexpr int kPN4 = kP * kN / 4;  // float4s of one state

struct TcParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  const float* D;
  const float* h0;      // nullptr: the state starts at 0
  const bf16* dy;       // (B, T, H, P) contiguous
  const float* dh_fin;  // nullptr: no cotangent on the final state
  bf16* dx;             // (B, T, H, P) contiguous
  float* ddt;           // (B, T, H) contiguous
  float* dh0;           // nullptr: not wanted
  float* S;             // (B, H, nc, P, N): increments, then the states entering each chunk
  float* R;             // (B, H, nc, P, N): increments, then the cotangents leaving each chunk
  float* decay;         // (B, H, nc)
  float* dB_part;       // (B, H / group, T, N)
  float* dC_part;       // (B, H / group, T, N)
  float* dA_part;       // (B, nc, H)
  float* dD_part;       // (B, nc, H)
  int T, H, nc, group, vec, dy_vec, drop_carry;
  long long xs_b, xs_t, xs_h, xs_p;
  long long ds_b, ds_t, ds_h;
  long long bs_b, bs_t, bs_n;
  long long cs_b, cs_t, cs_n;
};

__device__ __forceinline__ float2 pair(const bf16* s, int r, int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s + swz(r, c)));
}
// Sum over the 8 lanes of one t4 (the rows g of an accumulator column).
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
// Sum over the 4 lanes of one g (the columns of an accumulator row).
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One 64 x 64 bf16 tile of rows [t0, t0 + len) into a swizzled tile (rows
// past len as zeros): by cp.async when rows are 16-byte aligned runs (vec),
// else by plain loads.
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long rs, long long cs,
                                           int len, bool vec, int tid) {
  if (vec) {
    for (int i = tid; i < kQ * 8; i += kThreadsTc) {
      const int r = i >> 3, ch = i & 7;
      const bool ok = r < len;
      cp_async16(dst + swz(r, ch * 8), ok ? src + r * rs + ch * 8 : src, ok);
    }
  } else {
    for (int i = tid; i < kQ * 64; i += kThreadsTc) {
      const int r = i >> 6, col = i & 63;
      dst[swz(r, col)] = r < len ? src[r * rs + col * cs] : __float2bfloat16_rn(0.f);
    }
  }
}

// cum (inclusive sum of A dt, in base-2 units) by one warp, two steps a
// lane, into cum[]; returns the chunk's total.
__device__ __forceinline__ float warp_cum(const float* dt, float A2, float* cum, int lane) {
  const float a0 = A2 * dt[2 * lane], a1 = A2 * dt[2 * lane + 1];
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  cum[2 * lane] = incl - a1;
  cum[2 * lane + 1] = incl;
  return __shfl_sync(0xffffffffu, incl, 31);
}

struct StateSmem {
  bf16 x[kTile], dy[kTile], b[kTile], c[kTile];
  float dt[kQ];
  float cum[kWarps][kQ], ws[kWarps][kQ], ec[kWarps][kQ];  // each warp's own copy
};

// acc[8][4] (+)= (w o T)^T U over the chunk: T, U swizzled tiles (rows s),
// w per row s; this warp's rows of the result are T's columns 16 warp ...
__device__ __forceinline__ void weighted_tn(float (&acc)[8][4], const bf16* t, const bf16* u,
                                            const float* w, int warp, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ta[4], ahi[4], alo[4];
    ld_a_t(ta, t, 16 * warp, 16 * kk, lane);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 16 * kk + 2 * t4 + ((r >> 1) << 3);
      const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&ta[r]));
      split2(v.x * w[k], v.y * w[k + 1], ahi[r], alo[r]);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bq[4];
      ld_b_kn(bq, u, 16 * kk, 16 * np, lane);
      mma(acc[2 * np], ahi, bq[0], bq[1]);
      mma(acc[2 * np + 1], ahi, bq[2], bq[3]);
      mma(acc[2 * np], alo, bq[0], bq[1]);
      mma(acc[2 * np + 1], alo, bq[2], bq[3]);
    }
  }
}

// Launch 1, grid (nc, H, B): S_c, R_c and the chunk's decay.
__global__ void __launch_bounds__(kThreadsTc) chunk_states(TcParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  StateSmem& s = *reinterpret_cast<StateSmem*>(smem_raw);
  const int ci = blockIdx.x, head = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int t0 = ci * kQ, len = min(kQ, p.T - t0);
  const bf16* xb = static_cast<const bf16*>(p.x) + bi * p.xs_b + head * p.xs_h + t0 * p.xs_t;
  const bf16* bb = static_cast<const bf16*>(p.b) + bi * p.bs_b + t0 * p.bs_t;
  const bf16* cb = static_cast<const bf16*>(p.c) + bi * p.cs_b + t0 * p.cs_t;
  const long long row = (long long)p.H * kP;
  const bf16* dyb = p.dy + ((long long)bi * p.T + t0) * row + (long long)head * kP;
  const float* dtb = p.dt + bi * p.ds_b + head * p.ds_h + t0 * p.ds_t;
  stage_tile(s.x, xb, p.xs_t, p.xs_p, len, p.vec, tid);
  stage_tile(s.b, bb, p.bs_t, p.bs_n, len, p.vec, tid);
  stage_tile(s.dy, dyb, row, 1, len, p.dy_vec, tid);
  stage_tile(s.c, cb, p.cs_t, p.cs_n, len, p.vec, tid);
  cp_async_commit();
  if (tid < kQ) s.dt[tid] = tid < len ? dtb[tid * p.ds_t] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  float* cum = s.cum[warp];
  const float tot = warp_cum(s.dt, p.A[head] * kLog2e, cum, lane);
  __syncwarp();
  for (int k = lane; k < kQ; k += 32) {
    s.ws[warp][k] = ex2(tot - cum[k]) * s.dt[k];
    s.ec[warp][k] = ex2(cum[k]);
  }
  __syncwarp();

  const long long st = (((long long)bi * p.H + head) * p.nc + ci) * kP * kN;
  const int pr[2] = {16 * warp + g, 16 * warp + g + 8};
  float acc[8][4];
  if (ci + 1 < p.nc) {  // the last chunk's increment reaches no state that is read
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    weighted_tn(acc, s.x, s.b, s.ws[warp], warp, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(p.S + st + pr[r] * kN + 8 * j + 2 * t4) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  weighted_tn(acc, s.dy, s.c, s.ec[warp], warp, lane);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(p.R + st + pr[r] * kN + 8 * j + 2 * t4) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  if (tid == 0) p.decay[((long long)bi * p.H + head) * p.nc + ci] = ex2(tot);
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

// Launch 2: one thread a float4 of one (b, h) state walks the chunks,
// forward over S (threads [0, n4)) or in reverse over R ([n4, 2 n4)),
// reading kU chunks ahead so that the loads overlap.
constexpr int kU = 16;
__global__ void __launch_bounds__(256) combine(TcParams p, long long n4) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * n4) return;
  const bool fwd = j < n4;
  const long long i = fwd ? j : j - n4;
  const long long bh = i / kPN4, e = i % kPN4;
  const int nc = p.nc;
  float4* S = reinterpret_cast<float4*>(fwd ? p.S : p.R) + bh * nc * kPN4 + e;
  const float* dc = p.decay + bh * nc;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* init = fwd ? p.h0 : p.dh_fin;
  float4 h = init ? reinterpret_cast<const float4*>(init)[i] : zero;
  for (int c0 = 0; c0 < nc; c0 += kU) {
    float4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = fwd ? c0 + u : nc - 1 - c0 - u;
      if (c0 + u < nc) v[u] = S[(long long)c * kPN4];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (c0 + u >= nc) break;
      const int c = fwd ? c0 + u : nc - 1 - c0 - u;
      S[(long long)c * kPN4] = h;
      if (fwd) {
        if (c + 1 < nc) h = axpy4(dc[c], h, v[u]);  // the last chunk's increment is not formed
      } else {
        h = p.drop_carry ? zero : axpy4(dc[c], h, v[u]);
      }
    }
  }
  if (!fwd && p.dh0) reinterpret_cast<float4*>(p.dh0)[i] = h;
}

struct BodySmem {
  bf16 b[kTile], c[kTile];  // the block's (b, chunk): shared by its heads
  bf16 x[kTile], dy[kTile];
  bf16 h_hi[kTile], h_lo[kTile], dh_hi[kTile], dh_lo[kTile];
  bf16 g_hi[kTile], g_lo[kTile], f_hi[kTile], f_lo[kTile];
  float dt[kQ];
  float cum[kWarps][kQ], ws[kWarps][kQ];  // each warp's own copy (base-2 cum)
  float direct[kWarps][kQ], rect[kWarps][kQ];  // each warp's column sums
  float inter[kQ], dws[kQ];
  float red[2][kWarps];  // sum(dh o h), the trace of dY X^T
};

// A bf16 pair of U[s][j] = [s < j] at (k, n), (k + 1, n): a B fragment.
__device__ __forceinline__ uint32_t ustrict(int k, int n) {
  return (k < n ? 0x3F80u : 0u) | (k + 1 < n ? 0x3F800000u : 0u);
}

// Launch 3, grid (H / group, nc, B): the body (see the namespace comment).
__global__ void __launch_bounds__(kThreadsTc, 2) body(TcParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BodySmem& s = *reinterpret_cast<BodySmem*>(smem_raw);
  const int hg = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int t0 = ci * kQ, len = min(kQ, p.T - t0);
  const long long row = (long long)p.H * kP;  // dy and dx: one step of (B, T, H, P)
  // this thread's accumulator rows (t for C B^T, dY X^T, dC; s for dB, dX)
  const int tr[2] = {16 * warp + g, 16 * warp + g + 8};

  stage_tile(s.b, static_cast<const bf16*>(p.b) + bi * p.bs_b + t0 * p.bs_t, p.bs_t, p.bs_n,
             len, p.vec, tid);
  stage_tile(s.c, static_cast<const bf16*>(p.c) + bi * p.cs_b + t0 * p.cs_t, p.cs_t, p.cs_n,
             len, p.vec, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // C B^T for this warp's rows t, columns s <= t only (kept over the heads)
  float cbt[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) cbt[j][0] = cbt[j][1] = cbt[j][2] = cbt[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ca[4];
    ld_a(ca, s.c, 16 * warp, 16 * kk, lane);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp > warp) break;
      uint32_t bf[4];
      ld_b_nk(bf, s.b, 16 * jp, 16 * kk, lane);
      mma(cbt[2 * jp], ca, bf[0], bf[1]);
      mma(cbt[2 * jp + 1], ca, bf[2], bf[3]);
    }
  }
  float dB_acc[8][4], dC_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dB_acc[j][e] = dC_acc[j][e] = 0.f;

  for (int hi = 0; hi < p.group; ++hi) {
    const int head = hg * p.group + hi;
    __syncthreads();  // the previous head is done with every buffer
    stage_tile(s.x, static_cast<const bf16*>(p.x) + bi * p.xs_b + head * p.xs_h + t0 * p.xs_t,
               p.xs_t, p.xs_p, len, p.vec, tid);
    stage_tile(s.dy, p.dy + ((long long)bi * p.T + t0) * row + (long long)head * kP, row, 1, len,
               p.dy_vec, tid);
    cp_async_commit();
    if (tid < kQ)
      s.dt[tid] = tid < len ? p.dt[bi * p.ds_b + head * p.ds_h + (t0 + tid) * p.ds_t] : 0.f;
    {  // h and dh (float32, from the combine) as bf16 hi / lo tiles; sum(dh o h)
      const long long st = (((long long)bi * p.H + head) * p.nc + ci) * kPN4;
      const float4* hs = reinterpret_cast<const float4*>(p.S) + st;
      const float4* ds = reinterpret_cast<const float4*>(p.R) + st;
      float hh = 0.f;
#pragma unroll
      for (int i = tid; i < kPN4; i += kThreadsTc) {
        const float4 hv = hs[i], dv = ds[i];
        hh = fmaf(hv.x, dv.x, fmaf(hv.y, dv.y, fmaf(hv.z, dv.z, fmaf(hv.w, dv.w, hh))));
        const int off = swz((4 * i) >> 6, (4 * i) & 63);
        uint2 hi2, lo2;
        split2(hv.x, hv.y, hi2.x, lo2.x);
        split2(hv.z, hv.w, hi2.y, lo2.y);
        *reinterpret_cast<uint2*>(&s.h_hi[off]) = hi2;
        *reinterpret_cast<uint2*>(&s.h_lo[off]) = lo2;
        split2(dv.x, dv.y, hi2.x, lo2.x);
        split2(dv.z, dv.w, hi2.y, lo2.y);
        *reinterpret_cast<uint2*>(&s.dh_hi[off]) = hi2;
        *reinterpret_cast<uint2*>(&s.dh_lo[off]) = lo2;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) hh += __shfl_xor_sync(0xffffffffu, hh, off);
      if (lane == 0) s.red[0][warp] = hh;
    }
    cp_async_wait_all();
    __syncthreads();

    float* cum = s.cum[warp];
    float* ws = s.ws[warp];
    {
      const float tot = warp_cum(s.dt, p.A[head] * kLog2e, cum, lane);
      __syncwarp();
      for (int k = lane; k < kQ; k += 32) ws[k] = ex2(tot - cum[k]) * s.dt[k];
      __syncwarp();
    }
    const float ct[2] = {cum[tr[0]], cum[tr[1]]};

    // M = dY X^T, this warp's rows t, columns s <= t
    float m[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j][0] = m[j][1] = m[j][2] = m[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      ld_a(da, s.dy, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (jp > warp) break;
        uint32_t bx[4];
        ld_b_nk(bx, s.x, 16 * jp, 16 * kk, lane);
        mma(m[2 * jp], da, bx[0], bx[1]);
        mma(m[2 * jp + 1], da, bx[2], bx[3]);
      }
    }

    // G, F (to shared memory as hi / lo), E (as A fragments), the column
    // sums of L o (C B^T) o M, the trace of M
    uint32_t ehi[4][4], elo[4][4];
    float trace = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float gv[4], fv[4], ev[4], lv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tr[e >> 1], u = 8 * j + 2 * t4 + (e & 1);
        gv[e] = fv[e] = ev[e] = lv[e] = 0.f;
        if (j <= 2 * warp + 1 && u <= t) {
          const float L = ex2(ct[e >> 1] - cum[u]), d = s.dt[u];
          const float ld = L * d;
          gv[e] = cbt[j][e] * ld;
          fv[e] = m[j][e] * ld;
          lv[e] = L * cbt[j][e] * m[j][e];
          if (u < t) ev[e] = lv[e] * d;
          if (u == t) trace += m[j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = swz(tr[r], 8 * j + 2 * t4);
        uint32_t h, l;
        split2(gv[2 * r], gv[2 * r + 1], h, l);
        *reinterpret_cast<uint32_t*>(&s.g_hi[off]) = h;
        *reinterpret_cast<uint32_t*>(&s.g_lo[off]) = l;
        split2(fv[2 * r], fv[2 * r + 1], h, l);
        *reinterpret_cast<uint32_t*>(&s.f_hi[off]) = h;
        *reinterpret_cast<uint32_t*>(&s.f_lo[off]) = l;
      }
      split2(ev[0], ev[1], ehi[j >> 1][(j & 1) * 2], elo[j >> 1][(j & 1) * 2]);
      split2(ev[2], ev[3], ehi[j >> 1][(j & 1) * 2 + 1], elo[j >> 1][(j & 1) * 2 + 1]);
      const float c0 = col_sum(lv[0] + lv[2]), c1 = col_sum(lv[1] + lv[3]);
      if (g == 0) {
        s.direct[warp][8 * j + 2 * t4] = c0;
        s.direct[warp][8 * j + 2 * t4 + 1] = c1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) trace += __shfl_xor_sync(0xffffffffu, trace, off);
    if (lane == 0) s.red[1][warp] = trace;

    // RP = E U (RP[t][j] = sum_{s < j} E[t][s]) and its column sums over t >= j
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      float rp[4] = {0.f, 0.f, 0.f, 0.f};
      if (jn <= 2 * warp + 1) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk > warp || 16 * kk >= 8 * jn + 8) break;
          const uint32_t b0 = ustrict(16 * kk + 2 * t4, 8 * jn + g);
          const uint32_t b1 = ustrict(16 * kk + 2 * t4 + 8, 8 * jn + g);
          mma(rp, ehi[kk], b0, b1);
          mma(rp, elo[kk], b0, b1);
        }
      }
      const int j0 = 8 * jn + 2 * t4;
      const float c0 = col_sum((j0 <= tr[0] ? rp[0] : 0.f) + (j0 <= tr[1] ? rp[2] : 0.f));
      const float c1 = col_sum((j0 + 1 <= tr[0] ? rp[1] : 0.f) + (j0 + 1 <= tr[1] ? rp[3] : 0.f));
      if (g == 0) {
        s.rect[warp][j0] = c0;
        s.rect[warp][j0 + 1] = c1;
      }
    }
    __syncthreads();  // G and F written

    float acc[8][4];
    // dC += exp(cum) o (dY h) + F B; inter[t] = exp(cum[t]) sum_n C[t][n] (dY h)[t][n]
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      ld_a(da, s.dy, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bh[4];
        ld_b_kn(bh, s.h_hi, 16 * kk, 16 * np, lane);
        mma(acc[2 * np], da, bh[0], bh[1]);
        mma(acc[2 * np + 1], da, bh[2], bh[3]);
        ld_b_kn(bh, s.h_lo, 16 * kk, 16 * np, lane);
        mma(acc[2 * np], da, bh[0], bh[1]);
        mma(acc[2 * np + 1], da, bh[2], bh[3]);
      }
    }
    {
      const float ec[2] = {ex2(ct[0]), ex2(ct[1])};
      float ip[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 cv = pair(s.c, tr[r], 8 * j + 2 * t4);
          ip[r] = fmaf(cv.x, acc[j][2 * r], fmaf(cv.y, acc[j][2 * r + 1], ip[r]));
          dC_acc[j][2 * r] = fmaf(ec[r], acc[j][2 * r], dC_acc[j][2 * r]);
          dC_acc[j][2 * r + 1] = fmaf(ec[r], acc[j][2 * r + 1], dC_acc[j][2 * r + 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = row_sum(ip[r]);
        if (t4 == 0) s.inter[tr[r]] = ec[r] * v;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) break;  // F[t][s] = 0 for s > t
      uint32_t fh[4], fl[4];
      ld_a(fh, s.f_hi, 16 * warp, 16 * kk, lane);
      ld_a(fl, s.f_lo, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ld_b_kn(bq, s.b, 16 * kk, 16 * np, lane);
        mma(dC_acc[2 * np], fh, bq[0], bq[1]);
        mma(dC_acc[2 * np + 1], fh, bq[2], bq[3]);
        mma(dC_acc[2 * np], fl, bq[0], bq[1]);
        mma(dC_acc[2 * np + 1], fl, bq[2], bq[3]);
      }
    }

    // dB += ws o (X dh) + F^T C (rows s); dws[s] = sum_n B[s][n] (X dh)[s][n]
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t xa[4];
      ld_a(xa, s.x, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bd[4];
        ld_b_kn(bd, s.dh_hi, 16 * kk, 16 * np, lane);
        mma(acc[2 * np], xa, bd[0], bd[1]);
        mma(acc[2 * np + 1], xa, bd[2], bd[3]);
        ld_b_kn(bd, s.dh_lo, 16 * kk, 16 * np, lane);
        mma(acc[2 * np], xa, bd[0], bd[1]);
        mma(acc[2 * np + 1], xa, bd[2], bd[3]);
      }
    }
    const float wsr[2] = {ws[tr[0]], ws[tr[1]]};
    {
      float ip[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 bv = pair(s.b, tr[r], 8 * j + 2 * t4);
          ip[r] = fmaf(bv.x, acc[j][2 * r], fmaf(bv.y, acc[j][2 * r + 1], ip[r]));
          dB_acc[j][2 * r] = fmaf(wsr[r], acc[j][2 * r], dB_acc[j][2 * r]);
          dB_acc[j][2 * r + 1] = fmaf(wsr[r], acc[j][2 * r + 1], dB_acc[j][2 * r + 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = row_sum(ip[r]);
        if (t4 == 0) s.dws[tr[r]] = v;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < warp) continue;  // F[t][s] = 0 for t < s
      uint32_t fh[4], fl[4];
      ld_a_t(fh, s.f_hi, 16 * warp, 16 * kk, lane);
      ld_a_t(fl, s.f_lo, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ld_b_kn(bq, s.c, 16 * kk, 16 * np, lane);
        mma(dB_acc[2 * np], fh, bq[0], bq[1]);
        mma(dB_acc[2 * np + 1], fh, bq[2], bq[3]);
        mma(dB_acc[2 * np], fl, bq[0], bq[1]);
        mma(dB_acc[2 * np + 1], fl, bq[2], bq[3]);
      }
    }

    // dX = ws o (B dh^T) + G^T dY + D dY (rows s)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ba[4];
      ld_a(ba, s.b, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t bd[4];
        ld_b_nk(bd, s.dh_hi, 16 * pp, 16 * kk, lane);
        mma(acc[2 * pp], ba, bd[0], bd[1]);
        mma(acc[2 * pp + 1], ba, bd[2], bd[3]);
        ld_b_nk(bd, s.dh_lo, 16 * pp, 16 * kk, lane);
        mma(acc[2 * pp], ba, bd[0], bd[1]);
        mma(acc[2 * pp + 1], ba, bd[2], bd[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= wsr[e >> 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < warp) continue;  // G[t][s] = 0 for t < s
      uint32_t gh[4], gl[4];
      ld_a_t(gh, s.g_hi, 16 * warp, 16 * kk, lane);
      ld_a_t(gl, s.g_lo, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t bq[4];
        ld_b_kn(bq, s.dy, 16 * kk, 16 * pp, lane);
        mma(acc[2 * pp], gh, bq[0], bq[1]);
        mma(acc[2 * pp + 1], gh, bq[2], bq[3]);
        mma(acc[2 * pp], gl, bq[0], bq[1]);
        mma(acc[2 * pp + 1], gl, bq[2], bq[3]);
      }
    }
    {
      const float Dh = p.D[head];
      bf16* dxb = p.dx + ((long long)bi * p.T + t0) * row + (long long)head * kP;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (tr[r] >= len) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t4;
          const float2 dv = pair(s.dy, tr[r], col);
          *reinterpret_cast<__nv_bfloat162*>(dxb + tr[r] * row + col) = __floats2bfloat162_rn(
              fmaf(Dh, dv.x, acc[j][2 * r]), fmaf(Dh, dv.y, acc[j][2 * r + 1]));
        }
      }
    }
    __syncthreads();  // inter, dws and the column sums written

    // da, ddt, and this head's dA and dD partials: warp 0, steps 2 lane and 2 lane + 1
    if (warp == 0) {
      const float A = p.A[head];
      const float dhh = ((s.red[0][0] + s.red[0][1]) + s.red[0][2]) + s.red[0][3];
      const float tr_sum = ((s.red[1][0] + s.red[1][1]) + s.red[1][2]) + s.red[1][3];
      const float last = cum[kQ - 1];
      float d[2], q[2], rect[2], dir[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 2 * lane + e;
        q[e] = s.dws[t] * ws[t];
        d[e] = s.inter[t];
        rect[e] = ((s.rect[0][t] + s.rect[1][t]) + s.rect[2][t]) + s.rect[3][t];
        dir[e] = ((s.direct[0][t] + s.direct[1][t]) + s.direct[2][t]) + s.direct[3][t];
      }
      if (lane == 31) d[1] += ex2(last) * dhh;
      // suffix sums of d and exclusive prefix sums of q
      float suf = d[0] + d[1], pre = q[0] + q[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += v;
        const float w = __shfl_up_sync(0xffffffffu, pre, off);
        if (lane >= off) pre += w;
      }
      pre -= q[0] + q[1];
      const float da[2] = {suf + rect[0] + pre, (suf - d[0]) + rect[1] + (pre + q[0])};
      float da_dt = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 2 * lane + e;
        if (t < len)
          p.ddt[((long long)bi * p.T + t0 + t) * p.H + head] =
              dir[e] + s.dws[t] * ex2(last - cum[t]) + A * da[e];
        da_dt = fmaf(da[e], s.dt[t], da_dt);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) da_dt += __shfl_xor_sync(0xffffffffu, da_dt, off);
      if (lane == 0) {
        const long long at = ((long long)bi * p.nc + ci) * p.H + head;
        p.dA_part[at] = da_dt;
        p.dD_part[at] = tr_sum;
      }
    }
  }

  // the group's dB and dC partials
  const int HG = p.H / p.group;
  const long long base = (((long long)bi * HG + hg) * p.T + t0) * kN;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (tr[r] >= len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long at = base + (long long)tr[r] * kN + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(p.dB_part + at) = make_float2(dB_acc[j][2 * r], dB_acc[j][2 * r + 1]);
      *reinterpret_cast<float2*>(p.dC_part + at) = make_float2(dC_acc[j][2 * r], dC_acc[j][2 * r + 1]);
    }
  }
}

// Launch 4: dB and dC over the head groups, dA and dD over batch rows and
// chunks, in order; one thread an output.
__global__ void __launch_bounds__(256) reduce(TcParams p, int B, void* dB, void* dC, float* dA,
                                              float* dD) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long tn = (long long)p.T * kN, total = B * tn;
  const int HG = p.H / p.group;
  if (i < total) {
    const long long bi = i / tn, r = i % tn;
    const float* pb = p.dB_part + bi * HG * tn + r;
    const float* pc = p.dC_part + bi * HG * tn + r;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < HG; ++k) {
      sb += pb[k * tn];
      sc += pc[k * tn];
    }
    static_cast<bf16*>(dB)[i] = __float2bfloat16_rn(sb);
    static_cast<bf16*>(dC)[i] = __float2bfloat16_rn(sc);
  } else if (i - total < p.H) {
    const int h = (int)(i - total);
    float sa = 0.f, sd = 0.f;
    for (long long k = 0; k < (long long)B * p.nc; ++k) {
      sa += p.dA_part[k * p.H + h];
      sd += p.dD_part[k * p.H + h];
    }
    dA[h] = sa;
    dD[h] = sd;
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

int launch(const TcParams& p, int B, void* dB, void* dC, float* dA, float* dD, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int sbytes = (int)sizeof(StateSmem);
  chunk_states<<<dim3(p.nc, p.H, B), kThreadsTc, sbytes, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n4 = (long long)B * p.H * kPN4;
  combine<<<(unsigned)((2 * n4 + 255) / 256), 256, 0, s>>>(p, n4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bbytes = (int)sizeof(BodySmem);
  err = cudaFuncSetAttribute(body, cudaFuncAttributeMaxDynamicSharedMemorySize, bbytes);
  if (err != cudaSuccess) return (int)err;
  body<<<dim3(p.H / p.group, p.nc, B), kThreadsTc, bbytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * p.T * kN + p.H;
  reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(p, B, dB, dC, dA, dD);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x (B, T, H, P) and b, c (B, T, N): bf16 (is_bf16 nonzero) or float32, any
// strides (in elements); dt (B, T, H) float32, any strides; A, D (H,) and h0
// (B, H, P, N, or null) contiguous float32; dy (B, T, H, P) contiguous in
// x's type; dh_fin (B, H, P, N, or null) contiguous float32.  Outputs, all
// contiguous: dx (B, T, H, P) in x's type, ddt (B, T, H) float32, dB and dC
// (B, T, N) in x's type, dA and dD (H,) float32, dh0 (B, H, P, N, or null)
// float32.  scratch: float32, B H (ceil(T / 64) P N + 2 T N + 2) elements.
// (P, N) is (64, 64) or (128, 16).  drop_carry: 0 (a planted fault: the
// cotangent of the state is not carried from a chunk to the one before).
extern "C" int ssm_scan_bwd(const void* x, const void* dt, const void* A, const void* b,
                            const void* c, const void* D, const void* h0, const void* dy,
                            const void* dh_fin, void* dx, void* ddt, void* dB, void* dC,
                            void* dA, void* dD, void* dh0, void* scratch, int is_bf16, int B,
                            int T, int H, int P, int N,
                            long long xs_b, long long xs_t, long long xs_h, long long xs_p,
                            long long ds_b, long long ds_t, long long ds_h,
                            long long bs_b, long long bs_t, long long bs_n,
                            long long cs_b, long long cs_t, long long cs_n, int drop_carry,
                            void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  const long long nc = (T + kQ - 1) / kQ, bh = (long long)B * H;
  float* states = static_cast<float*>(scratch);
  float* dB_part = states + bh * nc * P * N;
  float* dC_part = dB_part + bh * T * N;
  float* dA_part = dC_part + bh * T * N;
  float* dD_part = dA_part + bh;
  const Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), b, c,
                 static_cast<const float*>(D), static_cast<const float*>(h0), dy,
                 static_cast<const float*>(dh_fin), dx, static_cast<float*>(ddt),
                 static_cast<float*>(dh0), states, dB_part, dC_part, dA_part, dD_part, T, H,
                 drop_carry, xs_b, xs_t, xs_h, xs_p, ds_b, ds_t, ds_h, bs_b, bs_t, bs_n,
                 cs_b, cs_t, cs_n};
  float* dAf = static_cast<float*>(dA);
  float* dDf = static_cast<float*>(dD);
  return is_bf16 ? launch_shape<__nv_bfloat16>(p, B, P, N, dB, dC, dAf, dDf, stream)
                 : launch_shape<float>(p, B, P, N, dB, dC, dAf, dDf, stream);
}

// The tensor-core route (bf16 at P = N = 64): operands as `ssm_scan_bwd`'s,
// x, b and c bf16.  group: heads a body block (a divisor of H).  scratch:
// float32, 2 B H nc 64 64 + B H nc + 2 B (H / group) T 64 + 2 B nc H
// elements, nc = ceil(T / 64).  drop_carry: 0 (the planted fault).
extern "C" int ssm_scan_bwd_tc(const void* x, const void* dt, const void* A, const void* b,
                               const void* c, const void* D, const void* h0, const void* dy,
                               const void* dh_fin, void* dx, void* ddt, void* dB, void* dC,
                               void* dA, void* dD, void* dh0, void* scratch, int B, int T, int H,
                               int group,
                               long long xs_b, long long xs_t, long long xs_h, long long xs_p,
                               long long ds_b, long long ds_t, long long ds_h,
                               long long bs_b, long long bs_t, long long bs_n,
                               long long cs_b, long long cs_t, long long cs_n, int drop_carry,
                               void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  if (group < 1 || H % group) return (int)cudaErrorInvalidValue;
  const int nc = (T + kQ - 1) / kQ;
  const long long bhc = (long long)B * H * nc, parts = (long long)B * (H / group) * T * tc::kN;
  float* f = static_cast<float*>(scratch);
  float* S = f;
  float* R = S + bhc * tc::kP * tc::kN;
  float* decay = R + bhc * tc::kP * tc::kN;
  float* dB_part = decay + bhc;
  float* dC_part = dB_part + parts;
  float* dA_part = dC_part + parts;
  float* dD_part = dA_part + (long long)B * nc * H;
  const auto al = [](const void* ptr) { return tc::aligned16(ptr); };
  const int vec = xs_p == 1 && bs_n == 1 && cs_n == 1 && al(x) && al(b) && al(c) &&
                  xs_b % 8 == 0 && xs_t % 8 == 0 && xs_h % 8 == 0 && bs_b % 8 == 0 &&
                  bs_t % 8 == 0 && cs_b % 8 == 0 && cs_t % 8 == 0;
  const tc::TcParams p{x, static_cast<const float*>(dt), static_cast<const float*>(A), b, c,
                       static_cast<const float*>(D), static_cast<const float*>(h0),
                       static_cast<const tc::bf16*>(dy), static_cast<const float*>(dh_fin),
                       static_cast<tc::bf16*>(dx), static_cast<float*>(ddt),
                       static_cast<float*>(dh0), S, R, decay, dB_part, dC_part, dA_part, dD_part,
                       T, H, nc, group, vec, (int)al(dy), drop_carry,
                       xs_b, xs_t, xs_h, xs_p, ds_b, ds_t, ds_h, bs_b, bs_t, bs_n, cs_b, cs_t, cs_n};
  return tc::launch(p, B, dB, dC, static_cast<float*>(dA), static_cast<float*>(dD), stream);
}
