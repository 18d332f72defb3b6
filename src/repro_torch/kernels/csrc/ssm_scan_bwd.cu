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
// The states entering each chunk are recomputed, not saved by the forward:
// a first pass walks the chunks forward (the forward's state update alone,
// a third of its products) and writes them to a float32 scratch (B, H,
// T / kQ, P, N), 42 MB at Zamba2's training shape (B 2, T 1024, H 80), for
// one layer at a time; saving them in the forward would hold 1.9 GB over
// Zamba2's 45 layers from the forward to the backward.  The second pass
// walks the chunks in reverse, carrying dh in shared memory.
//
// B and C are one group shared by all heads, and A and D are per head, so
// dB, dC, dA and dD are sums over blocks.  Each block writes its float32
// partials (dB and dC per head: 42 MB each at the training shape), and a
// second launch sums them in a fixed order and rounds dB and dC to their
// dtype: the result is the same bit for bit from run to run.
//
// Design (the first, simple one): one block of 256 threads per (head,
// batch row), as K6's FMA route; each chunk's operands staged as float32 in
// shared memory; every product float32 FMA over a 16 x 16 grid of threads,
// each holding a register tile; the row sums by shuffles within a
// half-warp, the column sums through shared memory, the cumulative sums by
// one warp, all in a fixed order.  Tensor cores are later work.
//
// Operands: x, dt, B and C are read through their strides (the model hands
// x, B and C as column views); dy, dh_fin and the outputs are contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
int launch_shape(const Params& p, int B, int P, int N, void* dB, void* dC, float* dA, float* dD,
                 void* stream) {
  if (P == 64 && N == 64) return launch<T, 64, 64>(p, B, dB, dC, dA, dD, stream);
  if (P == 128 && N == 16) return launch<T, 128, 16>(p, B, dB, dC, dA, dD, stream);
  return (int)cudaErrorInvalidValue;
}

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
