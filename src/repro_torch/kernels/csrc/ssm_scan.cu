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
// (B, H, P, N) in float32.  The exponent is formed only where s <= t, so it
// is never positive: for s > t, with A down to -16, exp(cum[t] - cum[s])
// would overflow to inf (and 0 * inf is NaN).
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
// Two routes, chosen by dtype and (P, N) alone (`ssm_scan_fwd` below and
// `scan_route` in ssm_scan.py):
//
//  * tensor cores (namespace tc): bf16 at P = N = 64, Zamba2's shape.  A
//    block of 128 threads owns one head of one batch row and walks the
//    chunks in order; warp w owns rows 16 w .. 16 w + 15 of the chunk (for
//    y) and of the state (for h).  Every product is mma.sync m16n8k16, bf16
//    in and float32 accumulate: C B^T, C h^T, G x with
//    G = L o (C B^T) o dt, and the state update (ws o x)^T B.  A block of
//    one head fits three to an SM (12 warps); a block of two heads sharing
//    C B^T fits two, and the scan is bound by latency, not by its products,
//    so it was the slower (PERF.md, section 6).  C, B and x enter
//    exactly (they are bf16); each float32 operand (h, G, ws o x) is split into a bf16 high
//    part and a bf16 low part, v = hi + lo to about 2^-16 relative, and
//    takes two products, so the scan keeps float32's accuracy where a
//    single rounding to bf16 would move the state by ~2^-9.  The state
//    stays in registers (float32, accumulator layout) and is written to
//    shared memory as its hi / lo parts once a chunk for the next chunk's
//    C h^T.  The next chunk's x, B, C and dt are staged by cp.async into a
//    second buffer while this one computes; tiles are 128-byte rows,
//    XOR-swizzled by 16-byte chunk so that ldmatrix reads no bank twice.
//    Operands whose rows are not 16-byte aligned runs (an inner stride
//    other than 1) are staged by plain loads into the same buffers.
//  * float32 FMA (the first design), for float32 and for P 128 / N 16:
//    one block of 256 threads per (head, batch row), the state in shared
//    memory, each chunk's operands staged as float32, the three products as
//    float32 FMA over a 16 x 16 grid of threads, each holding a register
//    tile.  The reference's float32 tolerance (2e-4 against a float64
//    recurrence) leaves no room for bf16 operands there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------------------- tensor-core route
namespace tc {

#include "bf16_mma.cuh"

constexpr int kP = 64, kN = 64;  // the route's (P, N); kQ steps a chunk
constexpr int kWarps = 4, kThreadsTc = 32 * kWarps;

struct Smem {
  bf16 x[2][kQ * kP];  // two stages
  bf16 b[2][kQ * kN];
  bf16 c[2][kQ * kN];
  bf16 h_hi[kP * kN];  // the state at the chunk's start, split
  bf16 h_lo[kP * kN];
  float dt[2][kQ];
  float cum[kWarps][kQ];  // each warp's own copy (no block barrier)
  float ws[kWarps][kQ];   // exp(cum[-1] - cum[s]) dt[s]
};

// 4-byte global -> shared copy; zero-fills the destination when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

// grid (H, B), 128 threads, three blocks an SM (ptxas holds a thread to 170
// registers).  vec: x, B and C rows are 16-byte aligned runs (inner stride
// 1), staged by cp.async; else by plain loads.  drop_lo: a planted fault (the
// low parts of the split operands left out; 0 in every real run).
__global__ void __launch_bounds__(kThreadsTc, 3) ssm_scan_tc(Params p, int vec, int drop_lo) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int head = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nchunks = (p.T + kQ - 1) / kQ;

  const bf16* xg = static_cast<const bf16*>(p.x);
  const bf16* xb = xg + bi * p.xs_b + head * p.xs_h;
  const bf16* bb = static_cast<const bf16*>(p.b) + bi * p.bs_b;
  const bf16* cb = static_cast<const bf16*>(p.c) + bi * p.cs_b;
  const float* dtb = p.dt + bi * p.ds_b + head * p.ds_h;

  // Stage chunk c into buffer st (rows past T as zeros): tiles x, B, C.
  auto stage = [&](int c, int st) {
    const int t0 = c * kQ, len = min(kQ, p.T - t0);
    if (vec) {
      for (int i = tid; i < 3 * kQ * 8; i += kThreadsTc) {
        const int tile = i / (kQ * 8), r = (i >> 3) % kQ, ch = i & 7;
        const long long t = t0 + r;
        const bf16* src;
        bf16* dst;
        if (tile == 0) {
          src = xb + t * p.xs_t + ch * 8;
          dst = s.x[st];
        } else if (tile == 1) {
          src = bb + t * p.bs_t + ch * 8;
          dst = s.b[st];
        } else {
          src = cb + t * p.cs_t + ch * 8;
          dst = s.c[st];
        }
        const bool ok = r < len;
        cp_async16(dst + swz(r, ch * 8), ok ? src : xg, ok);
      }
    } else {
      for (int i = tid; i < 3 * kQ * 64; i += kThreadsTc) {
        const int tile = i / (kQ * 64), r = (i >> 6) % kQ, col = i & 63;
        const long long t = t0 + r;
        const bool ok = r < len;
        bf16 v = __float2bfloat16_rn(0.f);
        bf16* dst;
        if (tile == 0) {
          if (ok) v = xb[t * p.xs_t + col * p.xs_p];
          dst = s.x[st];
        } else if (tile == 1) {
          if (ok) v = bb[t * p.bs_t + col * p.bs_n];
          dst = s.b[st];
        } else {
          if (ok) v = cb[t * p.cs_t + col * p.cs_n];
          dst = s.c[st];
        }
        dst[swz(r, col)] = v;
      }
    }
    for (int r = tid; r < kQ; r += kThreadsTc) {
      const bool ok = r < len;
      cp_async4(&s.dt[st][r], ok ? dtb + (long long)(t0 + r) * p.ds_t : p.dt, ok);
    }
  };

  // This thread's state elements: rows pr[e >> 1] (of P), columns 8 j + 2 t4 + (e & 1) (of N).
  const int pr[2] = {16 * warp + g, 16 * warp + g + 8};
  float hs[8][4];
  {
    const long long base = ((long long)bi * p.H + head) * kP * kN;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hs[j][e] = p.h0 ? p.h0[base + pr[e >> 1] * kN + 8 * j + 2 * t4 + (e & 1)] : 0.f;
  }
  auto write_state = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t hi, lo;
        split2(hs[j][2 * r], hs[j][2 * r + 1], hi, lo);
        const int off = swz(pr[r], 8 * j + 2 * t4);
        *reinterpret_cast<uint32_t*>(&s.h_hi[off]) = hi;
        *reinterpret_cast<uint32_t*>(&s.h_lo[off]) = lo;
      }
  };
  write_state();
  stage(0, 0);
  cp_async_commit();

  const long long y_row = (long long)p.H * kP;
  bf16* yb = static_cast<bf16*>(p.y) + (long long)bi * p.T * y_row + (long long)head * kP;
  const int tr[2] = {16 * warp + g, 16 * warp + g + 8};  // this thread's rows t of y

  for (int c = 0; c < nchunks; ++c) {
    const int st = c & 1, t0 = c * kQ, len = min(kQ, p.T - t0);
    cp_async_wait_all();
    __syncthreads();  // chunk c staged, the state written, buffer st ^ 1 free
    if (c + 1 < nchunks) stage(c + 1, st ^ 1);
    cp_async_commit();

    // cum (inclusive sum of A dt, in base-2 units) and ws, by every warp for
    // itself, two steps a lane.
    float* cum = s.cum[warp];
    float* ws = s.ws[warp];
    const float* dtv = s.dt[st];
    {
      const float A2 = p.A[head] * kLog2e;
      const float d0 = dtv[2 * lane], d1 = dtv[2 * lane + 1];
      const float a0 = A2 * d0, a1 = A2 * d1;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float c0 = incl - a1, tot = __shfl_sync(0xffffffffu, incl, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = incl;
      ws[2 * lane] = ex2(tot - c0) * d0;
      ws[2 * lane + 1] = ex2(tot - incl) * d1;
    }
    __syncwarp();

    // C's fragments for this warp's rows, and C B^T there (columns s <= t only).
    uint32_t cf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ld_a(cf[kk], s.c[st], 16 * warp, 16 * kk, lane);
    float cbt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) cbt[j][0] = cbt[j][1] = cbt[j][2] = cbt[j][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp > warp) break;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bf[4];
        ld_b_nk(bf, s.b[st], 16 * jp, 16 * kk, lane);
        mma(cbt[2 * jp], cf[kk], bf[0], bf[1]);
        mma(cbt[2 * jp + 1], cf[kk], bf[2], bf[3]);
      }
    }

    const float ct[2] = {cum[tr[0]], cum[tr[1]]};

    // G = L o (C B^T) o dt as split A operands over s (0 past this warp's rows)
    uint32_t ghi[4][4], glo[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      if (j <= 2 * warp + 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = tr[e >> 1], u = 8 * j + 2 * t4 + (e & 1);
          if (u <= t) gv[e] = cbt[j][e] * ex2(ct[e >> 1] - cum[u]) * dtv[u];
        }
      }
      split2(gv[0], gv[1], ghi[j >> 1][(j & 1) * 2], glo[j >> 1][(j & 1) * 2]);
      split2(gv[2], gv[3], ghi[j >> 1][(j & 1) * 2 + 1], glo[j >> 1][(j & 1) * 2 + 1]);
    }

    // y = exp(cum[t]) (C h^T) + G x + D x
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t bh[4];
        ld_b_nk(bh, s.h_hi, 16 * pp, 16 * kk, lane);
        mma(acc[2 * pp], cf[kk], bh[0], bh[1]);
        mma(acc[2 * pp + 1], cf[kk], bh[2], bh[3]);
        if (!drop_lo) {
          ld_b_nk(bh, s.h_lo, 16 * pp, 16 * kk, lane);
          mma(acc[2 * pp], cf[kk], bh[0], bh[1]);
          mma(acc[2 * pp + 1], cf[kk], bh[2], bh[3]);
        }
      }
    const float ec0 = ex2(ct[0]), ec1 = ex2(ct[1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= ec0;
      acc[j][1] *= ec0;
      acc[j][2] *= ec1;
      acc[j][3] *= ec1;
    }
    const bf16* sx = s.x[st];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) break;  // G is 0 for s > t
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t bx[4];
        ld_b_kn(bx, sx, 16 * kk, 16 * pp, lane);
        mma(acc[2 * pp], ghi[kk], bx[0], bx[1]);
        mma(acc[2 * pp + 1], ghi[kk], bx[2], bx[3]);
        if (!drop_lo) {
          mma(acc[2 * pp], glo[kk], bx[0], bx[1]);
          mma(acc[2 * pp + 1], glo[kk], bx[2], bx[3]);
        }
      }
    }
    const float Dh = p.D[head];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (tr[r] >= len) continue;
      bf16* dst = yb + (long long)(t0 + tr[r]) * y_row;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t4;
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sx + swz(tr[r], col)));
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            fmaf(Dh, xv.x, acc[j][2 * r]), fmaf(Dh, xv.y, acc[j][2 * r + 1]));
      }
    }

    // h <- exp(cum[-1]) h + (ws o x)^T B, in registers
    const float decay = ex2(cum[kQ - 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[j][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t xa[4], ahi[4], alo[4];
      ld_a_t(xa, sx, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 16 * kk + 2 * t4 + ((r >> 1) << 3);
        const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&xa[r]));
        split2(v.x * ws[k], v.y * ws[k + 1], ahi[r], alo[r]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ld_b_kn(bq, s.b[st], 16 * kk, 16 * np, lane);
        mma(hs[2 * np], ahi, bq[0], bq[1]);
        mma(hs[2 * np + 1], ahi, bq[2], bq[3]);
        if (!drop_lo) {
          mma(hs[2 * np], alo, bq[0], bq[1]);
          mma(hs[2 * np + 1], alo, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp has read this chunk's state
    write_state();
  }

  float* dst = p.h_out + ((long long)bi * p.H + head) * kP * kN;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(dst + pr[r] * kN + 8 * j + 2 * t4) =
          make_float2(hs[j][2 * r], hs[j][2 * r + 1]);
}

// x, B and C rows are 16-byte aligned runs of 64 contiguous bf16.
bool vectorizable(const Params& p) {
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  return p.xs_p == 1 && p.bs_n == 1 && p.cs_n == 1 && aligned(p.x) && aligned(p.b) &&
         aligned(p.c) && p.xs_b % 8 == 0 && p.xs_t % 8 == 0 && p.xs_h % 8 == 0 &&
         p.bs_b % 8 == 0 && p.bs_t % 8 == 0 && p.cs_b % 8 == 0 && p.cs_t % 8 == 0;
}

int launch(const Params& p, int B, int drop_lo, void* stream) {
  const int bytes = (int)sizeof(Smem);
  cudaError_t err =
      cudaFuncSetAttribute(ssm_scan_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_tc<<<dim3(p.H, B), kThreadsTc, bytes, (cudaStream_t)stream>>>(
      p, (int)vectorizable(p), drop_lo);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The FMA route: (64, 64) in float32 only (bf16 there takes the tensor cores).
template <typename T>
int launch_shape(const Params& p, int B, int P, int N, void* stream) {
  if constexpr (std::is_same_v<T, float>) {
    if (P == 64 && N == 64) return launch<T, 64, 64>(p, B, stream);
  }
  if (P == 128 && N == 16) return launch<T, 128, 16>(p, B, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, T, H, P) and b, c (B, T, N): bf16 (is_bf16 nonzero) or float32, any
// strides (in elements); dt (B, T, H) float32, any strides; A, D (H,) and
// h0 (B, H, P, N, or null) contiguous float32; y (B, T, H, P) contiguous in
// x's type; h_out (B, H, P, N) contiguous float32.  (P, N) is (64, 64) or
// (128, 16).  bf16 at (64, 64) takes the tensor-core route, everything
// else the float32 FMA route.  drop_lo: 0 (a planted fault: the
// tensor-core route leaves out the low parts of its split operands).
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* A, const void* b,
                            const void* c, const void* D, const void* h0, void* y, void* h_out,
                            int is_bf16, int B, int T, int H, int P, int N,
                            long long xs_b, long long xs_t, long long xs_h, long long xs_p,
                            long long ds_b, long long ds_t, long long ds_h,
                            long long bs_b, long long bs_t, long long bs_n,
                            long long cs_b, long long cs_t, long long cs_n, int drop_lo,
                            void* stream) {
  if (B == 0 || H == 0) return 0;
  const Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), b, c,
                 static_cast<const float*>(D), static_cast<const float*>(h0), y,
                 static_cast<float*>(h_out), T, H,
                 xs_b, xs_t, xs_h, xs_p, ds_b, ds_t, ds_h, bs_b, bs_t, bs_n, cs_b, cs_t, cs_n};
  if (is_bf16 && P == tc::kP && N == tc::kN) return tc::launch(p, B, drop_lo, stream);
  return is_bf16 ? launch_shape<__nv_bfloat16>(p, B, P, N, stream)
                 : launch_shape<float>(p, B, P, N, stream);
}
