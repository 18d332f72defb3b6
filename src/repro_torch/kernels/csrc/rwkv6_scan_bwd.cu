// RWKV-6 WKV recurrence, backward (K7b), written for Hopper (sm_90a).
//
// The reference has no TPU kernel for it: its gradient is autodiff through
// the oracle's lax.scan, src/repro/kernels/ref.py:58 (what
// repro.kernels.ops.rwkv6_scan runs off the TPU).  For K7's function
//
//     y_t = (S_{t-1} + u o (k_t v_t^T))^T r_t,   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// and the cotangents dy (B, T, H, V) and dS_T (of the final state), with G_t
// the cotangent of S_t (G_{t-1} = diag(w_t) G_t + r_t dy_t^T), it computes
// per (b, h):
//
//     dr_t = S_{t-1} dy_t + u o k_t (v_t . dy_t)
//     dk_t = G_t v_t + u o r_t (v_t . dy_t)
//     dv_t = G_t^T k_t + (sum_k r_t u k_t) dy_t
//     dw_t = rowsum(G_t o S_{t-1})
//     du   = sum_t r_t o k_t (v_t . dy_t)
//
// and dS_0 = G_0, the cotangent of state0.  Every element of S and G is its
// own scalar recurrence (row k decays by w[k]), so dr, dk and dw are sums
// along a row and dv a sum along a column.
//
// What bounds it on this card: float32 operations, 14 B T H K^2 (0.056 ms at
// rwkv6-1.6b's training shape B 2, T 1024, H 32, K 64, on the 67 TFLOP/s
// CUDA cores), against 38 MB of operands.
//
// Design: chunks of kC = 32 steps in parallel.  The state and its cotangent
// are linear in what enters a chunk:
//
//     S leaving chunk c  = diag(W_c) S entering it + dS_c,  dS_c = chunk from S = 0
//     G entering chunk c = diag(W_c) G leaving it  + dG_c,  dG_c = chunk from G = 0
//     W_c = prod_{t in c} w_t
//
// (suffix and prefix products: nothing is divided by w, which can be ~0).
// Four launches a call:
//
//  1. chunk_increments: every (b, h, chunk) in parallel runs the chunk from
//     zero forward (dS_c) and in reverse (dG_c), a thread 4 rows x 8 columns
//     of K x K; W_c; and each step's v . dy and sum_k r u k and each row's
//     partial of du, which the body reads.
//  2. combine: float32 passes over the chunks, a (b, h) and four elements
//     of K x K a thread: forward, S entering every chunk (written over
//     dS_c); in reverse, G leaving every chunk (over dG_c, from dS_T), and
//     dS_0.
//  3. body: every (b, h, chunk, row group) in parallel.  A cluster of K / R
//     blocks splits the chunk's K rows into groups of R = 16 (rows are
//     independent, so dr, dk and dw stay in the block; dv, a column sum, is
//     added across the cluster through distributed shared memory in rank
//     order).  A thread holds 2 rows x K / 16 columns of S and G.  A forward
//     pass keeps S at the start of each kL = 8-step sub-tile (shared
//     memory, each thread its own); then the sub-tiles in reverse: its 8
//     states recomputed into registers (writing dr), then the 8 steps swept
//     back from G (dk, dw from S_{t-1} itself, dv).  A row's sums are
//     gathered over kH = 4 steps and the thread's 2 rows and reduced across
//     the row pair's 16 lanes in one reduce-scatter (8 shuffles for 8
//     sums), so no step waits on a reduction.
//  4. du_reduce: du's chunk partials summed over batch rows and chunks in a
//     fixed order.
//
// Shared memory, not arithmetic, bounds the body: a step's v, dy and row
// scalars are read from it by every thread that holds their columns or rows.
//
// Every sum runs in a fixed order and nothing is atomic: two launches give
// the same bits.  All arithmetic is float32; bf16 and float32 differ in the
// loads and the rounding of the outputs alone.  Scratch (float32): dS_c and
// dG_c (B, H, nc, K, K) each, W_c and du's partials (B, H, nc, K) each, the
// step sums (B, H, nc, 2, kC): 68.7 MB at rwkv6-1.6b's training shape.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kC = 32;  // chunk steps (rwkv6_scan.K7_CHUNK)
constexpr int kL = 8;   // steps a body sub-tile
constexpr int kH = 4;   // steps a row's sums are gathered over before one reduce-scatter

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  const float* s0;      // nullptr: the state starts at 0
  const void* dy;       // (B, T, H, V) contiguous, r's type
  const float* ds_fin;  // nullptr: no cotangent on the final state
  void* dr;             // (B, T, H, K) contiguous, r's type; dk, dv, dw likewise
  void* dk;
  void* dv;
  void* dw;
  float* ds0;    // nullptr: not wanted
  float* sx;     // (B, H, nc, K, K): dS_c, then S entering chunk c
  float* gx;     // (B, H, nc, K, K): dG_c, then G leaving chunk c
  float* wc;     // (B, H, nc, K): W_c
  float* dup;    // (B, H, nc, K): du's chunk partials
  float* vr;     // (B, H, nc, 2, kC): v . dy and sum_k r u k of every step
  int T, H, nc, drop_carry, dw_fault;
  // b, t, h strides in elements; every row contiguous and 16-byte aligned
  long long rs_b, rs_t, rs_h, ks_b, ks_t, ks_h, vs_b, vs_t, vs_h, ws_b, ws_t, ws_h;
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

// The block layout at head size K.  A row group of R rows is a block; a
// thread holds rows 2 p and 2 p + 1 of its warp's and the CL columns
// q + LQ j of them (q = lane % LQ): LQ lanes share a row pair.
template <int K>
struct BodyCfg {
  static constexpr int LQ = K < 16 ? K : 16;   // lanes a row pair
  static constexpr int CL = K / LQ;            // columns a thread
  static constexpr int RW = 2 * (32 / LQ);     // rows a warp
  static constexpr int R = K < 16 ? K : 16;    // rows a block
  static constexpr int WARPS = R / RW;
  static constexpr int NT = 32 * WARPS;
  static constexpr int CS = K / R;             // blocks a cluster: the row groups
  static constexpr int NS = kC / kL;           // sub-tiles a chunk
  static_assert(kL % kH == 0, "whole groups of steps a sub-tile");
  static_assert(R % RW == 0, "whole warps");
};

// The increments' layout: a block holds all K rows (they need no sum
// across rows), a thread RT rows x CT columns q + 8 j (q = lane % 8), so
// each staged v, dy and row scalar serves more elements than in the body.
template <int K>
struct IncCfg {
  static constexpr int LQ = K < 8 ? K : 8;     // lanes a row group
  static constexpr int CT = K / LQ;            // columns a thread
  static constexpr int RT = K < 16 ? 1 : K / 16;  // rows a thread
  static constexpr int NT = LQ * K / RT;       // threads a block
  static_assert(NT % 32 == 0, "whole warps");
};

// Where column c of v or dy sits in a staged row: the CL = K / LQ columns
// q + LQ j of a thread side by side, so it reads them in one vector load.
template <int K, int LQ>
__device__ __forceinline__ int cpos(int c) {
  return (c % LQ) * (K / LQ) + c / LQ;
}

// A chunk's operands in shared memory as float32, steps past T as the
// identity (w = 1, the rest 0): r, k, w of the block's R rows; v and dy of
// all K columns (at cpos).  A row's scalars are read one word at a time: a
// warp needs four rows' worth, and a 16-byte load costs a shared-memory
// pass for every eight lanes however few addresses they share.
template <int K, int R>
struct Stage {
  float r[kC][R], k[kC][R], w[kC][R];
  float v[kC][K], dy[kC][K];
};

// This thread's CL columns of a staged row (`row` points at column q's).
template <int CL>
__device__ __forceinline__ void cols(const float* row, float (&out)[CL]) {
  if constexpr (CL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CL / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(row)[i];
      out[4 * i] = a.x, out[4 * i + 1] = a.y, out[4 * i + 2] = a.z, out[4 * i + 3] = a.w;
    }
  } else if constexpr (CL == 2) {
    const float2 a = *reinterpret_cast<const float2*>(row);
    out[0] = a.x, out[1] = a.y;
  } else {
    static_assert(CL == 1, "1, 2 or a multiple of 4 columns");
    out[0] = row[0];
  }
}

// 16 bytes of T as float32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&out)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else {
    out[0] = __uint_as_float(u.x), out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z), out[3] = __uint_as_float(u.w);
  }
}

// Every load is issued before the first store, so a block waits for one
// round trip to memory, not one per element it stages; a load is 16 bytes.
template <typename T, int K, int R, int NT, int LQ>
__device__ void stage(Stage<K, R>& s, const Params& p, int bi, int h, int t0, int row0) {
  const T* r = static_cast<const T*>(p.r) + bi * p.rs_b + h * p.rs_h;
  const T* k = static_cast<const T*>(p.k) + bi * p.ks_b + h * p.ks_h;
  const T* v = static_cast<const T*>(p.v) + bi * p.vs_b + h * p.vs_h;
  const T* w = static_cast<const T*>(p.w) + bi * p.ws_b + h * p.ws_h;
  const T* dy = static_cast<const T*>(p.dy) + ((long long)bi * p.T * p.H + h) * K;
  const long long dy_row = (long long)p.H * K;
  constexpr int EV = 16 / sizeof(T), RV = R / EV, KV = K / EV;  // elements, vectors a row
  constexpr int NR = (kC * RV + NT - 1) / NT, NV = (kC * KV + NT - 1) / NT;
  static_assert(R % EV == 0 && K % EV == 0, "whole vectors a row");
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 lr[NR], lk[NR], lw[NR], lv[NV], ld[NV];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    const int i = threadIdx.x + n * NT, t = i / RV, c = row0 + (i % RV) * EV, tt = t0 + t;
    const bool in = i < kC * RV && tt < p.T;
    lr[n] = in ? *reinterpret_cast<const uint4*>(r + tt * p.rs_t + c) : zero;
    lk[n] = in ? *reinterpret_cast<const uint4*>(k + tt * p.ks_t + c) : zero;
    lw[n] = in ? *reinterpret_cast<const uint4*>(w + tt * p.ws_t + c) : zero;
  }
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int i = threadIdx.x + n * NT, t = i / KV, c = (i % KV) * EV, tt = t0 + t;
    const bool in = i < kC * KV && tt < p.T;
    lv[n] = in ? *reinterpret_cast<const uint4*>(v + tt * p.vs_t + c) : zero;
    ld[n] = in ? *reinterpret_cast<const uint4*>(dy + tt * dy_row + c) : zero;
  }
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    const int i = threadIdx.x + n * NT, t = i / RV, c = (i % RV) * EV;
    if (i >= kC * RV) continue;
    float fr[EV], fk[EV], fw[EV];
    unpack<T>(lr[n], fr);
    unpack<T>(lk[n], fk);
    unpack<T>(lw[n], fw);
    const bool in = t0 + t < p.T;
#pragma unroll
    for (int e = 0; e < EV; ++e) {
      s.r[t][c + e] = fr[e];
      s.k[t][c + e] = fk[e];
      s.w[t][c + e] = in ? fw[e] : 1.f;
    }
  }
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int i = threadIdx.x + n * NT, t = i / KV, c = (i % KV) * EV;
    if (i >= kC * KV) continue;
    float fv[EV], fd[EV];
    unpack<T>(lv[n], fv);
    unpack<T>(ld[n], fd);
#pragma unroll
    for (int e = 0; e < EV; ++e) {
      s.v[t][cpos<K, LQ>(c + e)] = fv[e];
      s.dy[t][cpos<K, LQ>(c + e)] = fd[e];
    }
  }
}

// Block (chunk c, row group g) of head h, batch row bi: grid (CS nc, H, B).
struct Where {
  int c, g, h, bi, t0, row0;
  long long bhc;  // (bi H + h) nc + c
};
template <int K>
__device__ __forceinline__ Where where(const Params& p) {
  Where x;
  x.c = blockIdx.x / BodyCfg<K>::CS;
  x.g = blockIdx.x % BodyCfg<K>::CS;
  x.h = blockIdx.y;
  x.bi = blockIdx.z;
  x.t0 = x.c * kC;
  x.row0 = x.g * BodyCfg<K>::R;
  x.bhc = ((long long)x.bi * p.H + x.h) * p.nc + x.c;
  return x;
}

// ------------------------------------------------- 1. chunk increments
// Also, for the body: v . dy and sum_k r u k of every step, and du's
// partial of every row over the chunk.
template <typename T, int K>
__global__ void __launch_bounds__(IncCfg<K>::NT) chunk_increments(Params p) {
  using C = IncCfg<K>;
  constexpr int CT = C::CT, LQ = C::LQ, RT = C::RT, NT = C::NT;
  __shared__ Stage<K, K> s;
  __shared__ float su[K], vdy[kC];
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const long long bhc = ((long long)bi * p.H + h) * p.nc + c;
  stage<T, K, K, NT, LQ>(s, p, bi, h, c * kC, 0);
  if (threadIdx.x < K) su[threadIdx.x] = p.u[h * K + threadIdx.x];
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, q = tid % LQ;
  const int r0 = (tid / LQ) * RT;  // the thread's first row
  for (int t = warp; t < kC; t += NT / 32) {  // a warp a step, fixed order
    float a = 0.f, b = 0.f;
    for (int i = lane; i < K; i += 32) {
      a = fmaf(s.v[t][i], s.dy[t][i], a);
      b = fmaf(s.r[t][i] * su[i], s.k[t][i], b);
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, m);
      b += __shfl_xor_sync(0xffffffffu, b, m);
    }
    if (lane == 0) {
      vdy[t] = a;
      p.vr[bhc * 2 * kC + t] = a;
      p.vr[bhc * 2 * kC + kC + t] = b;
    }
  }
  float d[RT][CT], wp[RT];
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    wp[a] = 1.f;
#pragma unroll
    for (int j = 0; j < CT; ++j) d[a][j] = 0.f;
  }
#pragma unroll 4
  for (int t = 0; t < kC; ++t) {
    float vv[CT];
    cols<CT>(&s.v[t][q * CT], vv);
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      const float ww = s.w[t][r0 + a], kk = s.k[t][r0 + a];
#pragma unroll
      for (int j = 0; j < CT; ++j) d[a][j] = fmaf(ww, d[a][j], kk * vv[j]);
      wp[a] *= ww;
    }
  }
  float* sx = p.sx + bhc * K * K;
#pragma unroll
  for (int a = 0; a < RT; ++a) {
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      sx[(r0 + a) * K + q + LQ * j] = d[a][j];
      d[a][j] = 0.f;
    }
    if (q == 0) p.wc[bhc * K + r0 + a] = wp[a];
  }
#pragma unroll 4
  for (int t = kC - 1; t >= 0; --t) {
    float dyv[CT];
    cols<CT>(&s.dy[t][q * CT], dyv);
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      const float ww = s.w[t][r0 + a], rr = s.r[t][r0 + a];
#pragma unroll
      for (int j = 0; j < CT; ++j) d[a][j] = fmaf(ww, d[a][j], rr * dyv[j]);
    }
  }
  float* gx = p.gx + bhc * K * K;
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int j = 0; j < CT; ++j) gx[(r0 + a) * K + q + LQ * j] = d[a][j];
  __syncthreads();  // vdy
  if (tid < K) {  // du's partial of row tid over the chunk
    float a = 0.f;
    for (int t = 0; t < kC; ++t) a = fmaf(s.r[t][tid] * s.k[t][tid], vdy[t], a);
    p.dup[bhc * K + tid] = a;
  }
}

// ----------------------------------------------------------- 2. combine
// One thread a (b, h), four consecutive elements of one row and one of the
// two passes: the state forward over the chunks (the first half of the
// threads), its cotangent in reverse (the second half).  The chunks'
// increments are read eight ahead (they do not depend on the carry).
template <int K>
__global__ void __launch_bounds__(256) combine(Params p, int bh_count) {
  constexpr int KK = K * K, QUADS = KK / 4, kAhead = 8;
  const long long total = (long long)bh_count * QUADS;
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= 2 * total) return;
  const bool back = n >= total;  // the cotangent's pass
  n -= back ? total : 0;
  const long long bh = n / QUADS;
  const int e = (int)(n % QUADS) * 4, row = e / K, nc = p.nc;
  float* x = (back ? p.gx : p.sx) + bh * nc * KK + e;
  const float* w = p.wc + bh * nc * K + row;
  const float* start = back ? p.ds_fin : p.s0;
  float4 c = start ? *reinterpret_cast<const float4*>(start + bh * KK + e) : make_float4(0, 0, 0, 0);
  for (int i0 = 0; i0 < nc; i0 += kAhead) {
    float4 d[kAhead];
    float wv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (i0 + i < nc) {
        const int ci = back ? nc - 1 - i0 - i : i0 + i;
        d[i] = *reinterpret_cast<const float4*>(x + ci * KK);
        wv[i] = w[ci * K];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (i0 + i < nc) {
        const int ci = back ? nc - 1 - i0 - i : i0 + i;
        *reinterpret_cast<float4*>(x + ci * KK) = c;  // what enters (S) or leaves (G) chunk ci
        if (p.drop_carry) {  // a planted fault: the next chunk is given nothing
          c = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          c.x = fmaf(wv[i], c.x, d[i].x);
          c.y = fmaf(wv[i], c.y, d[i].y);
          c.z = fmaf(wv[i], c.z, d[i].z);
          c.w = fmaf(wv[i], c.w, d[i].w);
        }
      }
  }
  if (back && p.ds0) *reinterpret_cast<float4*>(p.ds0 + bh * KK + e) = c;
}

// -------------------------------------------------------------- 3. body
// v[N] summed over the M lanes lane ^ 1 .. lane ^ M / 2 and scattered: each
// lane keeps max(N / M, 1) of the sums (index bits from the highest mask
// down), in v[0 ..); with fewer sums than lanes, the last masks add without
// scattering, so lanes that differ only there hold the same sum.  Fixed
// order: the same bits every run.
template <int N, int M>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (M > 1) {
    if constexpr (N >= 2) {
      constexpr int H = N / 2;
      const bool up = lane & (M / 2);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M / 2);
      }
      reduce_scatter<H, M / 2>(reinterpret_cast<float(&)[H]>(v), lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M / 2);
      reduce_scatter<1, M / 2>(v, lane);
    }
  }
}
// The index (into the N sums) of v[0] after reduce_scatter<N, M>, and
// whether this lane is the one of its duplicates that writes it.
template <int N, int M>
__device__ __forceinline__ int scatter_index(int lane, bool& owner) {
  int idx = 0;
  owner = true;
#pragma unroll
  for (int m = M / 2, n = N; m >= 1; m >>= 1, n >>= 1) {
    if (n >= 2 && (lane & m)) idx += n / 2;
    if (n < 2 && (lane & m)) owner = false;
  }
  return idx;
}

template <int K>
struct BodySmem {
  Stage<K, BodyCfg<K>::R> s;
  float u[BodyCfg<K>::R];
  float vdy[kC], ruk[kC];                 // v . dy; sum of r u k over all K rows
  float dvw[BodyCfg<K>::WARPS][kL][K];        // a sub-tile's dv, each warp's rows
  float dv[kC][K];                        // the group's dv (before the cluster's sum)
  float ck[BodyCfg<K>::NS - 1][2 * BodyCfg<K>::CL][BodyCfg<K>::NT];  // S at sub-tiles 1 .., each thread's own
};

// DWF: the planted fault, dw reading S_t for S_{t-1} (false in real runs).
template <typename T, int K, bool DWF>
__global__ void __launch_bounds__(BodyCfg<K>::NT, 4) body(Params p) {
  using C = BodyCfg<K>;
  constexpr int CL = C::CL, LQ = C::LQ, R = C::R, NS = C::NS;
  constexpr int NSUM = 2 * kH;  // a row pair's sums of kH steps: 2 rows x kH steps
  extern __shared__ __align__(16) unsigned char body_smem[];
  BodySmem<K>& sm = *reinterpret_cast<BodySmem<K>*>(body_smem);
  Stage<K, R>& s = sm.s;
  const Where x = where<K>(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, q = lane % LQ;
  const int rl = warp * C::RW + 2 * (lane / LQ);
  const int len = min(kC, p.T - x.t0);

  // S entering the chunk, G leaving it (the combine's), loaded under the staging
  float S[2][CL], G[2][CL];
  const float* sx = p.sx + x.bhc * K * K;
  const float* gx = p.gx + x.bhc * K * K;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < CL; ++j) {
      S[a][j] = sx[(x.row0 + rl + a) * K + q + LQ * j];
      G[a][j] = gx[(x.row0 + rl + a) * K + q + LQ * j];
    }
  stage<T, K, R, C::NT, LQ>(s, p, x.bi, x.h, x.t0, x.row0);
  if (tid < R) sm.u[tid] = p.u[x.h * K + x.row0 + tid];
  for (int i = tid; i < 2 * kC; i += C::NT)  // the increments' v . dy and r u k a step
    (i < kC ? sm.vdy[i] : sm.ruk[i - kC]) = p.vr[x.bhc * 2 * kC + i];
  __syncthreads();

  auto advance = [&](float (&st)[2][CL], int t) {
    float vv[CL];
    cols<CL>(&s.v[t][q * CL], vv);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float ww = s.w[t][rl + a], kk = s.k[t][rl + a];
#pragma unroll
      for (int j = 0; j < CL; ++j) st[a][j] = fmaf(ww, st[a][j], kk * vv[j]);
    }
  };
  // the forward pass: S at the start of sub-tiles 1 .. NS - 1
  for (int st = 1; st < NS; ++st) {
#pragma unroll
    for (int l = 0; l < kL; ++l) advance(S, (st - 1) * kL + l);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < CL; ++j) sm.ck[st - 1][a * CL + j][tid] = S[a][j];
  }

  bool owner;
  const int my = scatter_index<NSUM, LQ>(lane, owner);  // this lane's sum: (row my / kH, step my % kH)
  const long long out_row = (long long)p.H * K;
  const long long base = ((long long)x.bi * p.T + x.t0) * out_row + (long long)x.h * K + x.row0;
  T* const dr = static_cast<T*>(p.dr) + base;
  T* const dk = static_cast<T*>(p.dk) + base;
  T* const dw = static_cast<T*>(p.dw) + base;
  const int my_row = rl + my / kH, my_step = my % kH;
  for (int st = NS - 1; st >= 0; --st) {
    const int tb = st * kL;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < CL; ++j)
        S[a][j] = st == 0 ? sx[(x.row0 + rl + a) * K + q + LQ * j] : sm.ck[st - 1][a * CL + j][tid];
    // the sub-tile's states S_{t-1} recomputed, and dr
    float Sp[kL][2][CL];
#pragma unroll
    for (int hh = 0; hh < kL / kH; ++hh) {
      float sums[NSUM];
#pragma unroll
      for (int l = hh * kH; l < (hh + 1) * kH; ++l) {
        const int t = tb + l;
        float dyv[CL];
        cols<CL>(&s.dy[t][q * CL], dyv);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < CL; ++j) {
            Sp[l][a][j] = S[a][j];
            part = fmaf(S[a][j], dyv[j], part);
          }
          sums[a * kH + l - hh * kH] = part;
        }
        advance(S, t);
      }
      reduce_scatter<NSUM, LQ>(sums, lane);
      const int t = tb + hh * kH + my_step;
      if (owner && t < len)
        dr[t * out_row + my_row] =
            from_f32<T>(fmaf(sm.u[my_row] * s.k[t][my_row], sm.vdy[t], sums[0]));
    }
    // the sweep back: dk, dw (row sums) and dv (column sums)
#pragma unroll
    for (int hh = kL / kH - 1; hh >= 0; --hh) {
      float dks[NSUM], dws[NSUM];
#pragma unroll
      for (int l = (hh + 1) * kH - 1; l >= hh * kH; --l) {
        const int t = tb + l;
        float vv[CL], dyv[CL], dvp[CL];
        cols<CL>(&s.v[t][q * CL], vv);
        cols<CL>(&s.dy[t][q * CL], dyv);
#pragma unroll
        for (int j = 0; j < CL; ++j) dvp[j] = 0.f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float rr = s.r[t][rl + a], kk = s.k[t][rl + a], ww = s.w[t][rl + a];
          float pk = 0.f, pw = 0.f;
#pragma unroll
          for (int j = 0; j < CL; ++j) {
            const float sp = DWF ? fmaf(ww, Sp[l][a][j], kk * vv[j]) : Sp[l][a][j];
            pw = fmaf(G[a][j], sp, pw);
            pk = fmaf(G[a][j], vv[j], pk);
            dvp[j] = fmaf(G[a][j], kk, dvp[j]);
            G[a][j] = fmaf(ww, G[a][j], rr * dyv[j]);
          }
          dks[a * kH + l - hh * kH] = pk;
          dws[a * kH + l - hh * kH] = pw;
        }
        // dv: this warp's rows summed over its row pairs (lanes q, q + LQ,
        // ...); with two row pairs and two or more columns, scattered over both
        if constexpr (LQ == 16 && CL >= 2) {
          const bool up = lane & 16;
#pragma unroll
          for (int j = 0; j < CL / 2; ++j) {
            const float send = up ? dvp[j] : dvp[j + CL / 2];
            const float keep = up ? dvp[j + CL / 2] : dvp[j];
            sm.dvw[warp][l][q + LQ * (j + (up ? CL / 2 : 0))] =
                keep + __shfl_xor_sync(0xffffffffu, send, 16);
          }
        } else {
#pragma unroll
          for (int m = 16; m >= LQ; m >>= 1)
#pragma unroll
            for (int j = 0; j < CL; ++j) dvp[j] += __shfl_xor_sync(0xffffffffu, dvp[j], m);
          if (lane < LQ) {
#pragma unroll
            for (int j = 0; j < CL; ++j) sm.dvw[warp][l][q + LQ * j] = dvp[j];
          }
        }
      }
      reduce_scatter<NSUM, LQ>(dks, lane);
      reduce_scatter<NSUM, LQ>(dws, lane);
      const int t = tb + hh * kH + my_step;
      if (owner && t < len) {
        dk[t * out_row + my_row] =
            from_f32<T>(fmaf(sm.u[my_row] * s.r[t][my_row], sm.vdy[t], dks[0]));
        dw[t * out_row + my_row] = from_f32<T>(dws[0]);
      }
    }
    __syncthreads();  // the warps' dv of this sub-tile
    for (int i = tid; i < kL * K; i += C::NT) {
      const int l = i / K, c = i % K;
      float a = 0.f;
#pragma unroll
      for (int wi = 0; wi < C::WARPS; ++wi) a += sm.dvw[wi][l][c];
      sm.dv[tb + l][c] = a;
    }
    __syncthreads();
  }

  // dv: rank g sums its R columns over the cluster's row groups, in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  T* const dv = static_cast<T*>(p.dv) + base - x.row0;
  for (int i = tid; i < len * R; i += C::NT) {
    const int t = i / R, col = x.row0 + i % R;
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < C::CS; ++g) a += cluster.map_shared_rank(&sm, g)->dv[t][col];
    dv[t * out_row + col] = from_f32<T>(fmaf(sm.ruk[t], s.dy[t][cpos<K, LQ>(col)], a));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// --------------------------------------------------------- 4. du_reduce
// du (H, K): the chunk partials summed over batch rows, then chunks, in order.
__global__ void du_reduce(const float* dup, float* du, int B, int H, int K, int nc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * K) return;
  const int h = i / K, c = i % K;
  float acc = 0.f;
  for (int bi = 0; bi < B; ++bi)
    for (int ci = 0; ci < nc; ++ci) acc += dup[(((long long)bi * H + h) * nc + ci) * K + c];
  du[i] = acc;
}

template <typename T, int K>
int launch(const Params& p, int B, float* du, cudaStream_t s) {
  using C = BodyCfg<K>;
  const dim3 grid((unsigned)(C::CS * p.nc), (unsigned)p.H, (unsigned)B);
  chunk_increments<T, K><<<dim3((unsigned)p.nc, (unsigned)p.H, (unsigned)B), IncCfg<K>::NT, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long threads = 2LL * B * p.H * K * K / 4;
  combine<K><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(p, B * p.H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = (int)sizeof(BodySmem<K>);
  auto kernel = p.dw_fault ? body<T, K, true> : body<T, K, false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  du_reduce<<<(p.H * K + 255) / 256, 256, 0, s>>>(p.dup, du, B, p.H, K, p.nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shape(const Params& p, int B, int K, float* du, cudaStream_t s) {
  switch (K) {
    case 8: return launch<T, 8>(p, B, du, s);
    case 16: return launch<T, 16>(p, B, du, s);
    case 32: return launch<T, 32>(p, B, du, s);
    case 64: return launch<T, 64>(p, B, du, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w (B, T, H, K), K = V in {8, 16, 32, 64}, bf16 (dims[0] nonzero)
// or float32, rows contiguous and 16-byte aligned (dims[5..20]: r's, k's,
// v's and w's b, t, h, k strides in elements, every k stride 1, every other
// a multiple of 16 bytes); u (H, K) and s0 (B, H, K, K, or null) contiguous
// float32; dy (B, T, H, K) contiguous in r's type; ds_fin (B, H, K, K, or
// null) contiguous float32.  Outputs, all contiguous: dr, dk, dv, dw (B, T,
// H, K) in r's type, du (H, K) float32, ds0 (B, H, K, K, or null) float32.
// scratch: float32, 2 B H nc (K K + K + 32) elements, nc = ceil(T / 32).  dims:
// is_bf16, B, T, H, K, the 16 strides, then drop_carry (0; a planted fault:
// the combine leaves out what enters each chunk), dw_fault (0; a planted
// fault: dw reads S_t for S_{t-1}).
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, const void* dy, const void* ds_fin,
                              void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
                              void* scratch, const long long* dims, void* stream) {
  const int is_bf16 = (int)dims[0], B = (int)dims[1], T = (int)dims[2], H = (int)dims[3],
            K = (int)dims[4];
  if (B == 0 || H == 0 || T == 0) return 0;
  const long long* st = dims + 5;
  const int nc = (T + kC - 1) / kC;
  const long long bhc = (long long)B * H * nc, KK = (long long)K * K;
  float* sx = static_cast<float*>(scratch);
  float* gx = sx + bhc * KK;
  float* wc = gx + bhc * KK;
  float* dup = wc + bhc * K;
  float* vr = dup + bhc * K;
  const Params p{r, k, v, w, static_cast<const float*>(u), static_cast<const float*>(s0), dy,
                 static_cast<const float*>(ds_fin), dr, dk, dv, dw, static_cast<float*>(ds0),
                 sx, gx, wc, dup, vr, T, H, nc, (int)dims[21], (int)dims[22],
                 st[0], st[1], st[2], st[4], st[5], st[6], st[8], st[9], st[10],
                 st[12], st[13], st[14]};
  float* duf = static_cast<float*>(du);
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_shape<__nv_bfloat16>(p, B, K, duf, s)
                 : launch_shape<float>(p, B, K, duf, s);
}
