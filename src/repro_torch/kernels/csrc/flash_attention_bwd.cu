// Flash attention backward (causal, sliding-window or non-causal GQA),
// written for Hopper (sm_90a).
//
// The reference has no TPU kernel for it: its gradient is the jnp custom_vjp
// _ca_bwd (src/repro/kernels/ops.py:105), which scans key chunks and
// recomputes each score block from the forward's saved log-sum-exp, never
// building an (S, S) tensor.  This computes the same:
//
//     delta_i = rowsum(dO_i * O_i)                       (float32)
//     P_ij    = exp(scale * q_i . k_j - lse_i), 0 where masked
//     dV_j    = sum_i P_ij dO_i
//     dS_ij   = P_ij (dO_i . v_j - delta_i)
//     dK_j    = scale * sum_i dS_ij q_i
//     dQ_i    = scale * sum_j dS_ij k_j
//
// for q (B, Sq, H, Dh), k, v (B, Skv, KVH, Dh), with query head h reading kv
// head h / G, and the forward's masks by absolute position: key j < Skv,
// j <= i + q_offset when causal, i + q_offset - j < window when one is given.
// P is masked by position, so a row with no allowed key (whose lse the
// forward leaves as a sentinel) contributes nothing and gets dQ = 0.  dK and
// dV sum over the G query heads of their kv head.  Outputs have the inputs'
// type; every sum is float32.
//
// What bounds it on this card: operations.  At the training shape (bf16,
// B 2, S 1024, 12/2 heads, Dh 128, causal: 524,800 (i, j) pairs a head) the
// five products of the backward are 10 B H pairs Dh = 16.1 GFLOP, 16 us at
// the 989 TFLOP/s bf16 tensor-core peak, against 19 MB of operands.
//
// At Zamba2's training shape (bf16, B 2, S 1024, 32/32 heads, Dh 80,
// causal) the five products are 26.9 GFLOP, 27 us at the bf16 peak.
//
// Two routes, chosen by dtype and group alone (`backward_route` in
// flash_attention.py): bf16 with G <= 8 takes the wgmma + TMA kernel
// (namespace wg, below), which forms the five products of FA2's backward in
// one kernel, three launches a call (a prologue, the kernel, a dQ
// epilogue); at Dh 64 and 128 its tiles are boxes of 64 columns with the
// 128-byte swizzle, at Dh 80 (whose 160-byte rows are not whole 128-byte
// boxes) five boxes of 16 columns with the 32-byte swizzle.  bf16 with
// G > 8 (more than a portable cluster) and float32 take the first design:
// FA2's deterministic pair of kernels, with no atomics, between a row-sum
// launch before and a group reduction after (four launches a call).
//
//  1. bwd_delta: one warp per (b, i, h) row computes delta.
//  2. bwd_dkdv: one block per (key tile, query head, batch).  The block keeps
//     its K and V tile in shared memory and loops over the query tiles the
//     mask lets through (cp.async, two stages), accumulating that query
//     head's dK and dV in registers.  S^T = K Q^T and dP^T = V dO^T give P^T
//     and dS^T in the accumulator layout; they are re-packed in registers
//     into the A operand of dV += P^T dO and dK += dS^T Q.  Each query head
//     writes its own float32 partial, so the grid has B H key tiles (384 at
//     the training shape) rather than B KVH (64 on 132 SMs).
//  3. bwd_dq: one block per (query tile, query head, batch) loops over the
//     allowed key tiles: S = Q K^T, dP = dO V^T, dQ += dS K.
//  4. bwd_group_sum: dK (times scale) and dV of each kv head as the sum of
//     its G query heads' partials, rounded to the output type.
//
//  * bf16: tensor-core mma.sync m16n8k16 (bf16 in, float32 accumulate), each
//    warp owning 16 rows (keys in bwd_dkdv, queries in bwd_dq); P and dS are
//    rounded to bf16 as the operands of the second products, as FA2 does.
//  * float32: the reference's f32 gradient tolerance rules out TF32, so it
//    runs on the CUDA cores: 4 threads a row of a 32-row tile, operands and
//    P / dS in shared memory (rows padded against bank conflicts), FMA.
//
// Recomputing S and dP in both kernels costs 7 products instead of FA2's 5
// with atomics; the wgmma route forms 5.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  void* dq;
  void* dk;
  void* dv;
  float* delta;  // (B, H, Sq)
  float* dk_h;   // (B, Skv, H, Dh): each query head's dK, before the scale
  float* dv_h;   // (B, Skv, H, Dh)
  int B, Sq, Skv, H, KVH, G;
  int q_offset, causal, window;  // window 0: none
  int skip_keys;                 // keys below this are treated as masked (0 in real runs)
  float scale;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ bool allowed(const Params& p, int qpos, int kpos) {
  return kpos < p.Skv && kpos >= p.skip_keys && (!p.causal || qpos >= kpos) &&
         (p.window == 0 || qpos - kpos < p.window);
}

// Key tiles [lo, hi] that query rows at absolute positions [first, last] can see.
__device__ __forceinline__ void key_tiles(const Params& p, int first, int last, int bk,
                                          int& lo, int& hi) {
  hi = (p.Skv + bk - 1) / bk - 1;
  if (p.causal) hi = min(hi, floor_div(last, bk));
  lo = p.window > 0 ? max(0, floor_div(first - p.window + 1, bk)) : 0;
}

// Query tiles [lo, hi] (of bq rows) that can see some key of [k0, k0 + bk).
__device__ __forceinline__ void query_tiles(const Params& p, int k0, int bk, int bq, int& lo,
                                            int& hi) {
  lo = 0;
  hi = (p.Sq + bq - 1) / bq - 1;
  if (p.causal) lo = max(lo, floor_div(k0 - p.q_offset, bq));
  if (p.window > 0) hi = min(hi, floor_div(k0 + bk + p.window - 2 - p.q_offset, bq));
}

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte global -> shared copy; zero-fills the destination when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}

// c += a b for one m16n8k16 tile: bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment loads from a tile stored row-major in shared memory with `ld`
// elements a row (rows 16-byte aligned).
//  * A operand, 16 rows from `row0`, k columns [k0, k0 + 16):
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s, int ld,
                                       int row0, int k0, int lane) {
  ldmatrix_x4(a, s + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
//  * B operand of two n-tiles [n0, n0 + 16) when the tile holds B^T (rows are n,
//    columns k, k in [k0, k0 + 16)): b[0], b[1] for n0, b[2], b[3] for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* s, int ld,
                                          int n0, int k0, int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + (((lane >> 3) & 1) << 3));
}
//  * B operand of two n-tiles [n0, n0 + 16) when the tile holds B (rows are k
//    in [k0, k0 + 16), columns n).
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* s, int ld,
                                          int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
                           ((lane >> 4) << 3));
}

// ------------------------------------------------------------- delta
template <typename T>
__global__ void __launch_bounds__(256) bwd_delta(Params p, int dh) {
  const long long rows = (long long)p.B * p.Sq * p.H;
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);  // (b * Sq + i) * H + h
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(p.o) + row * dh;
  const T* d = static_cast<const T*>(p.dout) + row * dh;
  float acc = 0.f;
  for (int c = lane; c < dh; c += 32) acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const int h = (int)(row % p.H);
    const long long bi = row / p.H;
    const int i = (int)(bi % p.Sq), b = (int)(bi / p.Sq);
    p.delta[((long long)b * p.H + h) * p.Sq + i] = acc;
  }
}

// ------------------------------------------------------ dK, dV in bf16
template <int DH>
struct KVTile {
  static constexpr int BK = 64, BQ = 32, THREADS = 128;
  static constexpr int LD = DH + 8;  // padded row, in bf16 elements
  static constexpr int CHUNKS = DH / 8;
  // K, V; then Q and dO in two stages; then lse * log2e and delta in two stages
  static constexpr int SMEM = (2 * BK + 4 * BQ) * LD * 2 + 4 * BQ * 4;
};

template <int DH>
__global__ void __launch_bounds__(128) bwd_dkdv_bf16(Params p) {
  using T = KVTile<DH>;
  constexpr int BK = T::BK, BQ = T::BQ, LD = T::LD, CHUNKS = T::CHUNKS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BK * LD;
  __nv_bfloat16* sQ = sV + BK * LD;    // stage s at sQ + s * BQ * LD
  __nv_bfloat16* sdO = sQ + 2 * BQ * LD;
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * LD);  // stage s at sL + s * BQ
  float* sD = sL + 2 * BQ;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BK;

  const long long q_stride = (long long)p.H * DH, kv_stride = (long long)p.KVH * DH;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v);
  const __nv_bfloat16* qb = qg + (long long)b * p.Sq * q_stride + (long long)h * DH;
  const __nv_bfloat16* dob = dog + (long long)b * p.Sq * q_stride + (long long)h * DH;
  const __nv_bfloat16* kb = kg + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;
  const __nv_bfloat16* vb = vg + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;
  const float* lseb = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* deltab = p.delta + ((long long)b * p.H + h) * p.Sq;

  for (int i = tid; i < BK * CHUNKS; i += T::THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = k0 + r < p.Skv;
    const long long off = (k0 + r) * kv_stride + c * 8;
    cp_async16(sK + r * LD + c * 8, ok ? kb + off : kg, ok);
    cp_async16(sV + r * LD + c * 8, ok ? vb + off : vg, ok);
  }
  auto load_q = [&](int qt, int stage) {
    const int q0 = qt * BQ;
    __nv_bfloat16* dq_ = sQ + stage * BQ * LD;
    __nv_bfloat16* ddo = sdO + stage * BQ * LD;
    for (int i = tid; i < BQ * CHUNKS; i += T::THREADS) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool ok = q0 + r < p.Sq;
      const long long off = (q0 + r) * q_stride + c * 8;
      cp_async16(dq_ + r * LD + c * 8, ok ? qb + off : qg, ok);
      cp_async16(ddo + r * LD + c * 8, ok ? dob + off : dog, ok);
    }
    if (tid < BQ) {
      const bool ok = q0 + tid < p.Sq;
      sL[stage * BQ + tid] = ok ? lseb[q0 + tid] * kLog2e : 0.f;
      sD[stage * BQ + tid] = ok ? deltab[q0 + tid] : 0.f;
    }
  };
  int lo, hi;
  query_tiles(p, k0, BK, BQ, lo, hi);
  if (lo <= hi) load_q(lo, 0);
  cp_async_commit();

  // This thread holds keys g and g + 8 of its warp's 16 (accumulator rows)
  // and query columns 2t, 2t + 1 of every 8-wide tile.
  const int g = lane >> 2, t = lane & 3;
  const int kpos[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float sl2 = p.scale * kLog2e;

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int qt = lo; qt <= hi; ++qt) {
    const int stage = (qt - lo) & 1;
    if (qt < hi) load_q(qt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* cQ = sQ + stage * BQ * LD;
    const __nv_bfloat16* cdO = sdO + stage * BQ * LD;
    const float* cL = sL + stage * BQ;
    const float* cD = sD + stage * BQ;
    const int q0 = qt * BQ;

    // S^T = K Q^T and dP^T = V dO^T (16 keys x BQ queries a warp)
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, LD, warp * 16, kk * 16, lane);
      load_a(va, sV, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; nt += 2) {
        uint32_t qf[4], of[4];
        load_b_nk(qf, cQ, LD, nt * 8, kk * 16, lane);
        mma_bf16(s[nt], ka, qf[0], qf[1]);
        mma_bf16(s[nt + 1], ka, qf[2], qf[3]);
        load_b_nk(of, cdO, LD, nt * 8, kk * 16, lane);
        mma_bf16(dp[nt], va, of[0], of[1]);
        mma_bf16(dp[nt + 1], va, of[2], of[3]);
      }
    }

    // P^T and dS^T, packed into A operands over the query (k) axis
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      float e[4], d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = nt * 8 + 2 * t + (j & 1);
        const int qi = q0 + qc;
        const bool ok = qi < p.Sq && allowed(p, qi + p.q_offset, kpos[j >> 1]);
        e[j] = ok ? exp2f(s[nt][j] * sl2 - cL[qc]) : 0.f;
        d[j] = e[j] * (dp[nt][j] - cD[qc]);
      }
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(e[0], e[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(e[2], e[3]);
      da[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(d[0], d[1]);
      da[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }

    // dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
#pragma unroll
      for (int dt = 0; dt < DH / 8; dt += 2) {
        uint32_t bo[4], bq[4];
        load_b_kn(bo, cdO, LD, kq * 16, dt * 8, lane);
        mma_bf16(dv[dt], pa[kq], bo[0], bo[1]);
        mma_bf16(dv[dt + 1], pa[kq], bo[2], bo[3]);
        load_b_kn(bq, cQ, LD, kq * 16, dt * 8, lane);
        mma_bf16(dk[dt], da[kq], bq[0], bq[1]);
        mma_bf16(dk[dt + 1], da[kq], bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= p.Skv) continue;
    const long long off = (((long long)b * p.Skv + kpos[r]) * p.H + h) * DH + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      *reinterpret_cast<float2*>(p.dk_h + off + dt * 8) = make_float2(dk[dt][2 * r], dk[dt][2 * r + 1]);
      *reinterpret_cast<float2*>(p.dv_h + off + dt * 8) = make_float2(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

// ----------------------------------------------------------- dQ in bf16
template <int DH>
struct QTile {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
  static constexpr int LD = DH + 8;
  static constexpr int CHUNKS = DH / 8;
  static constexpr int SMEM = (2 * BQ + 4 * BK) * LD * 2;  // Q, dO; then K and V in two stages
};

template <int DH>
__global__ void __launch_bounds__(128) bwd_dq_bf16(Params p) {
  using T = QTile<DH>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD, CHUNKS = T::CHUNKS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + BQ * LD;
  __nv_bfloat16* sK = sdO + BQ * LD;  // stage s at sK + s * BK * LD
  __nv_bfloat16* sV = sK + 2 * BK * LD;

  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = iq * BQ;
  const int rows = min(BQ, p.Sq - q0);
  const int first = q0 + p.q_offset, last = q0 + rows - 1 + p.q_offset;

  const long long q_stride = (long long)p.H * DH, kv_stride = (long long)p.KVH * DH;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v);
  const __nv_bfloat16* qb = qg + (long long)b * p.Sq * q_stride + (long long)h * DH;
  const __nv_bfloat16* dob = dog + (long long)b * p.Sq * q_stride + (long long)h * DH;
  const __nv_bfloat16* kb = kg + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;
  const __nv_bfloat16* vb = vg + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;

  for (int i = tid; i < BQ * CHUNKS; i += T::THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = r < rows;
    const long long off = (q0 + r) * q_stride + c * 8;
    cp_async16(sQ + r * LD + c * 8, ok ? qb + off : qg, ok);
    cp_async16(sdO + r * LD + c * 8, ok ? dob + off : dog, ok);
  }
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BK;
    __nv_bfloat16* dk_ = sK + stage * BK * LD;
    __nv_bfloat16* dv_ = sV + stage * BK * LD;
    for (int i = tid; i < BK * CHUNKS; i += T::THREADS) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool ok = k0 + r < p.Skv;
      const long long off = (k0 + r) * kv_stride + c * 8;
      cp_async16(dk_ + r * LD + c * 8, ok ? kb + off : kg, ok);
      cp_async16(dv_ + r * LD + c * 8, ok ? vb + off : vg, ok);
    }
  };
  int lo, hi;
  key_tiles(p, first, last, BK, lo, hi);
  if (lo <= hi) load_kv(lo, 0);
  cp_async_commit();

  // This thread holds query rows g and g + 8 of its warp's 16, key columns
  // 2t, 2t + 1 of every 8-wide tile.
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
  const float sl2 = p.scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < rows;
    const long long i = ((long long)b * p.H + h) * p.Sq + q0 + row[r];
    lse2[r] = ok ? p.lse[i] * kLog2e : 0.f;
    dl[r] = ok ? p.delta[i] : 0.f;
  }

  float dq[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int kt = lo; kt <= hi; ++kt) {
    const int stage = (kt - lo) & 1;
    if (kt < hi) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* cK = sK + stage * BK * LD;
    const __nv_bfloat16* cV = sV + stage * BK * LD;
    const int k0 = kt * BK;

    // S = Q K^T and dP = dO V^T (16 queries x BK keys a warp)
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4], oa[4];
      load_a(qa, sQ, LD, warp * 16, kk * 16, lane);
      load_a(oa, sdO, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < BK / 8; nt += 2) {
        uint32_t kf[4], vf[4];
        load_b_nk(kf, cK, LD, nt * 8, kk * 16, lane);
        mma_bf16(s[nt], qa, kf[0], kf[1]);
        mma_bf16(s[nt + 1], qa, kf[2], kf[3]);
        load_b_nk(vf, cV, LD, nt * 8, kk * 16, lane);
        mma_bf16(dp[nt], oa, vf[0], vf[1]);
        mma_bf16(dp[nt + 1], oa, vf[2], vf[3]);
      }
    }

    // dS, packed into A operands over the key (k) axis
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const bool ok = row[r] < rows &&
                        allowed(p, q0 + row[r] + p.q_offset, k0 + nt * 8 + 2 * t + (j & 1));
        const float e = ok ? exp2f(s[nt][j] * sl2 - lse2[r]) : 0.f;
        d[j] = e * (dp[nt][j] - dl[r]);
      }
      da[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(d[0], d[1]);
      da[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < DH / 8; dt += 2) {
        uint32_t bk[4];
        load_b_kn(bk, cK, LD, kk * 16, dt * 8, lane);
        mma_bf16(dq[dt], da[kk], bk[0], bk[1]);
        mma_bf16(dq[dt + 1], da[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(p.dq) + (long long)b * p.Sq * q_stride +
                       (long long)h * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= rows) continue;
    __nv_bfloat16* dst = dqb + (q0 + row[r]) * q_stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(dq[dt][2 * r] * p.scale, dq[dt][2 * r + 1] * p.scale);
  }
}

// ---------------------------------------------------- float32: CUDA cores
template <int DH>
struct F32Tile {
  static constexpr int B = 32, THREADS = 128;  // 32-row tiles of queries and of keys
  static constexpr int LDR = DH + 1, LDS = B + 1;
  // dK/dV: K, V, Q, dO, then P, dS, then lse and delta
  static constexpr int SMEM_KV = (4 * B * LDR + 2 * B * LDS + 2 * B) * 4;
  // dQ: Q, dO, K, V, then dS
  static constexpr int SMEM_Q = (4 * B * LDR + B * LDS) * 4;
};

template <int DH>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < DH; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// rows [r0, r0 + 32) of a (., H or KVH, DH) float32 operand into a padded tile; 0 past `n`.
template <int DH>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride,
                                              int r0, int n, int tid) {
  for (int i = tid; i < F32Tile<DH>::B * DH; i += F32Tile<DH>::THREADS) {
    const int r = i / DH, d = i % DH;
    dst[r * F32Tile<DH>::LDR + d] = r0 + r < n ? src[(r0 + r) * stride + d] : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(128) bwd_dkdv_f32(Params p) {
  using T = F32Tile<DH>;
  constexpr int BT = T::B, LDR = T::LDR, LDS = T::LDS;
  extern __shared__ float fsm[];
  float* sK = fsm;
  float* sV = sK + BT * LDR;
  float* sQ = sV + BT * LDR;
  float* sdO = sQ + BT * LDR;
  float* sP = sdO + BT * LDR;
  float* sS = sP + BT * LDS;
  float* sL = sS + BT * LDS;
  float* sD = sL + BT;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const long long q_stride = (long long)p.H * DH, kv_stride = (long long)p.KVH * DH;
  const float* qb = static_cast<const float*>(p.q) + (long long)b * p.Sq * q_stride + (long long)h * DH;
  const float* dob = static_cast<const float*>(p.dout) + (long long)b * p.Sq * q_stride + (long long)h * DH;
  const float* kb = static_cast<const float*>(p.k) + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;
  const float* vb = static_cast<const float*>(p.v) + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;
  const float* lseb = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* deltab = p.delta + ((long long)b * p.H + h) * p.Sq;

  load_rows_f32<DH>(sK, kb, kv_stride, k0, p.Skv, tid);
  load_rows_f32<DH>(sV, vb, kv_stride, k0, p.Skv, tid);
  int lo, hi;
  query_tiles(p, k0, BT, BT, lo, hi);

  // Thread = (key row r, column group c): queries c + 4j of the tile, dims c + 4j.
  const int r = tid >> 2, c = tid & 3;
  const int kpos = k0 + r;
  float dk[DH / 4], dv[DH / 4];
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) dk[j] = dv[j] = 0.f;

  for (int qt = lo; qt <= hi; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // K, V written; the previous tile's Q, dO, P, dS consumed
    load_rows_f32<DH>(sQ, qb, q_stride, q0, p.Sq, tid);
    load_rows_f32<DH>(sdO, dob, q_stride, q0, p.Sq, tid);
    if (tid < BT) {
      const bool ok = q0 + tid < p.Sq;
      sL[tid] = ok ? lseb[q0 + tid] : 0.f;
      sD[tid] = ok ? deltab[q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BT / 4; ++j) {
      const int qc = c + 4 * j, qi = q0 + qc;
      const float s = dot_rows<DH>(sK + r * LDR, sQ + qc * LDR);
      const float dp = dot_rows<DH>(sV + r * LDR, sdO + qc * LDR);
      const bool ok = qi < p.Sq && allowed(p, qi + p.q_offset, kpos);
      const float e = ok ? expf(s * p.scale - sL[qc]) : 0.f;
      sP[r * LDS + qc] = e;
      sS[r * LDS + qc] = e * (dp - sD[qc]);
    }
    __syncwarp();  // a key row's P and dS are written by the 4 threads of one warp
#pragma unroll 4
    for (int qc = 0; qc < BT; ++qc) {
      const float pe = sP[r * LDS + qc], de = sS[r * LDS + qc];
#pragma unroll
      for (int j = 0; j < DH / 4; ++j) {
        dv[j] = fmaf(pe, sdO[qc * LDR + c + 4 * j], dv[j]);
        dk[j] = fmaf(de, sQ[qc * LDR + c + 4 * j], dk[j]);
      }
    }
  }

  if (kpos < p.Skv) {
    const long long off = (((long long)b * p.Skv + kpos) * p.H + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 4; ++j) {
      p.dk_h[off + c + 4 * j] = dk[j];
      p.dv_h[off + c + 4 * j] = dv[j];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(128) bwd_dq_f32(Params p) {
  using T = F32Tile<DH>;
  constexpr int BT = T::B, LDR = T::LDR, LDS = T::LDS;
  extern __shared__ float fsm[];
  float* sQ = fsm;
  float* sdO = sQ + BT * LDR;
  float* sK = sdO + BT * LDR;
  float* sV = sK + BT * LDR;
  float* sS = sV + BT * LDR;

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G;
  const int tid = threadIdx.x;
  const int q0 = iq * BT;
  const int rows = min(BT, p.Sq - q0);
  const int first = q0 + p.q_offset, last = q0 + rows - 1 + p.q_offset;
  const long long q_stride = (long long)p.H * DH, kv_stride = (long long)p.KVH * DH;
  const float* qb = static_cast<const float*>(p.q) + (long long)b * p.Sq * q_stride + (long long)h * DH;
  const float* dob = static_cast<const float*>(p.dout) + (long long)b * p.Sq * q_stride + (long long)h * DH;
  const float* kb = static_cast<const float*>(p.k) + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;
  const float* vb = static_cast<const float*>(p.v) + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;

  load_rows_f32<DH>(sQ, qb, q_stride, q0, p.Sq, tid);
  load_rows_f32<DH>(sdO, dob, q_stride, q0, p.Sq, tid);

  // Thread = (query row r, column group c): keys c + 4j of the tile, dims c + 4j.
  const int r = tid >> 2, c = tid & 3;
  const bool row_ok = r < rows;
  const int qpos = q0 + r + p.q_offset;
  const long long li = ((long long)b * p.H + h) * p.Sq + q0 + r;
  const float lse = row_ok ? p.lse[li] : 0.f, dl = row_ok ? p.delta[li] : 0.f;
  int lo, hi;
  key_tiles(p, first, last, BT, lo, hi);
  float dq[DH / 4];
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) dq[j] = 0.f;

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // Q, dO written; the previous tile's K, V and dS consumed
    load_rows_f32<DH>(sK, kb, kv_stride, k0, p.Skv, tid);
    load_rows_f32<DH>(sV, vb, kv_stride, k0, p.Skv, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BT / 4; ++j) {
      const int kc = c + 4 * j;
      const float s = dot_rows<DH>(sQ + r * LDR, sK + kc * LDR);
      const float dp = dot_rows<DH>(sdO + r * LDR, sV + kc * LDR);
      const bool ok = row_ok && allowed(p, qpos, k0 + kc);
      const float e = ok ? expf(s * p.scale - lse) : 0.f;
      sS[r * LDS + kc] = e * (dp - dl);
    }
    __syncwarp();  // a query row's dS is written by the 4 threads of one warp
#pragma unroll 4
    for (int kc = 0; kc < BT; ++kc) {
      const float de = sS[r * LDS + kc];
#pragma unroll
      for (int j = 0; j < DH / 4; ++j) dq[j] = fmaf(de, sK[kc * LDR + c + 4 * j], dq[j]);
    }
  }

  if (row_ok) {
    float* dst = static_cast<float*>(p.dq) + (long long)b * p.Sq * q_stride +
                 (long long)h * DH + (q0 + r) * q_stride;
#pragma unroll
    for (int j = 0; j < DH / 4; ++j) dst[c + 4 * j] = dq[j] * p.scale;
  }
}

// ------------------------------------------------- sum over the group
template <typename T>
__global__ void __launch_bounds__(256) bwd_group_sum(Params p, int dh) {
  const long long n = (long long)p.B * p.Skv * p.KVH * dh;
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int d = (int)(i % dh);
    const long long bk = i / dh;  // (b * Skv + key) * KVH + kvh
    const int kvh = (int)(bk % p.KVH);
    const long long src = ((bk / p.KVH) * p.H + (long long)kvh * p.G) * dh + d;
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < p.G; ++g) {
      sk += p.dk_h[src + (long long)g * dh];
      sv += p.dv_h[src + (long long)g * dh];
    }
    dk[i] = from_f<T>(sk * p.scale);
    dv[i] = from_f<T>(sv);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(int bf16, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (bf16) {
    const dim3 gkv((p.Skv + KVTile<DH>::BK - 1) / KVTile<DH>::BK, p.H, p.B);
    if (p.Skv > 0) err = launch(bwd_dkdv_bf16<DH>, KVTile<DH>::SMEM, gkv, p, stream);
    if (err != cudaSuccess) return err;
    const dim3 gq((p.Sq + QTile<DH>::BQ - 1) / QTile<DH>::BQ, p.H, p.B);
    return launch(bwd_dq_bf16<DH>, QTile<DH>::SMEM, gq, p, stream);
  }
  constexpr int BT = F32Tile<DH>::B;
  if (p.Skv > 0)
    err = launch(bwd_dkdv_f32<DH>, F32Tile<DH>::SMEM_KV, dim3((p.Skv + BT - 1) / BT, p.H, p.B),
                 p, stream);
  if (err != cudaSuccess) return err;
  return launch(bwd_dq_f32<DH>, F32Tile<DH>::SMEM_Q, dim3((p.Sq + BT - 1) / BT, p.H, p.B), p,
                stream);
}

template <typename T>
cudaError_t launch_all(int dh, const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.Sq * p.H;
  bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bf16 = sizeof(T) == 2;
  switch (dh) {
    case 64: err = launch_dh<64>(bf16, p, stream); break;
    case 80: err = launch_dh<80>(bf16, p, stream); break;
    case 128: err = launch_dh<128>(bf16, p, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long long n = (long long)p.B * p.Skv * p.KVH * dh;
  if (n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 132LL * 16 ? (n + 255) / 256 : 132LL * 16);
  bwd_group_sum<T><<<blocks, 256, 0, stream>>>(p, dh);
  return cudaGetLastError();
}

// ------------------------------------ bf16 at Dh 64, 80 and 128: wgmma + TMA
// One kernel with the five products (namespace wg), between a prologue
// launch (delta, lse in base-2 units, the dQ accumulator zeroed) and an
// epilogue launch (dQ scaled and rounded to bf16).
//
// Grid (H, B, key tiles of BK = 128) as clusters of G blocks along H: the G
// query heads of one kv head, one block each.  A block holds its K and V
// tile (TMA, once) and walks the query tiles of BQ = 64 rows its keys can
// see, two stages of Q, dO, lse and delta landing by TMA while the last
// tile computes (thread 0 issues every load).  Two consumer warpgroups own
// 64 keys each:
//
//     S^T  = K Q^T,  dP^T = V dO^T          wgmma, both operands in shared memory
//     P^T  = exp2(S^T scale log2e - lse2),  dS^T = P^T (dP^T - delta)   registers
//     dV  += P^T dO, dK += dS^T Q           wgmma, P^T and dS^T from registers
//     dQ_partial = dS K                      wgmma, dS^T from shared memory (transposed)
//
// S^T and dP^T are committed as two groups, and dV's product is issued as
// soon as P^T is formed: P^T's exponentials overlap dP^T's product, and
// dS^T's arithmetic overlaps dV's.  Only tiles that cross the diagonal or a
// window's edge test the mask element by element, against the query range
// each of a thread's keys may see, solved once.  Within a warpgroup the
// phases are otherwise serial, and the two warpgroups meet at a barrier
// before dQ and at the end of each tile, so the tensor cores idle while both
// form P^T and dS^T (a producer warp and two warpgroups out of phase, as
// FA3 has them, are the next step).
//
// dQ across key tiles: each warpgroup's partial (64 queries x its columns
// over all BK keys at Dh 128 and 80, where the two split the columns 64 + 64
// and 48 + 32; all 64 columns over its own keys at Dh 64) goes to shared
// memory and one thread adds it into a float32 accumulator in device memory with one bulk reduce-add
// (cp.reduce.async.bulk ... add.f32): the order of the adds is not fixed,
// so dQ is not bit-reproducible between launches.  dK and dV: after the
// loop every block of the cluster puts its query head's float32 dK and dV
// in its own shared memory, and block r sums the r-th slice of all G in
// rank order through distributed shared memory (deterministic) and writes
// it in the output type: no float32 partials in device memory and no group
// reduction launch.  256 threads at one block an SM give ptxas 255
// registers a thread (the dK and dV accumulators alone take DH of them).
namespace wg {

namespace cg = cooperative_groups;

#include "wgmma_tma.cuh"

constexpr int BK = 128, BQ = 64, kThreads = 256;

// How a head dim's rows are tiled (Boxes, in wgmma_tma.cuh), and dQ's tile:
// 64 queries x DQN columns of float32 a warpgroup partial.
template <int DH>
struct Tiling : Boxes<DH> {
  // dQ: at Dh 64 each warpgroup's partial covers its own 64 keys and all 64
  // columns (both add into one 64 x 64 part); at Dh 80 and 128 all BK keys
  // and its own columns, part 0 [0, N0) and part 1 [N0, Dh) (48 + 32,
  // 64 + 64; whole boxes), so that a (key tile, query tile) pair adds one
  // 64 x Dh partial into device memory.
  static constexpr bool SPLIT_KEYS = DH == 64;
  static constexpr int N0 = DH == 80 ? 48 : 64, N1 = SPLIT_KEYS ? 64 : DH - N0;
  static_assert(N0 % Boxes<DH>::BW == 0, "whole boxes");
};

template <int DH>
struct Smem {
  static constexpr int K = 0;  // tiles: Tiling<DH>::COLS column boxes of (rows, BW) bf16, swizzled
  static constexpr int V = K + BK * DH * 2;
  static constexpr int Q = V + BK * DH * 2;     // two stages
  static constexpr int DO = Q + 2 * BQ * DH * 2;  // two stages
  static constexpr int DS = DO + 2 * BQ * DH * 2;  // dS^T (BK, BQ) bf16, 128B-swizzled
  static constexpr int DQ = DS + BK * BQ * 2;  // the warpgroups' float32 dQ partials
  static constexpr int LD = DQ + (Tiling<DH>::SPLIT_KEYS ? 2 : 1) * 64 * DH * 4;  // lse2, delta
  static constexpr int BAR = LD + 2 * 2 * BQ * 4;  // kv_full, full[2]
  static constexpr int BYTES = BAR + 3 * 8 + 1024;  // + 1024 to align
  static constexpr int Q_BYTES = BQ * DH * 2, KV_BYTES = BK * DH * 2;
  static_assert(2 * BK * DH * 4 <= DS, "dK and dV (float32) fit over K, V, Q and dO");
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tiles keep the swizzle's alignment");
};

// `bytes` (a multiple of 16) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// dst[i] += src[i] (float32) for `bytes` bytes, shared -> global.
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
      ::"l"(dst), "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until the source of every bulk reduce this thread issued has been read.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory made visible to wgmma and bulk copies.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (+)= A B for a 64 x 64 tile, k 16, both operands in shared memory:
// K-major (tnsp 0) or MN-major (tnsp 1), the same for A and B.
template <int TNSP>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32 "}, "
      "%32, %33, p, 1, 1, %35, %35;\n}\n"
      : WG_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TNSP));
}

// d (+)= A B for a 64 x 32 / 64 x 48 tile, k 16, both operands in shared
// memory, MN-major.
__device__ __forceinline__ void wgmma_ss_m64n32_mn(float (&d)[16], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss_m64n48_mn(float (&d)[24], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}

// dQ's partial (+)= dS K over one k16 step: N columns, both operands
// MN-major in shared memory.
template <int N>
__device__ __forceinline__ void dq_product(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d);
template <>
__device__ __forceinline__ void dq_product<64>(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  wgmma_ss_m64n64<1>(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void dq_product<32>(float (&d)[16], uint64_t da, uint64_t db,
                                               int scale_d) {
  wgmma_ss_m64n32_mn(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void dq_product<48>(float (&d)[24], uint64_t da, uint64_t db,
                                               int scale_d) {
  wgmma_ss_m64n48_mn(d, da, db, scale_d);
}

// Extra operands of the wgmma route (the common Params carry the rest).
struct Extra {
  float* lse2;    // (B, H, Sq_pad): lse * log2(e), 0 past Sq
  float* dpad;    // (B, H, Sq_pad): delta, 0 past Sq
  float* dq_acc;  // (B, H, Sq_pad / 64, 64 DH) float32: a query tile's parts, each swizzled
  int sq_pad;
  int drop_rank;  // a planted fault: the group sum leaves out this rank (-1 in real runs)
};

// Element (r, c) of a 64 x N float32 dQ part: 8-column groups permuted by
// the row (XOR at N 64, a rotation at N 32 and 48), so that a warp's float2 stores
// of the accumulator layout spread over the banks (the epilogue launch
// undoes it); each 8-column group stays whole and 32-byte aligned.
template <int N>
__device__ __forceinline__ int dq_swz(int r, int c) {
  if constexpr (N == 64) return r * 64 + (c ^ ((r & 7) << 3));
  else return r * N + (c + ((r & 7) << 3)) % N;
}

// prologue: eight lanes a row (b, h, i), i < Sq_pad, 16-byte loads of O and dO.
__global__ void __launch_bounds__(256) bwd_prep(Params p, Extra x, int dh) {
  const long long rows = (long long)p.B * p.H * x.sq_pad;  // a multiple of 64: whole warps
  const long long row = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);  // (b * H + h) * sq_pad + i
  const int sub = threadIdx.x & 7;
  if (row >= rows) return;
  const int i = (int)(row % x.sq_pad);
  const long long bh = row / x.sq_pad;
  const int h = (int)(bh % p.H), b = (int)(bh / p.H);
  float acc = 0.f;
  if (i < p.Sq) {
    const long long off = (((long long)b * p.Sq + i) * p.H + h) * dh;
    const uint4* o = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.o) + off);
    const uint4* d = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.dout) + off);
    for (int c = sub; c < dh / 8; c += 8) {
      const uint4 ov = o[c], dv = d[c];
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(op[e]), g = __bfloat1622float2(dp[e]);
        acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
      }
    }
  }
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  float4* z = reinterpret_cast<float4*>(x.dq_acc + row * dh);
  for (int c = sub; c < dh / 4; c += 8) z[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (sub == 0) {
    x.dpad[row] = acc;
    x.lse2[row] = i < p.Sq ? p.lse[bh * p.Sq + i] * kLog2e : 0.f;
  }
}

// epilogue: dQ = scale * accumulator in bf16; one thread 8 columns of a row.
template <int DH>
__global__ void __launch_bounds__(256) bwd_dq_convert(Params p, Extra x) {
  using TL = Tiling<DH>;
  const long long n = (long long)p.B * p.Sq * p.H * (DH / 8);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c8 = (int)(i % (DH / 8)) * 8;
  const long long row = i / (DH / 8);  // (b * Sq + q) * H + h
  const int h = (int)(row % p.H);
  const long long bq = row / p.H;
  const int q = (int)(bq % p.Sq), b = (int)(bq / p.Sq);
  const long long tile = (((long long)b * p.H + h) * (x.sq_pad / 64) + q / 64) * (64 * DH);
  const bool part1 = !TL::SPLIT_KEYS && c8 >= TL::N0;
  const float* src = x.dq_acc + tile +
                     (part1 ? 64 * TL::N0 + dq_swz<TL::N1>(q % 64, c8 - TL::N0)
                            : dq_swz<TL::N0>(q % 64, c8));
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 c = reinterpret_cast<const float4*>(src)[1];
  __nv_bfloat162 out[4] = {__floats2bfloat162_rn(a.x * p.scale, a.y * p.scale),
                           __floats2bfloat162_rn(a.z * p.scale, a.w * p.scale),
                           __floats2bfloat162_rn(c.x * p.scale, c.y * p.scale),
                           __floats2bfloat162_rn(c.z * p.scale, c.w * p.scale)};
  *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.dq) + row * DH + c8) =
      *reinterpret_cast<uint4*>(out);
}

// Whether a (BK keys at k0) x (BQ queries at q0) tile needs the per-element mask.
__device__ __forceinline__ bool tile_masked(const Params& p, int k0, int q0) {
  const int first = q0 + p.q_offset, last = q0 + BQ - 1 + p.q_offset;
  return q0 + BQ > p.Sq || k0 + BK > p.Skv || k0 < p.skip_keys ||
         (p.causal && k0 + BK - 1 > first) || (p.window > 0 && k0 <= last - p.window);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_wgmma(const Params p, const Extra x, const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do) {
  using L = Smem<DH>;
  using TL = Tiling<DH>;
  constexpr int BW = TL::BW, RB = TL::RB, COLS = TL::COLS;
  constexpr uint64_t MODE = TL::MODE;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024
  unsigned char* gbase = wg_smem + (base - raw);  // the same, as a generic pointer
  const uint32_t sK = base + L::K, sV = base + L::V, sQ = base + L::Q, sDO = base + L::DO;
  const uint32_t sDS = base + L::DS, sDQ = base + L::DQ, sLD = base + L::LD;
  const uint32_t kv_full = base + L::BAR, full0 = kv_full + 8;

  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;  // the longest causal tiles first
  const int kvh = h / p.G, rank = h % p.G;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, w = tid >> 7, ct = tid & 127;
  const int warp = ct >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  int lo, hi;
  query_tiles(p, k0, BK, BQ, lo, hi);
  const int n_it = hi - lo + 1;
  const long long lrow = ((long long)b * p.H + h) * x.sq_pad;  // this head's lse2 / delta row

  const CUtensorMap* mq = &tm_q;
  const CUtensorMap* mdo = &tm_do;
  auto issue_q = [&](int it) {  // Q, dO, lse2 and delta of query tile lo + it
    const int st = it & 1, q0 = (lo + it) * BQ;
    const uint32_t bar = full0 + 8 * st;
    mbar_expect_tx(bar, 2 * L::Q_BYTES + 2 * BQ * 4);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      tma_load_4d(sQ + st * L::Q_BYTES + c * BQ * RB, mq, bar, c * BW, h, q0, b);
      tma_load_4d(sDO + st * L::Q_BYTES + c * BQ * RB, mdo, bar, c * BW, h, q0, b);
    }
    bulk_load(sLD + st * 2 * BQ * 4, x.lse2 + lrow + q0, BQ * 4, bar);
    bulk_load(sLD + st * 2 * BQ * 4 + BQ * 4, x.dpad + lrow + q0, BQ * 4, bar);
  };
  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(full0, 1);
    mbar_init(full0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_it > 0) {
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        tma_load_4d(sK + c * BK * RB, &tm_k, kv_full, c * BW, kvh, k0, b);
        tma_load_4d(sV + c * BK * RB, &tm_v, kv_full, c * BW, kvh, k0, b);
      }
      issue_q(0);
      if (n_it > 1) issue_q(1);
    }
  }
  __syncthreads();

  // This thread's accumulator rows: keys 64 w + 16 warp + g (+ 8) of the
  // tile (S^T, dP^T, dK, dV); queries 16 warp + g (+ 8) of the q tile (dQ).
  const int kr = 64 * w + 16 * warp + g;
  const int kpos[2] = {k0 + kr, k0 + kr + 8};
  // The queries [qlo, qhi) each of this thread's two keys may see (the
  // masks of `allowed`, solved for the query once): an edge tile's mask is
  // then two compares an element.
  int qlo[2], qhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = kpos[r];
    qlo[r] = p.causal ? k - p.q_offset : INT_MIN;
    qhi[r] = p.window > 0 ? min(p.Sq, k - p.q_offset + p.window) : p.Sq;
    if (k >= p.Skv || k < p.skip_keys) qlo[r] = INT_MAX;
  }
  const float sl2 = p.scale * kLog2e;
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t sK_rows = sK + w * 64 * RB, sV_rows = sV + w * 64 * RB;
  // dQ (see Tiling): warpgroup w's keys (dq_a, dS^T's rows), its columns
  // (dq_b, K's boxes) and its part of the query tile's 64 x DH floats (col0)
  constexpr int DQ_STEPS = TL::SPLIT_KEYS ? 64 / 16 : BK / 16;
  const int col0 = TL::SPLIT_KEYS || w == 0 ? 0 : TL::N0;
  const uint32_t dq_a = TL::SPLIT_KEYS ? sDS + w * 64 * 128 : sDS;
  const uint32_t dq_b = TL::SPLIT_KEYS ? sK + w * 64 * RB : sK + (col0 / BW) * BK * RB;
  float* dq_tiles = x.dq_acc + ((long long)b * p.H + h) * (x.sq_pad / 64) * (64 * DH) + 64 * col0;
  const int sdq_off = TL::SPLIT_KEYS ? w * 64 * DH : 64 * col0;  // floats
  float* sdq = reinterpret_cast<float*>(gbase + L::DQ) + sdq_off;
  const bool leader = ct == 0;  // issues this warpgroup's bulk reduces

  if (n_it > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, qt = lo + it, q0 = qt * BQ;
    mbar_wait(full0 + 8 * st, (it >> 1) & 1);
    const uint32_t q_tile = sQ + st * L::Q_BYTES, do_tile = sDO + st * L::Q_BYTES;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries a warpgroup, two
    // groups, so that P^T is formed while dP^T is still on the tensor cores
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int box = kk * 16 / BW, in = (kk * 16 % BW) * 2;  // k16 step: box, bytes into its row
      wgmma_ss_m64n64<0>(s, desc(sK_rows + box * BK * RB + in, 16, 8 * RB, MODE),
                         desc(q_tile + box * BQ * RB + in, 16, 8 * RB, MODE), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int box = kk * 16 / BW, in = (kk * 16 % BW) * 2;
      wgmma_ss_m64n64<0>(dp, desc(sV_rows + box * BK * RB + in, 16, 8 * RB, MODE),
                         desc(do_tile + box * BQ * RB + in, 16, 8 * RB, MODE), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T
    fence_regs(s);

    // P^T (in place of S^T, float32) and its bf16 A operand; then dV += P^T dO
    // (dO MN-major: Dh boxes BQ rows apart) while dS^T is formed
    const float* lse2 = reinterpret_cast<const float*>(gbase + L::LD) + st * 2 * BQ;
    const float* dl = lse2 + BQ;
    uint32_t pa[4][4], da[4][4];
    // Two instantiations, chosen once a tile: tested element by element, the
    // mask cost the pass three times its arithmetic on every tile.
    auto p_pass = [&](auto masked_tile) {
      constexpr bool MASKED = decltype(masked_tile)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + qc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qi = q0 + qc + (r & 1);
          const bool ok = !MASKED || (qi >= qlo[r >> 1] && qi < qhi[r >> 1]);
          s[4 * j + r] = ok ? ex2(s[4 * j + r] * sl2 - ((r & 1) ? l2.y : l2.x)) : 0.f;
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
    };
    if (tile_masked(p, k0, q0))
      p_pass(std::true_type{});
    else
      p_pass(std::false_type{});
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      rs_product<DH>(dv, pa[kk], desc(do_tile + kk * 16 * RB, BQ * RB, 8 * RB, MODE));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T
    fence_regs(dp);

    // dS^T = P^T (dP^T - delta), also to shared memory for dQ; dK += dS^T Q
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
      float d[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) d[r] = s[4 * j + r] * (dp[4 * j + r] - ((r & 1) ? d2.y : d2.x));
      da[j >> 1][(j & 1) * 2] = pack_bf16(d[0], d[1]);
      da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = kr + 8 * r;
        *reinterpret_cast<uint32_t*>(gbase + L::DS + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t) =
            da[j >> 1][(j & 1) * 2 + r];
      }
    }
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      rs_product<DH>(dk, da[kk], desc(q_tile + kk * 16 * RB, BQ * RB, 8 * RB, MODE));
    wgmma_commit();

    // dQ partial = dS K: dS^T from shared memory (MN-major A), K MN-major
    fence_async_smem();
    if constexpr (TL::SPLIT_KEYS)
      named_barrier(2 + w, 128);  // this warpgroup's dS^T rows written: it reads its own keys
    else
      named_barrier(1, kThreads);  // both warpgroups' dS^T written: each reads all BK keys
    auto dq_phase = [&](auto n_cols) {
      constexpr int N = decltype(n_cols)::value;
      float dq[N / 2];
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_STEPS; ++kk)
        dq_product<N>(dq, desc(dq_a + kk * 16 * 128, 64 * 128, 1024),
                      desc(dq_b + kk * 16 * RB, BK * RB, 8 * RB, MODE), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);

      if (leader) bulk_wait_read();  // the previous partial has left shared memory
      named_barrier(2 + w, 128);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r;
          *reinterpret_cast<float2*>(sdq + dq_swz<N>(row, 8 * j + 2 * t)) =
              make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
      fence_async_smem();
      named_barrier(2 + w, 128);
      if (leader)
        bulk_reduce_add(dq_tiles + (long long)qt * (64 * DH), sDQ + sdq_off * 4, 64 * N * 4);
    };
    if (w == 0)
      dq_phase(std::integral_constant<int, TL::N0>{});
    else
      dq_phase(std::integral_constant<int, TL::N1>{});

    __syncthreads();  // stage st and dS^T are free
    if (tid == 0 && it + 2 < n_it) issue_q(it + 2);
  }
  if (leader) bulk_wait_all();

  // dK and dV of the group: each block's float32 share over K, V, Q and dO,
  // then block `rank` sums slice `rank` of all G in rank order.
  __syncthreads();
  float* red = reinterpret_cast<float*>(gbase);  // dK (BK, DH) then dV (BK, DH)
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kr + 8 * r, col = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(red + row * DH + col) = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(red + (BK + row) * DH + col) =
          make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int CHUNKS = 2 * BK * DH / 4;  // float4s
  const int per = (CHUNKS + p.G - 1) / p.G;
  const int first = rank * per, end = min(CHUNKS, first + per);
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv);
  for (int i = first + tid; i < end; i += kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < p.G; ++r) {
      if (r == x.drop_rank) continue;
      const float4 v = cluster.map_shared_rank(reinterpret_cast<float4*>(red), r)[i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const int e = 4 * i, which = e / (BK * DH), rem = e % (BK * DH);
    const int row = rem / DH, col = rem % DH;
    if (k0 + row >= p.Skv) continue;
    const float sc = which == 0 ? p.scale : 1.f;
    __nv_bfloat162 out[2] = {__floats2bfloat162_rn(acc.x * sc, acc.y * sc),
                             __floats2bfloat162_rn(acc.z * sc, acc.w * sc)};
    __nv_bfloat16* dst = (which == 0 ? dkg : dvg) +
                         (((long long)b * p.Skv + k0 + row) * p.KVH + kvh) * DH + col;
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<uint2*>(out);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int DH>
int launch(const Params& p, const Extra& x, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * x.sq_pad;
  bwd_prep<<<(unsigned)((rows + 31) / 32), 256, 0, stream>>>(p, x, DH);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (p.Skv > 0) {
    CUtensorMap tq, tk, tv, tdo;
    constexpr int bw = Tiling<DH>::BW;
    int err = encode(&tq, p.q, DH, p.H, p.Sq, p.B, BQ, bw);
    if (!err) err = encode(&tdo, p.dout, DH, p.H, p.Sq, p.B, BQ, bw);
    if (!err) err = encode(&tk, p.k, DH, p.KVH, p.Skv, p.B, BK, bw);
    if (!err) err = encode(&tv, p.v, DH, p.KVH, p.Skv, p.B, BK, bw);
    if (err) return err;
    e = cudaFuncSetAttribute(bwd_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<DH>::BYTES);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)p.H, (unsigned)p.B, (unsigned)((p.Skv + BK - 1) / BK));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Smem<DH>::BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)p.G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, bwd_wgmma<DH>, p, x, tq, tk, tv, tdo);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long n = (long long)p.B * p.Sq * p.H * (DH / 8);
  bwd_dq_convert<DH><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(p, x);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// q, out, dout, dq (B, Sq, H, Dh); k, v, dk, dv (B, Skv, KVH, Dh), all
// contiguous, of one type (bf16 when `bf16` is nonzero, else float32),
// 16-byte aligned; lse (B, H, Sq) float32 from the forward.  Scratch, float32:
// delta (B, H, Sq), dk_h and dv_h (B, Skv, H, Dh).  skip_key_tiles: 0 (a
// planted fault masks the first this-many 64-key tiles).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, void* dk_h, void* dv_h, int bf16,
                                   int B, int Sq, int Skv, int H, int KVH, int Dh, int q_offset,
                                   int causal, int window, int skip_key_tiles, float scale,
                                   void* stream) {
  if (B == 0 || H == 0) return 0;
  if (KVH == 0 || H % KVH) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out, dout, static_cast<const float*>(lse), dq, dk, dv,
                 static_cast<float*>(delta), static_cast<float*>(dk_h), static_cast<float*>(dv_h),
                 B, Sq, Skv, H, KVH, H / KVH, q_offset, causal, window, 64 * skip_key_tiles,
                 scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (Sq == 0) {  // no query: dK and dV are zero
    const int dtype_size = bf16 ? 2 : 4;
    cudaMemsetAsync(dk, 0, (size_t)B * Skv * KVH * Dh * dtype_size, s);
    cudaMemsetAsync(dv, 0, (size_t)B * Skv * KVH * Dh * dtype_size, s);
    return (int)cudaGetLastError();
  }
  return (int)(bf16 ? launch_all<__nv_bfloat16>(Dh, p, s) : launch_all<float>(Dh, p, s));
}

// The wgmma route: bf16 q, k, v, out, dout, dq, dk, dv as above, at Dh 64 or
// 128 and a group G = H / KVH of at most 8 (a portable cluster); lse (B, H, Sq)
// float32.  Scratch, float32: lse2 and delta (B, H, sq_pad) and the dQ
// accumulator (B, H, sq_pad, Dh), sq_pad = Sq rounded up to 64.
// skip_key_tiles: 0 (a planted fault masks the first this-many 64-key
// tiles); drop_rank: -1 (a planted fault leaves that query head of each
// group out of dK and dV).
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* out, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, void* scratch, int B,
                                         int Sq, int Skv, int H, int KVH, int Dh, int q_offset,
                                         int causal, int window, int skip_key_tiles,
                                         int drop_rank, float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (KVH == 0 || H % KVH || H / KVH > 8 || (Dh != 64 && Dh != 80 && Dh != 128))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Sq == 0) {  // no query: dK and dV are zero
    const size_t bytes = (size_t)B * Skv * KVH * Dh * sizeof(__nv_bfloat16);
    cudaMemsetAsync(dk, 0, bytes, s);
    cudaMemsetAsync(dv, 0, bytes, s);
    return (int)cudaGetLastError();
  }
  const Params p{q, k, v, out, dout, static_cast<const float*>(lse), dq, dk, dv,
                 nullptr, nullptr, nullptr,
                 B, Sq, Skv, H, KVH, H / KVH, q_offset, causal, window, 64 * skip_key_tiles,
                 scale};
  const int sq_pad = (Sq + 63) / 64 * 64;
  float* f = static_cast<float*>(scratch);
  const long long rows = (long long)B * H * sq_pad;
  const wg::Extra x{f, f + rows, f + 2 * rows, sq_pad, drop_rank};
  switch (Dh) {
    case 64: return wg::launch<64>(p, x, s);
    case 80: return wg::launch<80>(p, x, s);
    default: return wg::launch<128>(p, x, s);
  }
}
