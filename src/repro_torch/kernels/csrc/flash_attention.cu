// Flash attention forward (causal, sliding-window or non-causal GQA),
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:105
// (flash_attention: a pallas_call over a (B, H, q_blocks, kv_blocks) grid
// whose minor kv axis carries the online-softmax state (m, l, acc) in VMEM
// scratch, with blocks strictly above the causal diagonal skipped).  For
// q (B, Sq, H, Dh) and k, v (B, Skv, KVH, Dh) it computes
//
//     out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(Dh)) v[b, j, h / G]
//
// over the keys j that the mask allows for query row i at absolute position
// i + q_offset: j < Skv, and j <= i + q_offset when causal, and
// i + q_offset - j < window when a sliding window is given.  The softmax is
// taken in float32; the output has q's type; a row with no allowed key is 0
// (the Pallas kernel's acc / max(l, 1e-30)).  When `lse` is not null it also
// writes each row's log-sum-exp of the scaled scores, lse[b, h, i] (float32,
// natural log), which the backward (flash_attention_bwd.cu) recomputes P
// from; a row with no allowed key gets a large negative finite value there.
//
// What bounds it on this card: operations.  At the main path's prefill
// (bf16, B = 4, S = 2048, H = 24, Dh = 128, causal) the two products are
// 4 B H S^2 Dh / 2 = 1.03e11 operations, 0.10 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 50 MB of q, k, v and out (15 us at 3.35 TB/s).
//
// At Zamba2's prefill (bf16, B 4, S 2048, 32/32 heads, Dh 80, causal) the
// products are 8.6e10 operations, 0.087 ms at the bf16 peak.
//
// Design.  The TPU's sequential kv grid axis becomes a loop inside one block;
// blocks run in parallel and nothing carries between them.  GQA reads K/V of
// head h / G in place: nothing is replicated.  Key tiles wholly above the
// causal diagonal or wholly outside the window are never loaded; only tiles
// that cross an edge are masked.  Two routes, chosen by dtype alone
// (launch_dh):
//
//  * bf16 at Dh 64, 80 and 128 (flash_fwd_wgmma, namespace wg): a persistent
//    grid, one CTA of three warpgroups per SM, walks 128-row q tiles of
//    every (b, h), longest first, dealt to the CTAs in a snake so each
//    gets about the mean number of key tiles.  Warpgroup 2 is the producer:
//    it gives up registers (setmaxnreg 40) and one thread issues TMA loads,
//    each tile's Q and K, V tiles of 128 keys into a two-stage ring guarded
//    by mbarriers (a full and an empty barrier for each of Q, K and V); the
//    ring runs on across tiles and the next tile's Q loads once the last S
//    of the current one is issued, so a tile's loads overlap the previous
//    tile's tail and epilogue.  Warpgroups 0 and 1 (setmaxnreg 232) own 64
//    rows each: S = Q K^T is wgmma m64n128k16 with both operands in shared
//    memory, K-major; the online softmax runs on the float32 accumulators
//    in registers (masked scores are -inf, exponentials by the SFU's ex2);
//    P is rounded to bf16 in registers, where the accumulator layout
//    already is the A-operand layout, and O += P V is wgmma m64n{Dh}k16
//    with A from registers and V as an MN-major (transposed) B operand.  A
//    consumer takes one key tile at a time; the two consumers are not
//    synchronised with each other, so one's products run while the other
//    computes its softmax.  Tensor maps are 4-D over (Dh, heads, S, B),
//    boxes of (BW, 1, rows, 1): 64 columns with the 128-byte swizzle at Dh
//    64 and 128 (a Dh-128 row is two boxes), 16 columns with the 32-byte
//    swizzle at Dh 80 (a 160-byte row is not whole 128-byte boxes, so it is
//    five 32-byte ones, and each k16 step of S is one box), as K4b tiles
//    them (Boxes in wgmma_tma.cuh, shared by both); a ragged Sq or Skv tail
//    is filled with zeros instead of read from the next sequence.  The maps
//    are encoded on the host for every call (a few microseconds; the
//    tensors' addresses change from call to call, so a cache would not
//    hit), with cuTensorMapEncodeTiled looked up through the CUDA runtime.
//    The softmax is not overlapped with the products inside a consumer.
//    Issuing S of tile i with P V of tile i-1 (FA3's schedule) measured no
//    faster in any form tried: with P in registers, ptxas allocates a
//    three-warpgroup kernel's registers within 168 a thread whatever
//    setmaxnreg grants, so S, P and O of 128-key tiles do not fit together
//    (it spills and serialises the products), and at 64-key tiles it moves
//    the P V wait above the softmax to reuse P's registers; with P staged
//    through shared memory it ran no faster either.  A ping-pong between
//    the two consumers and 3 or 4 stages changed little.  P is rounded to
//    bf16 for the second product, as flash attention does, while the row
//    sums l stay in float32.
//  * float32: the reference's tolerance (2e-5) rules out TF32, so this path
//    stays on the CUDA cores: 128 threads own a 32-row Q tile (4 threads a
//    row), with Q, K, V and P in shared memory (rows padded against bank
//    conflicts) and every product an FMA in float32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF: finite, so m - m never NaNs
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) or null
  int B, Sq, Skv, H, KVH;
  int q_offset, causal, window;  // window 0: none
  float scale;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ bool allowed(const Params& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || qpos >= kpos) && (p.window == 0 || qpos - kpos < p.window);
}

// Key tiles [lo, hi] that rows at absolute positions [first, last] can see.
__device__ __forceinline__ void key_tiles(const Params& p, int first, int last, int bk,
                                          int& lo, int& hi) {
  hi = (p.Skv + bk - 1) / bk - 1;
  if (p.causal) hi = min(hi, floor_div(last, bk));
  lo = p.window > 0 ? max(0, floor_div(first - p.window + 1, bk)) : 0;
}

// Whether some (row, key) pair of the tile starting at key k0 is masked.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int k0, int bk, int first,
                                                int last) {
  return k0 + bk > p.Skv || (p.causal && k0 + bk - 1 > first) ||
         (p.window > 0 && k0 <= last - p.window);
}

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------- float32: CUDA cores
template <int DH>
struct F32Tile {
  static constexpr int BQ = 32, BK = 32, THREADS = 128;
  static constexpr int LDQ = DH + 1, LDK = DH + 1, LDV = DH, LDP = BK + 1;
  static constexpr int SMEM = (BQ * LDQ + BK * LDK + BK * LDV + BQ * LDP) * 4;
};

template <int DH>
__global__ void __launch_bounds__(128) flash_fwd_f32(Params p) {
  using T = F32Tile<DH>;
  constexpr int BQ = T::BQ, BK = T::BK, LDQ = T::LDQ, LDK = T::LDK, LDV = T::LDV, LDP = T::LDP;
  extern __shared__ float fsm[];
  float* sQ = fsm;
  float* sK = sQ + BQ * LDQ;
  float* sV = sK + BK * LDK;
  float* sP = sV + BK * LDV;

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x;
  const int q0 = iq * BQ;
  const int rows = min(BQ, p.Sq - q0);
  const int first = q0 + p.q_offset, last = q0 + rows - 1 + p.q_offset;
  const long long q_stride = (long long)p.H * DH, kv_stride = (long long)p.KVH * DH;
  const float* qb = static_cast<const float*>(p.q) + (long long)b * p.Sq * q_stride + (long long)h * DH;
  const float* kb = static_cast<const float*>(p.k) + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;
  const float* vb = static_cast<const float*>(p.v) + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;

  int lo, hi;
  key_tiles(p, first, last, BK, lo, hi);

  for (int i = tid; i < BQ * DH; i += T::THREADS) {  // q * scale, as the Pallas kernel scales q
    const int r = i / DH, d = i % DH;
    sQ[r * LDQ + d] = r < rows ? qb[(q0 + r) * q_stride + d] * p.scale : 0.f;
  }

  // Thread = (row r, column group c): keys c + 4j of the tile, dims c + 4j of the output.
  const int r = tid >> 2, c = tid & 3;
  const int qpos = q0 + r + p.q_offset;
  float acc[DH / 4];
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q written; the previous tile's K, V and P consumed
    for (int i = tid; i < BK * DH; i += T::THREADS) {
      const int kr = i / DH, d = i % DH;
      const bool ok = k0 + kr < p.Skv;
      sK[kr * LDK + d] = ok ? kb[(k0 + kr) * kv_stride + d] : 0.f;
      sV[kr * LDV + d] = ok ? vb[(k0 + kr) * kv_stride + d] : 0.f;
    }
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float* qr = sQ + r * LDQ;
      const float* kr = sK + (c + 4 * j) * LDK;
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) a = fmaf(qr[d], kr[d], a);
      s[j] = a;
    }
    const bool masked = tile_needs_mask(p, k0, BK, first, last);
    if (masked) {
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        if (!allowed(p, qpos, k0 + c + 4 * j)) s[j] = kNegInf;
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) mx = fmaxf(mx, s[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float e = masked && s[j] == kNegInf ? 0.f : expf(s[j] - mx);
      sP[r * LDP + c + 4 * j] = e;
      rs += e;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * corr + rs;
    __syncwarp();  // a row's P is written by the 4 threads of one warp
#pragma unroll
    for (int j = 0; j < DH / 4; ++j) acc[j] *= corr;
#pragma unroll 4
    for (int kr = 0; kr < BK; ++kr) {
      const float pk = sP[r * LDP + kr];
#pragma unroll
      for (int j = 0; j < DH / 4; ++j) acc[j] = fmaf(pk, sV[kr * LDV + c + 4 * j], acc[j]);
    }
  }

  if (r < rows) {
    if (p.lse && c == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + q0 + r] = m + logf(fmaxf(l, 1e-30f));
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* dst = static_cast<float*>(p.o) + (long long)b * p.Sq * q_stride + (long long)h * DH +
                 (q0 + r) * q_stride;
#pragma unroll
    for (int j = 0; j < DH / 4; ++j) dst[c + 4 * j] = acc[j] * inv;
  }
}

// ---------------------------------------- bf16 at Dh 64, 80 and 128: wgmma + TMA
//
// A CTA of three warpgroups of 128 threads works on one 128-row Q tile at a
// time.  Warpgroup 2 is the producer: it lowers its registers to 40 with
// setmaxnreg and one of its threads issues every TMA load (a tile's Q, then
// its K and V tiles into a ring of kStages stages).  Warpgroups 0 and 1 are
// consumers, 64 query rows each: S = Q K^T as wgmma from shared memory
// (both operands K-major), the online softmax in registers, P rounded to
// bf16 in registers as the A operand of O += P V, V read MN-major (the
// transposed B operand bf16 allows).  Q, K and V each have a full barrier
// (per stage), which carries the TMA byte count, and an empty barrier,
// which takes all 256 consumer threads' arrivals before the producer
// refills it: a K slot frees as soon as S is computed, a V slot once P V is,
// Q once the tile's last S is.  Rows are tiled in boxes by head dim
// (Boxes<DH>): 64 columns with the 128-byte swizzle at Dh 64 and 128, 16
// columns with the 32-byte swizzle at Dh 80, so every k16 step of S lies in
// one box and O += P V is one m64n{DH}k16 product a step.
namespace wg {

#include "wgmma_tma.cuh"

constexpr int BM = 128, BN = 128, kStages = 2;
// Two consumer warpgroups (threads 0-255), then the producer warpgroup.
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 40 + 2 * 232 <= 512 per lane

template <int DH>
struct Smem {
  static constexpr int Q = 0;  // each tile: Boxes<DH>::COLS boxes of (rows, BW) bf16, swizzled
  static constexpr int K = Q + BM * DH * 2;
  static constexpr int V = K + kStages * BN * DH * 2;
  static constexpr int BAR = V + kStages * BN * DH * 2;
  static constexpr int TILE_BYTES = BN * DH * 2;  // one K or V tile
  // q_full, q_empty, then k_full, v_full, k_empty and v_empty for each
  // stage; + 1024 to align
  static constexpr int BYTES = BAR + (2 + 4 * kStages) * 8 + 1024;
  static_assert(BM * DH * 2 % 1024 == 0 && TILE_BYTES % 1024 == 0,
                "tiles keep the swizzle's alignment");
};

// d (+)= A B for a 64 x 128 tile, k 16: A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS32 ", "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S = Q K^T for this consumer's 64 rows and one 128-key tile: k steps of
// 16 along Dh, each inside one box (32 bytes into a 128-byte box row, or a
// whole 32-byte one); box c of a tile lies c * rows * RB bytes on.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t q_rows, uint32_t k_tile) {
  using X = Boxes<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int box = kk * 16 / X::BW, in = (kk * 16 % X::BW) * 2;
    wgmma_ss_m64n128(s, desc(q_rows + box * BM * X::RB + in, 16, 8 * X::RB, X::MODE),
                     desc(k_tile + box * BN * X::RB + in, 16, 8 * X::RB, X::MODE), kk > 0);
  }
  wgmma_commit();
}

// O += P V: k steps of 16 keys, 16 box rows down the V tile; V's boxes are
// BN rows apart (the MN-major leading offset).
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2], const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_tile) {
  using X = Boxes<DH>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    rs_product<DH>(o, pa[kk], desc(v_tile + kk * 16 * X::RB, BN * X::RB, 8 * X::RB, X::MODE));
  wgmma_commit();
}

constexpr float kMasked = -__builtin_huge_valf();  // a masked score: exp gives exactly 0

// The online softmax of one tile of raw scores s (this thread's rows 0 and
// 1 at absolute positions pos), in place: s becomes exp(scale (s - m_new));
// m moves to the new row maxima; corr is exp(scale (m_old - m_new)) and rs
// the tile's row sums (this thread's columns; the quad sums them at the end).
// Masked scores are -inf.  A row that has seen no key yet keeps m = -inf and
// takes its exponents against 0 instead, so its scores give exp(-inf) = 0:
// one select a row, not a compare a score.
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[BN / 2], float (&m)[2],
                                             float (&corr)[2], float (&rs)[2], const int (&pos)[2],
                                             int k0, int t, bool masked, float sl2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!allowed(p, pos[e >> 1], k0 + 8 * j + 2 * t + (e & 1))) s[4 * j + e] = kMasked;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mb[r] = mx[r] == kMasked ? 0.f : mx[r] * sl2;
    corr[r] = ex2(fmaf(m[r], sl2, -mb[r]));  // 0 while the row has seen no key (l, O are 0)
    m[r] = mx[r];
    rs[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = ex2(fmaf(s[4 * j + e], sl2, -mb[e >> 1]));
      s[4 * j + e] = v;
      rs[e >> 1] += v;
    }
}

// P as the A operand of P V: the accumulator layout of S already is the
// register layout of A, two 8-wide blocks to a k step of 16.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4], const float (&s)[BN / 2]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// A work tile: one 128-row q tile of one (b, h).  Tiles are numbered with
// the q tile slowest and taken in order, so the causal rows that see the
// most keys come first.
struct WorkTile {
  int b, h, kvh, q0, rows, first, last, lo, hi;
};

__device__ __forceinline__ WorkTile work_tile(const Params& p, int tile, int skip_last) {
  WorkTile w;
  const int nq = (p.Sq + BM - 1) / BM;
  const int iq = nq - 1 - tile / (p.H * p.B);
  const int rest = tile % (p.H * p.B);
  w.h = rest % p.H;
  w.b = rest / p.H;
  w.kvh = w.h / (p.H / p.KVH);
  w.q0 = iq * BM;
  w.rows = min(BM, p.Sq - w.q0);
  w.first = w.q0 + p.q_offset;
  w.last = w.q0 + w.rows - 1 + p.q_offset;
  key_tiles(p, w.first, w.last, BN, w.lo, w.hi);
  w.hi -= skip_last;  // a planted fault only (0 in every real run)
  return w;
}

// Round r of a persistent grid hands CTA c the tile r G + c, or r G + G - 1 - c
// on odd rounds: the longest-first tiles dealt in a snake, so every CTA's
// sum of key tiles stays near the mean (at the Llama shape the busiest CTA
// gets 100 key tiles against a mean of 98.9; dealt in order, 106).
__device__ __forceinline__ int snake_tile(int r, int c) {
  return r * (int)gridDim.x + ((r & 1) ? (int)gridDim.x - 1 - c : c);
}

// Persistent: one CTA per SM walks its work tiles (snake_tile).  The K/V
// ring runs on across tiles, and the producer loads the next tile's Q as
// soon as both consumers have issued their last S of the current one, so
// the next tile's loads overlap this one's last P V and its epilogue.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const Params p, const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, int tiles, int skip_last) {
  using L = Smem<DH>;
  constexpr int BW = Boxes<DH>::BW, RB = Boxes<DH>::RB, COLS = Boxes<DH>::COLS;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024
  const uint32_t sQ = base + L::Q, sK = base + L::K, sV = base + L::V;
  const uint32_t q_full = base + L::BAR, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages, v_empty = k_empty + 8 * kStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumers);
      mbar_init(v_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {  // one thread issues every load
      int it = 0;  // position in the K/V ring, across tiles
      for (int r = 0, n = 0; r * (int)gridDim.x < tiles; ++r) {
        const int tile = snake_tile(r, blockIdx.x);
        if (tile >= tiles) continue;  // the last round is short
        const WorkTile wt = work_tile(p, tile, skip_last);
        mbar_wait(q_empty, (n++ & 1) ^ 1);  // the previous tile's last S is issued
        mbar_expect_tx(q_full, BM * DH * 2);
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          tma_load_4d(sQ + c * BM * RB, &tm_q, q_full, c * BW, wt.h, wt.q0, wt.b);
        for (int kt = wt.lo; kt <= wt.hi; ++kt, ++it) {
          const int s = it % kStages;
          const uint32_t free_phase = ((it / kStages) & 1) ^ 1;  // round 0 passes at once
          mbar_wait(k_empty + 8 * s, free_phase);
          mbar_expect_tx(k_full + 8 * s, L::TILE_BYTES);
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            tma_load_4d(sK + s * L::TILE_BYTES + c * BN * RB, &tm_k, k_full + 8 * s, c * BW,
                        wt.kvh, kt * BN, wt.b);
          mbar_wait(v_empty + 8 * s, free_phase);
          mbar_expect_tx(v_full + 8 * s, L::TILE_BYTES);
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            tma_load_4d(sV + s * L::TILE_BYTES + c * BN * RB, &tm_v, v_full + 8 * s, c * BW,
                        wt.kvh, kt * BN, wt.b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = threadIdx.x;
    const int w = ct >> 7;  // consumer warpgroup: rows 64 w .. 64 w + 63 of the tile
    const int lane = ct & 31, warp = (ct >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    // This thread holds rows r0 and r0 + 8 of the tile, columns 8 j + 2 t (+1)
    // of every 8-wide block j (the wgmma accumulator layout).
    const int r0 = w * 64 + warp * 16 + g;
    const float sl2 = p.scale * kLog2e;
    const uint32_t q_rows = sQ + w * 64 * RB;
    const long long q_stride = (long long)p.H * DH;
    float o[DH / 2], s[BN / 2], corr[2], rs[2];
    uint32_t pa[BN / 16][4];
    int it = 0;
    for (int r = 0, n = 0; r * (int)gridDim.x < tiles; ++r, ++n) {
      const int tile = snake_tile(r, blockIdx.x);
      if (tile >= tiles) break;  // the last round is short
      const WorkTile wt = work_tile(p, tile, skip_last);
      const int pos[2] = {wt.q0 + r0 + p.q_offset, wt.q0 + r0 + 8 + p.q_offset};
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

      // One key tile at a time: S = Q K^T, its softmax, O += P V.  The two
      // consumers' products and softmaxes interleave on the SM.
      mbar_wait(q_full, n & 1);
      if (wt.lo > wt.hi) mbar_arrive(q_empty);  // no key tile: Q is not read
      for (int kt = wt.lo; kt <= wt.hi; ++kt, ++it) {
        const int st = it % kStages;
        const uint32_t phase = (it / kStages) & 1;
        mbar_wait(k_full + 8 * st, phase);
        fence_regs(s);
        wgmma_fence();
        issue_qk<DH>(s, q_rows, sK + st * L::TILE_BYTES);
        wgmma_wait<0>();
        fence_regs(s);
        mbar_arrive(k_empty + 8 * st);
        if (kt == wt.hi) mbar_arrive(q_empty);  // the producer may load the next Q
        softmax_tile(p, s, m, corr, rs, pos, kt * BN, t,
                     tile_needs_mask(p, kt * BN, BN, wt.first, wt.last), sl2);
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
        pack_p(pa, s);
        mbar_wait(v_full + 8 * st, phase);
        fence_regs(o);
        wgmma_fence();
        issue_pv<DH>(o, pa, sV + st * L::TILE_BYTES);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(v_empty + 8 * st);
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + (long long)wt.b * p.Sq * q_stride +
                          (long long)wt.h * DH;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= wt.rows) continue;
        if (p.lse && t == 0)  // a row with no key: the first design's finite sentinel
          p.lse[((long long)wt.b * p.H + wt.h) * p.Sq + wt.q0 + row] =
              (m[r] == kMasked ? kNegInf : m[r]) * p.scale + logf(fmaxf(l[r], 1e-30f));
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* dst = ob + (wt.q0 + row) * q_stride + 2 * t;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------- host
template <int DH>
int launch(const Params& p, int skip_last, void* stream) {
  CUtensorMap tq, tk, tv;
  constexpr int bw = Boxes<DH>::BW;
  int err = encode(&tq, p.q, DH, p.H, p.Sq, p.B, BM, bw);
  if (!err) err = encode(&tk, p.k, DH, p.KVH, p.Skv, p.B, BN, bw);
  if (!err) err = encode(&tv, p.v, DH, p.KVH, p.Skv, p.B, BN, bw);
  if (err) return err;
  const int smem = Smem<DH>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((p.Sq + BM - 1) / BM) * p.H * p.B;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(tiles < sms ? tiles : sms);  // one CTA an SM (its shared memory)
  flash_fwd_wgmma<DH><<<grid, kThreads, smem, (cudaStream_t)stream>>>(p, tq, tk, tv, (int)tiles,
                                                                       skip_last);
  return (int)cudaGetLastError();
}

}  // namespace wg

template <typename Kernel>
int launch(Kernel kernel, int smem, int q_tile, const Params& p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + q_tile - 1) / q_tile, p.H, p.B);
  kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The route: bf16 takes the wgmma + TMA kernel, float32 the FMA kernel.  It
// depends on dtype alone; a launch that fails returns its error and is
// never retried on another route.
template <int DH>
int launch_dh(int bf16, const Params& p, int skip_last, void* stream) {
  if (bf16) return wg::launch<DH>(p, skip_last, stream);
  return launch(flash_fwd_f32<DH>, F32Tile<DH>::SMEM, F32Tile<DH>::BQ, p, stream);
}

}  // namespace

// q (B, Sq, H, Dh), k and v (B, Skv, KVH, Dh), out like q; all contiguous, of
// one type (bf16 when `bf16` is nonzero, else float32), 16-byte aligned.
// lse: null, or (B, H, Sq) float32 for each row's log-sum-exp.  skip_last:
// 0, or a planted fault: the wgmma route drops that many last key tiles.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int bf16, int B, int Sq, int Skv, int H, int KVH,
                                   int Dh, int q_offset, int causal, int window, int skip_last,
                                   float scale, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const Params p{q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, H, KVH,
                 q_offset, causal, window, scale};
  switch (Dh) {
    case 64: return launch_dh<64>(bf16, p, skip_last, stream);
    case 80: return launch_dh<80>(bf16, p, skip_last, stream);
    case 128: return launch_dh<128>(bf16, p, skip_last, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
