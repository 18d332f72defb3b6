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
// Design.  The TPU's sequential kv grid axis becomes a loop inside one block;
// blocks run in parallel and nothing carries between them.  GQA reads K/V of
// head h / G in place: nothing is replicated.  Key tiles wholly above the
// causal diagonal or wholly outside the window are never loaded; only tiles
// that cross an edge are masked.  Three routes, chosen by dtype and Dh alone
// (launch_dh):
//
//  * bf16 at Dh 64 and 128 (flash_fwd_wgmma, namespace wg): a persistent
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
//    already is the A-operand layout, and O += P V is wgmma with A from
//    registers and V as an MN-major (transposed) B operand.  A consumer
//    takes one key tile at a time; the two consumers are not synchronised
//    with each other, so one's products run while the other computes its
//    softmax.  Tensor maps are 4-D over (Dh, heads, S, B) with 128-byte
//    swizzle, boxes of (64, 1, rows, 1), so a Dh-128 row is two boxes and a
//    ragged Sq or Skv tail is filled with zeros instead of read from the
//    next sequence.  The maps are encoded on the host for every call (a
//    few microseconds; the tensors' addresses change from call to call, so
//    a cache would not hit), with cuTensorMapEncodeTiled looked up through
//    the CUDA runtime.
//    The softmax is not overlapped with the products inside a consumer.
//    Issuing S of tile i with P V of tile i-1 (FA3's schedule) measured no
//    faster in any form tried: with P in registers, ptxas allocates a
//    three-warpgroup kernel's registers within 168 a thread whatever
//    setmaxnreg grants, so S, P and O of 128-key tiles do not fit together
//    (it spills and serialises the products), and at 64-key tiles it moves
//    the P V wait above the softmax to reuse P's registers; with P staged
//    through shared memory it ran no faster either.  A ping-pong between
//    the two consumers and 3 or 4 stages changed little.
//  * bf16 at Dh 80 (flash_fwd_bf16, Zamba2's shared block): a Dh-80 row is
//    not a whole number of 128-byte boxes, so it keeps the first design.  4
//    warps own a 64-row Q tile, 16 rows each.  K/V tiles of 64 keys are
//    staged in shared memory by cp.async, two stages deep, in rows padded by
//    16 bytes so ldmatrix reads them without bank conflicts.  S = Q K^T and
//    O += P V run on the tensor cores as mma.sync m16n8k16 (bf16 in, float32
//    accumulate).
//  * float32: the reference's tolerance (2e-5) rules out TF32, so this path
//    stays on the CUDA cores: 128 threads own a 32-row Q tile (4 threads a
//    row), with Q, K, V and P in shared memory (rows padded against bank
//    conflicts) and every product an FMA in float32.
//
// On both bf16 routes P is rounded to bf16 for the second product, as flash
// attention does, while the row sums l stay in float32.
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

// ------------------------------------------------------ bf16: tensor cores
template <int DH>
struct Bf16Tile {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
  static constexpr int LD = DH + 8;  // padded row, in bf16 elements
  static constexpr int CHUNKS = DH / 8;  // 16-byte chunks per row
  static constexpr int SMEM = (BQ + 4 * BK) * LD * 2;  // Q, then K and V in two stages
};

template <int DH>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  using T = Bf16Tile<DH>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD, CHUNKS = T::CHUNKS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LD;  // stage s at sK + s * BK * LD
  __nv_bfloat16* sV = sK + 2 * BK * LD;

  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = iq * BQ;
  const int rows = min(BQ, p.Sq - q0);
  const int first = q0 + p.q_offset, last = q0 + rows - 1 + p.q_offset;

  const long long q_stride = (long long)p.H * DH, kv_stride = (long long)p.KVH * DH;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v);
  const __nv_bfloat16* qb = qg + (long long)b * p.Sq * q_stride + (long long)h * DH;
  const __nv_bfloat16* kb = kg + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;
  const __nv_bfloat16* vb = vg + (long long)b * p.Skv * kv_stride + (long long)kvh * DH;

  int lo, hi;
  key_tiles(p, first, last, BK, lo, hi);

  for (int i = tid; i < BQ * CHUNKS; i += T::THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = r < rows;
    cp_async16(sQ + r * LD + c * 8, ok ? qb + (q0 + r) * q_stride + c * 8 : qg, ok);
  }
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BK;
    __nv_bfloat16* dk = sK + stage * BK * LD;
    __nv_bfloat16* dv = sV + stage * BK * LD;
    for (int i = tid; i < BK * CHUNKS; i += T::THREADS) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool ok = k0 + r < p.Skv;
      const long long off = (k0 + r) * kv_stride + c * 8;
      cp_async16(dk + r * LD + c * 8, ok ? kb + off : kg, ok);
      cp_async16(dv + r * LD + c * 8, ok ? vb + off : vg, ok);
    }
  };
  if (lo <= hi) load_kv(lo, 0);
  cp_async_commit();

  // This thread holds rows g and g + 8 of its warp's 16, columns 2t and 2t + 1
  // of every 8-wide tile (the mma accumulator layout).
  const int g = lane >> 2, t = lane & 3;
  const int pos[2] = {q0 + warp * 16 + g + p.q_offset, q0 + warp * 16 + g + 8 + p.q_offset};
  const float sl2 = p.scale * kLog2e;

  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = lo; kt <= hi; ++kt) {
    const int stage = (kt - lo) & 1;
    if (kt < hi) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == lo) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* cK = sK + stage * BK * LD;
    const __nv_bfloat16* cV = sV + stage * BK * LD;

    // S = Q K^T (raw scores; the scale is folded into the exponent below)
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; nt += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, cK + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            (((lane >> 3) & 1) << 3));
        mma_bf16(s[nt], qf[kk], kf[0], kf[1]);
        mma_bf16(s[nt + 1], qf[kk], kf[2], kf[3]);
      }
    }

    const int k0 = kt * BK;
    const bool masked = tile_needs_mask(p, k0, BK, first, last);
    if (masked) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!allowed(p, pos[j >> 1], k0 + nt * 8 + 2 * t + (j & 1))) s[nt][j] = kNegInf;
    }

    // Online softmax: the 4 threads of a quad share a row.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * sl2);
      m[r] = mx[r];
    }
    uint32_t pf[BK / 16][4];  // P as the A operand of P V
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[j] = exp2f((s[nt][j] - mx[j >> 1]) * sl2);
        if (masked && s[nt][j] == kNegInf) e[j] = 0.f;
      }
      rs[0] += e[0] + e[1];
      rs[1] += e[2] + e[3];
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(e[0], e[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(e[2], e[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < DH / 8; dt += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, cV + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                                  dt * 8 + ((lane >> 4) << 3));
        mma_bf16(o[dt], pf[kk], vf[0], vf[1]);
        mma_bf16(o[dt + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + (long long)b * p.Sq * q_stride +
                      (long long)h * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row >= rows) continue;
    if (p.lse && t == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + q0 + row] = m[r] * p.scale + logf(fmaxf(l[r], 1e-30f));
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = ob + (q0 + row) * q_stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
  }
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

// ------------------------------------- bf16 at Dh 64 and 128: wgmma + TMA
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
// Q once the tile's last S is.
namespace wg {

constexpr int BM = 128, BN = 128, kStages = 2;
// Two consumer warpgroups (threads 0-255), then the producer warpgroup.
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 40 + 2 * 232 <= 512 per lane
constexpr int kBox = 64;  // bf16 of one 128-byte swizzled box row

template <int DH>
struct Smem {
  static constexpr int Q = 0;  // each tile: DH / 64 column blocks of (rows, 64) bf16
  static constexpr int K = Q + BM * DH * 2;
  static constexpr int V = K + kStages * BN * DH * 2;
  static constexpr int BAR = V + kStages * BN * DH * 2;
  static constexpr int TILE_BYTES = BN * DH * 2;  // one K or V tile
  // q_full, q_empty, then k_full, v_full, k_empty and v_empty for each
  // stage; + 1024 to align
  static constexpr int BYTES = BAR + (2 + 4 * kStages) * 8 + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the phase of parity `parity` to complete.  A wait that lasts
// ~10 s (a lost arrival) traps, so a fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from moving accesses to an accumulator across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B for a 64 x 128 tile, k 16: A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B for a 64 x 64 tile, k 16: A in registers, B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n64_mn(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for a 64 x 128 tile, k 16: A in registers, B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n128_mn(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void pv_product(float (&o)[DH / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv_product<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n64_mn(o, a, db);
}
template <>
__device__ __forceinline__ void pv_product<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n128_mn(o, a, db);
}

// Keep the bf16 P fragments alive (their registers reserved) until the
// product that reads them has completed.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// S = Q K^T for this consumer's 64 rows and one 128-key tile: k steps of
// 16 along Dh, 32 bytes apart within a 128-byte box row, the next box
// BM (Q) or BN (K) rows of 128 bytes on.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss_m64n128(s, desc(q_rows + (kk >> 2) * BM * 128 + off, 16, 1024),
                     desc(k_tile + (kk >> 2) * BN * 128 + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V: k steps of 16 keys, 16 rows (2048 bytes) down the V tile; V's
// Dh column blocks are BN * 128 bytes apart (the MN-major leading offset).
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2], const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    pv_product<DH>(o, pa[kk], desc(v_tile + kk * 16 * 128, BN * 128, 1024));
  wgmma_commit();
}

// 2^x by the SFU (MUFU.EX2, ~2 ulp, subnormal results flushed to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
  constexpr int COLS = DH / kBox;
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
          tma_load_4d(sQ + c * BM * 128, &tm_q, q_full, c * kBox, wt.h, wt.q0, wt.b);
        for (int kt = wt.lo; kt <= wt.hi; ++kt, ++it) {
          const int s = it % kStages;
          const uint32_t free_phase = ((it / kStages) & 1) ^ 1;  // round 0 passes at once
          mbar_wait(k_empty + 8 * s, free_phase);
          mbar_expect_tx(k_full + 8 * s, L::TILE_BYTES);
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            tma_load_4d(sK + s * L::TILE_BYTES + c * BN * 128, &tm_k, k_full + 8 * s, c * kBox,
                        wt.kvh, kt * BN, wt.b);
          mbar_wait(v_empty + 8 * s, free_phase);
          mbar_expect_tx(v_full + 8 * s, L::TILE_BYTES);
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            tma_load_4d(sV + s * L::TILE_BYTES + c * BN * 128, &tm_v, v_full + 8 * s, c * kBox,
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
    const uint32_t q_rows = sQ + w * 64 * 128;
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

// ---------------------------------------------------- host: tensor maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up at run time through the CUDA runtime, so
// the library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, S, heads, DH) bf16 tensor as a 4-D map over (DH, heads, S, B): boxes
// of (64, 1, rows, 1), 128-byte swizzled.  Rows past S (a ragged tail) are
// filled with zeros, never read from the next sequence.
int encode(CUtensorMap* map, const void* ptr, int dh, int heads, int seq, int batch, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t rows_total = seq > 0 ? seq : 1;  // an empty sequence is never read
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, rows_total, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {dh * e, (cuuint64_t)heads * dh * e, rows_total * heads * dh * e};
  const cuuint32_t box[4] = {(cuuint32_t)wg::kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH>
int launch(const Params& p, int skip_last, void* stream) {
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, p.q, DH, p.H, p.Sq, p.B, BM);
  if (!err) err = encode(&tk, p.k, DH, p.KVH, p.Skv, p.B, BN);
  if (!err) err = encode(&tv, p.v, DH, p.KVH, p.Skv, p.B, BN);
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

// The route: bf16 at Dh 64 and 128 takes the wgmma + TMA kernel, bf16 at Dh
// 80 the mma.sync kernel (a Dh-80 row is not a whole number of 128-byte
// swizzled boxes), float32 the FMA kernel.  It depends on dtype and Dh
// alone; a launch that fails returns its error and is never retried on
// another route.
template <int DH>
int launch_dh(int bf16, const Params& p, int skip_last, void* stream) {
  if constexpr (DH % 64 == 0) {
    if (bf16) return wg::launch<DH>(p, skip_last, stream);
  } else {
    if (bf16) return launch(flash_fwd_bf16<DH>, Bf16Tile<DH>::SMEM, Bf16Tile<DH>::BQ, p, stream);
  }
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
