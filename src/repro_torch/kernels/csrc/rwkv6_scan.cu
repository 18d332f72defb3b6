// RWKV-6 WKV recurrence (per-channel data-dependent decay), written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:58 (rwkv6_scan: a
// pallas_call over a (B, H, T / block_t) grid whose minor axis walks the
// time blocks in order, carrying the (K, V) state in VMEM scratch and
// stepping it with a loop over time inside each block).  For r, k, w
// (B, T, H, K), v (B, T, H, V) of one type (bf16 or float32), u (H, K)
// float32 and an optional state0 S (B, H, K, V) float32 it computes, per
// (b, h) and step t,
//
//     y_t = (S + u o (k_t v_t^T))^T r_t
//     S  <- diag(w_t) S + k_t v_t^T
//
// and returns y (B, T, H, V) in r's type (contiguous) and the final S
// (B, H, K, V) in float32.  Every product and sum runs in float32; y is
// rounded once, at the store.  w arrives in r's type, as the model rounds
// it (exp(-exp(w_raw)) cast to the compute dtype), and is widened here.
//
// r, k, v and w are read in place through their strides; the TPU version's
// transpose to (B, H, T, K) and its padding of T (w padded with ones) are
// gone: the last tile's steps t >= T are neither run nor written.
//
// What bounds it on this card: operations.  At rwkv6-1.6b's prefill shape
// (B 4, T 2048, H 32, K = V = 64, bf16) it reads r, k, v, w once and writes
// y once (33.5 MB each) and writes the state (2.1 MB): 0.051 ms at
// 3.35 TB/s.  The function needs 5 K V + O(K) float32 operations a step and
// (b, h), 5.45e9 in all, 0.081 ms at the float32 peak outside the tensor
// cores: the read S^T r is 2 K V, the update diag(w) S + k v^T 3 K V.
//
// Design.  The bonus is a scalar a step: u o (k v^T) read by r is
// v_t beta_t with beta_t = sum_k r_t[k] u[k] k_t[k], so
//
//     y_t[v] = sum_k S[k, v] r_t[k] + beta_t v_t[v]
//
// and a step costs 3 float32 instructions an element of S (an FFMA for the
// read, an FMUL and an FFMA for the update), beta_t one reduction a step
// shared by all columns.  A block takes one (head, batch row) and all of S;
// a thread holds 8 rows x 4 columns of it in registers: rows
// 4 ks .. 4 ks + 3 and K/2 + 4 ks .. K/2 + 4 ks + 3 for its row lane ks
// (KS = K / 8 lanes), columns 4 cg .. 4 cg + 3 for its column group cg
// (lane = cg KS + ks).  So every word of r, k and w read from shared memory
// serves 4 columns, read as 4-wide vectors (16 bytes in float32, 8 in
// bf16, widened in registers), a quarter-warp's eight row lanes on eight
// consecutive vectors.  At the prefill shape that is 128 blocks of 128
// threads on the 132 SMs, one warp to a scheduler, so no other warp hides
// a step's latency, and nothing in a step waits on another lane: each
// thread stores its 4 partial sums of y_t (one 16-byte store), and the
// tile's y is summed over the KS row lanes after the tile's steps, with the
// bonus, 4 columns a thread.  (Summing y_t by shuffles within the step put
// three shuffle latencies into every step.)  Tiles of kTile steps of r, k,
// w and v land in two slots by the copy engine: thread 0 issues one TMA
// load an operand through a 4-D tensor map over (K, H, T, B), completing on
// the slot's mbarrier, so tile i + 1 lands under tile i's steps; an operand
// whose K stride is not 1 or whose rows are not 16-byte aligned is copied
// element by element instead.  (Measured against the alternatives: 16-byte
// cp.async by every thread, and a bulk copy a row, spent far longer issuing
// the copies; widening bf16 tiles into a float32 buffer once cost what
// widening at each read costs; helper warps that stage and sum beside the
// stepping warps were slower, taking issue slots from them.)  Decode (T = 1,
// the state written over state0) takes its own kernel in the same layout, with
// nothing staged and no barrier: r, k, w and v read from global memory,
// beta and y_t summed by shuffles, the state read and written as 16-byte
// vectors.  The chunked tensor-core form with per-block renormalisation
// (rwkv6_scan.py:6-10) is later work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;   // time steps staged a pass
constexpr int kUnroll = 4;  // steps the compiler may interleave

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  const float* s0;  // nullptr: the state starts at 0
  void* y;
  float* s_out;
  int T, H;
  int vec;    // stage with 16-byte cp.async (unit K stride, rows 16-byte aligned)
  int s_vec;  // s0 and s_out start on 16-byte boundaries: state rows as vectors
  long long rs_b, rs_t, rs_h, rs_k;
  long long ks_b, ks_t, ks_h, ks_k;
  long long vs_b, vs_t, vs_h, vs_v;
  long long ws_b, ws_t, ws_h, ws_k;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive values from shared memory, widened to float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(void* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// A (kTile, K) box of one operand, global to shared, by the copy engine
// (TMA) through its 4-D map over (K, H, T, B), completing on bar.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, void* bar, int h,
                                         int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(h), "r"(t0), "r"(b)
      : "memory");
}

template <typename T, int K>
struct Layout {  // the block's shape and its dynamic shared memory, in bytes
  static constexpr int KS = K / 8;  // row lanes: 8 rows of S a thread
  static constexpr int CG = K / 4;  // column groups: 4 columns a thread
  static constexpr int NT = KS * CG < 32 ? 32 : KS * CG;  // threads (idle lanes when K < 32)
  static constexpr int kOperand = kTile * K * (int)sizeof(T);
  static constexpr int kRaw = 4 * kOperand;  // r, k, w, v of one tile as they land
  // Row-lane partial sums of y: (kTile, CG, KS + 1, 4) floats, a column
  // group's KS float4s padded by one, so that neighbouring groups fall in
  // other banks when the tile's y is summed.
  static constexpr int kGS = 4 * (KS + 1);
  static constexpr int kPartAt = 2 * kRaw;
  static constexpr int kBetaAt = kPartAt + kTile * CG * kGS * 4;
  static constexpr int kUAt = kBetaAt + kTile * 4;
  static constexpr int kBarAt = kUAt + K * 4;  // two mbarriers, one a slot
  static constexpr int kBytes = kBarAt + 16;
};

struct Maps {  // the four operands' tensor maps, in r, k, w, v order
  CUtensorMap op[4];
};

template <typename T, int K>
__global__ void __launch_bounds__(Layout<T, K>::NT)
    rwkv6_scan_kernel(Params p, const __grid_constant__ Maps maps) {
  using L = Layout<T, K>;
  constexpr int V = K, KS = L::KS, CG = L::CG, NT = L::NT, GS = L::kGS;
  constexpr int LPS = NT / kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem + L::kPartAt);   // row-lane partials of y
  float* sbeta = reinterpret_cast<float*>(smem + L::kBetaAt);  // (kTile,) the bonus scalars
  float* su = reinterpret_cast<float*>(smem + L::kUAt);        // (K,) u of this head
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + L::kBarAt);
  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x, ks = tid % KS;
  const bool active = tid < KS * CG;
  const int cg = active ? tid / KS : CG - 1;  // idle lanes mirror the last group
  const long long st = ((long long)bi * p.H + h) * K * V;  // (b, h)'s state
  for (int i = tid; i < K; i += NT) su[i] = p.u[h * K + i];
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // This thread's 8 rows x 4 columns of S: rows 4 ks + i (i < 4) and
  // K/2 + 4 ks + i - 4 (i >= 4), columns 4 cg + c.
  float S[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : K / 2) + 4 * ks + (i & 3);
#pragma unroll
    for (int c = 0; c < 4; ++c) S[i][c] = 0.f;
    if (p.s0 && p.s_vec) {
      const float4 s = load4(p.s0 + st + row * V + 4 * cg);
      S[i][0] = s.x, S[i][1] = s.y, S[i][2] = s.z, S[i][3] = s.w;
    } else if (p.s0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) S[i][c] = p.s0[st + row * V + 4 * cg + c];
    }
  }
  const T* src[4] = {static_cast<const T*>(p.r) + bi * p.rs_b + h * p.rs_h,
                     static_cast<const T*>(p.k) + bi * p.ks_b + h * p.ks_h,
                     static_cast<const T*>(p.w) + bi * p.ws_b + h * p.ws_h,
                     static_cast<const T*>(p.v) + bi * p.vs_b + h * p.vs_h};
  const long long s_t[4] = {p.rs_t, p.ks_t, p.ws_t, p.vs_t};
  const long long s_k[4] = {p.rs_k, p.ks_k, p.ws_k, p.vs_v};
  T* yb = static_cast<T*>(p.y) + ((long long)bi * p.T * p.H + h) * V;
  const long long y_row = (long long)p.H * V;
  const bool vec = p.vec != 0;
  const int ntiles = (p.T + kTile - 1) / kTile;
  auto slot = [&](int it) { return smem + (it & 1) * L::kRaw; };  // two slots, by parity
  auto tile_len = [&](int it) { return min(kTile, p.T - it * kTile); };
  // Tile it into its slot: four copy-engine transfers (one an operand)
  // issued by thread 0, completing on the slot's mbarrier; rows past T are
  // filled with zeros and never read.  Without 16-byte rows, element by
  // element by every thread.
  auto stage_tile = [&](int it) {
    if (it >= ntiles) return;
    T* dst = reinterpret_cast<T*>(slot(it));
    const int t0 = it * kTile, len = tile_len(it);
    if (vec) {
      if (tid == 0) {
        mbar_expect(&bar[it & 1], 4u * L::kOperand);
#pragma unroll
        for (int op = 0; op < 4; ++op)
          tma_tile(dst + op * kTile * K, &maps.op[op], &bar[it & 1], h, t0, bi);
      }
    } else {
#pragma unroll
      for (int op = 0; op < 4; ++op)
        for (int i = tid; i < len * K; i += NT)
          dst[op * kTile * K + i] = src[op][(t0 + i / K) * s_t[op] + (i % K) * s_k[op]];
    }
  };
  __syncthreads();  // the mbarriers are set up
  stage_tile(0);

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * kTile, len = tile_len(it);
    if (vec) mbar_wait(&bar[it & 1], (it >> 1) & 1);  // tile it has landed
    // Every thread is done with tile it - 1: its partials, its beta and its
    // slot, which tile it + 1 lands in now, under this tile's steps.
    __syncthreads();
    stage_tile(it + 1);
    // The tile where it landed: r, k, w, v, (kTile, K) each, in their type
    // (a bf16 vector is widened to float32 as it is read).
    const T* fr = reinterpret_cast<const T*>(slot(it));
    const T* fk = fr + kTile * K;
    const T* fw = fr + 2 * kTile * K;
    const T* fv = fr + 3 * kTile * K;
    {  // beta_t = sum_k r_t[k] u[k] k_t[k], LPS lanes a step, 4 partial sums a lane
      const int t = tid / LPS, piece = tid % LPS;
      constexpr int kRows = K / LPS;
      float b4[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < len) {
#pragma unroll
        for (int i = 0; i < kRows; i += 4) {
          const int c = piece * kRows + i;
          const float4 r4 = load4(fr + t * K + c), k4 = load4(fk + t * K + c);
          const float4 u4 = load4(su + c);
          b4[0] = fmaf(r4.x * u4.x, k4.x, b4[0]);
          b4[1] = fmaf(r4.y * u4.y, k4.y, b4[1]);
          b4[2] = fmaf(r4.z * u4.z, k4.z, b4[2]);
          b4[3] = fmaf(r4.w * u4.w, k4.w, b4[3]);
        }
      }
      float b = (b4[0] + b4[1]) + (b4[2] + b4[3]);
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1) b += __shfl_xor_sync(0xffffffffu, b, off);
      if (piece == 0 && t < len) sbeta[t] = b;
    }
    __syncthreads();  // beta is in place

    // The steps: each thread's share of y_t (its 4 columns summed over its 8
    // rows) goes to shared memory; no lane waits on another within a step.
    float* my_part = part + cg * GS + 4 * ks;
#pragma unroll kUnroll
    for (int t = 0; t < len; ++t) {
      const float4 ra = load4(fr + t * K + 4 * ks), rb = load4(fr + t * K + K / 2 + 4 * ks);
      const float4 ka = load4(fk + t * K + 4 * ks), kb = load4(fk + t * K + K / 2 + 4 * ks);
      const float4 wa = load4(fw + t * K + 4 * ks), wb = load4(fw + t * K + K / 2 + 4 * ks);
      const float4 v4 = load4(fv + t * K + 4 * cg);
      const float r8[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
      const float k8[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
      const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float vc[4] = {v4.x, v4.y, v4.z, v4.w};
      float acc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[c] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[c] = fmaf(S[i][c], r8[i], acc[c]);  // the state before
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) S[i][c] = fmaf(k8[i], vc[c], w8[i] * S[i][c]);
      }
      if (active) store4(my_part + t * CG * GS, make_float4(acc[0], acc[1], acc[2], acc[3]));
    }
    __syncthreads();

    // y of the tile: a column group's KS partials summed in row-lane order,
    // plus the bonus, 4 columns a store.
    for (int i = tid; i < len * CG; i += NT) {
      const int t = i / CG, g = i % CG;
      const float* pt = part + (t * CG + g) * GS;
      float4 y = load4(pt);
#pragma unroll
      for (int j = 1; j < KS; ++j) {
        const float4 q = load4(pt + 4 * j);
        y.x += q.x, y.y += q.y, y.z += q.z, y.w += q.w;
      }
      const float bt = sbeta[t];
      const float4 vt = load4(fv + t * K + 4 * g);
      y.x = fmaf(bt, vt.x, y.x), y.y = fmaf(bt, vt.y, y.y);
      y.z = fmaf(bt, vt.z, y.z), y.w = fmaf(bt, vt.w, y.w);
      store4(yb + (t0 + t) * y_row + 4 * g, y);
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = (i < 4 ? 0 : K / 2) + 4 * ks + (i & 3);
      float* dst = p.s_out + st + row * V + 4 * cg;
      if (p.s_vec) {
        store4(dst, make_float4(S[i][0], S[i][1], S[i][2], S[i][3]));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = S[i][c];
      }
    }
  }
}

// One step (T = 1, decode) in the same layout, with nothing staged: a
// thread reads its 8 rows of r, k, w and its 4 columns of v straight from
// global memory, beta and y_t are summed over the KS row lanes by shuffles,
// and no barrier is needed.
template <typename T>
__device__ __forceinline__ float4 load4_global(const T* p, long long stride, bool vec) {
  if (vec) return load4(p);
  return make_float4(to_f32(p[0]), to_f32(p[stride]), to_f32(p[2 * stride]),
                     to_f32(p[3 * stride]));
}

template <typename T, int K>
__global__ void __launch_bounds__(Layout<T, K>::NT) rwkv6_step_kernel(Params p) {
  using L = Layout<T, K>;
  constexpr int V = K, KS = L::KS, CG = L::CG;
  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x, ks = tid % KS;
  const bool active = tid < KS * CG;
  const int cg = active ? tid / KS : CG - 1;  // idle lanes mirror the last group
  const long long st = ((long long)bi * p.H + h) * K * V;
  const bool vec = p.vec != 0;
  const T* rb = static_cast<const T*>(p.r) + bi * p.rs_b + h * p.rs_h;
  const T* kb = static_cast<const T*>(p.k) + bi * p.ks_b + h * p.ks_h;
  const T* wb = static_cast<const T*>(p.w) + bi * p.ws_b + h * p.ws_h;
  const T* vb = static_cast<const T*>(p.v) + bi * p.vs_b + h * p.vs_h;
  float r8[8], k8[8], w8[8], u8[8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half * (K / 2) + 4 * ks;
    const float4 r4 = load4_global(rb + row * p.rs_k, p.rs_k, vec);
    const float4 k4 = load4_global(kb + row * p.ks_k, p.ks_k, vec);
    const float4 w4 = load4_global(wb + row * p.ws_k, p.ws_k, vec);
    const float4 u4 = load4_global(p.u + h * K + row, 1, false);  // u: any offset
    const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w};
    const float ww[4] = {w4.x, w4.y, w4.z, w4.w}, uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r8[4 * half + i] = rr[i], k8[4 * half + i] = kk[i];
      w8[4 * half + i] = ww[i], u8[4 * half + i] = uu[i];
    }
  }
  const float4 v4 = load4_global(vb + 4 * cg * p.vs_v, p.vs_v, vec);
  const float vc[4] = {v4.x, v4.y, v4.z, v4.w};
  float S[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : K / 2) + 4 * ks + (i & 3);
#pragma unroll
    for (int c = 0; c < 4; ++c) S[i][c] = 0.f;
    if (p.s0 && p.s_vec) {
      const float4 s = load4(p.s0 + st + row * V + 4 * cg);
      S[i][0] = s.x, S[i][1] = s.y, S[i][2] = s.z, S[i][3] = s.w;
    } else if (p.s0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) S[i][c] = p.s0[st + row * V + 4 * cg + c];
    }
  }
  float b = 0.f, acc[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) b = fmaf(r8[i] * u8[i], k8[i], b);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    acc[c] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[c] = fmaf(S[i][c], r8[i], acc[c]);  // the state before
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) S[i][c] = fmaf(k8[i], vc[c], w8[i] * S[i][c]);
  }
#pragma unroll
  for (int off = KS / 2; off > 0; off >>= 1) {
    b += __shfl_xor_sync(0xffffffffu, b, off);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  if (active && ks == 0) {
    T* yb = static_cast<T*>(p.y) + ((long long)bi * p.H + h) * V + 4 * cg;
    store4(yb, make_float4(fmaf(b, vc[0], acc[0]), fmaf(b, vc[1], acc[1]),
                           fmaf(b, vc[2], acc[2]), fmaf(b, vc[3], acc[3])));
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = (i < 4 ? 0 : K / 2) + 4 * ks + (i & 3);
      float* dst = p.s_out + st + row * V + 4 * cg;
      if (p.s_vec) {
        store4(dst, make_float4(S[i][0], S[i][1], S[i][2], S[i][3]));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = S[i][c];
      }
    }
  }
}

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

// One operand (B, T, H, K) with unit K stride, as a 4-D map over (K, H, T, B)
// (strides in elements), boxes of (K, 1, kTile, 1), not swizzled: a box lands
// as a dense (kTile, K) tile.
template <typename T, int K>
int encode(CUtensorMap* map, const void* ptr, int B, int T_, int H, long long s_b, long long s_t,
           long long s_h) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)K, (cuuint64_t)H, (cuuint64_t)T_, (cuuint64_t)B};
  const cuuint64_t strides[3] = {s_h * e, s_t * e, s_b * e};
  const cuuint32_t box[4] = {(cuuint32_t)K, 1, (cuuint32_t)kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int K>
int launch(const Params& p, int B, void* stream) {
  auto kern = rwkv6_scan_kernel<T, K>;
  constexpr int smem = Layout<T, K>::kBytes;
  constexpr int nt = Layout<T, K>::NT;
  if (p.T == 1) {
    rwkv6_step_kernel<T, K><<<dim3(p.H, B), nt, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
  }
  if constexpr (smem > 48 * 1024) {
    static bool configured = false;  // set once a process
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
  }
  Maps maps = {};
  if (p.vec && p.T > 0) {
    int err = encode<T, K>(&maps.op[0], p.r, B, p.T, p.H, p.rs_b, p.rs_t, p.rs_h);
    if (!err) err = encode<T, K>(&maps.op[1], p.k, B, p.T, p.H, p.ks_b, p.ks_t, p.ks_h);
    if (!err) err = encode<T, K>(&maps.op[2], p.w, B, p.T, p.H, p.ws_b, p.ws_t, p.ws_h);
    if (!err) err = encode<T, K>(&maps.op[3], p.v, B, p.T, p.H, p.vs_b, p.vs_t, p.vs_h);
    if (err) return err;
  }
  kern<<<dim3(p.H, B), nt, smem, (cudaStream_t)stream>>>(p, maps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shape(const Params& p, int B, int K, void* stream) {
  switch (K) {
    case 8: return launch<T, 8>(p, B, stream);
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr, long long s_b, long long s_t, long long s_h, long long s_k,
               int esz) {
  return ((uintptr_t)ptr % 16) == 0 && s_k == 1 && (s_b * esz) % 16 == 0 &&
         (s_t * esz) % 16 == 0 && (s_h * esz) % 16 == 0;
}

}  // namespace

// r, k, w (B, T, H, K) and v (B, T, H, V = K): bf16 or float32, any strides
// (in elements); u (H, K) and s0 (B, H, K, V, or null) contiguous float32;
// y (B, T, H, V) contiguous in r's type; s_out (B, H, K, V) contiguous
// float32, which may be s0 itself (each block reads its (b, h) state before
// its time loop and writes it after).  K is 8, 16, 32 or 64.  dims: is_bf16,
// B, T, H, K, then the strides of r, k, v and w, four each in (b, t, h, k)
// order.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* y, void* s_out,
                              const long long* dims, void* stream) {
  const int is_bf16 = (int)dims[0], B = (int)dims[1], T = (int)dims[2], H = (int)dims[3],
            K = (int)dims[4];
  if (B == 0 || H == 0) return 0;
  const long long* s = dims + 5;
  const int esz = is_bf16 ? 2 : 4;
  const int vec = aligned16(r, s[0], s[1], s[2], s[3], esz) &&
                  aligned16(k, s[4], s[5], s[6], s[7], esz) &&
                  aligned16(v, s[8], s[9], s[10], s[11], esz) &&
                  aligned16(w, s[12], s[13], s[14], s[15], esz);
  const Params p{r, k, v, w, static_cast<const float*>(u), static_cast<const float*>(s0), y,
                 static_cast<float*>(s_out), T, H, vec,
                 (int)(((uintptr_t)s0 | (uintptr_t)s_out) % 16 == 0),
                 s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                 s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15]};
  return is_bf16 ? launch_shape<__nv_bfloat16>(p, B, K, stream)
                 : launch_shape<float>(p, B, K, stream);
}
