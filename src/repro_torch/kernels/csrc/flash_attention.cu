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
// the block's grid is (q tiles, H, B), so blocks run in parallel and nothing
// carries between them.  GQA reads K/V of head h / G in place: nothing is
// replicated.  Key tiles wholly above the causal diagonal or wholly outside
// the window are never loaded; only tiles that cross an edge are masked.
//
//  * bf16: 4 warps own a 64-row Q tile, 16 rows each.  K/V tiles of 64 keys
//    are staged in shared memory by cp.async, two stages deep, in rows padded
//    by 16 bytes so ldmatrix reads them without bank conflicts.  S = Q K^T
//    and O += P V run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//    float32 accumulate); P is rounded to bf16 for the second product, as
//    flash attention does, while the row sums l stay in float32.  The
//    online softmax (m, l) and O live in registers.
//  * float32: the reference's tolerance (2e-5) rules out TF32, so this path
//    stays on the CUDA cores: 128 threads own a 32-row Q tile (4 threads a
//    row), with Q, K, V and P in shared memory (rows padded against bank
//    conflicts) and every product an FMA in float32.
//
// wgmma, TMA and a producer warp are the later, faster design.
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

template <typename Kernel>
int launch(Kernel kernel, int smem, int q_tile, const Params& p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + q_tile - 1) / q_tile, p.H, p.B);
  kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(int bf16, const Params& p, void* stream) {
  if (bf16) return launch(flash_fwd_bf16<DH>, Bf16Tile<DH>::SMEM, Bf16Tile<DH>::BQ, p, stream);
  return launch(flash_fwd_f32<DH>, F32Tile<DH>::SMEM, F32Tile<DH>::BQ, p, stream);
}

}  // namespace

// q (B, Sq, H, Dh), k and v (B, Skv, KVH, Dh), out like q; all contiguous, of
// one type (bf16 when `bf16` is nonzero, else float32), 16-byte aligned.
// lse: null, or (B, H, Sq) float32 for each row's log-sum-exp.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int bf16, int B, int Sq, int Skv, int H, int KVH,
                                   int Dh, int q_offset, int causal, int window, float scale,
                                   void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const Params p{q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, H, KVH,
                 q_offset, causal, window, scale};
  switch (Dh) {
    case 64: return launch_dh<64>(bf16, p, stream);
    case 80: return launch_dh<80>(bf16, p, stream);
    case 128: return launch_dh<128>(bf16, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
