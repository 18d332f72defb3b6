// Single-token decode attention against a KV cache, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:62
// (decode_attention: a pallas_call over a (B, H, S / block_s) grid whose minor
// axis streams the cache through VMEM carrying (m, l, acc) in scratch).  For
// q (B, 1, H, Dh), caches k, v (B, S, KVH, Dh) and a validity vector
// valid (S,) shared by the batch it computes
//
//     out[b, 0, h] = softmax_s(q[b, 0, h] . k[b, s, h / G] / sqrt(Dh) | valid[s]) v[b, s, h / G]
//
// in float32, with the output in q's type.  q and the caches may differ in
// type (bf16 or float32 each): the serving engine keeps a float32 cache
// beside bf16 activations.  A row with no valid key gives 0.
//
// What bounds it on this card: bytes.  Every valid cache row is read once
// (2 * B * KVH * Dh * itemsize bytes per valid position) for 4 * H * Dh
// operations per batch row and position, far below the ~20 float32
// operations per byte at which the CUDA cores would bound it.  At
// B = 8, S = 4096, KVH = 8, Dh = 128 in float32 that is 268 MB, 80 us at
// 3.35 TB/s.
//
// Design: one block of 8 warps per (kv head, batch row); the G query heads
// that share the kv head share one pass over the cache, so each cache row is
// read from memory once.  Each half-warp is one stream: its 16 lanes split a
// cache row (Dh / 16 values each, vector loads), take U rows per step with
// all loads issued before any use, reduce the G dot products by shuffles
// inside the half-warp and keep its own online softmax (m, l, acc) in
// registers.  Rows whose valid bit is clear are never loaded.  At the end
// the two half-warps merge by shuffles and the 8 warps through shared
// memory.  With B * KVH blocks the cache read is spread over at most that
// many SMs (64 at the shape above); a split over S with a combine pass is
// the later design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kWarps = 8, kThreads = 32 * kWarps, kStreams = 2 * kWarps;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* valid;
  void* o;
  int S, H, KVH;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive values from src (aligned to N * sizeof(T) where vectorised) as float32.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* src, float (&dst)[N]) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + i);
      dst[i] = x.x, dst[i + 1] = x.y, dst[i + 2] = x.z, dst[i + 3] = x.w;
    }
  } else if constexpr (sizeof(T) == 2 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(src + i);
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
      const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
      dst[i] = __low2float(a), dst[i + 1] = __high2float(a);
      dst[i + 2] = __low2float(c), dst[i + 3] = __high2float(c);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f32(src[i]);
  }
}

template <typename TQ, typename TC, int DH, int GMAX>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Params p) {
  constexpr int EPL = DH / 16;            // values of a row per lane
  constexpr int U = GMAX <= 4 ? 4 : 2;    // rows per stream per step
  __shared__ float s_m[kWarps][GMAX], s_l[kWarps][GMAX];
  __shared__ float s_acc[kWarps][GMAX][DH];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = p.H / p.KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int stream = tid >> 4, li = tid & 15;
  const unsigned hmask = (lane < 16) ? 0x0000ffffu : 0xffff0000u;
  const int d0 = li * EPL;

  const TQ* qb = static_cast<const TQ*>(p.q) + ((long long)b * p.H + (long long)kvh * G) * DH + d0;
  const long long row_stride = (long long)p.KVH * DH;
  const TC* kb = static_cast<const TC*>(p.k) + ((long long)b * p.S * p.KVH + kvh) * DH + d0;
  const TC* vb = static_cast<const TC*>(p.v) + ((long long)b * p.S * p.KVH + kvh) * DH + d0;

  float q[GMAX][EPL], acc[GMAX][EPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf, l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) q[g][e] = acc[g][e] = 0.f;
    if (g < G) {
      load_row<TQ, EPL>(qb + g * DH, q[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) q[g][e] *= p.scale;  // q * scale, as the Pallas kernel
    }
  }

  for (int base = stream * U; base < p.S; base += kStreams * U) {
    float kr[U][EPL], vr[U][EPL];
    bool ok[U];
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = base + u;
      ok[u] = s < p.S && p.valid[s];
      any |= ok[u];
      if (ok[u]) {
        load_row<TC, EPL>(kb + s * row_stride, kr[u]);
        load_row<TC, EPL>(vb + s * row_stride, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
    if (!any) continue;  // uniform across the half-warp: its lanes read the same bits

#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a = fmaf(q[g][e], kr[u][e], a);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) a += __shfl_xor_sync(hmask, a, off, 16);
        sc[u] = ok[u] ? a : kNegInf;
      }
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u]);
      const float corr = expf(m[g] - mx);
      m[g] = mx;
      float pu[U], rs = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pu[u] = ok[u] ? expf(sc[u] - mx) : 0.f;
        rs += pu[u];
      }
      l[g] = l[g] * corr + rs;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(pu[u], vr[u][e], a);
        acc[g][e] = a;
      }
    }
  }
  __syncwarp();

  // Merge the warp's two streams, then the warps.
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    const float mo = __shfl_xor_sync(0xffffffffu, m[g], 16);
    const float lo = __shfl_xor_sync(0xffffffffu, l[g], 16);
    const float mx = fmaxf(m[g], mo);
    const float c1 = expf(m[g] - mx), c2 = expf(mo - mx);
    l[g] = l[g] * c1 + lo * c2;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      acc[g][e] = acc[g][e] * c1 + __shfl_xor_sync(0xffffffffu, acc[g][e], 16) * c2;
    m[g] = mx;
    if (lane < 16) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) s_acc[warp][g][d0 + e] = acc[g][e];
      if (li == 0) s_m[warp][g] = m[g], s_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  TQ* ob = static_cast<TQ*>(p.o) + ((long long)b * p.H + (long long)kvh * G) * DH;
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][g] - mx);
      lsum += s_l[w][g] * c;
      a += s_acc[w][g][d] * c;
    }
    ob[i] = from_f32<TQ>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename TQ, typename TC, int DH>
int launch_g(const Params& p, int B, void* stream) {
  const dim3 grid(p.KVH, B);
  if (p.H / p.KVH <= 4)
    decode_attention_kernel<TQ, TC, DH, 4><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    decode_attention_kernel<TQ, TC, DH, 8><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int launch_dh(const Params& p, int B, int Dh, void* stream) {
  switch (Dh) {
    case 64: return launch_g<TQ, TC, 64>(p, B, stream);
    case 80: return launch_g<TQ, TC, 80>(p, B, stream);
    case 128: return launch_g<TQ, TC, 128>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, 1, H, Dh) and out like q; k, v (B, S, KVH, Dh); valid (S,) bytes.
// q_bf16 / cache_bf16 pick bf16 (nonzero) or float32 for q and for the
// caches; all contiguous and 16-byte aligned; H / KVH <= 8.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, int q_bf16, int cache_bf16,
                                    int B, int S, int H, int KVH, int Dh, float scale,
                                    void* stream) {
  if (B == 0 || H == 0) return 0;
  const Params p{q, k, v, static_cast<const uint8_t*>(valid), out, S, H, KVH, scale};
  using bf = __nv_bfloat16;
  if (q_bf16)
    return cache_bf16 ? launch_dh<bf, bf>(p, B, Dh, stream) : launch_dh<bf, float>(p, B, Dh, stream);
  return cache_bf16 ? launch_dh<float, bf>(p, B, Dh, stream)
                    : launch_dh<float, float>(p, B, Dh, stream);
}
