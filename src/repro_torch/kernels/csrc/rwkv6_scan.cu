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
// cores: the read S^T r is 2 K V, the update diag(w) S + k v^T 3 K V, and
// the bonus factors out as v_t (sum_k r_k u_k k_k), a scalar a step.  This
// kernel forms u k v^T per element instead (7 K V a step); the scalar form
// is a lever for the redesign.
//
// Design (a simple one that is right first).  Column v of S evolves on its
// own: the update needs w_t[k], k_t[k] and v_t[v], and y_t[v] sums over k
// only.  So a block takes one (head, batch row) and kCols columns of S, and
// kSplit = 8 lanes of one warp share each column, lane ks holding rows
// k = i kSplit + ks (i < K / kSplit) in registers; y_t[v] is their sum,
// by three xor-shuffles.  At the prefill shape that is 32 x 4 x 4 = 512
// blocks of 128 threads, about four to an SM, where one block per (b, h)
// would give 128 on 132 SMs.  Blocks never talk: each reads its columns of
// state0 before the time loop and writes them after it.  r, k, w (all K
// rows) and v (the block's columns) are staged in shared memory as float32
// for kTile steps at a time; rows are read with k = i kSplit + ks, so a
// warp's eight row lanes fall in eight banks and its four columns share
// them by broadcast.  y of a tile is gathered in shared memory and stored
// row by row.  The chunked tensor-core form with per-block renormalisation
// (rwkv6_scan.py:6-10), TMA staging and a split over time are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;   // time steps staged a pass
constexpr int kSplit = 8;   // lanes sharing one column of S

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
  long long rs_b, rs_t, rs_h, rs_k;
  long long ks_b, ks_t, ks_h, ks_k;
  long long vs_b, vs_t, vs_h, vs_v;
  long long ws_b, ws_t, ws_h, ws_k;
};

template <int K>
struct Shape {
  static constexpr int V = K;
  static constexpr int kCols = V < 16 ? V : 16;  // columns of S a block
  static constexpr int kThreads = kCols * kSplit;
  static constexpr int R = K / kSplit;  // rows of S a thread
};

template <int K>
struct Smem {
  float r[kTile][K];
  float k[kTile][K];
  float w[kTile][K];
  float v[kTile][Shape<K>::kCols];
  float y[kTile][Shape<K>::kCols];
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

template <typename T, int K>
__global__ void __launch_bounds__(Shape<K>::kThreads) rwkv6_scan_kernel(Params p) {
  using S_ = Shape<K>;
  constexpr int V = S_::V, kCols = S_::kCols, kThreads = S_::kThreads, R = S_::R;
  static_assert(K % kSplit == 0 && kThreads % 32 == 0, "K is 8, 16, 32 or 64");
  __shared__ Smem<K> s;

  const int h = blockIdx.x, bi = blockIdx.y, v0 = blockIdx.z * kCols;
  const int tid = threadIdx.x, ks = tid % kSplit, col = tid / kSplit;
  const long long st = ((long long)bi * p.H + h) * K * V + v0 + col;

  float S[R], u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = i * kSplit + ks;
    S[i] = p.s0 ? p.s0[st + (long long)row * V] : 0.f;
    u[i] = p.u[h * K + row];
  }

  const T* rb = static_cast<const T*>(p.r) + bi * p.rs_b + h * p.rs_h;
  const T* kb = static_cast<const T*>(p.k) + bi * p.ks_b + h * p.ks_h;
  const T* wb = static_cast<const T*>(p.w) + bi * p.ws_b + h * p.ws_h;
  const T* vb = static_cast<const T*>(p.v) + bi * p.vs_b + h * p.vs_h + v0 * p.vs_v;
  T* yb = static_cast<T*>(p.y) + ((long long)bi * p.T * p.H + h) * V + v0;
  const long long y_row = (long long)p.H * V;

  for (int t0 = 0; t0 < p.T; t0 += kTile) {
    const int len = min(kTile, p.T - t0);

    // Stage the tile as float32; rows t >= len are left unread.
    for (int i = tid; i < len * K; i += kThreads) {
      const int t = i / K, c = i % K;
      const long long tt = t0 + t;
      s.r[t][c] = to_f32(rb[tt * p.rs_t + c * p.rs_k]);
      s.k[t][c] = to_f32(kb[tt * p.ks_t + c * p.ks_k]);
      s.w[t][c] = to_f32(wb[tt * p.ws_t + c * p.ws_k]);
    }
    for (int i = tid; i < len * kCols; i += kThreads) {
      const int t = i / kCols, c = i % kCols;
      s.v[t][c] = to_f32(vb[(t0 + t) * p.vs_t + c * p.vs_v]);
    }
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      const float vt = s.v[t][col];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = i * kSplit + ks;
        const float kv = s.k[t][row] * vt;
        acc = fmaf(s.r[t][row], fmaf(u[i], kv, S[i]), acc);  // the state before the step
        S[i] = fmaf(s.w[t][row], S[i], kv);
      }
#pragma unroll
      for (int off = kSplit / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (ks == 0) s.y[t][col] = acc;
    }
    __syncthreads();

    for (int i = tid; i < len * kCols; i += kThreads) {
      const int t = i / kCols, c = i % kCols;
      yb[(t0 + t) * y_row + c] = from_f32<T>(s.y[t][c]);
    }
    // The next tile's staging writes r, k, w and v only; its steps write y
    // after the barrier that follows the staging, when these reads are done.
  }

#pragma unroll
  for (int i = 0; i < R; ++i) p.s_out[st + (long long)(i * kSplit + ks) * V] = S[i];
}

template <typename T, int K>
int launch(const Params& p, int B, void* stream) {
  using S_ = Shape<K>;
  const dim3 grid(p.H, B, S_::V / S_::kCols);
  rwkv6_scan_kernel<T, K><<<grid, S_::kThreads, 0, (cudaStream_t)stream>>>(p);
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

}  // namespace

// r, k, w (B, T, H, K) and v (B, T, H, V = K): bf16 (is_bf16 nonzero) or
// float32, any strides (in elements); u (H, K) and s0 (B, H, K, V, or null)
// contiguous float32; y (B, T, H, V) contiguous in r's type; s_out
// (B, H, K, V) contiguous float32, which may be s0 itself (each block reads
// its columns of s0 before its time loop and writes them after it).  K is
// 8, 16, 32 or 64.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* y, void* s_out,
                              int is_bf16, int B, int T, int H, int K,
                              long long rs_b, long long rs_t, long long rs_h, long long rs_k,
                              long long ks_b, long long ks_t, long long ks_h, long long ks_k,
                              long long vs_b, long long vs_t, long long vs_h, long long vs_v,
                              long long ws_b, long long ws_t, long long ws_h, long long ws_k,
                              void* stream) {
  if (B == 0 || H == 0) return 0;
  const Params p{r, k, v, w, static_cast<const float*>(u), static_cast<const float*>(s0), y,
                 static_cast<float*>(s_out), T, H,
                 rs_b, rs_t, rs_h, rs_k, ks_b, ks_t, ks_h, ks_k,
                 vs_b, vs_t, vs_h, vs_v, ws_b, ws_t, ws_h, ws_k};
  return is_bf16 ? launch_shape<__nv_bfloat16>(p, B, K, stream)
                 : launch_shape<float>(p, B, K, stream);
}
