// RWKV-6 WKV recurrence, backward (K7b), written for Hopper (sm_90a).
//
// The reference has no TPU kernel for it: its gradient is autodiff through
// the oracle's lax.scan, src/repro/kernels/ref.py:58 (what
// repro.kernels.ops.rwkv6_scan runs off the TPU).  For K7's function
//
//     y_t = (S_{t-1} + u o (k_t v_t^T))^T r_t,   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// and the cotangents dy (B, T, H, V) and dS_T (of the final state), with dS
// the cotangent of S_t, this kernel computes per (b, h), going backwards:
//
//     dr_t = S_{t-1} dy_t + u o k_t (v_t . dy_t)
//     dk_t = dS v_t + u o r_t (v_t . dy_t)
//     dv_t = dS^T k_t + (sum_k r_t u k_t) dy_t
//     dw_t = rowsum(dS o S_{t-1})
//     du  += r_t o k_t (v_t . dy_t)
//     dS  <- diag(w_t) dS + r_t dy_t^T
//
// and dS_0, the cotangent of state0.  S and dS evolve row by row (row k
// depends on w[k], k[k] and r[k] alone), so dr, dk and dw are sums along a
// row and dv a sum along a column.
//
// dw needs S_{t-1} in the reverse sweep.  It is not recovered from S_t by
// dividing by w_t, which can be ~0 (w = exp(-exp(w_raw))).  Instead:
//
//  1. a forward pass steps S over the sequence, writes dr_t (which needs
//     S_{t-1} and nothing of dS) and keeps a checkpoint of S at the start
//     of every kT-step tile (float32 (B, H, T / kT, K, V), 33.5 MB at
//     rwkv6-1.6b's training shape B 2, T 1024, H 32; for one layer at a
//     time, freed after the call);
//  2. a reverse pass over the tiles: each tile's states are recomputed from
//     its checkpoint and written to a per-block float32 scratch (kT states,
//     512 KB a block at K 64), then its steps run in reverse, reading
//     S_{t-1} back.
//
// Design (the first, simple one): one block of 4 K threads per (head, batch
// row).  In the row layout thread (k, q) = (tid / 4, tid % 4) holds the
// columns q, q + 4, ... of row k of S and of dS in registers, so a row's
// sums take two shuffles; dv needs column sums, so the reverse pass also
// carries dS in the column layout (thread (v, q) holds rows q, q + 4, ... of
// column v), which is stepped from r, w and dy alone.  Tiles of kT steps of
// r, k, w, v and dy are staged as float32 in shared memory; v_t . dy_t and
// sum_k r u k a step are summed once a tile.  The scratch is private to each
// thread (it reads back what it wrote), so it needs no barrier.  du is
// summed over t in registers and over the batch rows by a second launch, in
// a fixed order: the result is the same bit for bit from run to run.  Every
// product and sum runs in float32; the outputs are rounded once, at the
// store.  BlinkDL's wkv6 CUDA backward is a known alternative design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;  // tile length (K7's)

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  const float* s0;     // nullptr: the state starts at 0
  const void* dy;      // (B, T, H, V) contiguous, r's type
  const float* ds_fin;  // nullptr: no cotangent on the final state
  void* dr;            // (B, T, H, K) contiguous, r's type; dk, dv, dw likewise
  void* dk;
  void* dv;
  void* dw;
  float* ds0;      // nullptr: not wanted
  float* ckpt;     // (B, H, nT, K, K): S entering every tile (each thread's own layout)
  float* tiles;    // (B, H, kT, K, K): the states of the tile in hand
  float* du_part;  // (B, H, K)
  int T, H, skip_tile, dw_fault;
  long long rs_b, rs_t, rs_h, rs_k, ks_b, ks_t, ks_h, ks_k;
  long long vs_b, vs_t, vs_h, vs_k, ws_b, ws_t, ws_h, ws_k;
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

// Sum over the 4 lanes of one row (or column) of the layout.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int K>
struct Tile {
  float r[kT][K], k[kT][K], w[kT][K], v[kT][K], dy[kT][K];
  float vdy[kT], ruk[kT], u[K];
};

template <typename T, int K>
__device__ void stage(Tile<K>& s, const Params& p, int bi, int h, int t0, int len, int tid,
                      bool with_ruk) {
  constexpr int NT = 4 * K;
  const T* r = static_cast<const T*>(p.r) + bi * p.rs_b + h * p.rs_h;
  const T* k = static_cast<const T*>(p.k) + bi * p.ks_b + h * p.ks_h;
  const T* v = static_cast<const T*>(p.v) + bi * p.vs_b + h * p.vs_h;
  const T* w = static_cast<const T*>(p.w) + bi * p.ws_b + h * p.ws_h;
  const T* dy = static_cast<const T*>(p.dy) + ((long long)bi * p.T * p.H + h) * K;
  const long long dy_row = (long long)p.H * K;
  for (int i = tid; i < kT * K; i += NT) {
    const int t = i / K, c = i % K, tt = t0 + t;
    const bool in = t < len;
    s.r[t][c] = in ? to_f32(r[tt * p.rs_t + c * p.rs_k]) : 0.f;
    s.k[t][c] = in ? to_f32(k[tt * p.ks_t + c * p.ks_k]) : 0.f;
    s.v[t][c] = in ? to_f32(v[tt * p.vs_t + c * p.vs_k]) : 0.f;
    s.w[t][c] = in ? to_f32(w[tt * p.ws_t + c * p.ws_k]) : 0.f;
    s.dy[t][c] = in ? to_f32(dy[tt * dy_row + c]) : 0.f;
  }
  __syncthreads();
  if (tid < kT) {
    float a = 0.f, b = 0.f;
    for (int c = 0; c < K; ++c) {
      a = fmaf(s.v[tid][c], s.dy[tid][c], a);
      if (with_ruk) b = fmaf(s.r[tid][c] * s.u[c], s.k[tid][c], b);
    }
    s.vdy[tid] = a;
    s.ruk[tid] = b;
  }
  __syncthreads();
}

template <typename T, int K>
__global__ void __launch_bounds__(4 * K) rwkv6_scan_bwd_kernel(Params p) {
  constexpr int NT = 4 * K, CPT = K / 4;
  static_assert(K % 8 == 0, "a block is whole warps");
  __shared__ Tile<K> s;

  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int kr = tid / 4, q = tid % 4;  // row layout: row kr, columns q + 4 j
  const int vc = kr;                    // column layout: column vc, rows q + 4 j
  const int steps = p.T, nT = (steps + kT - 1) / kT;
  const long long bh = (long long)bi * p.H + h, KK = (long long)K * K;
  const long long out_row = (long long)p.H * K;
  const long long out_base = (long long)bi * steps * out_row + (long long)h * K;
  float* ckpt = p.ckpt + bh * nT * KK;
  float* tiles = p.tiles + bh * kT * KK;
  if (tid < K) s.u[tid] = p.u[h * K + tid];

  // ---- pass 1: S forward, dr, a checkpoint at every tile's start
  float S[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) S[j] = p.s0 ? p.s0[bh * KK + kr * K + q + 4 * j] : 0.f;
  T* dr = static_cast<T*>(p.dr) + out_base;
  for (int ti = 0; ti < nT; ++ti) {
    const int t0 = ti * kT, len = min(kT, steps - t0);
#pragma unroll
    for (int j = 0; j < CPT; ++j) ckpt[((long long)ti * CPT + j) * NT + tid] = S[j];
    __syncthreads();  // the previous tile is done with the staging buffers
    stage<T, K>(s, p, bi, h, t0, len, tid, false);
    const float uk = s.u[kr];
    for (int t = 0; t < len; ++t) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) part = fmaf(S[j], s.dy[t][q + 4 * j], part);
      part = quad_sum(part);
      const float kk = s.k[t][kr], ww = s.w[t][kr];
      if (q == 0) dr[(t0 + t) * out_row + kr] = from_f32<T>(fmaf(uk * kk, s.vdy[t], part));
#pragma unroll
      for (int j = 0; j < CPT; ++j) S[j] = fmaf(ww, S[j], kk * s.v[t][q + 4 * j]);
    }
  }

  // ---- pass 2: the tiles in reverse; dk, dw, du (row layout), dv (column layout)
  float dSr[CPT], dSc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    dSr[j] = p.ds_fin ? p.ds_fin[bh * KK + kr * K + q + 4 * j] : 0.f;
    dSc[j] = p.ds_fin ? p.ds_fin[bh * KK + (q + 4 * j) * K + vc] : 0.f;
  }
  T* dk = static_cast<T*>(p.dk) + out_base;
  T* dv = static_cast<T*>(p.dv) + out_base;
  T* dw = static_cast<T*>(p.dw) + out_base;
  float du_acc = 0.f;
  for (int ti = nT - 1; ti >= 0; --ti) {
    const int t0 = ti * kT, len = min(kT, steps - t0);
    __syncthreads();
    stage<T, K>(s, p, bi, h, t0, len, tid, true);
    const float uk = s.u[kr];
    if (ti != p.skip_tile) {  // the planted fault leaves the last tile's states in place
#pragma unroll
      for (int j = 0; j < CPT; ++j) S[j] = ckpt[((long long)ti * CPT + j) * NT + tid];
      for (int t = 0; t < len; ++t) {
        const float kk = s.k[t][kr], ww = s.w[t][kr];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          tiles[((long long)t * CPT + j) * NT + tid] = S[j];
          S[j] = fmaf(ww, S[j], kk * s.v[t][q + 4 * j]);
        }
      }
    }
    float Sp[CPT], Sn[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) Sp[j] = tiles[((long long)(len - 1) * CPT + j) * NT + tid];
    for (int t = len - 1; t >= 0; --t) {
      if (t > 0) {  // the next step's S_{t-1}, in flight under this step
#pragma unroll
        for (int j = 0; j < CPT; ++j) Sn[j] = tiles[((long long)(t - 1) * CPT + j) * NT + tid];
      }
      const float rk = s.r[t][kr], kk = s.k[t][kr], ww = s.w[t][kr], vdy = s.vdy[t];
      float dwp = 0.f, dkp = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vj = s.v[t][q + 4 * j];
        // the planted fault reads S_t for S_{t-1}
        const float sp = p.dw_fault ? fmaf(ww, Sp[j], kk * vj) : Sp[j];
        dwp = fmaf(dSr[j], sp, dwp);
        dkp = fmaf(dSr[j], vj, dkp);
      }
      dwp = quad_sum(dwp);
      dkp = quad_sum(dkp);
      const float dyc = s.dy[t][vc];
      float dvp = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) dvp = fmaf(s.k[t][q + 4 * j], dSc[j], dvp);
      dvp = quad_sum(dvp);
      if (q == 0) {
        const long long o = (t0 + t) * out_row;
        dw[o + kr] = from_f32<T>(dwp);
        dk[o + kr] = from_f32<T>(fmaf(uk * rk, vdy, dkp));
        dv[o + vc] = from_f32<T>(fmaf(s.ruk[t], dyc, dvp));
        du_acc = fmaf(rk * kk, vdy, du_acc);
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        dSr[j] = fmaf(ww, dSr[j], rk * s.dy[t][q + 4 * j]);
        dSc[j] = fmaf(s.w[t][q + 4 * j], dSc[j], s.r[t][q + 4 * j] * dyc);
      }
      if (t > 0) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) Sp[j] = Sn[j];
      }
    }
  }
  if (p.ds0) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) p.ds0[bh * KK + kr * K + q + 4 * j] = dSr[j];
  }
  if (q == 0) p.du_part[bh * K + kr] = du_acc;
}

// du (H, K): the batch rows' partials summed in order.
__global__ void du_reduce(const float* du_part, float* du, int B, int HK) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HK) return;
  float acc = 0.f;
  for (int bi = 0; bi < B; ++bi) acc += du_part[(long long)bi * HK + i];
  du[i] = acc;
}

template <typename T, int K>
int launch(const Params& p, int B, float* du, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  rwkv6_scan_bwd_kernel<T, K><<<dim3(p.H, B), 4 * K, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int HK = p.H * K;
  du_reduce<<<(HK + 255) / 256, 256, 0, s>>>(p.du_part, du, B, HK);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shape(const Params& p, int B, int K, float* du, void* stream) {
  switch (K) {
    case 8: return launch<T, 8>(p, B, du, stream);
    case 16: return launch<T, 16>(p, B, du, stream);
    case 32: return launch<T, 32>(p, B, du, stream);
    case 64: return launch<T, 64>(p, B, du, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w (B, T, H, K), K = V in {8, 16, 32, 64}, bf16 (dims[0] nonzero)
// or float32, any strides (dims[5..20]: r's, k's, v's and w's b, t, h, k
// strides in elements); u (H, K) and s0 (B, H, K, K, or null) contiguous
// float32; dy (B, T, H, K) contiguous in r's type; ds_fin (B, H, K, K, or
// null) contiguous float32.  Outputs, all contiguous: dr, dk, dv, dw (B, T,
// H, K) in r's type, du (H, K) float32, ds0 (B, H, K, K, or null) float32.
// scratch: float32, B H K (ceil(T / 32) K + 32 K + 1) elements.  dims: is_bf16,
// B, T, H, K, the 16 strides, then skip_tile (-1; a planted fault: that
// tile's states are not recomputed) and dw_fault (0; a planted fault: dw
// reads S_t for S_{t-1}).
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, const void* dy, const void* ds_fin,
                              void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
                              void* scratch, const long long* dims, void* stream) {
  const int is_bf16 = (int)dims[0], B = (int)dims[1], T = (int)dims[2], H = (int)dims[3],
            K = (int)dims[4];
  if (B == 0 || H == 0 || T == 0) return 0;
  const long long* st = dims + 5;
  const long long nT = (T + kT - 1) / kT, KK = (long long)K * K, bh = (long long)B * H;
  float* ckpt = static_cast<float*>(scratch);
  float* tiles = ckpt + bh * nT * KK;
  float* du_part = tiles + bh * kT * KK;
  const Params p{r, k, v, w, static_cast<const float*>(u), static_cast<const float*>(s0), dy,
                 static_cast<const float*>(ds_fin), dr, dk, dv, dw, static_cast<float*>(ds0),
                 ckpt, tiles, du_part, T, H, (int)dims[21], (int)dims[22],
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                 st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15]};
  float* duf = static_cast<float*>(du);
  return is_bf16 ? launch_shape<__nv_bfloat16>(p, B, K, duf, stream)
                 : launch_shape<float>(p, B, K, duf, stream);
}
