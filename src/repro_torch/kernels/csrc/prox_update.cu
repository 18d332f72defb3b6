// Batched Algorithm-7 step for a sweep batch, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/prox_update.py:91
// (prox_update_batched, a pallas_call over a (B, row_blocks) grid with the
// per-trial scalars in a (B, 2) operand).  For every row r of R rows of d
// values it computes
//
//     out[r, j] = y[r, j] - lr[r] * (g[r, j] + (y[r, j] - z[r, j]) * inv_eta[r])
//
// What bounds it on this card: bytes.  It reads three operands and writes one
// (4 * R * d * itemsize bytes, plus the two per-row scalars) and does five
// operations per element, far below the H100's ~20 flop/byte balance point.
// At the main path's shapes (R = 16 trials, d = 40) that is 20 KB, a few
// nanoseconds at 3.35 TB/s, so in practice the launch itself bounds it.
//
// Design: one thread per element in a grid-stride loop; the row index
// i / d selects the row's (lr, inv_eta), read with stride 0 when the caller
// passes one scalar for all rows.  Each operation is rounded on its own
// (the _rn intrinsics are never contracted into an FMA), in the order of the
// plain PyTorch version, so the kernel and the plain version agree exactly.
// No shared memory and no tensor cores: the TPU's (8, 128) tiling has no
// counterpart here.  Fusing the quadratic
// gradient's batched matvec into this pass, or capturing the GD loop in a CUDA
// graph, is what would remove the launch cost.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void prox_update_batched_kernel(
    const T* __restrict__ y, const T* __restrict__ g, const T* __restrict__ z,
    const T* __restrict__ lr, const T* __restrict__ inv_eta,
    T* __restrict__ out, long long total, long long d, long long s_stride) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    const long long r = (i / d) * s_stride;
    const T yi = y[i];
    // y - lr * (g + (y - z) * inv_eta)
    out[i] = sub_rn(yi, mul_rn(lr[r], add_rn(g[i], mul_rn(sub_rn(yi, z[i]), inv_eta[r]))));
  }
}

template <typename T>
int launch(const void* y, const void* g, const void* z, const void* lr,
           const void* inv_eta, void* out, long long rows, long long d,
           long long s_stride, void* stream) {
  const long long total = rows * d;
  if (total == 0) return 0;
  constexpr int kThreads = 256;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  prox_update_batched_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)y, (const T*)g, (const T*)z, (const T*)lr, (const T*)inv_eta,
      (T*)out, total, d, s_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prox_update_batched_f32(const void* y, const void* g, const void* z,
                                       const void* lr, const void* inv_eta, void* out,
                                       long long rows, long long d, long long s_stride,
                                       void* stream) {
  return launch<float>(y, g, z, lr, inv_eta, out, rows, d, s_stride, stream);
}

extern "C" int prox_update_batched_f64(const void* y, const void* g, const void* z,
                                       const void* lr, const void* inv_eta, void* out,
                                       long long rows, long long d, long long s_stride,
                                       void* stream) {
  return launch<double>(y, g, z, lr, inv_eta, out, rows, d, s_stride, stream);
}
