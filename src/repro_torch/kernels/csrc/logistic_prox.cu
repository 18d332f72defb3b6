// The whole Algorithm-7 loop on the logistic oracle, one launch for a sweep
// batch, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/logistic_prox.py:64
// (logistic_prox_gd_batched).  Row r of the batch owns label-signed client
// rows A_r = y * Z_m, shape (n, d), a prox target z_r and a start x0_r
// (y0_r, or z_r), and runs num_steps of
//
//     t = A_r x;  u = 0.5 (tanh(-t / 2) + 1);  g = -(A_r^T u) / n + lam x
//     x <- x - beta_r (g + (x - z_r) * inv_eta_r)
//
// The TPU kernel keeps a trial's whole A resident in VMEM across the steps
// (logistic_prox.py:20-23).  At a9a size that is 2000 x 123 x 8 B = 1.97 MB
// per trial in float64, far above the 227 KB of shared memory a Hopper block
// can hold, so that design does not carry over.
//
// Design: one block per row, looping over all num_steps inside the kernel.
// x (d values), u (n values: 16 KB at n = 2000 in float64) and the column
// partial sums live in shared memory; A is streamed from L2 and device memory
// twice per step.
//   * t = A x: one warp per row, lanes striding along d (coalesced), then a
//     warp-shuffle reduction; lane 0 writes u[i].
//   * A^T u: threads own columns and loop over rows, so neighbouring threads
//     read neighbouring addresses of one row.  The block's threads form
//     `groups` row groups of ceil32(d) column lanes each; their partial sums
//     are added in shared memory by the first group, which also applies the
//     update to x.
// tanh/tanhf are the accurate library functions (no --use_fast_math): the
// reference tolerance is rtol 1e-12 in float64.  Ragged n and d are handled
// by bounds checks; 1/n uses the true n.
//
// What bounds it on this card: with B = 16 rows only 16 of the 132 SMs hold a
// block, and each block re-reads its A 2 * num_steps times, so a step costs
// two latency-bound passes over 2 MB from one SM.  The bytes bound (A read
// once) and the operations bound (4 n d per step) are both about 10 us for the
// whole batch at the main path's shapes; this kernel is far from either.  The
// redesign: split n across a thread-block cluster and reduce the (d,) partial
// gradient through distributed shared memory, or keep A in shared memory as
// reduced-precision tiles.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float tanh_t(float v) { return tanhf(v); }
__device__ __forceinline__ double tanh_t(double v) { return tanh(v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) logistic_prox_gd_kernel(
    const T* __restrict__ A, const T* __restrict__ z, const T* __restrict__ x0,
    const T* __restrict__ beta, const T* __restrict__ inv_eta, T lam,
    int n, int d, int num_steps, long long s_stride, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x = reinterpret_cast<T*>(smem_raw);  // (d,) current iterate
  T* u = x + d;                           // (n,) sigmoid of minus-margins
  T* part = u + n;                        // (kThreads,) column partial sums

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* Ar = A + (long long)r * n * d;
  const T* zr = z + (long long)r * d;
  const T* x0r = x0 + (long long)r * d;
  const T b = beta[r * s_stride];
  const T ie = inv_eta[r * s_stride];
  const T nn = (T)n;

  // Column lanes per row group (a multiple of 32, at most the block) and the
  // number of row groups the block splits the A^T u reduction into.
  const int cpad = min(((d + 31) / 32) * 32, kThreads);
  const int groups = kThreads / cpad;
  const int grp = tid / cpad;
  const int col = tid - grp * cpad;

  for (int j = tid; j < d; j += kThreads) x[j] = x0r[j];
  __syncthreads();

  for (int s = 0; s < num_steps; ++s) {
    for (int i = warp; i < n; i += kWarps) {
      const T* row = Ar + (long long)i * d;
      T acc = 0;
      for (int j = lane; j < d; j += 32) acc += row[j] * x[j];
      acc = warp_sum(acc);
      if (lane == 0) u[i] = (T)0.5 * (tanh_t((T)-0.5 * acc) + (T)1);
    }
    __syncthreads();

    for (int j0 = 0; j0 < d; j0 += cpad) {
      if (grp < groups) {
        const int j = j0 + col;
        T acc = 0;
        if (j < d) {
          for (int i = grp; i < n; i += groups) acc += u[i] * Ar[(long long)i * d + j];
        }
        part[grp * cpad + col] = acc;
      }
      __syncthreads();
      const int jj = j0 + tid;
      if (tid < cpad && jj < d) {
        T gsum = 0;
        for (int k = 0; k < groups; ++k) gsum += part[k * cpad + tid];
        const T xj = x[jj];
        const T g = -gsum / nn + lam * xj;
        x[jj] = xj - b * (g + (xj - zr[jj]) * ie);
      }
      __syncthreads();
    }
  }

  for (int j = tid; j < d; j += kThreads) out[(long long)r * d + j] = x[j];
}

template <typename T>
int launch(const void* A, const void* z, const void* x0, const void* beta,
           const void* inv_eta, double lam, long long rows, long long n,
           long long d, long long num_steps, long long s_stride, void* out,
           void* stream) {
  if (rows == 0 || d == 0) return 0;
  const size_t smem = (size_t)(d + n + kThreads) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        logistic_prox_gd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  logistic_prox_gd_kernel<T><<<(unsigned)rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)z, (const T*)x0, (const T*)beta, (const T*)inv_eta, (T)lam,
      (int)n, (int)d, (int)num_steps, s_stride, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int logistic_prox_gd_batched_f32(
    const void* A, const void* z, const void* x0, const void* beta, const void* inv_eta,
    double lam, long long rows, long long n, long long d, long long num_steps,
    long long s_stride, void* out, void* stream) {
  return launch<float>(A, z, x0, beta, inv_eta, lam, rows, n, d, num_steps, s_stride, out, stream);
}

extern "C" int logistic_prox_gd_batched_f64(
    const void* A, const void* z, const void* x0, const void* beta, const void* inv_eta,
    double lam, long long rows, long long n, long long d, long long num_steps,
    long long s_stride, void* out, void* stream) {
  return launch<double>(A, z, x0, beta, inv_eta, lam, rows, n, d, num_steps, s_stride, out, stream);
}
