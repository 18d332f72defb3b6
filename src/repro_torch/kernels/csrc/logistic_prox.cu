// The whole Algorithm-7 loop on the logistic oracle, one launch for a sweep
// batch, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/logistic_prox.py:64
// (logistic_prox_gd_batched).  Row r of the batch owns label-signed client
// rows A_r = y_m * Z_m (m = m[r], or A_r given already signed), shape (n, d),
// a prox target z_r and a start x0_r (y0_r, or z_r), and runs num_steps of
//
//     t = A_r x;  u = 0.5 (tanh(-t / 2) + 1);  g = -(A_r^T u) / n + lam x
//     x <- x - beta_r (g + (x - z_r) * inv_eta_r)
//
// The labels fold in as the rows are read (a = y_i Z_i, exact for y = +-1),
// so a sweep hands over Z, y and the sampled clients m and nothing is
// gathered or multiplied on the device before the launch.  With null y and
// m pointers the operand is A itself and row r reads A[r].
//
// What bounds it on this card: both about equally.  At the Figure-2 sweep's
// shape (R 16 sampled clients of n 2000 rows, d 123, 20 steps, float64) the
// rows read once are at most 31.5 MB (fewer when a client is drawn twice):
// 9.4 us at 3.35 TB/s; the 4 n d operations a step and row are 3.2e8
// float64 operations, 9.3 us at 34 TFLOP/s.  The TPU kernel keeps a trial's
// A in VMEM across the steps (logistic_prox.py:20-23); a block's 227 KB
// cannot hold a trial's 1.97 MB, so here a trial's rows are split over a
// cluster, and each block keeps what it can of its share.
//
// Design (cluster route, d <= 512).  A row of the batch is a thread-block
// cluster of C blocks: the wrapper takes the largest C <= 8 whose R clusters
// the card holds in one wave (cudaOccupancyMaxActiveClusters; an H100 holds
// 15 clusters of 8 full blocks, so R 16 takes C 6).  Block `rank` owns
// client rows [n rank / C, n (rank + 1) / C) (empty when n < C) and 16
// warps, each taking whole rows:
//   * one pass over A a step: a warp loads G rows once into registers
//     (lanes along d, NV = ceil(d / 32) values a lane, G NV <= 16), forms
//     their margins by a reduce-scatter over the lanes (lane l ends with row
//     l / (32 / G)'s), so one tanh gives all G rows' u, and adds u * row
//     into its column accumulators from the same registers;
//   * A stays on chip where it fits: in step 0 a warp writes its rows into
//     shared memory (the first `res_rows` of the block's range, as many as
//     the 227 KB hold) and reads them there in later steps; the rest are
//     read from L2 every step;
//   * the warps' partial gradients are summed in shared memory in warp
//     order, then across the cluster through distributed shared memory:
//     after one cluster barrier every block reads the C block partials (all
//     C loads in flight at once) and adds them in rank order 0..C-1, so
//     every block forms the same sum and applies the same update to its own
//     copy of x; no broadcast, no atomics (two launches give the same
//     bits).  The partials are double-buffered by step parity, so a step
//     needs one cluster barrier.
// tanh/tanhf are the accurate library functions (no --use_fast_math): the
// reference tolerance is rtol 1e-12 in float64.  1/n uses the true n.
//
// Wide route (d > 512, more than 16 values a lane): the first port's
// kernel, one block per row with x, u and the partial sums in shared memory and A read
// from L2 twice a step; it takes any n, d with (n + d + 512) itemsize <=
// 232,448 bytes, as before.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a Hopper block may use
constexpr int kMaxCluster = 16;   // the largest (non-portable) cluster on Hopper

struct Params {
  const void* A;        // (M, n, d) Z, or (R, n, d) label-signed A when y is null
  const void* y;        // (M, n) labels, or null
  const long long* m;   // (R,) client of each row, or null (row r reads A[r])
  const void* z;        // (R, d)
  const void* x0;       // (R, d)
  const void* beta;     // (R,) or (1,), read with stride ss
  const void* inv_eta;  // likewise
  void* out;            // (R, d)
  double lam;
  long long n, d, ss;
  int num_steps;
  int res_rows;   // rows a block keeps in shared memory (cluster route)
  int drop_rank;  // a planted fault: this rank's partial is left out (-1: none)
};

__device__ __forceinline__ float tanh_t(float v) { return tanhf(v); }
__device__ __forceinline__ double tanh_t(double v) { return tanh(v); }

template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The G margins of a row group, summed over the warp's 32 lanes by halving:
// the first log2 G levels each hand half of the remaining rows to the other
// half of the lanes (a reduce-scatter), the rest add the one left.  Lane l
// returns the margin of row l / (32 / G); the lanes sharing a row hold the
// same bits (each addition is of the same two values).
template <typename T, int G>
__device__ __forceinline__ T group_margins(T (&t)[G], int lane) {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8, "rows a group");
#pragma unroll
  for (int n = G, off = 16; n > 1; n >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      const T keep = up ? t[j + n / 2] : t[j];
      const T send = up ? t[j] : t[j + n / 2];
      t[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  T v = t[0];
#pragma unroll
  for (int off = 16 / G; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------ cluster route
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 1) logistic_prox_cluster_kernel(Params p) {
  constexpr int G = 16 / NV > 8 ? 8 : 16 / NV;  // rows a warp has in flight (G NV <= 16)
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long r = blockIdx.x / C;
  const int n = (int)p.n, d = (int)p.d;
  const long long mr = p.m ? p.m[r] : r;
  const T* Ar = static_cast<const T*>(p.A) + mr * n * d;
  const T* yr = p.y ? static_cast<const T*>(p.y) + mr * n : nullptr;
  const int i0 = (int)((long long)n * rank / C);
  const int nb = (int)((long long)n * (rank + 1) / C) - i0;
  const int res = min(nb, p.res_rows);
  const T* Ab = Ar + (long long)i0 * d;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (d,) this block's copy of x
  T* bpart = xs + d;                       // (2, d) block partial, by step parity
  T* wpart = bpart + 2 * d;                // (kWarps, d) warp partials
  T* rows = wpart + kWarps * d;            // (res, d) resident rows, signs folded

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T b = static_cast<const T*>(p.beta)[r * p.ss];
  const T ie = static_cast<const T*>(p.inv_eta)[r * p.ss];
  const T lam = (T)p.lam, nn = (T)n;
  const T* zr = static_cast<const T*>(p.z) + r * d;
  for (int j = tid; j < d; j += kThreads) xs[j] = static_cast<const T*>(p.x0)[r * d + j];
  __syncthreads();

  for (int s = 0; s < p.num_steps; ++s) {
    T xr[NV], acc[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int j = lane + 32 * q;
      xr[q] = j < d ? xs[j] : (T)0;
      acc[q] = 0;
    }
    for (int base = warp * G; base < nb; base += kWarps * G) {
      T a[G][NV];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int li = base + g;
        if (li < nb && s > 0 && li < res) {
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const int j = lane + 32 * q;
            a[g][q] = j < d ? rows[(long long)li * d + j] : (T)0;
          }
        } else if (li < nb) {
          const T sign = yr ? yr[i0 + li] : (T)1;
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const int j = lane + 32 * q;
            a[g][q] = j < d ? Ab[(long long)li * d + j] * sign : (T)0;
          }
          if (s == 0 && li < res) {
#pragma unroll
            for (int q = 0; q < NV; ++q) {
              const int j = lane + 32 * q;
              if (j < d) rows[(long long)li * d + j] = a[g][q];
            }
          }
        } else {
#pragma unroll
          for (int q = 0; q < NV; ++q) a[g][q] = 0;
        }
      }
      T t[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        t[g] = 0;
#pragma unroll
        for (int q = 0; q < NV; ++q) t[g] = fma(a[g][q], xr[q], t[g]);
      }
      // u of each row in one tanh: lane group g (lanes 32 g / G ..) ends with
      // row g's margin and evaluates its u; zero rows add nothing.
      const T tv = group_margins<T, G>(t, lane);
      const T uv = (T)0.5 * (tanh_t((T)-0.5 * tv) + (T)1);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const T u = __shfl_sync(0xffffffffu, uv, g * (32 / G));
#pragma unroll
        for (int q = 0; q < NV; ++q) acc[q] = fma(u, a[g][q], acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int j = lane + 32 * q;
      if (j < d) wpart[warp * d + j] = acc[q];
    }
    __syncthreads();
    T* mine = bpart + (s & 1) * d;
    for (int j = tid; j < d; j += kThreads) {
      T sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += wpart[w * d + j];
      mine[j] = sum;
    }
    // Every block's partial of this step is written; the other parity's
    // buffer is free, since every block read it before this barrier.
    cluster.sync();
    for (int j = tid; j < d; j += kThreads) {
      T part[kMaxCluster];  // every rank's load in flight at once
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        part[c] = c < C ? cluster.map_shared_rank(mine, c)[j] : (T)0;
      T sum = 0;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        if (c < C && c != p.drop_rank) sum += part[c];
      const T xj = xs[j];
      const T g = -sum / nn + lam * xj;
      xs[j] = xj - b * (g + (xj - zr[j]) * ie);
    }
    __syncthreads();
  }
  // No block may leave while another still reads its partials.
  if (p.num_steps > 0) cluster.sync();
  if (rank == 0) {
    T* out = static_cast<T*>(p.out) + r * d;
    for (int j = tid; j < d; j += kThreads) out[j] = xs[j];
  }
}

// ------------------------------------------------------------- legacy route
template <typename T>
__global__ void __launch_bounds__(kThreads) logistic_prox_rowblock_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = (int)p.n, d = (int)p.d;
  T* x = reinterpret_cast<T*>(smem_raw);  // (d,) current iterate
  T* u = x + d;                           // (n,) sigmoid of minus-margins
  T* part = u + n;                        // (kThreads,) column partial sums

  const long long r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long mr = p.m ? p.m[r] : r;
  const T* Ar = static_cast<const T*>(p.A) + mr * n * d;
  const T* yr = p.y ? static_cast<const T*>(p.y) + mr * n : nullptr;
  const T* zr = static_cast<const T*>(p.z) + r * d;
  const T b = static_cast<const T*>(p.beta)[r * p.ss];
  const T ie = static_cast<const T*>(p.inv_eta)[r * p.ss];
  const T lam = (T)p.lam, nn = (T)n;

  // Column lanes per row group (a multiple of 32, at most the block) and the
  // number of row groups the block splits the A^T u reduction into.
  const int cpad = min(((d + 31) / 32) * 32, kThreads);
  const int groups = kThreads / cpad;
  const int grp = tid / cpad;
  const int col = tid - grp * cpad;

  for (int j = tid; j < d; j += kThreads) x[j] = static_cast<const T*>(p.x0)[r * d + j];
  __syncthreads();

  for (int s = 0; s < p.num_steps; ++s) {
    for (int i = warp; i < n; i += kWarps) {
      const T* row = Ar + (long long)i * d;
      const T sign = yr ? yr[i] : (T)1;
      T acc = 0;
      for (int j = lane; j < d; j += 32) acc += row[j] * sign * x[j];
      acc = warp_allsum(acc);
      if (lane == 0) u[i] = (T)0.5 * (tanh_t((T)-0.5 * acc) + (T)1);
    }
    __syncthreads();

    for (int j0 = 0; j0 < d; j0 += cpad) {
      if (grp < groups) {
        const int j = j0 + col;
        T acc = 0;
        if (j < d) {
          for (int i = grp; i < n; i += groups)
            acc += u[i] * (Ar[(long long)i * d + j] * (yr ? yr[i] : (T)1));
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

  for (int j = tid; j < d; j += kThreads) static_cast<T*>(p.out)[r * d + j] = x[j];
}

template <typename T, int NV>
cudaError_t configure() {  // attributes set once a process
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(logistic_prox_cluster_kernel<T, NV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(logistic_prox_cluster_kernel<T, NV>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  configured = e == cudaSuccess;
  return e;
}

// The cluster route's launch for `rows` rows of C blocks; with `clusters`
// set, only the number of such clusters the card holds at once is written
// there, and nothing is launched.
template <typename T, int NV>
int launch_cluster(const Params& p, long long rows, int C, void* stream, int* clusters) {
  const size_t smem = (size_t)((3 + kWarps) * p.d + (long long)p.res_rows * p.d) * sizeof(T);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = configure<T, NV>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters)
    return (int)cudaOccupancyMaxActiveClusters(clusters, logistic_prox_cluster_kernel<T, NV>, &cfg);
  e = cudaLaunchKernelEx(&cfg, logistic_prox_cluster_kernel<T, NV>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rowblock(const Params& p, long long rows, void* stream) {
  const size_t smem = (size_t)(p.d + p.n + kThreads) * sizeof(T);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        logistic_prox_rowblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  logistic_prox_rowblock_kernel<T><<<(unsigned)rows, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A, const void* y, const void* m, const void* z, const void* x0,
           const void* beta, const void* inv_eta, double lam, long long rows, long long n,
           long long d, long long num_steps, long long ss, void* out, int cluster,
           int res_rows, int drop_rank, void* stream, int* clusters = nullptr) {
  if ((rows == 0 || d == 0) && !clusters) return 0;
  if (n < 1 || num_steps < 0 || cluster < 1 || cluster > kMaxCluster || res_rows < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{A, y, static_cast<const long long*>(m), z, x0, beta, inv_eta, out, lam,
                 n, d, ss, (int)num_steps, res_rows, drop_rank};
  const int nv = (int)((d + 31) / 32);
  if (nv <= 1) return launch_cluster<T, 1>(p, rows, cluster, stream, clusters);
  if (nv <= 2) return launch_cluster<T, 2>(p, rows, cluster, stream, clusters);
  if (nv <= 4) return launch_cluster<T, 4>(p, rows, cluster, stream, clusters);
  if (nv <= 8) return launch_cluster<T, 8>(p, rows, cluster, stream, clusters);
  if (nv <= 16) return launch_cluster<T, 16>(p, rows, cluster, stream, clusters);
  if (clusters) return (int)cudaErrorInvalidValue;
  return launch_rowblock<T>(p, rows, stream);
}

}  // namespace

// A (M, n, d) with y (M, n) and m (R,) int64, or A (R, n, d) label-signed
// with y and m null; z, x0, out (R, d); beta, inv_eta (R,) read with stride
// ss (0: one scalar each); all of one type, contiguous.  d <= 512 takes the
// cluster route with `cluster` blocks a row, each keeping `res_rows` of its
// rows in shared memory; larger d the one-block-a-row route.
extern "C" int logistic_prox_gd_f32(
    const void* A, const void* y, const void* m, const void* z, const void* x0,
    const void* beta, const void* inv_eta, double lam, long long rows, long long n,
    long long d, long long num_steps, long long ss, void* out, int cluster, int res_rows,
    int drop_rank, void* stream) {
  return launch<float>(A, y, m, z, x0, beta, inv_eta, lam, rows, n, d, num_steps, ss, out,
                       cluster, res_rows, drop_rank, stream);
}

extern "C" int logistic_prox_gd_f64(
    const void* A, const void* y, const void* m, const void* z, const void* x0,
    const void* beta, const void* inv_eta, double lam, long long rows, long long n,
    long long d, long long num_steps, long long ss, void* out, int cluster, int res_rows,
    int drop_rank, void* stream) {
  return launch<double>(A, y, m, z, x0, beta, inv_eta, lam, rows, n, d, num_steps, ss, out,
                        cluster, res_rows, drop_rank, stream);
}

// How many clusters of `cluster` blocks, each keeping `res_rows` rows of
// width d in shared memory, the card holds at once (written to *clusters).
extern "C" int logistic_prox_max_clusters(int is_f64, long long d, int cluster, int res_rows,
                                          int* clusters) {
  *clusters = 0;
  return is_f64 ? launch<double>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                 0.0, 1, 1, d, 0, 0, nullptr, cluster, res_rows, -1, nullptr,
                                 clusters)
                : launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                0.0, 1, 1, d, 0, 0, nullptr, cluster, res_rows, -1, nullptr,
                                clusters);
}
