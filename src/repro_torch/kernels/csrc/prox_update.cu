// The Algorithm-7 step, written for Hopper (sm_90a): two entries.
//
// 1. prox_update_batched_{f32,f64} (K1), the batched step of a sweep:
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
// counterpart here.  The quadratic sweeps no longer take this entry: entry 3
// below runs their whole GD loop in one launch.  Catalyst's shifted solves
// and generic gradients still do, one launch per GD step.
#include <cuda_bf16.h>
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

// 2. prox_update_tree_{bf16,f32,f64} (K3), the DeepSVRP local step over a
// parameter tree.
//
// Replaces the TPU kernel src/repro/kernels/prox_update.py:45 (prox_update:
// one pallas_call over (256, 128) row blocks of one flattened tensor) and the
// way src/repro/kernels/ops.py:286-328 (prox_update_tree) feeds it: there the
// leaves of one dtype are concatenated into one flat operand, updated by one
// launch and split again.  For every leaf i of one dtype group it computes
//
//     out_i = y_i - lr * (g_i + (y_i - z_i) * inv_eta)
//
// with lr and inv_eta already rounded to the leaves' dtype by the caller (as
// the reference's jnp.asarray(local_lr, dtype) does) and g_i of y_i's dtype.
// The arithmetic runs in float32 (float64 for float64 leaves), each operation
// rounded on its own (the _rn intrinsics), and rounds once at the store.
//
// What bounds it on this card: bytes.  Three reads and one write of every
// element, five operations each.  At the DeepSVRP step's shape (the whole
// bf16 Qwen2-1.5B tree, 1.777e9 elements) that is 14.2 GB, 4.2 ms at
// 3.35 TB/s.
//
// Design: a pointer table instead of the reference's concatenation, as
// multi-tensor apply does.  The launcher passes every leaf's (y, g, z, out, n)
// by value in the kernel's parameter block (at most kMaxLeaves leaves, under
// the 4 KB parameter limit), so nothing is copied or staged.  Each leaf is cut
// into chunks of kChunk elements; blocks stride over the chunks of all leaves
// and find a chunk's leaf from the table's prefix of chunk counts.  Inside a
// chunk every thread moves 16 bytes a load (8 bf16, 4 float32, 2 float64)
// when all four of the leaf's pointers are 16-byte aligned, one element
// otherwise, and the chunk's ragged tail element by element.

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kTreeThreads = 256;
constexpr long long kChunk = 32768;  // a multiple of every vector width x kTreeThreads

struct LeafTable {
  const void* y[kMaxLeaves];
  const void* g[kMaxLeaves];
  const void* z[kMaxLeaves];
  void* out[kMaxLeaves];
  long long n[kMaxLeaves];
  long long chunk0[kMaxLeaves + 1];  // chunk0[i]: first chunk of leaf i; chunk0[leaves]: total
  unsigned char vec[kMaxLeaves];     // all four pointers 16-byte aligned
  int leaves;
};

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
template <typename T> __device__ __forceinline__ T from_acc(typename Acc<T>::type v);
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_acc<float>(float v) { return v; }
template <> __device__ __forceinline__ double from_acc<double>(double v) { return v; }

template <typename T>
__device__ __forceinline__ T step(T y, T g, T z, typename Acc<T>::type lr,
                                  typename Acc<T>::type ie) {
  const auto yv = to_acc(y);
  return from_acc<T>(sub_rn(yv, mul_rn(lr, add_rn(to_acc(g), mul_rn(sub_rn(yv, to_acc(z)), ie)))));
}

template <typename T>
__global__ void __launch_bounds__(kTreeThreads) prox_update_tree_kernel(
    const LeafTable t, typename Acc<T>::type lr, typename Acc<T>::type ie) {
  constexpr int V = 16 / sizeof(T);
  const long long chunks = t.chunk0[t.leaves];
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    int leaf = 0;
    while (c >= t.chunk0[leaf + 1]) ++leaf;
    const T* y = static_cast<const T*>(t.y[leaf]);
    const T* g = static_cast<const T*>(t.g[leaf]);
    const T* z = static_cast<const T*>(t.z[leaf]);
    T* out = static_cast<T*>(t.out[leaf]);
    const long long start = (c - t.chunk0[leaf]) * kChunk;
    const long long end = min(start + kChunk, t.n[leaf]);
    long long tail = start;
    if (t.vec[leaf]) {
      const long long nv = (end - start) / V;
      for (long long j = threadIdx.x; j < nv; j += kTreeThreads) {
        const long long i = start + j * V;
        const uint4 ry = *reinterpret_cast<const uint4*>(y + i);
        const uint4 rg = *reinterpret_cast<const uint4*>(g + i);
        const uint4 rz = *reinterpret_cast<const uint4*>(z + i);
        uint4 ro;
        const T* vy = reinterpret_cast<const T*>(&ry);
        const T* vg = reinterpret_cast<const T*>(&rg);
        const T* vz = reinterpret_cast<const T*>(&rz);
        T* vo = reinterpret_cast<T*>(&ro);
#pragma unroll
        for (int e = 0; e < V; ++e) vo[e] = step<T>(vy[e], vg[e], vz[e], lr, ie);
        *reinterpret_cast<uint4*>(out + i) = ro;
      }
      tail = start + nv * V;
    }
    for (long long i = tail + threadIdx.x; i < end; i += kTreeThreads)
      out[i] = step<T>(y[i], g[i], z[i], lr, ie);
  }
}

// table: `leaves` rows of (y, g, z, out, n) as 64-bit integers.
template <typename T>
int launch_tree(const long long* table, int leaves, double lr, double inv_eta, void* stream) {
  if (leaves < 0 || leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  LeafTable t{};
  t.leaves = leaves;
  t.chunk0[0] = 0;
  for (int i = 0; i < leaves; ++i) {
    const long long* row = table + 5 * i;
    t.y[i] = reinterpret_cast<const void*>(row[0]);
    t.g[i] = reinterpret_cast<const void*>(row[1]);
    t.z[i] = reinterpret_cast<const void*>(row[2]);
    t.out[i] = reinterpret_cast<void*>(row[3]);
    t.n[i] = row[4];
    t.vec[i] = ((row[0] | row[1] | row[2] | row[3]) & 15) == 0;
    t.chunk0[i + 1] = t.chunk0[i] + (row[4] + kChunk - 1) / kChunk;
  }
  const long long chunks = t.chunk0[leaves];
  if (chunks == 0) return 0;
  const unsigned blocks = (unsigned)(chunks < 132LL * 8 ? chunks : 132LL * 8);
  using A = typename Acc<T>::type;
  prox_update_tree_kernel<T><<<blocks, kTreeThreads, 0, (cudaStream_t)stream>>>(
      t, (A)lr, (A)inv_eta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prox_update_tree_bf16(const long long* table, int leaves, double lr,
                                     double inv_eta, void* stream) {
  return launch_tree<__nv_bfloat16>(table, leaves, lr, inv_eta, stream);
}

extern "C" int prox_update_tree_f32(const long long* table, int leaves, double lr,
                                    double inv_eta, void* stream) {
  return launch_tree<float>(table, leaves, lr, inv_eta, stream);
}

extern "C" int prox_update_tree_f64(const long long* table, int leaves, double lr,
                                    double inv_eta, void* stream) {
  return launch_tree<double>(table, leaves, lr, inv_eta, stream);
}

// 3. quadratic_prox_gd_batched_{f32,f64} (K1, redesigned), the whole
// Algorithm-7 solve of a quadratic sweep round in one launch.
//
// Replaces, for the quadratic family, the loop of num_steps launches of
// entry 1 (the TPU kernel src/repro/kernels/prox_update.py:91, driven one GD
// step at a time by src/repro/core/prox.py:90-128), each with its batched
// matvec and subtraction beside it.  For every row r of R rows it runs
//
//     y <- y - beta[r] * ((A[m[r]] y - b[m[r]]) + (y - z[r]) * inv_eta[r])
//
// num_steps times from y0[r] and writes the last y.  A (M, d, d) and b (M, d)
// are read in place through the row's client index m[r]: nothing is gathered.
//
// What bounds it on this card: neither bytes nor operations, but latency.
// The work is a chain of num_steps dependent steps, each a d x d matvec and
// a d-wide update.  At fig-1 svrp (R 16, d 40, 200 steps, f64) that is
// 200 * 16 * (2 * 40 * 40 + 7 * 40) = 1.1e7 operations, 0.3 us at the H100's
// 34 TFLOP/s in f64, and 16 * (40 * 40 + 4 * 40) * 8 = 0.23 MB, 0.07 us at
// 3.35 TB/s; minibatch (R 64) four times that.  A step cannot start before
// the previous one ends, so a solve costs num_steps times one step's latency
// however many SMs there are.
//
// Design: one block per row.  y lives in shared memory, double-buffered: a
// step reads one buffer and writes the other, so it needs one barrier.  Each
// output's dot product is split over `lanes` threads (a power of two, about
// d / 8 of them, at most 32), each summing every lanes-th column with FMAs,
// and reduced with shuffles: a step costs a few FMAs and log2(lanes)
// shuffles, not d dependent FMAs.  A[m[r]] never changes during the solve,
// so where one pass of at most 1024 threads covers all d outputs (d <= 64)
// each thread loads its <= 8 columns of its row of A into registers once
// (8 x 8 = 64 B a thread at d 40 in f64, 12.8 KB a block), and the row's
// owner keeps y, z and b of its row in registers too: a step then reads
// only y from shared memory.  Larger d loops over the rows in passes with A
// staged once in shared memory, or, when d x d x itemsize does not fit there
// (d > 168 in f64, d > 239 in f32), read from global memory, where the
// row's matrix stays in L2 across the steps.  The update keeps entry 1's
// order and rounding, y - lr (g + (y - z) inv_eta) with each operation
// rounded on its own; only the matvec sums in another order than the plain
// version's (cuBLAS / the CPU's BLAS).

namespace {

constexpr int kLoopMaxThreads = 1024;
enum { kRegsA = 0, kSmemA = 1, kGlobalA = 2 };  // where a block reads A[m[r]] from
constexpr int kRegCols = 8;  // columns of its row a thread keeps in registers

template <typename T>
__global__ void __launch_bounds__(kLoopMaxThreads) quadratic_prox_gd_kernel(
    const T* __restrict__ A, const T* __restrict__ b, const long long* __restrict__ m,
    const T* __restrict__ z, const T* __restrict__ y0, const T* __restrict__ beta,
    const T* __restrict__ inv_eta, T* __restrict__ out, int d, int steps,
    long long s_stride, int lanes, int mode) {
  extern __shared__ __align__(16) unsigned char loop_smem[];
  T* sy = reinterpret_cast<T*>(loop_smem);  // two buffers of d
  T* sz = sy + 2 * d;
  T* sb = sz + d;
  T* sA = sb + d;  // d * d, in mode kSmemA
  const int r = blockIdx.x, tid = threadIdx.x, nthreads = blockDim.x;
  const long long row = (long long)r * d;
  const T* Ag = A + m[r] * (long long)d * d;
  const T* bg = b + m[r] * (long long)d;
  for (int i = tid; i < d; i += nthreads) {
    sy[i] = y0[row + i];
    sz[i] = z[row + i];
    sb[i] = bg[i];
  }
  if (mode == kSmemA)
    for (int i = tid; i < d * d; i += nthreads) sA[i] = Ag[i];
  __syncthreads();
  const T lr = beta[r * s_stride], ie = inv_eta[r * s_stride];
  const int part = tid % lanes, slot = tid / lanes;
  int cur = 0;
  if (mode == kRegsA) {
    // One pass covers every output: thread (slot, part) keeps columns
    // part, part + lanes, ... of row `slot` of A in registers, and the
    // row's owner (part 0) keeps y, z and b of that row.
    const int j = slot;
    T a[kRegCols];
#pragma unroll
    for (int q = 0; q < kRegCols; ++q) {
      const int c = part + q * lanes;
      a[q] = j < d && c < d ? Ag[(long long)j * d + c] : T(0);
    }
    T yj = j < d ? sy[j] : T(0);
    const T zj = j < d ? sz[j] : T(0), bj = j < d ? sb[j] : T(0);
    for (int s = 0; s < steps; ++s) {
      const T* y = sy + cur * d;
      T acc = 0;
#pragma unroll
      for (int q = 0; q < kRegCols; ++q) {
        const int c = part + q * lanes;
        if (c < d) acc = fma(a[q], y[c], acc);
      }
      for (int off = lanes >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (j < d && part == 0) {
        const T g = sub_rn(acc, bj);  // A y - b
        yj = sub_rn(yj, mul_rn(lr, add_rn(g, mul_rn(sub_rn(yj, zj), ie))));
        sy[(cur ^ 1) * d + j] = yj;
      }
      __syncthreads();
      cur ^= 1;
    }
  } else {
    const T* Am = mode == kSmemA ? sA : Ag;  // kGlobalA: A stays in L2 across the steps
    const int per_pass = nthreads / lanes;
    for (int s = 0; s < steps; ++s) {
      const T* y = sy + cur * d;
      T* yn = sy + (cur ^ 1) * d;
      for (int j0 = 0; j0 < d; j0 += per_pass) {  // the same trip count on every thread
        const int j = j0 + slot;
        T acc = 0;
        if (j < d) {
          const T* Aj = Am + (long long)j * d;
          for (int c = part; c < d; c += lanes) acc = fma(Aj[c], y[c], acc);
        }
        for (int off = lanes >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (j < d && part == 0) {
          const T g = sub_rn(acc, sb[j]);  // A y - b
          const T yj = y[j];
          yn[j] = sub_rn(yj, mul_rn(lr, add_rn(g, mul_rn(sub_rn(yj, sz[j]), ie))));
        }
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  for (int i = tid; i < d; i += nthreads) out[row + i] = sy[cur * d + i];
}

constexpr long long kMaxSmem = 232448;  // bytes of shared memory one Hopper block may use

template <typename T>
int launch_loop(const void* A, const void* b, const void* m, const void* z, const void* y0,
                const void* beta, const void* inv_eta, void* out, long long rows, long long d,
                long long steps, long long s_stride, void* stream) {
  if (rows == 0 || d == 0) return 0;
  if (d > 32768 || steps < 0 || steps > 0x7fffffffLL || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes < 32 && lanes * kRegCols < d) lanes *= 2;
  long long threads = (d * lanes + 31) / 32 * 32;
  const long long vec_bytes = 4 * d * (long long)sizeof(T);
  const long long a_bytes = d * d * (long long)sizeof(T);
  int mode = kRegsA;  // d <= 64: one pass, every thread's columns in kRegCols registers
  if (threads > kLoopMaxThreads) {
    threads = kLoopMaxThreads;
    mode = vec_bytes + a_bytes <= kMaxSmem ? kSmemA : kGlobalA;
  }
  const long long smem = vec_bytes + (mode == kSmemA ? a_bytes : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(quadratic_prox_gd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  quadratic_prox_gd_kernel<T><<<(unsigned)rows, (unsigned)threads, (size_t)smem,
                                (cudaStream_t)stream>>>(
      (const T*)A, (const T*)b, (const long long*)m, (const T*)z, (const T*)y0,
      (const T*)beta, (const T*)inv_eta, (T*)out, (int)d, (int)steps, s_stride, lanes, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// A (M, d, d), b (M, d), m (R,) int64 in [0, M), z and y0 (R, d), beta and
// inv_eta (R,) read with stride s_stride (0: one scalar for all rows), out
// (R, d); all contiguous, of one floating type.
extern "C" int quadratic_prox_gd_batched_f32(const void* A, const void* b, const void* m,
                                             const void* z, const void* y0, const void* beta,
                                             const void* inv_eta, void* out, long long rows,
                                             long long d, long long steps, long long s_stride,
                                             void* stream) {
  return launch_loop<float>(A, b, m, z, y0, beta, inv_eta, out, rows, d, steps, s_stride, stream);
}

extern "C" int quadratic_prox_gd_batched_f64(const void* A, const void* b, const void* m,
                                             const void* z, const void* y0, const void* beta,
                                             const void* inv_eta, void* out, long long rows,
                                             long long d, long long steps, long long s_stride,
                                             void* stream) {
  return launch_loop<double>(A, b, m, z, y0, beta, inv_eta, out, rows, d, steps, s_stride,
                             stream);
}
