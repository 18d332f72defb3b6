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
// counterpart here.  Fusing the quadratic
// gradient's batched matvec into this pass, or capturing the GD loop in a CUDA
// graph, is what would remove the launch cost.
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
