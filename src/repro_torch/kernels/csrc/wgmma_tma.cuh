// Hopper wgmma + TMA helpers shared by K4's and K4b's wgmma routes
// (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu), each of which
// includes this file inside its own `namespace wg` after <cuda.h> and a
// `smem_addr`: mbarriers, 4-D TMA tile loads, shared-memory matrix
// descriptors, the wgmma fences and the register-A products O += P V takes,
// how a head dim's rows are cut into swizzled boxes, and the host's tensor-map
// encoder.
#pragma once

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the phase of parity `parity` to complete.  A wait that lasts
// ~10 s (a lost arrival) traps, so a fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// How a head dim's rows are tiled in shared memory.  Dh 64 and 128: boxes
// of 64 columns (128-byte rows), 128-byte swizzle.  Dh 80: five boxes of 16
// columns (32-byte rows), 32-byte swizzle, so that every product's operand
// is whole swizzle atoms (a 160-byte row is not whole 128-byte ones).  A
// tile of `rows` rows is COLS boxes, `rows * RB` bytes apart; a swizzle atom
// is 8 rows of one box.
template <int DH>
struct Boxes {
  static constexpr int BW = DH % 64 == 0 ? 64 : 16;  // columns a box
  static constexpr int RB = 2 * BW;                  // bytes a box row
  static constexpr int COLS = DH / BW;                // boxes a row
  static constexpr uint64_t MODE = BW == 64 ? 1 : 3;  // descriptor swizzle: 128B, 32B
  static_assert(DH % BW == 0 && DH % 16 == 0, "whole boxes and k16 steps");
};

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, all in 16-byte units; swizzle mode 1 (128-byte, the default) or 3
// (32-byte).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t mode = 1) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses to registers across the
// asynchronous products (and keep bf16 A fragments alive until the product
// that reads them has completed).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x by the SFU (MUFU.EX2, ~2 ulp, subnormal results flushed to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define WG_ACC32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_REGS32                                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_ACC40(d)                                                                          \
  WG_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
      "+f"(d[38]), "+f"(d[39])
#define WG_REGS40 WG_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39"

// d += A B for a 64 x 64 tile, k 16: A in registers, B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n64_mn(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for a 64 x 80 tile, k 16: A in registers, B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n80_mn(float (&d)[40], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {" WG_REGS40 "}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_ACC40(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for a 64 x 128 tile, k 16: A in registers, B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n128_mn(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS32 ", "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B over one k16 step, DH columns: A (64 x 16 bf16) from registers in
// the accumulator layout, B MN-major in shared memory.  K4's O += P V and
// K4b's dV += P^T dO and dK += dS^T Q.
template <int DH>
__device__ __forceinline__ void rs_product(float (&d)[DH / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void rs_product<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n64_mn(d, a, db);
}
template <>
__device__ __forceinline__ void rs_product<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n80_mn(d, a, db);
}
template <>
__device__ __forceinline__ void rs_product<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n128_mn(d, a, db);
}

// ---------------------------------------------------- host: tensor maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up at run time through the CUDA runtime, so
// the library needs no -lcuda.
inline EncodeTiled encode_fn() {
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

// A (B, S, heads, dh) bf16 tensor as a 4-D map over (dh, heads, S, B): boxes
// of (bw, 1, rows, 1), 128-byte swizzled at bw 64, 32-byte at bw 16 (see
// Boxes).  Rows past S (a ragged tail) are filled with zeros, never read
// from the next sequence.
inline int encode(CUtensorMap* map, const void* ptr, int dh, int heads, int seq, int batch,
                  int rows, int bw) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t rows_total = seq > 0 ? seq : 1;  // an empty sequence is never read
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, rows_total, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {dh * e, (cuuint64_t)heads * dh * e, rows_total * heads * dh * e};
  const cuuint32_t box[4] = {(cuuint32_t)bw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        bw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
