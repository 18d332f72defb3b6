// bf16 tensor-core helpers shared by K6's and K6b's tensor-core routes
// (csrc/ssm_scan.cu, csrc/ssm_scan_bwd.cu), each of which includes this
// file inside its own namespace: 64 x 64 bf16 tiles of 128-byte rows in
// shared memory, XOR-swizzled by 16-byte chunk; cp.async staging; ldmatrix
// fragment loads of a tile or of its transpose; mma.sync m16n8k16 (bf16 in,
// float32 accumulate); the SFU's 2^x; a float32 pair split into bf16 high
// and low parts.
#pragma once

using bf16 = __nv_bfloat16;

// Element offset of (r, c) in a 64 x 64 bf16 tile of 128-byte rows whose
// 16-byte chunks are XOR-swizzled by the row's low three bits.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16-byte global -> shared copy; zero-fills the destination when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}
// c += a b for one m16n8k16 tile: bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of a swizzled 64 x 64 tile (see swz):
//  * A operand, rows [r0, r0 + 16), columns [k0, k0 + 16);
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* s, int r0, int k0, int lane) {
  ldmatrix_x4(a, s + swz(r0 + (lane & 15), k0 + (lane >> 4) * 8));
}
//  * A operand of the transpose, A[m][k] = tile[k][m], m in [m0, m0 + 16);
__device__ __forceinline__ void ld_a_t(uint32_t (&a)[4], const bf16* s, int m0, int k0,
                                       int lane) {
  const int j = lane >> 3;
  ldmatrix_x4_trans(a, s + swz(k0 + ((j >> 1) << 3) + (lane & 7), m0 + ((j & 1) << 3)));
}
//  * B operand of two n-tiles [n0, n0 + 16) when the tile holds B^T (rows n, columns k);
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], const bf16* s, int n0, int k0,
                                        int lane) {
  ldmatrix_x4(b, s + swz(n0 + (lane & 7) + ((lane >> 4) << 3), k0 + (((lane >> 3) & 1) << 3)));
}
//  * B operand of two n-tiles [n0, n0 + 16) when the tile holds B (rows k, columns n).
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], const bf16* s, int k0, int n0,
                                        int lane) {
  ldmatrix_x4_trans(b, s + swz(k0 + (lane & 7) + (((lane >> 3) & 1) << 3), n0 + ((lane >> 4) << 3)));
}

constexpr float kLog2e = 1.4426950408889634f;
// 2^x by the SFU (MUFU.EX2, ~2 ulp; results below 2^-126 flushed to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (a, b) as two bf16 pairs: hi rounds them, lo rounds what hi left out.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}
