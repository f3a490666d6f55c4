// Hopper warpgroup MMA (wgmma, sm_90a) for 3xTF32 products whose A
// operand comes from registers and whose B operand lies in shared memory
// in the K-major layout without swizzle.  Used by frontend.cu's
// z_power_kernel.
//
// One wgmma.m64n64k8 of a warpgroup (four consecutive warps, the first a
// multiple of 4) multiplies a 64 x 8 tile of A by an 8 x 64 tile of B into
// a 64 x 64 FP32 tile.  With w = warp % 4, g = lane / 4, t = lane % 4:
//   A (registers, four per thread): a[0] (16w + g, t), a[1] (16w + g + 8, t),
//     a[2] (16w + g, t + 4), a[3] (16w + g + 8, t + 4);
//   D (32 per thread): d[4j + 2h + e] at (16w + g + 8h, 8j + 2t + e);
//   B (shared memory): "core matrices" of 8 columns n x 4 k (16 bytes a
//     column, 128 bytes each); the core matrix of columns 8q.. and k 4r..
//     starts (2q + r) * 128 bytes after the tile (bt_offset below).
// Both operands are TF32 bit patterns; kernels split each float into a
// high and a low part (tf32_hi) and take the three products of 3xTF32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG_N = 64;              // columns of one wgmma tile
constexpr int WG_TILE_WORDS = 8 * WG_N;   // one 8 x 64 B tile (32-bit words)
// The descriptor's byte strides between core matrices: along K (the
// leading dimension of a K-major operand) and along N.
constexpr uint32_t WG_LBO = 128;
constexpr uint32_t WG_SBO = 256;

// Word offset of B[k][n] (k < 8, n < 64) in one tile.
__host__ __device__ constexpr int bt_offset(int k, int n) {
  return (((n >> 3) * 2 + (k >> 2)) * 8 + (n & 7)) * 4 + (k & 3);
}

// Shared-memory matrix descriptor of a B tile: no swizzle, base offset 0.
__device__ __forceinline__ uint64_t wg_desc(const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((a >> 4) & 0x3FFF) |
         ((uint64_t)((WG_LBO >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((WG_SBO >> 4) & 0x3FFF) << 32);
}

// TF32 rounding to nearest, ties away from zero (cvt.rna.tf32.f32 on every
// finite value) in two integer operations; the low 13 bits come out 0.
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as a TF32 high part h and the TF32 rounding of x - h.
__device__ __forceinline__ void tf32_pair(float x, uint32_t& h,
                                          uint32_t& l) {
  h = tf32_hi(x);
  l = tf32_hi(x - __uint_as_float(h));
}

// Order this thread's generic-proxy writes to shared memory before later
// reads by the async proxy (wgmma's B operand), once a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// A fence for the compiler alone: the registers' values are settled here,
// in program order with the wgmma instructions around it (so a fragment is
// composed before wg_fence, and the accumulators are read after the last
// wg_wait).
__device__ __forceinline__ void wg_operands(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
               :: "memory");
}

__device__ __forceinline__ void wg_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// What to add to a descriptor to move it n tiles of WG_TILE_WORDS words on.
__host__ __device__ __forceinline__ uint64_t wg_desc_step(int n) {
  return (uint64_t)(n * WG_TILE_WORDS * 4 / 16);
}

// d += a . B (B: the 8 x 64 tile of descriptor b), issued asynchronously.
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

}  // namespace
