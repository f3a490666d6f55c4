// Complex products on Hopper's tensor cores at FP32 accuracy (3xTF32), and
// the cp.async copies that feed them.  Shared by frontend.cu and
// synthpower.cu.
//
// 3xTF32: each float x is split into a TF32 high part h = rna(x) and a low
// part l = rna(x - h); a . b is taken as l_a h_b + h_a l_b + h_a h_b (the
// l_a l_b term, ~2^-22 of |a b|, is dropped), each an
// mma.sync.m16n8k8.tf32 with FP32 accumulation.  A single TF32 pass keeps
// ~11 bits and misses the port's precision contract (power map within
// 1e-5 of its maximum); three passes meet it.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8, row) a0
// (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, col)
// b0 (t, g), b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2
// (g + 8, 2t), c3 (g + 8, 2t + 1).
//
// Operand tiles live in shared memory as interleaved complex float2; a
// row pitch of 4 mod 16 float2 makes every fragment load of a half-warp
// hit 32 distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// A complex operand element split into TF32 high and low parts.
struct Split {
  uint32_t rh, rl, ih, il;
};

__device__ __forceinline__ Split split(float2 v) {
  Split s;
  s.rh = tf32_rna(v.x);
  s.rl = tf32_rna(v.x - __uint_as_float(s.rh));
  s.ih = tf32_rna(v.y);
  s.il = tf32_rna(v.y - __uint_as_float(s.ih));
  return s;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32 (hi / lo fragments; small terms first).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al[0], al[1], al[2], al[3], bh[0], bh[1]);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bl[0], bl[1]);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bh[0], bh[1]);
}

// The A fragment of one complex 16 x 8 tile: real and imaginary parts,
// high and low, and the negated imaginary part (for -Ai Bi).
struct FragA {
  uint32_t rh[4], rl[4], ih[4], il[4], nih[4], nil[4];
};

struct FragB {
  uint32_t rh[2], rl[2], ih[2], il[2];
};

// The A fragment of the values v[i] at (row, col) = (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) of the tile.
__device__ __forceinline__ FragA make_frag_a(const float2 (&v)[4]) {
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    f.rh[i] = s.rh;
    f.rl[i] = s.rl;
    f.ih[i] = s.ih;
    f.il[i] = s.il;
    f.nih[i] = s.ih ^ 0x80000000u;
    f.nil[i] = s.il ^ 0x80000000u;
  }
  return f;
}

// The B fragment of the values v[i] at (row, col) = (t, g), (t + 4, g).
__device__ __forceinline__ FragB make_frag_b(const float2 (&v)[2]) {
  FragB f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const Split s = split(v[i]);
    f.rh[i] = s.rh;
    f.rl[i] = s.rl;
    f.ih[i] = s.ih;
    f.il[i] = s.il;
  }
  return f;
}

// A[m][k] at a[m * lda_m + k * lda_k] (float2), tile rows m0.., cols k0..
__device__ __forceinline__ FragA load_frag_a(const float2* a, int lda_m,
                                             int lda_k, int m0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 v[4] = {a[(m0 + g) * lda_m + (k0 + t) * lda_k],
                       a[(m0 + g + 8) * lda_m + (k0 + t) * lda_k],
                       a[(m0 + g) * lda_m + (k0 + t + 4) * lda_k],
                       a[(m0 + g + 8) * lda_m + (k0 + t + 4) * lda_k]};
  return make_frag_a(v);
}

// B[k][n] at b[k * ldb + n] (float2), tile rows k0.., cols n0..
__device__ __forceinline__ FragB load_frag_b(const float2* b, int ldb,
                                             int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 v[2] = {b[(k0 + t) * ldb + n0 + g],
                       b[(k0 + t + 4) * ldb + n0 + g]};
  return make_frag_b(v);
}

// Complex accumulate: zr += Ar Br - Ai Bi, zi += Ar Bi + Ai Br.
__device__ __forceinline__ void cmma3(float (&zr)[4], float (&zi)[4],
                                      const FragA& a, const FragB& b) {
  mma3(zr, a.rh, a.rl, b.rh, b.rl);
  mma3(zr, a.nih, a.nil, b.ih, b.il);
  mma3(zi, a.rh, a.rl, b.ih, b.il);
  mma3(zi, a.ih, a.il, b.rh, b.rl);
}

// The same product with the high x high terms in (zr, zi) and the small
// terms in (er, ei): the tensor cores truncate each partial sum to FP32,
// and the small terms, ~2^-11 of the sum, then lose nothing; the caller
// adds the two (and flushes both into an FP32 sum every few k-steps).
__device__ __forceinline__ void cmma3_split(float (&zr)[4], float (&zi)[4],
                                            float (&er)[4], float (&ei)[4],
                                            const FragA& a, const FragB& b) {
  mma_tf32(er, a.rl[0], a.rl[1], a.rl[2], a.rl[3], b.rh[0], b.rh[1]);
  mma_tf32(er, a.rh[0], a.rh[1], a.rh[2], a.rh[3], b.rl[0], b.rl[1]);
  mma_tf32(zr, a.rh[0], a.rh[1], a.rh[2], a.rh[3], b.rh[0], b.rh[1]);
  mma_tf32(er, a.nil[0], a.nil[1], a.nil[2], a.nil[3], b.ih[0], b.ih[1]);
  mma_tf32(er, a.nih[0], a.nih[1], a.nih[2], a.nih[3], b.il[0], b.il[1]);
  mma_tf32(zr, a.nih[0], a.nih[1], a.nih[2], a.nih[3], b.ih[0], b.ih[1]);
  mma_tf32(ei, a.rl[0], a.rl[1], a.rl[2], a.rl[3], b.ih[0], b.ih[1]);
  mma_tf32(ei, a.rh[0], a.rh[1], a.rh[2], a.rh[3], b.il[0], b.il[1]);
  mma_tf32(zi, a.rh[0], a.rh[1], a.rh[2], a.rh[3], b.ih[0], b.ih[1]);
  mma_tf32(ei, a.il[0], a.il[1], a.il[2], a.il[3], b.rh[0], b.rh[1]);
  mma_tf32(ei, a.ih[0], a.ih[1], a.ih[2], a.ih[3], b.rl[0], b.rl[1]);
  mma_tf32(zi, a.ih[0], a.ih[1], a.ih[2], a.ih[3], b.rh[0], b.rh[1]);
}

// ---- cp.async: 8-byte copies (one complex value), zero-filled when
// !valid; a group per pipeline stage.
__device__ __forceinline__ void cp_async8(float2* smem, const float2* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Smallest pitch >= n with pitch % 16 == 4 (float2 units).
__host__ __device__ __forceinline__ int frag_pitch(int n) {
  return n + ((20 - n % 16) % 16);
}

}  // namespace
