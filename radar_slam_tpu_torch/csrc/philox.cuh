// Counter-based Gaussian noise shared by frontend.cu and synthpower.cu
// (ops/noise.py is the plain form): Philox-4x32-10 under key (frame seed,
// 0) at counter (index, block, 0, 0), through the "fast" transform (words
// w0..w3 of block 0, w0 of block 1) or Box-Muller (u1 from w0, u2 from w1
// of block 0).  The _rn intrinsics keep nvcc from contracting into FMAs, so
// the arithmetic rounds as the plain version's does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IMPL_FAST = 0;    // noise transforms (ops/noise.py)
constexpr int IMPL_BOX_MULLER = 1;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float byte_sum(unsigned w) {
  // Logical shifts on unsigned words (an arithmetic shift NaN'd the
  // reference's noise on chip).
  return (float)((w & 255u) + ((w >> 8) & 255u) + ((w >> 16) & 255u) +
                 (w >> 24)) - 510.0f;
}

// Two standard normals for element idx of a frame's noise plane.
template <int IMPL>
__device__ __forceinline__ float2 normal_pair(unsigned seed, unsigned idx) {
  const uint4 a = philox4x32_10(make_uint4(idx, 0u, 0u, 0u),
                                make_uint2(seed, 0u));
  const float u1 = __fadd_rn(__fmul_rn((float)(a.x >> 8), 1.0f / 16777216.0f),
                             0.5f / 16777216.0f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  if (IMPL == IMPL_BOX_MULLER) {
    const float u2 = __fmul_rn((float)(a.y >> 8), 1.0f / 16777216.0f);
    const float ang = __fmul_rn(6.283185307179586f, u2);
    return make_float2(__fmul_rn(r, cosf(ang)), __fmul_rn(r, sinf(ang)));
  }
  const uint4 b = philox4x32_10(make_uint4(idx, 1u, 0u, 0u),
                                make_uint2(seed, 0u));
  const float g1 = byte_sum(a.y), g2 = byte_sum(a.z);
  const float h1 = byte_sum(a.w), h2 = byte_sum(b.x);
  const float v1 = __fadd_rn(g1, __fmul_rn(0.7071067811865476f,
                                           __fsub_rn(h1, h2)));
  const float v2 = __fadd_rn(g2, __fmul_rn(0.7071067811865476f,
                                           __fadd_rn(h1, h2)));
  const float inv = 1.0f / sqrtf(__fadd_rn(
      __fadd_rn(__fmul_rn(v1, v1), __fmul_rn(v2, v2)), 1e-6f));
  return make_float2(__fmul_rn(__fmul_rn(r, v1), inv),
                     __fmul_rn(__fmul_rn(r, v2), inv));
}

__device__ __forceinline__ float2 normal_pair(unsigned seed, unsigned idx,
                                              int impl) {
  return impl == IMPL_BOX_MULLER ? normal_pair<IMPL_BOX_MULLER>(seed, idx)
                                 : normal_pair<IMPL_FAST>(seed, idx);
}

}  // namespace
