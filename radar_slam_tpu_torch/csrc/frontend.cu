// One-pass radar front end for NVIDIA Hopper (sm_90a), FP32 SIMT.
//
// Replaces, in every branch of their shared body _frontend_body (:186), the
// two kernels of radar_slam_tpu/ops/frontend_pallas.py:
//   K1  radar_frontend_split  _frontend_kernel_split (:308), split
//       synthesis factors -- the kernel of the scatterer drivers' one-pass
//       route;
//   K3  radar_frontend_dense  _frontend_kernel (:296), dense factor planes
//       e_ac [F, Sc, A*C] and e_fast [F, Sc, S] (frontend_factors="dense").
// The two differ only in how the products' factor tiles are loaded (a
// template parameter SPLIT); everything after the loads is one code path.
//
// Branches (K1' are the non-default ones; launch arguments select them, and
// the production knobs' code path is the one K1 always had):
//   noise domain  range-frequency (T = e_fast W_rng, Z = e_at T + sigma
//                 sqrt(S) (g (*) taps), column 0 zeroed) or time
//                 (X = e_at e_fast + sigma n, the ADC cube, then Z = X W_rng;
//                 n at element (a*C + c) * S + s, the index of synthpower.cu
//                 and of the port's synthesize_frame, so K3 on the time
//                 domain builds the same cube as K4);
//   noise impl    the "fast" transform or Box-Muller (ops/noise.py);
//   CFAR          clipped box sums (the reference's banded products) or
//                 log-shift prefix sums in the reference's add order
//                 (_cfar_threshold_cumsum, :118);
//   clutter       an optional background power map [F, C, S]: a cell must
//                 exceed ln(max(c, 1e-12)) * 10 / ln 10 + clutter_offset_db.
//
// What bounds it on this card: arithmetic.  Per frame (A*C = 256, S = 400,
// Sc = 128) the range-frequency products T = e_fast W_rng and Z = e_at T
// are 33.6 M complex MACs, ~270 MFLOP; the time-domain products X = e_at
// e_fast and Z = X W_rng 54.1 M, ~430 MFLOP; against ~1.3 MB (range-
// frequency) or ~2.9 MB (time: X out and in) of device-memory traffic --
// 150-200 FLOP per byte, above the FP32 SIMT ridge of the H100 (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/byte).  The Doppler power, noise and CFAR
// stages are ~15 MFLOP per frame.
//
// What the design does about it: the products run as shared-memory-tiled
// FP32 SIMT matmuls (64 x 64 output tile, depth 16, 4 x 4 complex
// accumulators per thread, four real FMAs per complex MAC); K1 recomposes
// both factor planes from their per-axis tables while the tiles are
// loaded, so e_at [A*C, Sc] and e_fast [Sc, S] never exist in device
// memory; K3 reads them (e_ac transposed in the load, no copy).  The
// range-frequency noise is drawn once per Z tile (plus a halo for the
// window taps) from Philox-4x32-10 into shared memory; the time-domain
// noise is drawn in the synthesis epilogue.  The time domain writes X
// (0.82 MB per frame) to a scratch buffer and reads it back, as K4 does;
// keeping it on chip is later work.  The prefix-sum CFAR holds the map and
// two scan planes in shared memory (3 C S floats, 154 KB at C = 32).
// Tensor cores (wgmma, TMA, 3xTF32) are not used yet: the precision
// contract is FP32.
//
// Launch sequence, all on the caller's stream:
//   range-frequency domain:
//   1. range_dft_kernel   T[f] = e_fast[f] @ W_rng           [Sc, S] complex
//   2. z_kernel           Z[f] = e_at[f] @ T[f] + noise, DC zeroed, stored
//                         transposed as zr/zi [S, A*C]
//   time domain:
//   1. synth_x_kernel     X[f] = e_at[f] @ e_fast[f] + sigma n   [A*C, S]
//   2. z_time_kernel      Z[f] = X[f] @ W_rng, stored transposed
//   then:
//   3. doppler_power_kernel  p[f, d, s] = mean_a |sum_c Wdop^T[d, c] Z|^2
//   4. cfar_kernel / cfar_cumsum_kernel   CA-CFAR threshold + local max +
//                         range gate (+ clutter gate) -> score
//
// Built as a shared library with a plain C interface (no PyTorch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// No fast math: the noise needs accurate logf/sqrtf/cosf/sinf and the dB
// map uses logf(x) * 10/ln(10), as the reference kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output tile rows
constexpr int BN = 64;          // output tile columns
constexpr int BK = 16;          // reduction depth per stage
constexpr int TPB = 256;        // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_TAPS = 5;     // a 3-term cosine window has 5 taps
constexpr int MAX_HALO = 2;
constexpr int PS = 16;          // range bins per Doppler-power block
constexpr int CFAR_THREADS = 512;
constexpr float NEG_SCORE = -1e30f;
constexpr float LOG10E_10 = 4.3429448190325176f;   // 10 / ln(10)
constexpr int LDX = BM + 1;     // padded A-tile pitch of z_time_kernel
constexpr int IMPL_FAST = 0;    // noise transforms (ops/noise.py)
constexpr int IMPL_BOX_MULLER = 1;
constexpr int DOMAIN_RANGE_FREQ = 0;
constexpr int DOMAIN_TIME = 1;
constexpr int CFAR_BOX = 0;     // cfar_impl "matmul": clipped box sums
constexpr int CFAR_CUMSUM = 1;  // cfar_impl "cumsum": log-shift prefix sums

struct NoiseTaps {
  int n;
  int halo;
  int off[MAX_TAPS];
  float coef[MAX_TAPS];
};

// ---- counter-based Gaussian generator (ops/noise.py is the plain form) --

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

// Two standard normals for element idx = row * S + col of a frame's
// [A*C, S] noise plane, through the "fast" transform (words w0..w3 of block
// 0, w0 of block 1) or Box-Muller (u1 from w0, u2 from w1 of block 0).  The
// _rn intrinsics keep nvcc from contracting into FMAs, so the arithmetic
// rounds as the plain version's does.
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

// ---- shared tiled complex matmul core ----------------------------------
// smem layout: Ar, Ai [BK][LDA] then Br, Bi [BK][BN] (LDA = BM, or BM + 1
// where the A tile is stored transposed).  Thread (ty, tx) accumulates rows
// rm + 16 i and columns cn + 16 j of the output tile.

template <int LDA = BM>
__device__ __forceinline__ void mma_stage(const float* __restrict__ sm,
                                          int rm, int cn,
                                          float (&accr)[4][4],
                                          float (&acci)[4][4]) {
  const float* Ar = sm;
  const float* Ai = sm + BK * LDA;
  const float* Br = sm + 2 * BK * LDA;
  const float* Bi = sm + 2 * BK * LDA + BK * BN;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float ar[4], ai[4], br[4], bi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ar[i] = Ar[kk * LDA + rm + 16 * i];
      ai[i] = Ai[kk * LDA + rm + 16 * i];
      br[i] = Br[kk * BN + cn + 16 * i];
      bi[i] = Bi[kk * BN + cn + 16 * i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        accr[i][j] = fmaf(ar[i], br[j], accr[i][j]);
        accr[i][j] = fmaf(-ai[i], bi[j], accr[i][j]);
        acci[i][j] = fmaf(ar[i], bi[j], acci[i][j]);
        acci[i][j] = fmaf(ai[i], br[j], acci[i][j]);
      }
    }
  }
}

// 1. T[f] = e_fast[f] @ W_rng.  K1 (SPLIT): e_fast[sc, s] =
// coarse[sc, s / B] * fine[sc, s % B] * [t_s >= tau_sc] (* [t_s - tau_sc
// <= T] at reference fidelity), composed while loading the A tile; K3:
// e_fast (in coarse, already echo-gated) read as it is.  M = Sc, N = K = S.
template <bool SPLIT>
__global__ void __launch_bounds__(TPB)
range_dft_kernel(const float2* __restrict__ coarse,
                 const float2* __restrict__ fine,
                 const float* __restrict__ tau,
                 const float* __restrict__ tvec,
                 const float2* __restrict__ wrng,
                 float2* __restrict__ tout,
                 int Sc, int S, int B, int Q, int has_upper,
                 float echo_upper) {
  __shared__ float sm[2 * BK * BM + 2 * BK * BN];
  const int f = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float accr[4][4] = {}, acci[4][4] = {};
  const float2* co = coarse + (size_t)f * Sc * (SPLIT ? Q : S);
  const float2* fi = SPLIT ? fine + (size_t)f * Sc * B : nullptr;
  const float* ta = SPLIT ? tau + (size_t)f * Sc : nullptr;

  for (int k0 = 0; k0 < S; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += TPB) {
      const int mm = e % BM, kk = e / BM;
      const int sc = m0 + mm, s = k0 + kk;
      float er = 0.f, ei = 0.f;
      if (SPLIT && sc < Sc && s < S) {
        const int q = s / B, j = s - q * B;
        const float2 c = co[sc * Q + q];
        const float2 fn = fi[sc * B + j];
        const float ts = tvec[s], tt = ta[sc];
        float arrived = (ts >= tt) ? 1.f : 0.f;
        if (has_upper && !(ts - tt <= echo_upper)) arrived = 0.f;
        er = (c.x * fn.x - c.y * fn.y) * arrived;
        ei = (c.x * fn.y + c.y * fn.x) * arrived;
      } else if (!SPLIT && sc < Sc && s < S) {
        // Read along sc (a warp touches 32 rows of e_fast): uncoalesced,
        // but each [BM, BK] tile is small and e_fast stays in L2 across
        // the S / BN column tiles.  A coalesced transposing load is later
        // work.
        const float2 v = co[(size_t)sc * S + s];
        er = v.x;
        ei = v.y;
      }
      sm[kk * BM + mm] = er;
      sm[BK * BM + kk * BM + mm] = ei;
    }
    for (int e = threadIdx.x; e < BK * BN; e += TPB) {
      const int nn = e % BN, kk = e / BN;
      const int s = k0 + kk, n = n0 + nn;
      const float2 w = (s < S && n < S) ? wrng[(size_t)s * S + n]
                                        : make_float2(0.f, 0.f);
      sm[2 * BK * BM + kk * BN + nn] = w.x;
      sm[2 * BK * BM + BK * BN + kk * BN + nn] = w.y;
    }
    __syncthreads();
    mma_stage(sm, ty, tx, accr, acci);
    __syncthreads();
  }
  float2* out = tout + (size_t)f * Sc * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < Sc && n < S)
        out[(size_t)m * S + n] = make_float2(accr[i][j], acci[i][j]);
    }
  }
}

// 2. Z[f] = e_at[f] @ T[f] + sigma sqrt(S) (g (*) taps), column 0 zeroed,
// stored transposed: zr/zi[f, s, a*C + c].  K1 (SPLIT): e_at[a*C + c, sc]
// = dopp[sc, c] * ant[sc, a], composed while loading the A tile; K3:
// e_at[m, sc] = e_ac[sc, m] (in ant) read along m, coalesced.
// M = A*C, N = S, K = Sc.  Thread (ty, tx) owns rows tx + 16 i and
// columns ty + 16 j so the transposed store is contiguous along rows.
template <bool SPLIT, int IMPL>
__global__ void __launch_bounds__(TPB)
z_kernel(const float2* __restrict__ ant, const float2* __restrict__ dopp,
         const float2* __restrict__ tin, const int* __restrict__ seeds,
         float* __restrict__ zr, float* __restrict__ zi,
         int A, int C, int S, int Sc, float sn, NoiseTaps taps,
         int dc_removal) {
  constexpr int GW = BN + 2 * MAX_HALO;
  // The matmul stages and the noise tile share one buffer.
  __shared__ __align__(16) float sm[2 * BM * GW];
  const int f = blockIdx.z;
  const int M = A * C;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float accr[4][4] = {}, acci[4][4] = {};
  const float2* an = ant + (size_t)f * Sc * (SPLIT ? A : M);
  const float2* dp = SPLIT ? dopp + (size_t)f * Sc * C : nullptr;
  const float2* tf = tin + (size_t)f * Sc * S;

  for (int k0 = 0; k0 < Sc; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += TPB) {
      const int mm = e % BM, kk = e / BM;
      const int m = m0 + mm, sc = k0 + kk;
      float er = 0.f, ei = 0.f;
      if (SPLIT && m < M && sc < Sc) {
        const int a = m / C, c = m - a * C;
        const float2 d = dp[sc * C + c];
        const float2 w = an[sc * A + a];
        er = d.x * w.x - d.y * w.y;
        ei = d.x * w.y + d.y * w.x;
      } else if (!SPLIT && m < M && sc < Sc) {
        const float2 v = an[(size_t)sc * M + m];
        er = v.x;
        ei = v.y;
      }
      sm[kk * BM + mm] = er;
      sm[BK * BM + kk * BM + mm] = ei;
    }
    for (int e = threadIdx.x; e < BK * BN; e += TPB) {
      const int nn = e % BN, kk = e / BN;
      const int sc = k0 + kk, n = n0 + nn;
      const float2 v = (sc < Sc && n < S) ? tf[(size_t)sc * S + n]
                                          : make_float2(0.f, 0.f);
      sm[2 * BK * BM + kk * BN + nn] = v.x;
      sm[2 * BK * BM + BK * BN + kk * BN + nn] = v.y;
    }
    __syncthreads();
    mma_stage(sm, tx, ty, accr, acci);
    __syncthreads();
  }

  float2* g = reinterpret_cast<float2*>(sm);   // [BM][GW] noise tile
  const bool noisy = sn != 0.0f;
  if (noisy) {
    // Columns n0 - H .. n0 + BN + H - 1 (mod S) of rows m0 .. m0 + BM - 1:
    // each value drawn once, the window taps read it from shared memory.
    const unsigned seed = (unsigned)seeds[f];
    const int H = taps.halo;
    const int w = BN + 2 * H;
    for (int e = threadIdx.x; e < BM * w; e += TPB) {
      const int mm = e / w, jj = e % w;
      const int m = m0 + mm;
      const int col = ((n0 - H + jj) % S + S) % S;
      g[mm * GW + jj] = (m < M)
                            ? normal_pair<IMPL>(seed, (unsigned)(m * S + col))
                            : make_float2(0.f, 0.f);
    }
    __syncthreads();
  }

  float* zro = zr + (size_t)f * S * M;
  float* zio = zi + (size_t)f * S * M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int mm = tx + 16 * i, nn = ty + 16 * j;
      const int m = m0 + mm, n = n0 + nn;
      if (m >= M || n >= S) continue;
      float vr = accr[i][j], vi = acci[i][j];
      if (noisy) {
        float cr = 0.f, ci = 0.f;
        for (int t = 0; t < taps.n; ++t) {
          // roll by off: the tap reads column n - off.
          const float2 gv = g[mm * GW + nn + taps.halo - taps.off[t]];
          const float tr = __fmul_rn(taps.coef[t], gv.x);
          const float ti = __fmul_rn(taps.coef[t], gv.y);
          cr = (t == 0) ? tr : __fadd_rn(cr, tr);
          ci = (t == 0) ? ti : __fadd_rn(ci, ti);
        }
        vr = __fadd_rn(vr, __fmul_rn(sn, cr));
        vi = __fadd_rn(vi, __fmul_rn(sn, ci));
      }
      if (dc_removal && n == 0) {
        vr = 0.f;
        vi = 0.f;
      }
      zro[(size_t)n * M + m] = vr;
      zio[(size_t)n * M + m] = vi;
    }
  }
}

// 1t. Time domain: X[f] = e_at[f] @ e_fast[f] + sigma n, the ADC cube
// [A*C, S] row-major in xout.  The A tile is z_kernel's (e_at composed for
// K1, e_ac read transposed for K3), the B tile range_dft_kernel's A tile
// (e_fast composed from the split tables and the echo gate for K1, read
// for K3).  The epilogue adds sigma (n_re + j n_im) at element m * S + n
// under frame f's seed, as synthpower.cu's synthesis does.
// M = A*C, N = S, K = Sc.
template <bool SPLIT, int IMPL>
__global__ void __launch_bounds__(TPB)
synth_x_kernel(const float2* __restrict__ ant, const float2* __restrict__ dopp,
               const float2* __restrict__ coarse,
               const float2* __restrict__ fine, const float* __restrict__ tau,
               const float* __restrict__ tvec, const int* __restrict__ seeds,
               float2* __restrict__ xout, int A, int C, int S, int Sc, int B,
               int Q, int has_upper, float echo_upper, float sigma) {
  __shared__ float sm[2 * BK * BM + 2 * BK * BN];
  const int f = blockIdx.z;
  const int M = A * C;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float accr[4][4] = {}, acci[4][4] = {};
  const float2* an = ant + (size_t)f * Sc * (SPLIT ? A : M);
  const float2* dp = SPLIT ? dopp + (size_t)f * Sc * C : nullptr;
  const float2* co = coarse + (size_t)f * Sc * (SPLIT ? Q : S);
  const float2* fi = SPLIT ? fine + (size_t)f * Sc * B : nullptr;
  const float* ta = SPLIT ? tau + (size_t)f * Sc : nullptr;

  for (int k0 = 0; k0 < Sc; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += TPB) {
      const int mm = e % BM, kk = e / BM;
      const int m = m0 + mm, sc = k0 + kk;
      float er = 0.f, ei = 0.f;
      if (SPLIT && m < M && sc < Sc) {
        const int a = m / C, c = m - a * C;
        const float2 d = dp[sc * C + c];
        const float2 w = an[sc * A + a];
        er = d.x * w.x - d.y * w.y;
        ei = d.x * w.y + d.y * w.x;
      } else if (!SPLIT && m < M && sc < Sc) {
        const float2 v = an[(size_t)sc * M + m];
        er = v.x;
        ei = v.y;
      }
      sm[kk * BM + mm] = er;
      sm[BK * BM + kk * BM + mm] = ei;
    }
    for (int e = threadIdx.x; e < BK * BN; e += TPB) {
      const int nn = e % BN, kk = e / BN;
      const int sc = k0 + kk, s = n0 + nn;
      float er = 0.f, ei = 0.f;
      if (SPLIT && sc < Sc && s < S) {
        const int q = s / B, j = s - q * B;
        const float2 c = co[sc * Q + q];
        const float2 fn = fi[sc * B + j];
        const float ts = tvec[s], tt = ta[sc];
        float arrived = (ts >= tt) ? 1.f : 0.f;
        if (has_upper && !(ts - tt <= echo_upper)) arrived = 0.f;
        er = (c.x * fn.x - c.y * fn.y) * arrived;
        ei = (c.x * fn.y + c.y * fn.x) * arrived;
      } else if (!SPLIT && sc < Sc && s < S) {
        const float2 v = co[(size_t)sc * S + s];
        er = v.x;
        ei = v.y;
      }
      sm[2 * BK * BM + kk * BN + nn] = er;
      sm[2 * BK * BM + BK * BN + kk * BN + nn] = ei;
    }
    __syncthreads();
    mma_stage(sm, ty, tx, accr, acci);
    __syncthreads();
  }
  const bool noisy = sigma != 0.0f;
  const unsigned seed = noisy ? (unsigned)seeds[f] : 0u;
  float2* xo = xout + (size_t)f * M * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m >= M || n >= S) continue;
      float vr = accr[i][j], vi = acci[i][j];
      if (noisy) {
        const float2 g = normal_pair<IMPL>(seed, (unsigned)(m * S + n));
        vr = __fadd_rn(vr, __fmul_rn(sigma, g.x));
        vi = __fadd_rn(vi, __fmul_rn(sigma, g.y));
      }
      xo[(size_t)m * S + n] = make_float2(vr, vi);
    }
  }
}

// 2t. Time domain: Z[f] = X[f] @ W_rng, stored transposed zr/zi[f, s, m].
// The A tile is read along k (coalesced) into a padded transposed tile;
// no noise (X carries it) and no column zeroing (W_rng folds the DC
// projector, its column 0 is zero).  M = A*C, N = K = S.
__global__ void __launch_bounds__(TPB)
z_time_kernel(const float2* __restrict__ x, const float2* __restrict__ wrng,
              float* __restrict__ zr, float* __restrict__ zi, int M, int S) {
  __shared__ float sm[2 * BK * LDX + 2 * BK * BN];
  const int f = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float accr[4][4] = {}, acci[4][4] = {};
  const float2* xf = x + (size_t)f * M * S;

  for (int k0 = 0; k0 < S; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += TPB) {
      const int kk = e % BK, mm = e / BK;
      const int m = m0 + mm, k = k0 + kk;
      const float2 v = (m < M && k < S) ? xf[(size_t)m * S + k]
                                        : make_float2(0.f, 0.f);
      sm[kk * LDX + mm] = v.x;
      sm[BK * LDX + kk * LDX + mm] = v.y;
    }
    for (int e = threadIdx.x; e < BK * BN; e += TPB) {
      const int nn = e % BN, kk = e / BN;
      const int k = k0 + kk, n = n0 + nn;
      const float2 w = (k < S && n < S) ? wrng[(size_t)k * S + n]
                                        : make_float2(0.f, 0.f);
      sm[2 * BK * LDX + kk * BN + nn] = w.x;
      sm[2 * BK * LDX + BK * BN + kk * BN + nn] = w.y;
    }
    __syncthreads();
    mma_stage<LDX>(sm, tx, ty, accr, acci);
    __syncthreads();
  }
  float* zro = zr + (size_t)f * S * M;
  float* zio = zi + (size_t)f * S * M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx + 16 * i, n = n0 + ty + 16 * j;
      if (m >= M || n >= S) continue;
      zro[(size_t)n * M + m] = accr[i][j];
      zio[(size_t)n * M + m] = acci[i][j];
    }
  }
}

// 3. p[f, d, s] = (1/A) sum_a |sum_c WdopT[d, c] Z[f, s, a*C + c]|^2.
// One block per (PS range bins, frame); Z rows and WdopT staged in shared
// memory (rows padded by one float against bank conflicts).
__global__ void __launch_bounds__(TPB)
doppler_power_kernel(const float* __restrict__ zr,
                     const float* __restrict__ zi,
                     const float2* __restrict__ wdt, float* __restrict__ p,
                     int A, int C, int S) {
  extern __shared__ float dsm[];
  const int M = A * C, ld = M + 1;
  float* zsr = dsm;
  float* zsi = zsr + PS * ld;
  float* wr = zsi + PS * ld;
  float* wi = wr + C * C;
  const int f = blockIdx.y, s0 = blockIdx.x * PS;
  const float* zrf = zr + (size_t)f * S * M;
  const float* zif = zi + (size_t)f * S * M;
  for (int e = threadIdx.x; e < PS * M; e += blockDim.x) {
    const int sl = e / M, col = e % M;
    const int s = s0 + sl;
    zsr[sl * ld + col] = (s < S) ? zrf[(size_t)s * M + col] : 0.f;
    zsi[sl * ld + col] = (s < S) ? zif[(size_t)s * M + col] : 0.f;
  }
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    wr[e] = wdt[e].x;
    wi[e] = wdt[e].y;
  }
  __syncthreads();
  const float inv_a = 1.0f / (float)A;
  for (int o = threadIdx.x; o < PS * C; o += blockDim.x) {
    const int sl = o % PS, d = o / PS;
    const int s = s0 + sl;
    if (s >= S) continue;
    float acc = 0.f;
    for (int a = 0; a < A; ++a) {
      float orr = 0.f, oii = 0.f;
      const float* zra = zsr + sl * ld + a * C;
      const float* zia = zsi + sl * ld + a * C;
      for (int c = 0; c < C; ++c) {
        const float w_r = wr[d * C + c], w_i = wi[d * C + c];
        orr = fmaf(w_r, zra[c], orr);
        orr = fmaf(-w_i, zia[c], orr);
        oii = fmaf(w_r, zia[c], oii);
        oii = fmaf(w_i, zra[c], oii);
      }
      acc += orr * orr + oii * oii;
    }
    p[((size_t)f * C + d) * S + s] = acc * inv_a;
  }
}

__device__ __forceinline__ float window_count(int i, int pad, int n) {
  return (float)(min(i + pad, n - 1) - max(i - pad, 0) + 1);
}

// The clutter gate's level in dB: ln(max(c, 1e-12)) * 10 / ln 10 + offset.
__device__ __forceinline__ float clutter_level(float c, float offset_db) {
  return __fadd_rn(__fmul_rn(logf(fmaxf(c, 1e-12f)), LOG10E_10), offset_db);
}

// 4. CA-CFAR + local max + range gate (+ clutter gate) -> score.  One
// block per frame; the whole [C, S] map and its Doppler-axis
// training-window sums live in shared memory (2 C S floats: 205 KB at
// C = 64, S = 400).  Box sums run along Doppler first, then range, as the
// reference's banded products do.  clutter: [F, C, S] or null.
__global__ void __launch_bounds__(CFAR_THREADS)
cfar_kernel(const float* __restrict__ p, float* __restrict__ score,
            const float* __restrict__ clutter,
            int C, int S, int train, int guard, int neighborhood,
            float offset_db, float threshold_db, int gate_lo, int gate_hi,
            float clutter_offset_db) {
  extern __shared__ float csm[];
  const int n = C * S;
  float* p1 = csm;
  float* tcol = p1 + n;     // training-window sums along Doppler
  const int f = blockIdx.x;
  const float* pf = p + (size_t)f * n;
  const int tpad = train + guard, gpad = guard;
  for (int e = threadIdx.x; e < n; e += blockDim.x) p1[e] = pf[e] + 1e-12f;
  __syncthreads();
  if (train > 0) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int d = e / S, s = e % S;
      float ts = 0.f;
      for (int dd = max(d - tpad, 0); dd <= min(d + tpad, C - 1); ++dd)
        ts += p1[dd * S + s];
      tcol[e] = ts;
    }
    __syncthreads();
  }
  const float n_train = (float)((2 * tpad + 1) * (2 * tpad + 1));
  const float n_guard = (float)((2 * gpad + 1) * (2 * gpad + 1));
  const int r = neighborhood / 2;
  float* out = score + (size_t)f * n;
  const float* cl = clutter ? clutter + (size_t)f * n : nullptr;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int d = e / S, s = e % S;
    const float v = p1[e];
    const float pd = logf(v) * LOG10E_10;
    float thresh = threshold_db;
    if (train > 0) {
      float st = 0.f;
      for (int ss = max(s - tpad, 0); ss <= min(s + tpad, S - 1); ++ss)
        st += tcol[d * S + ss];
      float noise = st / (window_count(d, tpad, C) * window_count(s, tpad, S));
      if (guard > 0) {
        float sg = 0.f;
        for (int ss = max(s - gpad, 0); ss <= min(s + gpad, S - 1); ++ss) {
          float cg = 0.f;
          for (int dd = max(d - gpad, 0); dd <= min(d + gpad, C - 1); ++dd)
            cg += p1[dd * S + ss];
          sg += cg;
        }
        const float gm =
            sg / (window_count(d, gpad, C) * window_count(s, gpad, S));
        noise = (noise * n_train - gm * n_guard) / (n_train - n_guard);
      }
      const float noise_db = logf(fmaxf(noise, 1e-12f)) * LOG10E_10;
      thresh = fmaxf(noise_db + offset_db, threshold_db);
    }
    // Local max against zero-filled neighbours (p1 > 0, so the border
    // never blocks a peak).
    bool peak = true;
    for (int dy = -r; dy <= r; ++dy) {
      for (int dx = -r; dx <= r; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const int dd = d - dy, ss = s - dx;
        const float nb = (dd >= 0 && dd < C && ss >= 0 && ss < S)
                             ? p1[dd * S + ss] : 0.f;
        peak = peak && (v >= nb);
      }
    }
    bool mask = peak && (pd > thresh) && s >= gate_lo && s <= gate_hi;
    if (cl) mask = mask && (pd > clutter_level(cl[e], clutter_offset_db));
    out[e] = mask ? pd : NEG_SCORE;
  }
}

// ---- 4c. the prefix-sum CA-CFAR (cfar_impl "cumsum") ---------------------

// Inclusive log-shift prefix sum of a [C, S] plane along Doppler (axis 0)
// or range (axis 1): x[i] += x[i - sh] for sh = 1, 2, 4, ... < n, each step
// from one plane into the other (the reference's _cumsum_axis order).
// Returns the plane that holds the result; the other is free.
__device__ float* scan_plane(float* a, float* b, int C, int S, int axis) {
  const int n = C * S;
  const int len = axis == 0 ? C : S;
  for (int sh = 1; sh < len; sh *= 2) {
    const int off = axis == 0 ? sh * S : sh;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int i = axis == 0 ? e / S : e % S;
      b[e] = (i >= sh) ? __fadd_rn(a[e], a[e - off]) : a[e];
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
  return a;
}

// Clipped box sum at (d, s) from an inclusive prefix sum along axis:
// cs[min(i + pad, n - 1)] - cs[i - pad - 1] (0 before the start).
__device__ __forceinline__ float box_from_scan(const float* cs, int d, int s,
                                               int C, int S, int axis,
                                               int pad) {
  if (axis == 0) {
    const float hi = cs[min(d + pad, C - 1) * S + s];
    return (d - pad - 1 >= 0) ? __fsub_rn(hi, cs[(d - pad - 1) * S + s]) : hi;
  }
  const float hi = cs[d * S + min(s + pad, S - 1)];
  return (s - pad - 1 >= 0) ? __fsub_rn(hi, cs[d * S + s - pad - 1]) : hi;
}

// One block per frame, three [C, S] planes of shared memory (154 KB at
// C = 32, S = 400): the map, then the prefix sums.  Pass 1 writes the
// candidate score (local max, range gate, clutter gate) from the map; the
// map's plane is then reused by the scans, and the last pass drops the
// candidates that do not clear the threshold.  Each thread re-reads only
// the score entries it wrote itself.
__global__ void __launch_bounds__(CFAR_THREADS)
cfar_cumsum_kernel(const float* __restrict__ p, float* __restrict__ score,
                   const float* __restrict__ clutter, int C, int S,
                   int train, int guard, int neighborhood, float offset_db,
                   float threshold_db, int gate_lo, int gate_hi,
                   float clutter_offset_db) {
  extern __shared__ float csm[];
  const int n = C * S;
  float* P = csm;
  float* Q1 = P + n;
  float* Q2 = Q1 + n;
  const int f = blockIdx.x;
  const float* pf = p + (size_t)f * n;
  float* out = score + (size_t)f * n;
  const float* cl = clutter ? clutter + (size_t)f * n : nullptr;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    P[e] = __fadd_rn(pf[e], 1e-12f);
  __syncthreads();

  const int r = neighborhood / 2;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int d = e / S, s = e % S;
    const float v = P[e];
    const float pd = logf(v) * LOG10E_10;
    bool cand = s >= gate_lo && s <= gate_hi;
    for (int dy = -r; dy <= r; ++dy) {
      for (int dx = -r; dx <= r; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const int dd = d - dy, ss = s - dx;
        const float nb = (dd >= 0 && dd < C && ss >= 0 && ss < S)
                             ? P[dd * S + ss] : 0.f;
        cand = cand && (v >= nb);
      }
    }
    if (cl) cand = cand && (pd > clutter_level(cl[e], clutter_offset_db));
    if (train <= 0) cand = cand && (pd > threshold_db);
    out[e] = cand ? pd : NEG_SCORE;
  }
  __syncthreads();
  if (train <= 0) return;

  const int tpad = train + guard, gpad = guard;
  float* cs_d = scan_plane(P, Q1, C, S, 0);       // Doppler prefix sums
  float* spare = (cs_d == P) ? Q1 : P;
  float* gmean = nullptr;
  float* tbox = Q2;
  if (guard > 0) {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      Q2[e] = box_from_scan(cs_d, e / S, e % S, C, S, 0, gpad);
    __syncthreads();
    float* gs = scan_plane(Q2, spare, C, S, 1);
    gmean = (gs == Q2) ? spare : Q2;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int d = e / S, s = e % S;
      gmean[e] = __fdiv_rn(box_from_scan(gs, d, s, C, S, 1, gpad),
                           __fmul_rn(window_count(d, gpad, C),
                                     window_count(s, gpad, S)));
    }
    __syncthreads();
    tbox = gs;
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    tbox[e] = box_from_scan(cs_d, e / S, e % S, C, S, 0, tpad);
  __syncthreads();
  const float* ts = scan_plane(tbox, cs_d, C, S, 1);

  const float n_train = (float)((2 * tpad + 1) * (2 * tpad + 1));
  const float n_guard = (float)((2 * gpad + 1) * (2 * gpad + 1));
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int d = e / S, s = e % S;
    float noise = __fdiv_rn(box_from_scan(ts, d, s, C, S, 1, tpad),
                            __fmul_rn(window_count(d, tpad, C),
                                      window_count(s, tpad, S)));
    if (gmean)
      noise = __fdiv_rn(__fsub_rn(__fmul_rn(noise, n_train),
                                  __fmul_rn(gmean[e], n_guard)),
                        __fsub_rn(n_train, n_guard));
    const float noise_db = __fmul_rn(logf(fmaxf(noise, 1e-12f)), LOG10E_10);
    const float thresh = fmaxf(__fadd_rn(noise_db, offset_db), threshold_db);
    const float sc = out[e];
    if (sc > NEG_SCORE && !(sc > thresh)) out[e] = NEG_SCORE;
  }
}

// The four launches.  SPLIT: (ant, dopp, coarse, fine, tau, tvec) are the
// split tables; otherwise ant is e_ac [F, Sc, A*C] and coarse e_fast
// [F, Sc, S] (the rest unused).  scratch holds T [F, Sc, S] in the
// range-frequency domain and X [F, A*C, S] in the time domain; sn is
// sigma sqrt(S) on the window taps in the former, sigma in the latter.
template <bool SPLIT>
int launch_frontend(const void* ant, const void* dopp, const void* coarse,
                    const void* fine, const void* tau, const void* tvec,
                    const void* seeds, const void* wrng, const void* wdopt,
                    void* scratch, void* zr, void* zi, void* p, void* score,
                    const void* clutter, int F, int A, int C, int S, int Sc,
                    int B, int Q, int device, int has_upper, float echo_upper,
                    float sn, int n_taps, const int* tap_off,
                    const float* tap_coef, int dc_removal, int train,
                    int guard, int neighborhood, float offset_db,
                    float threshold_db, int gate_lo, int gate_hi, int domain,
                    int impl, int cfar_impl, float clutter_offset_db,
                    void* stream) {
  if (F <= 0 || F > 65535 || n_taps < 0 || n_taps > MAX_TAPS ||
      neighborhood < 1 || (neighborhood & 1) == 0 ||
      (domain != DOMAIN_RANGE_FREQ && domain != DOMAIN_TIME) ||
      (impl != IMPL_FAST && impl != IMPL_BOX_MULLER) ||
      (cfar_impl != CFAR_BOX && cfar_impl != CFAR_CUMSUM) ||
      (long long)A * C * S >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  NoiseTaps taps{};
  taps.n = n_taps;
  for (int t = 0; t < n_taps; ++t) {
    taps.off[t] = tap_off[t];
    taps.coef[t] = tap_coef[t];
    const int h = tap_off[t] < 0 ? -tap_off[t] : tap_off[t];
    if (h > MAX_HALO) return (int)cudaErrorInvalidValue;
    if (h > taps.halo) taps.halo = h;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = A * C;
  const float2* an = static_cast<const float2*>(ant);
  const float2* dp = static_cast<const float2*>(dopp);
  const float2* co = static_cast<const float2*>(coarse);
  const float2* fi = static_cast<const float2*>(fine);
  const float* ta = static_cast<const float*>(tau);
  const float* tv = static_cast<const float*>(tvec);
  const int* sd = static_cast<const int*>(seeds);
  const float2* wr = static_cast<const float2*>(wrng);
  float2* scr = static_cast<float2*>(scratch);
  float* zro = static_cast<float*>(zr);
  float* zio = static_cast<float*>(zi);

  dim3 g2((S + BN - 1) / BN, (M + BM - 1) / BM, F);
  if (domain == DOMAIN_RANGE_FREQ) {
    dim3 g1((S + BN - 1) / BN, (Sc + BM - 1) / BM, F);
    range_dft_kernel<SPLIT><<<g1, TPB, 0, st>>>(
        co, fi, ta, tv, wr, scr, Sc, S, B, Q, has_upper, echo_upper);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (impl == IMPL_FAST)
      z_kernel<SPLIT, IMPL_FAST><<<g2, TPB, 0, st>>>(
          an, dp, scr, sd, zro, zio, A, C, S, Sc, sn, taps, dc_removal);
    else
      z_kernel<SPLIT, IMPL_BOX_MULLER><<<g2, TPB, 0, st>>>(
          an, dp, scr, sd, zro, zio, A, C, S, Sc, sn, taps, dc_removal);
  } else {
    if (impl == IMPL_FAST)
      synth_x_kernel<SPLIT, IMPL_FAST><<<g2, TPB, 0, st>>>(
          an, dp, co, fi, ta, tv, sd, scr, A, C, S, Sc, B, Q, has_upper,
          echo_upper, sn);
    else
      synth_x_kernel<SPLIT, IMPL_BOX_MULLER><<<g2, TPB, 0, st>>>(
          an, dp, co, fi, ta, tv, sd, scr, A, C, S, Sc, B, Q, has_upper,
          echo_upper, sn);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    z_time_kernel<<<g2, TPB, 0, st>>>(scr, wr, zro, zio, M, S);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t pow_smem = sizeof(float) * (2 * PS * (M + 1) + 2 * C * C);
  err = cudaFuncSetAttribute(doppler_power_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)pow_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 g3((S + PS - 1) / PS, F);
  doppler_power_kernel<<<g3, TPB, pow_smem, st>>>(
      zro, zio, static_cast<const float2*>(wdopt), static_cast<float*>(p), A,
      C, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const float* cl = static_cast<const float*>(clutter);
  if (cfar_impl == CFAR_BOX) {
    const size_t cfar_smem = sizeof(float) * 2 * (size_t)C * S;
    err = cudaFuncSetAttribute(cfar_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfar_smem);
    if (err != cudaSuccess) return (int)err;
    cfar_kernel<<<F, CFAR_THREADS, cfar_smem, st>>>(
        static_cast<const float*>(p), static_cast<float*>(score), cl, C, S,
        train, guard, neighborhood, offset_db, threshold_db, gate_lo,
        gate_hi, clutter_offset_db);
  } else {
    const size_t cfar_smem = sizeof(float) * 3 * (size_t)C * S;
    err = cudaFuncSetAttribute(cfar_cumsum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfar_smem);
    if (err != cudaSuccess) return (int)err;
    cfar_cumsum_kernel<<<F, CFAR_THREADS, cfar_smem, st>>>(
        static_cast<const float*>(p), static_cast<float*>(score), cl, C, S,
        train, guard, neighborhood, offset_db, threshold_db, gate_lo,
        gate_hi, clutter_offset_db);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K1: split synthesis factors.
extern "C" int radar_frontend_split(
    const void* ant, const void* dopp, const void* coarse, const void* fine,
    const void* tau, const void* tvec, const void* seeds, const void* wrng,
    const void* wdopt, void* scratch, void* zr, void* zi, void* p,
    void* score, const void* clutter, int F, int A, int C, int S, int Sc,
    int B, int Q, int device, int has_upper, float echo_upper, float sn,
    int n_taps, const int* tap_off, const float* tap_coef, int dc_removal,
    int train, int guard, int neighborhood, float offset_db,
    float threshold_db, int gate_lo, int gate_hi, int domain, int impl,
    int cfar_impl, float clutter_offset_db, void* stream) {
  return launch_frontend<true>(
      ant, dopp, coarse, fine, tau, tvec, seeds, wrng, wdopt, scratch, zr,
      zi, p, score, clutter, F, A, C, S, Sc, B, Q, device, has_upper,
      echo_upper, sn, n_taps, tap_off, tap_coef, dc_removal, train, guard,
      neighborhood, offset_db, threshold_db, gate_lo, gate_hi, domain, impl,
      cfar_impl, clutter_offset_db, stream);
}

// K3: dense factor planes e_ac [F, Sc, A*C] and e_fast [F, Sc, S].
extern "C" int radar_frontend_dense(
    const void* e_ac, const void* e_fast, const void* seeds,
    const void* wrng, const void* wdopt, void* scratch, void* zr, void* zi,
    void* p, void* score, const void* clutter, int F, int A, int C, int S,
    int Sc, int device, float sn, int n_taps, const int* tap_off,
    const float* tap_coef, int dc_removal, int train, int guard,
    int neighborhood, float offset_db, float threshold_db, int gate_lo,
    int gate_hi, int domain, int impl, int cfar_impl,
    float clutter_offset_db, void* stream) {
  return launch_frontend<false>(
      e_ac, nullptr, e_fast, nullptr, nullptr, nullptr, seeds, wrng, wdopt,
      scratch, zr, zi, p, score, clutter, F, A, C, S, Sc, 1, 1, device, 0,
      0.0f, sn, n_taps, tap_off, tap_coef, dc_removal, train, guard,
      neighborhood, offset_db, threshold_db, gate_lo, gate_hi, domain, impl,
      cfar_impl, clutter_offset_db, stream);
}
