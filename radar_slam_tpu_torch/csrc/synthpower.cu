// Three-dispatch synthetic front end for NVIDIA Hopper (sm_90a), FP32 SIMT.
//
// Three kernels of the scatterer path's three-dispatch branch, each
// replacing one TPU kernel of radar_slam_tpu/ops/synthpower_pallas.py:
//
//   K6  synth_noise       _noise_kernel :126 (wrapper noise_cube :134):
//       the two standard-normal planes [F, rows, cols] for per-frame seeds,
//       "fast" or "box_muller".
//   K4  synth_power       _power_kernel :153 (wrapper scatterer_power
//       :175): the ADC cube X = e_at e_fast + sigma (n_re + j n_im)
//       [F, A*C, S], then the range product Z = X W_rng (mix and DC
//       projector folded in), per antenna the Doppler DFT, |.|^2 and the
//       mean over antennas -> power map [F, S, D] (range, Doppler), written
//       in the detection layout.
//   K5  synth_signatures  _sig_kernel :248 (wrapper scatterer_signatures
//       :278): the same X (same seeds, same noise, bit for bit),
//       G = X W_rc[f] [A*C, K] against the detected cells' range columns,
//       then sig[f, a, k] = sum_c G[a*C + c, k] wd[f, c, k] -> [F, A, K].
//
// The noise is the port's counter-based generator (ops/noise.py is the
// plain form): Philox-4x32-10 under key (frame seed, 0) at counter
// (row * S + col, block, 0, 0), through the "fast" or the Box-Muller
// transform, with the same words and the same float operations (the _rn
// intrinsics keep nvcc from contracting them into FMAs).  Element
// (a*C + c, s) of X draws index (a*C + c) * S + s, as the port's
// synthesize_frame does, so the three-dispatch and the materialized paths
// see one noise realization per generator state.
//
// Deviations from the TPU kernels:
// - The TPU kernels never write X to device memory: each keeps the cube in
//   VMEM between the synthesis and the range product.  This port writes X
//   (0.82 MB per frame at A*C = 256, S = 400) to a scratch buffer and
//   reads it back, and K4 writes Z as well (as K7 does).  Keeping X on chip
//   is later work (ROADMAP).
// - Every product runs in FP32.  On the TPU, K4's range product runs as one
//   bf16 MXU pass by default (PipelineConfig.power_precision = "default"),
//   the deviation already recorded for K7; the port's power map is held to
//   1e-5 of its maximum, which bf16 cannot meet.
//
// What bounds them on this card: arithmetic.  Per frame (A*C = 256,
// Sc = 128, S = 400, K = 64): the synthesis is 13.1 M complex MACs
// (105 MFLOP at four real products per complex MAC), K4's range product
// 41 M (328 MFLOP) and its Doppler stage 26 MFLOP; K5's product against
// the columns 6.6 M (52 MFLOP).  Against that, K4 moves ~4.2 MB per frame
// (factors 0.67 MB, X out and in, Z out and in) -- ~110 FLOP per byte,
// above the FP32 SIMT ridge of the H100 (67 TFLOP/s over 3.35 TB/s =
// 20 FLOP per byte).  The Philox draws (10 rounds, two blocks per element
// for "fast") add ~0.1 M integer multiplies per frame.  Design: one
// shared-memory-tiled FP32 SIMT complex product (64 x 64 output tile,
// depth 16, 4 x 4 complex accumulators per thread, four real FMAs per
// complex MAC) serves the synthesis (A operand e_ac [Sc, A*C] read
// transposed, no copy; noise added in the epilogue), the range product and
// K5's per-frame column product; the Doppler stage stages 32 range bins of
// Z and W_dop^T in shared memory (K7's design); K5's chirp reduction is a
// small launch, one thread per (frame, antenna, cell).  K6 is elementwise:
// one thread per element.
//
// Built as a shared library with a plain C interface (no PyTorch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// No fast math: the noise needs accurate logf, sqrtf, cosf and sinf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output tile rows
constexpr int BN = 64;          // output tile columns
constexpr int BK = 16;          // reduction depth per stage
constexpr int LDA = BM + 1;     // A-tile row pitch (transposing store)
constexpr int TPB = 256;        // 16 x 16 threads, 4 x 4 outputs each
constexpr int PS = 32;          // range bins per Doppler block
constexpr int EW = 256;         // threads per elementwise block
constexpr int IMPL_FAST = 0;    // noise transforms (ops/noise.py)
constexpr int IMPL_BOX_MULLER = 1;

// ---- counter-based Gaussian generator ----------------------------------

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

// u1 = (w >> 8) 2^-24 + 2^-25 in (0, 1) and the exact Rayleigh radius.
__device__ __forceinline__ float rayleigh(unsigned w) {
  const float u1 = __fadd_rn(__fmul_rn((float)(w >> 8), 1.0f / 16777216.0f),
                             0.5f / 16777216.0f);
  return sqrtf(__fmul_rn(-2.0f, logf(u1)));
}

// Two standard normals for element idx of a frame's noise plane.
__device__ __forceinline__ float2 normal_pair(unsigned seed, unsigned idx,
                                              int impl) {
  const uint4 a = philox4x32_10(make_uint4(idx, 0u, 0u, 0u),
                                make_uint2(seed, 0u));
  const float r = rayleigh(a.x);
  if (impl == IMPL_BOX_MULLER) {
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

// ---- K6: noise planes, one thread per element ---------------------------
__global__ void __launch_bounds__(EW)
noise_kernel(const int* __restrict__ seeds, float2* __restrict__ out,
             unsigned n, int impl) {
  const int f = blockIdx.y;
  const unsigned i = blockIdx.x * EW + threadIdx.x;
  if (i >= n) return;
  out[(size_t)f * n + i] = normal_pair((unsigned)seeds[f], i, impl);
}

// ---- tiled complex product: out[f] = A[f] @ B[f] (+ sigma N) -------------
// A[m, k] is a[f][m * Kd + k] (row-major) or, with A_T, a[f][k * M + m]
// (the transpose of a row-major [Kd, M] plane: e_ac).  B[k, n] is
// b[f * b_fstride + k * N + n] (b_fstride 0: one matrix for all frames).
// smem layout: Ar, Ai [BK][LDA] then Br, Bi [BK][BN].  Thread (ty, tx)
// accumulates rows ty + 16 i and columns tx + 16 j of the output tile.

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

// With sigma != 0 the epilogue adds sigma (n_re + j n_im) drawn for element
// index m * N + n under frame f's seed (the synthesis: N = S).
template <bool A_T>
__global__ void __launch_bounds__(TPB)
product_kernel(const float2* __restrict__ a, const float2* __restrict__ b,
               float2* __restrict__ out, int M, int N, int Kd,
               long long b_fstride, const int* __restrict__ seeds,
               float sigma, int impl) {
  __shared__ float sm[2 * BK * LDA + 2 * BK * BN];
  const int f = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float accr[4][4] = {}, acci[4][4] = {};
  const float2* af = a + (size_t)f * M * Kd;
  const float2* bf = b + (size_t)f * b_fstride;

  for (int k0 = 0; k0 < Kd; k0 += BK) {
    if (A_T) {
      // A tile along m: consecutive threads read consecutive columns of a
      // row of e_ac.
      for (int e = threadIdx.x; e < BM * BK; e += TPB) {
        const int mm = e % BM, kk = e / BM;
        const int m = m0 + mm, k = k0 + kk;
        const float2 v = (m < M && k < Kd) ? af[(size_t)k * M + m]
                                           : make_float2(0.f, 0.f);
        sm[kk * LDA + mm] = v.x;
        sm[BK * LDA + kk * LDA + mm] = v.y;
      }
    } else {
      // A tile along k (coalesced), stored transposed.
      for (int e = threadIdx.x; e < BM * BK; e += TPB) {
        const int kk = e % BK, mm = e / BK;
        const int m = m0 + mm, k = k0 + kk;
        const float2 v = (m < M && k < Kd) ? af[(size_t)m * Kd + k]
                                           : make_float2(0.f, 0.f);
        sm[kk * LDA + mm] = v.x;
        sm[BK * LDA + kk * LDA + mm] = v.y;
      }
    }
    for (int e = threadIdx.x; e < BK * BN; e += TPB) {
      const int nn = e % BN, kk = e / BN;
      const int k = k0 + kk, n = n0 + nn;
      const float2 w = (k < Kd && n < N) ? bf[(size_t)k * N + n]
                                         : make_float2(0.f, 0.f);
      sm[2 * BK * LDA + kk * BN + nn] = w.x;
      sm[2 * BK * LDA + BK * BN + kk * BN + nn] = w.y;
    }
    __syncthreads();
    mma_stage(sm, ty, tx, accr, acci);
    __syncthreads();
  }
  const bool noisy = sigma != 0.0f;
  const unsigned seed = noisy ? (unsigned)seeds[f] : 0u;
  float2* of = out + (size_t)f * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m >= M || n >= N) continue;
      float vr = accr[i][j], vi = acci[i][j];
      if (noisy) {
        const float2 g = normal_pair(seed, (unsigned)(m * N + n), impl);
        vr = __fadd_rn(vr, __fmul_rn(sigma, g.x));
        vi = __fadd_rn(vi, __fmul_rn(sigma, g.y));
      }
      of[(size_t)m * N + n] = make_float2(vr, vi);
    }
  }
}

// ---- K4's Doppler stage over PS range bins of one frame ------------------
// p[f, s, d] = inv_a sum_a |sum_c WdT[d, c] Z[a*C + c, s]|^2.  Z rows and
// WdT staged in shared memory (WdT rows padded by one float against bank
// conflicts); thread o -> (s = o / C, d = o % C), so a warp reads one Z
// value (broadcast) and stores contiguous Doppler bins.
__global__ void __launch_bounds__(TPB)
doppler_power_kernel(const float2* __restrict__ z,
                     const float2* __restrict__ wdt, float* __restrict__ p,
                     int A, int C, int S, float inv_a) {
  extern __shared__ float dsm[];
  const int M = A * C, ldw = C + 1;
  float* zr = dsm;                  // [M][PS]
  float* zi = zr + M * PS;
  float* wr = zi + M * PS;          // [C][C + 1]
  float* wi = wr + C * ldw;
  const int f = blockIdx.y, s0 = blockIdx.x * PS;
  const float2* zf = z + (size_t)f * M * S;
  for (int e = threadIdx.x; e < M * PS; e += blockDim.x) {
    const int row = e / PS, sl = e % PS;
    const int s = s0 + sl;
    const float2 v = (s < S) ? zf[(size_t)row * S + s] : make_float2(0.f, 0.f);
    zr[e] = v.x;
    zi[e] = v.y;
  }
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int d = e / C, c = e % C;
    wr[d * ldw + c] = wdt[e].x;
    wi[d * ldw + c] = wdt[e].y;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < PS * C; o += blockDim.x) {
    const int sl = o / C, d = o % C;
    const int s = s0 + sl;
    if (s >= S) continue;
    float acc = 0.f;
    for (int a = 0; a < A; ++a) {
      float orr = 0.f, oii = 0.f;
      for (int c = 0; c < C; ++c) {
        const float w_r = wr[d * ldw + c], w_i = wi[d * ldw + c];
        const float v_r = zr[(a * C + c) * PS + sl];
        const float v_i = zi[(a * C + c) * PS + sl];
        orr = fmaf(w_r, v_r, orr);
        orr = fmaf(-w_i, v_i, orr);
        oii = fmaf(w_r, v_i, oii);
        oii = fmaf(w_i, v_r, oii);
      }
      acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(orr, orr),
                                     __fmul_rn(oii, oii)));
    }
    p[((size_t)f * S + s) * C + d] = __fmul_rn(acc, inv_a);
  }
}

// ---- K5's chirp reduction: sig[f, a, k] = sum_c G[f, a*C + c, k] wd[f, c, k]
__global__ void __launch_bounds__(EW)
chirp_reduce_kernel(const float2* __restrict__ g,
                    const float2* __restrict__ wd, float2* __restrict__ sig,
                    int F, int A, int C, int K) {
  const long long o = (long long)blockIdx.x * EW + threadIdx.x;
  if (o >= (long long)F * A * K) return;
  const int k = (int)(o % K);
  const int a = (int)((o / K) % A);
  const int f = (int)(o / ((long long)K * A));
  const float2* gf = g + ((size_t)f * A * C + (size_t)a * C) * K;
  const float2* wf = wd + (size_t)f * C * K;
  float sr = 0.f, si = 0.f;
  for (int c = 0; c < C; ++c) {
    const float2 gv = gf[(size_t)c * K + k];
    const float2 wv = wf[(size_t)c * K + k];
    sr = fmaf(gv.x, wv.x, sr);
    sr = fmaf(-gv.y, wv.y, sr);
    si = fmaf(gv.x, wv.y, si);
    si = fmaf(gv.y, wv.x, si);
  }
  sig[o] = make_float2(sr, si);
}

// X[f] = e_ac[f]^T e_fast[f] + sigma N into xbuf [F, A*C, S].
cudaError_t launch_synthesis(const void* e_ac, const void* e_fast,
                             const void* seeds, void* xbuf, int F, int M,
                             int S, int Sc, float sigma, int impl,
                             cudaStream_t st) {
  dim3 g((S + BN - 1) / BN, (M + BM - 1) / BM, F);
  product_kernel<true><<<g, TPB, 0, st>>>(
      static_cast<const float2*>(e_ac), static_cast<const float2*>(e_fast),
      static_cast<float2*>(xbuf), M, S, Sc, (long long)Sc * S,
      static_cast<const int*>(seeds), sigma, impl);
  return cudaGetLastError();
}

bool bad_shape(int F, int A, int C, int S, int Sc, int impl) {
  return F <= 0 || F > 65535 || A <= 0 || C <= 0 || S <= 0 || Sc <= 0 ||
         (impl != IMPL_FAST && impl != IMPL_BOX_MULLER) ||
         (long long)A * C * S >= (1LL << 32);
}

}  // namespace

// K6: the noise planes [F, n] (complex, interleaved) for per-frame seeds.
extern "C" int synth_noise(const void* seeds, void* out, int F,
                           long long n, int impl, int device, void* stream) {
  if (F <= 0 || F > 65535 || n <= 0 || n >= (1LL << 32) ||
      (impl != IMPL_FAST && impl != IMPL_BOX_MULLER))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + EW - 1) / EW;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 g((unsigned)blocks, F);
  noise_kernel<<<g, EW, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seeds), static_cast<float2*>(out),
      (unsigned)n, impl);
  return (int)cudaGetLastError();
}

// K4: power map p [F, S, C] of the synthesized cubes.
extern "C" int synth_power(const void* e_ac, const void* e_fast,
                           const void* seeds, const void* wrng,
                           const void* wdopt, void* xbuf, void* zbuf,
                           void* p, int F, int A, int C, int S, int Sc,
                           float sigma, int impl, float inv_a, int device,
                           void* stream) {
  if (bad_shape(F, A, C, S, Sc, impl)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = A * C;
  if ((err = launch_synthesis(e_ac, e_fast, seeds, xbuf, F, M, S, Sc, sigma,
                              impl, st)) != cudaSuccess)
    return (int)err;

  dim3 g1((S + BN - 1) / BN, (M + BM - 1) / BM, F);
  product_kernel<false><<<g1, TPB, 0, st>>>(
      static_cast<const float2*>(xbuf), static_cast<const float2*>(wrng),
      static_cast<float2*>(zbuf), M, S, S, 0LL, nullptr, 0.0f, impl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem = sizeof(float) * (2 * (size_t)M * PS + 2 * C * (C + 1));
  err = cudaFuncSetAttribute(doppler_power_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 g2((S + PS - 1) / PS, F);
  doppler_power_kernel<<<g2, TPB, smem, st>>>(
      static_cast<const float2*>(zbuf), static_cast<const float2*>(wdopt),
      static_cast<float*>(p), A, C, S, inv_a);
  return (int)cudaGetLastError();
}

// K5: signatures sig [F, A, K] (complex, before normalization) of the
// synthesized cubes against per-frame range columns wrc [F, S, K] and
// Doppler columns wdc [F, C, K].
extern "C" int synth_signatures(const void* e_ac, const void* e_fast,
                                const void* seeds, const void* wrc,
                                const void* wdc, void* xbuf, void* gbuf,
                                void* sig, int F, int A, int C, int S,
                                int Sc, int K, float sigma, int impl,
                                int device, void* stream) {
  if (bad_shape(F, A, C, S, Sc, impl) || K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = A * C;
  if ((err = launch_synthesis(e_ac, e_fast, seeds, xbuf, F, M, S, Sc, sigma,
                              impl, st)) != cudaSuccess)
    return (int)err;

  dim3 g1((K + BN - 1) / BN, (M + BM - 1) / BM, F);
  product_kernel<false><<<g1, TPB, 0, st>>>(
      static_cast<const float2*>(xbuf), static_cast<const float2*>(wrc),
      static_cast<float2*>(gbuf), M, K, S, (long long)S * K, nullptr, 0.0f,
      impl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long n = (long long)F * A * K;
  chirp_reduce_kernel<<<(unsigned)((n + EW - 1) / EW), EW, 0, st>>>(
      static_cast<const float2*>(gbuf), static_cast<const float2*>(wdc),
      static_cast<float2*>(sig), F, A, C, K);
  return (int)cudaGetLastError();
}
