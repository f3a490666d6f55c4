// Three-dispatch synthetic front end for NVIDIA Hopper (sm_90a).
//
// Three kernels of the scatterer path's three-dispatch branch, each
// replacing one TPU kernel of radar_slam_tpu/ops/synthpower_pallas.py:
//
//   K6  synth_noise       _noise_kernel :126 (wrapper noise_cube :134):
//       the two standard-normal planes [F, rows, cols] for per-frame seeds,
//       "fast" or "box_muller".
//   K4  synth_power       _power_kernel :153 (wrapper scatterer_power
//       :175): the ADC cube X = e_at e_fast + sigma (n_re + j n_im)
//       [F, A*C, S], its range DFT Z (mix and DC projector folded in), per
//       antenna the Doppler DFT, |.|^2 and the mean over antennas -> power
//       map [F, S, D] (range, Doppler), written in the detection layout.
//   K5  synth_signatures  _sig_kernel :248 (wrapper scatterer_signatures
//       :278): the same X (same seeds, same noise words),
//       G = X W_rc[f] [A*C, K] against the detected cells' range columns,
//       then sig[f, a, k] = sum_c G[a*C + c, k] wd[f, c, k] -> [F, A, K].
//
// The noise is the port's counter-based generator (philox.cuh; ops/noise.py
// is the plain form).  Element (a*C + c, s) of X draws index
// (a*C + c) * S + s, as the port's synthesize_frame does, so the
// three-dispatch and the materialized paths see one noise realization per
// generator state.
//
// K4 (cube_onchip.cuh, shared with frontend.cu's time domain).  What bounds
// it: per frame (A*C = 256, Sc = 128, S = 400) the synthesis product, 13.1 M
// complex MACs (315 M TF32 MACs in 3xTF32), and the Philox noise, 102 k
// draws of two Philox-4x32-10 blocks (one for Box-Muller); the factored
// range DFT is 1.8 M complex MACs (the dense product was 41 M) and the
// Doppler DFT 3.3 M.  Design: one block per (antenna, frame) keeps the
// antenna's C x S cube rows in shared memory from the synthesis (3xTF32
// mma.sync on a cp.async ring, noise in the epilogue) through the FFT and
// the Doppler product; only the antenna's power plane leaves the chip, and
// a second small launch sums the planes in antenna order.  Neither X nor Z
// is written to device memory, as on the TPU.  C <= 32: the block holds all
// of an antenna's chirps.
//
// K5 and K6 (FP32 SIMT, unchanged by the redesign of K4): one
// shared-memory-tiled complex product (64 x 64 output tile, depth 16,
// 4 x 4 complex accumulators per thread) serves K5's synthesis (noise in
// its epilogue) and its per-frame column product, which writes X to a
// scratch buffer (0.82 MB per frame) and reads it back; K5's chirp
// reduction is one thread per (frame, antenna, cell).  K6 is elementwise.
// Every product keeps FP32 accuracy: on the TPU, K4's range product runs as
// one bf16 MXU pass by default (PipelineConfig.power_precision = "default");
// the port's power map is held to 1e-5 of its maximum, which bf16 cannot
// meet.
//
// Built as a shared library with a plain C interface (no PyTorch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// No fast math: the noise needs accurate logf, sqrtf, cosf and sinf.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cube_onchip.cuh"
#include "philox.cuh"

namespace {

constexpr int BM = 64;          // output tile rows
constexpr int BN = 64;          // output tile columns
constexpr int BK = 16;          // reduction depth per stage
constexpr int LDA = BM + 1;     // A-tile row pitch (transposing store)
constexpr int TPB = 256;        // 16 x 16 threads, 4 x 4 outputs each
constexpr int EW = 256;         // threads per elementwise block

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

// K4: power map p [F, S, C] of the synthesized cubes, the cube kept on
// chip (cube_onchip.cuh); pa holds the per-antenna power planes
// [F, A, S, C].  tw / pos / nst / radix: the range DFT's table, input
// positions and radices (ops/range_dft.py).
extern "C" int synth_power(const void* e_ac, const void* e_fast,
                           const void* seeds, const void* mix,
                           const void* tw, const void* pos, int nst,
                           const int* radix, const void* wdopt, void* pa,
                           void* p, int F, int A, int C, int S, int Sc,
                           float sigma, int impl, float inv_a,
                           int dc_removal, int device, void* stream) {
  if (bad_shape(F, A, C, S, Sc, impl) || nst < 0 || nst > FFT_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FftPlan plan{};
  plan.nst = nst;
  for (int t = 0; t < nst; ++t) plan.radix[t] = radix[t];
  const Factors fa{static_cast<const float2*>(e_ac), nullptr,
                   static_cast<const float2*>(e_fast), nullptr, nullptr,
                   nullptr, 1, 1, 0, 0.0f};
  return (int)launch_cube_onchip<false, false, true>(
      fa, nullptr, static_cast<const int*>(seeds), static_cast<const float2*>(mix),
      static_cast<const float2*>(tw), static_cast<const int*>(pos), plan,
      dc_removal, static_cast<const float2*>(wdopt), nullptr, nullptr,
      static_cast<float*>(pa), static_cast<float*>(p), F, A, C, S, Sc, sigma,
      impl, inv_a, static_cast<cudaStream_t>(stream));
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
