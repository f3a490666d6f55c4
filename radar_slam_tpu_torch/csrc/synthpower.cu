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
//       :278): the same X (same seeds, same noise words) and Z, then per
//       detected cell k sig[f, a, k] = sum_c W_dop^T[d_k, c] Z[a*C + c, r_k]
//       scaled to unit power over the antennas -> [F, K, A].
//
// The noise is the port's counter-based generator (philox.cuh; ops/noise.py
// is the plain form).  Element (a*C + c, s) of X draws index
// (a*C + c) * S + s, as the port's synthesize_frame does, so the
// three-dispatch and the materialized paths see one noise realization per
// generator state.
//
// K4 and K5 are one kernel (cube_onchip.cuh, shared with frontend.cu's
// time domain and cube.cu's K7) with two consumers.  What bounds them: per
// frame (A*C = 256, Sc = 128, S = 400) the synthesis product, 13.1 M
// complex MACs (315 M TF32 MACs in 3xTF32), and the Philox noise, 102 k
// draws of two Philox-4x32-10 blocks (one for Box-Muller); the factored
// range DFT is 1.8 M complex MACs and K4's Doppler DFT 3.3 M; K5's
// signatures are A K C = 16 k complex MACs.  Design: one block per
// (antenna, frame) -- a cluster of ceil(C / 32) blocks where C > 32 --
// keeps the antenna's C x S cube rows in shared memory from the synthesis
// (3xTF32 mma.sync on a cp.async ring, noise in the epilogue) through the
// FFT to the consumer: K4 the Doppler product and |.|^2 (the antenna's
// power plane leaves the chip, a second launch sums the planes in antenna
// order); K5 the detected cells' columns of Z against rows of the same
// W_dop^T, so K4's map and K5's signatures are one transform, then a
// second launch scales each signature to unit power.  Neither X nor Z is
// written to device memory, as on the TPU.  K6 is elementwise.  Every
// product keeps FP32 accuracy: on the TPU, K4's range product runs as one
// bf16 MXU pass by default (PipelineConfig.power_precision = "default");
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

bool bad_shape(int F, int A, int C, int S, int Sc, int impl, int nst) {
  return F <= 0 || F > 65535 || A <= 0 || C <= 0 || S <= 0 || Sc <= 0 ||
         (impl != IMPL_FAST && impl != IMPL_BOX_MULLER) ||
         (long long)A * C * S >= (1LL << 32) || nst < 0 ||
         nst > FFT_MAX_STAGES;
}

// The on-chip kernel's arguments shared by K4 and K5: the dense factors,
// the seeds and the range DFT's mix, table, positions and plan.
OcArgs synth_args(const void* e_ac, const void* e_fast, const void* seeds,
                  const void* mix, const void* tw, const void* pos, int nst,
                  const int* radix, const void* wdopt, int A, int C, int S,
                  int Sc, float sigma, int dc_removal) {
  OcArgs p{};
  p.fa = Factors{static_cast<const float2*>(e_ac), nullptr,
                 static_cast<const float2*>(e_fast), nullptr, nullptr,
                 nullptr, 1, 1, 0, 0.0f};
  p.seeds = static_cast<const int*>(seeds);
  p.mix = static_cast<const float2*>(mix);
  p.tw = static_cast<const float2*>(tw);
  p.pos = static_cast<const int*>(pos);
  p.plan.nst = nst;
  for (int t = 0; t < nst; ++t) p.plan.radix[t] = radix[t];
  p.wdt = static_cast<const float2*>(wdopt);
  p.A = A;
  p.C = C;
  p.S = S;
  p.Sc = Sc;
  p.sigma = sigma;
  p.dc_removal = dc_removal;
  return p;
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
  if (bad_shape(F, A, C, S, Sc, impl, nst)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  OcArgs a = synth_args(e_ac, e_fast, seeds, mix, tw, pos, nst, radix, wdopt,
                        A, C, S, Sc, sigma, dc_removal);
  a.pa = static_cast<float*>(pa);
  return (int)launch_cube_onchip<SRC_DENSE, OUT_PSC>(
      a, nullptr, static_cast<float*>(p), F, impl, inv_a,
      static_cast<cudaStream_t>(stream));
}

// K5: unit-power signatures sig [F, K, A] (complex) of the synthesized
// cubes at the detected cells (range_bin / doppler_bin [F, K] int32), the
// cube kept on chip as in K4: two launches.
extern "C" int synth_signatures(const void* e_ac, const void* e_fast,
                                const void* seeds, const void* mix,
                                const void* tw, const void* pos, int nst,
                                const int* radix, const void* wdopt,
                                const void* range_bin,
                                const void* doppler_bin, void* sig, int F,
                                int A, int C, int S, int Sc, int K,
                                float sigma, int impl, int dc_removal,
                                int device, void* stream) {
  if (bad_shape(F, A, C, S, Sc, impl, nst) || K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  OcArgs a = synth_args(e_ac, e_fast, seeds, mix, tw, pos, nst, radix, wdopt,
                        A, C, S, Sc, sigma, dc_removal);
  a.rbin = static_cast<const int*>(range_bin);
  a.dbin = static_cast<const int*>(doppler_bin);
  a.sig = static_cast<float2*>(sig);
  a.K = K;
  return (int)launch_cube_onchip<SRC_DENSE, OUT_SIG>(
      a, nullptr, nullptr, F, impl, 1.0f, static_cast<cudaStream_t>(stream));
}
