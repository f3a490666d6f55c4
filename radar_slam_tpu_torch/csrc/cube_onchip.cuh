// The synthesis factors, and the time-domain front end that keeps the ADC
// cube on chip: shared by frontend.cu (K1' and K3 with noise_domain="time")
// and synthpower.cu (K4).
//
// One block per (antenna a, frame f) holds that antenna's cube rows
// X[c, s] = sum_sc e_at[a*C + c, sc] e_fast[sc, s] + sigma n[(a*C + c) S + s]
// (C <= 32 chirps, all S samples) in shared memory:
//   1. the synthesis product in 3xTF32 on the tensor cores, 128 fast-time
//      columns at a time, its operand tiles fed by cp.async through a
//      two-stage ring (K1: e_fast composed once per frame beforehand by
//      compose_efast_kernel, e_at formed in place from the dopp rows and
//      this antenna's ant column); the epilogue adds the Philox noise at
//      the element index of ops/noise.py and multiplies by the range mix
//      vector;
//   2. the range DFT of every row in place (range_fft.cuh), DC bin zeroed;
//   3. Z written transposed zr/zi [F, S, A*C] (K1' only);
//   4. the Doppler DFT W_dop^T Z as a second 3xTF32 product and |.|^2:
//      this antenna's power plane, to pa [F, A, C, S] (K1') or
//      [F, A, S, C] (K4).
// antenna_sum_kernel then sums the A planes in antenna order (no atomics:
// the map repeats bit for bit run to run).  Neither X nor Z goes through
// device memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "range_fft.cuh"
#include "tf32x3.cuh"

namespace {

// The synthesis factors: the split tables of K1 or the dense planes of K3
// and K4 (ant = e_ac [F, Sc, A*C], coarse = e_fast [F, Sc, S]).
struct Factors {
  const float2* ant;      // [F, Sc, A]  | e_ac [F, Sc, A*C]
  const float2* dopp;     // [F, Sc, C]  | unused
  const float2* coarse;   // [F, Sc, Q]  | e_fast [F, Sc, S]
  const float2* fine;     // [F, Sc, B]  | unused
  const float* tau;       // [F, Sc]     | unused
  const float* tvec;      // [S]         | unused
  int B, Q, has_upper;
  float echo_upper;
};

// e_fast[f, sc, s] (sc < Sc, s < S): K1 composes coarse[sc, s / B] *
// fine[sc, s % B] * [t_s >= tau_sc] (* [t_s - tau_sc <= T] at reference
// fidelity); K3 / K4 read the plane.
template <bool SPLIT>
__device__ __forceinline__ float2 efast_at(const Factors& fa, int f, int sc,
                                           int s, int Sc, int S) {
  if constexpr (SPLIT) {
    const size_t row = (size_t)f * Sc + sc;
    const int q = s / fa.B, j = s - q * fa.B;
    const float2 c = fa.coarse[row * fa.Q + q];
    const float2 fn = fa.fine[row * fa.B + j];
    const float ts = fa.tvec[s], tt = fa.tau[row];
    float arrived = (ts >= tt) ? 1.f : 0.f;
    if (fa.has_upper && !(ts - tt <= fa.echo_upper)) arrived = 0.f;
    return make_float2((c.x * fn.x - c.y * fn.y) * arrived,
                       (c.x * fn.y + c.y * fn.x) * arrived);
  } else {
    return fa.coarse[((size_t)f * Sc + sc) * S + s];
  }
}

constexpr int OC_THREADS = 512;  // 16 warps: 2 row halves x 8 column strips
constexpr int OC_ROWS = 32;      // cube rows a block holds (C <= 32)
constexpr int OC_KC = 32;        // reduction depth per ring stage
constexpr int OC_NC = 128;       // fast-time columns per synthesis chunk
constexpr int OC_LDA = 36;       // frag_pitch(OC_ROWS)
constexpr int OC_LDB = 132;      // frag_pitch(OC_NC)
// A ring stage (float2): the A tile [OC_KC][OC_LDA] (e_at rows, or the
// split tables' dopp rows), this antenna's ant column [OC_KC] (split), and
// the B tile [OC_KC][OC_LDB] of e_fast.
constexpr int OC_STAGE = OC_KC * (OC_LDA + 1 + OC_LDB);

__host__ __device__ __forceinline__ int oc_ldx(int S) {
  return frag_pitch((S + 7) & ~7);
}

// Shared memory of cube_onchip_kernel (bytes): the cube rows, the ring,
// the twiddle table and the input positions.
__host__ __forceinline__ size_t oc_smem_bytes(int S) {
  return sizeof(float2) * ((size_t)OC_ROWS * oc_ldx(S) + 2 * OC_STAGE + S) +
         sizeof(int) * (size_t)S;
}

template <bool SPLIT, int IMPL, bool WRITE_Z, bool P_SD>
__global__ void __launch_bounds__(OC_THREADS, 1)
cube_onchip_kernel(Factors fa, const int* __restrict__ seeds,
                   const float2* __restrict__ mix,
                   const float2* __restrict__ twg,
                   const int* __restrict__ posg, FftPlan plan,
                   int dc_removal, const float2* __restrict__ wdt,
                   float* __restrict__ zr, float* __restrict__ zi,
                   float* __restrict__ pa, int A, int C, int S, int Sc,
                   float sigma) {
  extern __shared__ __align__(16) float2 osm[];
  const int a = blockIdx.x, f = blockIdx.y;
  const int M = A * C;
  const int ldx = oc_ldx(S), S8 = (S + 7) & ~7;
  float2* X = osm;                                  // [OC_ROWS][ldx]
  float2* ring = X + OC_ROWS * ldx;                 // 2 stages
  float2* tw = ring + 2 * OC_STAGE;                 // [S]
  int* pos = reinterpret_cast<int*>(tw + S);        // [S]
  for (int e = threadIdx.x; e < S; e += OC_THREADS) {
    tw[e] = twg[e];
    pos[e] = posg[e];
  }
  // Columns S..S8-1 are read by the Doppler product's last tile: zeros.
  for (int e = threadIdx.x; e < OC_ROWS * (S8 - S); e += OC_THREADS)
    X[(e / (S8 - S)) * ldx + S + e % (S8 - S)] = make_float2(0.f, 0.f);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 1, ns = warp >> 1;     // 16-row half, 16-col strip
  const int nk = (Sc + OC_KC - 1) / OC_KC;
  const int total = ((S + OC_NC - 1) / OC_NC) * nk;
  const bool noisy = sigma != 0.0f;
  const unsigned seed = noisy ? (unsigned)seeds[f] : 0u;

  // Every stage arrives by cp.async; e_fast is a plane (K1 composes it
  // once per frame, compose_efast_kernel), e_at of the split tables is
  // formed in place.
  auto load_stage = [&](int it) {
    float2* As = ring + (it & 1) * OC_STAGE;       // [OC_KC][OC_LDA]
    float2* Ant = As + OC_KC * OC_LDA;              // [OC_KC]
    float2* Bs = Ant + OC_KC;                       // [OC_KC][OC_LDB]
    const int n0 = (it / nk) * OC_NC, k0 = (it % nk) * OC_KC;
    for (int e = threadIdx.x; e < OC_KC * OC_ROWS; e += OC_THREADS) {
      const int kk = e / OC_ROWS, r = e % OC_ROWS, sc = k0 + kk;
      const bool ok = r < C && sc < Sc;
      const size_t row = (size_t)f * Sc + sc;
      if constexpr (SPLIT)
        cp_async8(&As[kk * OC_LDA + r], ok ? fa.dopp + row * C + r : fa.dopp,
                  ok);
      else
        cp_async8(&As[kk * OC_LDA + r], ok ? fa.ant + row * M + a * C + r
                                           : fa.ant, ok);
    }
    for (int e = threadIdx.x; e < OC_KC * OC_NC; e += OC_THREADS) {
      const int kk = e / OC_NC, nn = e % OC_NC;
      const int sc = k0 + kk, s = n0 + nn;
      const bool ok = sc < Sc && s < S;
      cp_async8(&Bs[kk * OC_LDB + nn],
                ok ? fa.coarse + ((size_t)f * Sc + sc) * S + s : fa.coarse,
                ok);
    }
    if constexpr (SPLIT) {
      for (int e = threadIdx.x; e < OC_KC; e += OC_THREADS) {
        const int sc = k0 + e;
        const bool ok = sc < Sc;
        cp_async8(&Ant[e], ok ? fa.ant + ((size_t)f * Sc + sc) * A + a
                              : fa.ant, ok);
      }
    }
    cp_async_commit();
  };

  // 1. X = e_at e_fast + sigma n, times mix, at the FFT's input positions.
  float accr[2][4], acci[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) accr[j][i] = acci[j][i] = 0.f;
  load_stage(0);
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) load_stage(it + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float2* As = ring + (it & 1) * OC_STAGE;
    float2* Bs = As + OC_KC * OC_LDA + OC_KC;
    const int n0 = (it / nk) * OC_NC, kc = it % nk;
    if constexpr (SPLIT) {
      // e_at[c, k] = dopp[k, c] ant[k, a], in place.
      const float2* Ant = As + OC_KC * OC_LDA;
      for (int e = threadIdx.x; e < OC_KC * OC_ROWS; e += OC_THREADS) {
        const int kk = e / OC_ROWS, r = e % OC_ROWS;
        const float2 d = As[kk * OC_LDA + r], w = Ant[kk];
        As[kk * OC_LDA + r] = make_float2(d.x * w.x - d.y * w.y,
                                          d.x * w.y + d.y * w.x);
      }
      __syncthreads();
    }
    if (16 * mt < C) {
      // This stage's sum in fresh accumulators (high terms, small terms),
      // added to the FP32 sum once per stage.
      float hr[2][4] = {}, hi[2][4] = {}, lr[2][4] = {}, li[2][4] = {};
      for (int ks = 0; ks < OC_KC && kc * OC_KC + ks < Sc; ks += 8) {
        const FragA fa_ = load_frag_a(As, 1, OC_LDA, 16 * mt, ks);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int nb = 16 * ns + 8 * nt;
          if (n0 + nb >= S) continue;
          const FragB fb = load_frag_b(Bs, OC_LDB, ks, nb);
          cmma3_split(hr[nt], hi[nt], lr[nt], li[nt], fa_, fb);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          accr[nt][i] += hr[nt][i] + lr[nt][i];
          acci[nt][i] += hi[nt][i] + li[nt][i];
        }
    }
    if (kc == nk - 1) {
      // The chunk's eight noise pairs of this thread, drawn unconditionally
      // (independent Philox chains the compiler can interleave).
      float2 nz[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * mt + g + 8 * (i >> 1);
          const int s = n0 + 16 * ns + 8 * nt + 2 * t + (i & 1);
          nz[nt][i] = noisy ? normal_pair<IMPL>(
                                  seed, (unsigned)((a * C + r) * S + s))
                            : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * mt + g + 8 * (i >> 1);
          const int s = n0 + 16 * ns + 8 * nt + 2 * t + (i & 1);
          float vr = accr[nt][i], vi = acci[nt][i];
          accr[nt][i] = acci[nt][i] = 0.f;
          if (s >= S) continue;
          if (r >= C) {
            vr = vi = 0.f;
          } else if (noisy) {
            vr = __fadd_rn(vr, __fmul_rn(sigma, nz[nt][i].x));
            vi = __fadd_rn(vi, __fmul_rn(sigma, nz[nt][i].y));
          }
          const float2 mx = mix[s];
          X[r * ldx + pos[s]] = make_float2(vr * mx.x - vi * mx.y,
                                            vr * mx.y + vi * mx.x);
        }
      }
    }
    __syncthreads();
  }

  // 2. The range DFT of the C rows (the ring is the dense route's scratch).
  fft_rows(X, C, ldx, S, plan, tw, ring);
  float2* Ws = ring;                      // [OC_ROWS][OC_LDA]: W_dop^T
  for (int e = threadIdx.x; e < OC_ROWS * OC_LDA; e += OC_THREADS) {
    const int d = e / OC_LDA, c = e % OC_LDA;
    Ws[e] = (d < C && c < C) ? wdt[d * C + c] : make_float2(0.f, 0.f);
  }
  if (dc_removal)
    for (int r = threadIdx.x; r < C; r += OC_THREADS)
      X[r * ldx] = make_float2(0.f, 0.f);
  __syncthreads();

  // 3. Z transposed (K1').
  if constexpr (WRITE_Z) {
    for (int e = threadIdx.x; e < C * S; e += OC_THREADS) {
      const int r = e % C, k = e / C;
      const float2 v = X[r * ldx + k];
      const size_t o = ((size_t)f * S + k) * M + a * C + r;
      zr[o] = v.x;
      zi[o] = v.y;
    }
  }

  // 4. This antenna's Doppler power |W_dop^T Z|^2.
  const int Cp = (C + 7) & ~7, mtiles = (Cp + 15) / 16;
  const int ntiles = S8 / 8;
  for (int ti = warp; ti < mtiles * ntiles; ti += OC_THREADS / 32) {
    const int m16 = (ti % mtiles) * 16, nb = (ti / mtiles) * 8;
    float orr[4] = {}, oii[4] = {}, err[4] = {}, eii[4] = {};
    for (int kb = 0; kb < Cp; kb += 8) {
      const FragA wf = load_frag_a(Ws, OC_LDA, 1, m16, kb);
      const FragB zf = load_frag_b(X, ldx, kb, nb);
      cmma3_split(orr, oii, err, eii, wf, zf);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = m16 + g + 8 * (i >> 1), k = nb + 2 * t + (i & 1);
      if (d >= C || k >= S) continue;
      const float o_r = orr[i] + err[i], o_i = oii[i] + eii[i];
      const float pw = __fadd_rn(__fmul_rn(o_r, o_r), __fmul_rn(o_i, o_i));
      const size_t plane = (size_t)f * A + a;
      pa[P_SD ? (plane * S + k) * C + d : (plane * C + d) * S + k] = pw;
    }
  }
}

// e_fast [F, Sc, S] of the split tables (efast_at), once per frame: the
// time-domain kernel's blocks (one per antenna) then all read the plane.
__global__ void __launch_bounds__(256)
compose_efast_kernel(Factors fa, float2* __restrict__ out, int S, int Sc) {
  const int f = blockIdx.y;
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= Sc * S) return;
  out[(size_t)f * Sc * S + e] = efast_at<true>(fa, f, e / S, e % S, Sc, S);
}

// p[f, e] = inv_a sum_a pa[f, a, e] over the n = C S cells of a frame, in
// antenna order.
__global__ void __launch_bounds__(256)
antenna_sum_kernel(const float* __restrict__ pa, float* __restrict__ p,
                   int A, int n, float inv_a) {
  const int f = blockIdx.y;
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  const float* src = pa + (size_t)f * A * n + e;
  float acc = src[0];
  for (int a = 1; a < A; ++a) acc = __fadd_rn(acc, src[(size_t)a * n]);
  p[(size_t)f * n + e] = __fmul_rn(acc, inv_a);
}

// Launch the on-chip cube kernel and the antenna sum: p [F, C, S] (P_SD
// false) or [F, S, C]; zr / zi written when WRITE_Z.  SPLIT: e_fast is
// first composed into efast [F, Sc, S].
template <bool SPLIT, bool WRITE_Z, bool P_SD>
cudaError_t launch_cube_onchip(Factors fa, float2* efast, const int* seeds,
                               const float2* mix, const float2* tw,
                               const int* pos, const FftPlan& plan,
                               int dc_removal, const float2* wdt, float* zr,
                               float* zi, float* pa, float* p, int F, int A,
                               int C, int S, int Sc, float sigma, int impl,
                               float inv_a, cudaStream_t st) {
  if (C > OC_ROWS || F <= 0 || F > 65535 || A <= 0 || A > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = oc_smem_bytes(S);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err;
  if (SPLIT) {
    compose_efast_kernel<<<dim3((Sc * S + 255) / 256, F), 256, 0, st>>>(
        fa, efast, S, Sc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    fa.coarse = efast;
  }
  auto kern = impl == IMPL_BOX_MULLER
                  ? cube_onchip_kernel<SPLIT, IMPL_BOX_MULLER, WRITE_Z, P_SD>
                  : cube_onchip_kernel<SPLIT, IMPL_FAST, WRITE_Z, P_SD>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(A, F), OC_THREADS, smem, st>>>(fa, seeds, mix, tw, pos, plan,
                                             dc_removal, wdt, zr, zi, pa, A,
                                             C, S, Sc, sigma);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = C * S;
  antenna_sum_kernel<<<dim3((n + 255) / 256, F), 256, 0, st>>>(pa, p, A, n,
                                                               inv_a);
  return cudaGetLastError();
}

}  // namespace
