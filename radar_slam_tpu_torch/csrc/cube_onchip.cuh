// The synthesis factors, and the front end that keeps one antenna's ADC
// cube rows on chip from the first stage to the last: shared by frontend.cu
// (K1' and K3 with noise_domain="time"), synthpower.cu (K4, K5) and cube.cu
// (K7).
//
// One block per (antenna a, frame f, chirp block h) holds 32 cube rows
// X[c, s], c in [32 h, 32 h + 32), all S samples, in shared memory:
//   1. the rows arrive by one of two producers:
//      synthesis (K1', K3, K4, K5): X[c, s] = sum_sc e_at[a*C + c, sc]
//        e_fast[sc, s] + sigma n[(a*C + c) S + s] in 3xTF32 on the tensor
//        cores, 128 fast-time columns at a time, its operand tiles fed by
//        cp.async through a two-stage ring (K1: e_fast composed once per
//        frame beforehand by compose_efast_kernel, e_at formed in place
//        from the dopp rows and this antenna's ant column); the epilogue
//        adds the Philox noise at the element index of ops/noise.py;
//      load (K7): the cube's rows [F, A, C, S], one contiguous run per
//        block, by 8-byte cp.async straight to the FFT's input positions;
//      either way times the range mix vector, at the FFT's input positions;
//   2. the range DFT of every row in place (range_fft.cuh), DC bin zeroed;
//   3. (K1') Z written transposed zr/zi [F, S, A*C];
//   4. one of two consumers:
//      power: the Doppler DFT W_dop^T Z as a second 3xTF32 product and
//        |.|^2, this block's 32 Doppler bins of the antenna's power plane,
//        to pa [F, A, C, S] (K1') or [F, A, S, C] (K4, K7); a second launch
//        (antenna_sum_kernel) sums the A planes in antenna order;
//      signatures (K5): per detected cell k, sum_c W_dop^T[d_k, c] Z[c, r_k]
//        into sig [F, K, A]; a second launch (sig_normalize_kernel) scales
//        each (f, k) to unit power over the antennas.
// No atomics: every output repeats bit for bit run to run.  Neither X nor Z
// goes through device memory.
//
// C <= 32: one block per (antenna, frame).  32 < C <= 256: a thread-block
// cluster of ceil(C / 32) blocks per (antenna, frame), launched with
// cudaLaunchKernelEx; after cluster.sync() block h reads the other blocks'
// Z rows as B fragments through distributed shared memory for its Doppler
// bins [32 h, 32 h + 32) (power), or block 0 adds the blocks' partial sums
// over chirps in block order (signatures).
#pragma once

#include <cooperative_groups.h>
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
constexpr int OC_ROWS = 32;      // cube rows a block holds
constexpr int OC_MAX_CLUSTER = 8;  // blocks per (antenna, frame): C <= 256
constexpr int OC_KC = 32;        // reduction depth per ring stage
constexpr int OC_NC = 128;       // fast-time columns per synthesis chunk
constexpr int OC_LDA = 36;       // frag_pitch(OC_ROWS)
constexpr int OC_LDB = 132;      // frag_pitch(OC_NC)
// A ring stage (float2): the A tile [OC_KC][OC_LDA] (e_at rows, or the
// split tables' dopp rows), this antenna's ant column [OC_KC] (split), and
// the B tile [OC_KC][OC_LDB] of e_fast.
constexpr int OC_STAGE = OC_KC * (OC_LDA + 1 + OC_LDB);
constexpr int OC_RING = 2 * OC_STAGE;

// Producers and consumers (template arguments of cube_onchip_kernel).
constexpr int SRC_SPLIT = 0;     // synthesis from K1's split tables
constexpr int SRC_DENSE = 1;     // synthesis from the dense planes
constexpr int SRC_CUBE = 2;      // the cube's rows, loaded (K7)
constexpr int OUT_Z_PCS = 0;     // Z transposed + planes [F, A, C, S] (K1')
constexpr int OUT_PSC = 1;       // planes [F, A, S, C] (K4, K7)
constexpr int OUT_SIG = 2;       // detected cells' signatures (K5)

__host__ __device__ __forceinline__ int oc_ldx(int S) {
  return frag_pitch((S + 7) & ~7);
}

// Shared memory of cube_onchip_kernel (bytes): the cube rows, the ring,
// the twiddle table and the input positions.
__host__ __forceinline__ size_t oc_smem_bytes(int S) {
  return sizeof(float2) * ((size_t)OC_ROWS * oc_ldx(S) + OC_RING + S) +
         sizeof(int) * (size_t)S;
}

struct OcArgs {
  Factors fa;                   // SRC_SPLIT, SRC_DENSE
  const float2* cube;           // SRC_CUBE: [F, A, C, S]
  const int* seeds;             // [F] (synthesis)
  const float2* mix;            // [S]
  const float2* tw;             // [S] the range DFT's twiddle table
  const int* pos;               // [S] its input positions
  FftPlan plan;
  const float2* wdt;            // W_dop^T [C, C]
  float* zr;                    // OUT_Z_PCS: [F, S, A*C]
  float* zi;
  float* pa;                    // OUT_Z_PCS, OUT_PSC: the planes
  const int* rbin;              // OUT_SIG: [F, K]
  const int* dbin;
  float2* sig;                  // OUT_SIG: [F, K, A]
  int A, C, S, Sc, K, nblk, dc_removal;
  float sigma;
};

template <int SRC, int IMPL, int OUT>
__global__ void __launch_bounds__(OC_THREADS, 1)
cube_onchip_kernel(const OcArgs p) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float2 osm[];
  const int nblk = p.nblk;
  const int a = blockIdx.x / nblk, h = blockIdx.x - a * nblk;
  const int f = blockIdx.y;
  const int A = p.A, C = p.C, S = p.S, Sc = p.Sc, M = A * C;
  const int c0 = h * OC_ROWS;                   // this block's first chirp
  const int rows = min(OC_ROWS, C - c0);        // and its number of chirps
  const int ldx = oc_ldx(S), S8 = (S + 7) & ~7;
  float2* X = osm;                                  // [OC_ROWS][ldx]
  float2* ring = X + OC_ROWS * ldx;                 // 2 stages
  float2* tw = ring + OC_RING;                      // [S]
  int* pos = reinterpret_cast<int*>(tw + S);        // [S]
  for (int e = threadIdx.x; e < S; e += OC_THREADS) {
    tw[e] = p.tw[e];
    pos[e] = p.pos[e];
  }
  // Columns S..S8-1 are read by the Doppler product's last tile: zeros.
  for (int e = threadIdx.x; e < OC_ROWS * (S8 - S); e += OC_THREADS)
    X[(e / (S8 - S)) * ldx + S + e % (S8 - S)] = make_float2(0.f, 0.f);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  if constexpr (SRC == SRC_CUBE) {
    // 1. The block's rows of the cube, one contiguous run, to the FFT's
    // input positions; then times the mix (permuted into the ring, free
    // until the FFT).
    __syncthreads();
    float2* mixp = ring;
    for (int s = threadIdx.x; s < S; s += OC_THREADS) mixp[pos[s]] = p.mix[s];
    const float2* src = p.cube + (((size_t)f * A + a) * C + c0) * S;
    for (int e = threadIdx.x; e < rows * S; e += OC_THREADS) {
      const int r = e / S;
      cp_async8(&X[r * ldx + pos[e - r * S]], src + e, true);
    }
    cp_async_commit();
    // Rows beyond C (the last block of a cluster) are read by the Doppler
    // product: zeros.
    for (int e = threadIdx.x; e < (OC_ROWS - rows) * S; e += OC_THREADS)
      X[(rows + e / S) * ldx + e % S] = make_float2(0.f, 0.f);
    cp_async_wait<0>();
    __syncthreads();
    for (int e = threadIdx.x; e < rows * S; e += OC_THREADS) {
      const int r = e / S, q = e - r * S;
      const float2 v = X[r * ldx + q], mx = mixp[q];
      X[r * ldx + q] = make_float2(v.x * mx.x - v.y * mx.y,
                                   v.x * mx.y + v.y * mx.x);
    }
  } else {
    constexpr bool SPLIT = SRC == SRC_SPLIT;
    const Factors& fa = p.fa;
    const int mt = warp & 1, ns = warp >> 1;   // 16-row half, 16-col strip
    const int nk = (Sc + OC_KC - 1) / OC_KC;
    const int total = ((S + OC_NC - 1) / OC_NC) * nk;
    const bool noisy = p.sigma != 0.0f;
    const unsigned seed = noisy ? (unsigned)p.seeds[f] : 0u;

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
        const bool ok = r < rows && sc < Sc;
        const size_t row = (size_t)f * Sc + sc;
        if constexpr (SPLIT)
          cp_async8(&As[kk * OC_LDA + r],
                    ok ? fa.dopp + row * C + c0 + r : fa.dopp, ok);
        else
          cp_async8(&As[kk * OC_LDA + r],
                    ok ? fa.ant + row * M + a * C + c0 + r : fa.ant, ok);
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
      if (16 * mt < rows) {
        // This stage's sum in fresh accumulators (high terms, small
        // terms), added to the FP32 sum once per stage.
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
        // The chunk's eight noise pairs of this thread, drawn
        // unconditionally (independent Philox chains the compiler can
        // interleave).
        float2 nz[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = c0 + 16 * mt + g + 8 * (i >> 1);
            const int s = n0 + 16 * ns + 8 * nt + 2 * t + (i & 1);
            const unsigned idx = (unsigned)(a * C + c) * (unsigned)S + s;
            nz[nt][i] = noisy ? normal_pair<IMPL>(seed, idx)
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
            if (r >= rows) {
              vr = vi = 0.f;
            } else if (noisy) {
              vr = __fadd_rn(vr, __fmul_rn(p.sigma, nz[nt][i].x));
              vi = __fadd_rn(vi, __fmul_rn(p.sigma, nz[nt][i].y));
            }
            const float2 mx = p.mix[s];
            X[r * ldx + pos[s]] = make_float2(vr * mx.x - vi * mx.y,
                                              vr * mx.y + vi * mx.x);
          }
        }
      }
      __syncthreads();
    }
  }

  // 2. The range DFT of the block's rows (the ring is the dense route's
  // scratch).
  fft_rows(X, rows, ldx, S, p.plan, tw, ring);
  if (p.dc_removal)
    for (int r = threadIdx.x; r < rows; r += OC_THREADS)
      X[r * ldx] = make_float2(0.f, 0.f);

  if constexpr (OUT == OUT_SIG) {
    // 4. Per detected cell: sum_c W_dop^T[d_k, c] Z[c, r_k] over the
    // block's chirps, one warp a cell, one lane a chirp, a fixed-order
    // shuffle tree; the blocks of a cluster then add in block order.
    __syncthreads();
    const int K = p.K;
    float2* part = ring;                            // [K]
    for (int k = warp; k < K; k += OC_THREADS / 32) {
      const int r = ((p.rbin[(size_t)f * K + k] % S) + S) % S;
      const int d = ((p.dbin[(size_t)f * K + k] % C) + C) % C;
      float2 v = make_float2(0.f, 0.f);
      if (lane < rows) {
        const float2 w = p.wdt[(size_t)d * C + c0 + lane];
        const float2 z = X[lane * ldx + r];
        v = make_float2(w.x * z.x - w.y * z.y, w.x * z.y + w.y * z.x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
        v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
      }
      if (lane == 0) {
        if (nblk == 1) p.sig[((size_t)f * K + k) * A + a] = v;
        else part[k] = v;
      }
    }
    if (nblk > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (h == 0) {
        for (int k = threadIdx.x; k < K; k += OC_THREADS) {
          float2 acc = part[k];
          for (int q = 1; q < nblk; ++q) {
            const float2 v = cluster.map_shared_rank(part, q)[k];
            acc.x += v.x;
            acc.y += v.y;
          }
          p.sig[((size_t)f * K + k) * A + a] = acc;
        }
      }
      cluster.sync();   // no block leaves while block 0 reads its sums
    }
    return;
  } else {
    // W_dop^T rows of the block's Doppler bins [c0, c0 + 32), all C
    // columns, into the ring (free after the FFT).
    const int Cp = (C + 7) & ~7, ldw = frag_pitch(Cp);
    float2* Ws = ring;                              // [OC_ROWS][ldw]
    for (int e = threadIdx.x; e < OC_ROWS * ldw; e += OC_THREADS) {
      const int i = e / ldw, c = e % ldw, d = c0 + i;
      Ws[e] = (d < C && c < C) ? p.wdt[d * C + c] : make_float2(0.f, 0.f);
    }
    __syncthreads();

    // 3. Z transposed (K1').
    if constexpr (OUT == OUT_Z_PCS) {
      for (int e = threadIdx.x; e < rows * S; e += OC_THREADS) {
        const int r = e % rows, k = e / rows;
        const float2 v = X[r * ldx + k];
        const size_t o = ((size_t)f * S + k) * M + a * C + c0 + r;
        p.zr[o] = v.x;
        p.zi[o] = v.y;
      }
    }
    // Every block's Z rows are in before any block reads another's.
    if (nblk > 1) cg::this_cluster().sync();

    // 4. This antenna's Doppler power |W_dop^T Z|^2 at the block's bins;
    // Z rows kb.. of block kb / 32 (distributed shared memory beyond the
    // block's own).
    const int mtiles = (rows + 15) / 16, ntiles = S8 / 8;
    for (int ti = warp; ti < mtiles * ntiles; ti += OC_THREADS / 32) {
      const int m16 = (ti % mtiles) * 16, nb = (ti / mtiles) * 8;
      float orr[4] = {}, oii[4] = {}, err[4] = {}, eii[4] = {};
      for (int kb = 0; kb < Cp; kb += 8) {
        const int q = kb / OC_ROWS;
        const float2* Xq =
            q == h ? X : cg::this_cluster().map_shared_rank(X, q);
        const FragA wf = load_frag_a(Ws, ldw, 1, m16, kb);
        const FragB zf = load_frag_b(Xq, ldx, kb - q * OC_ROWS, nb);
        cmma3_split(orr, oii, err, eii, wf, zf);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = c0 + m16 + g + 8 * (i >> 1);
        const int k = nb + 2 * t + (i & 1);
        if (d >= C || k >= S) continue;
        const float o_r = orr[i] + err[i], o_i = oii[i] + eii[i];
        const float pw = __fadd_rn(__fmul_rn(o_r, o_r), __fmul_rn(o_i, o_i));
        const size_t plane = (size_t)f * A + a;
        p.pa[OUT == OUT_PSC ? (plane * S + k) * C + d
                            : (plane * C + d) * S + k] = pw;
      }
    }
    // No block leaves while another reads its rows.
    if (nblk > 1) cg::this_cluster().sync();
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

// sig[i, :] /= sqrt(sum_a |sig[i, a]|^2) over the n = F K signatures
// [n, A], the power summed in antenna order; zero signatures stay zero.
__global__ void __launch_bounds__(256)
sig_normalize_kernel(float2* __restrict__ sig, int n, int A) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float2* v = sig + (size_t)i * A;
  float pw = 0.f;
  for (int a = 0; a < A; ++a)
    pw = __fadd_rn(pw, __fadd_rn(__fmul_rn(v[a].x, v[a].x),
                                 __fmul_rn(v[a].y, v[a].y)));
  if (!(pw > 0.f)) return;
  const float s = sqrtf(fmaxf(pw, 1e-30f));
  for (int a = 0; a < A; ++a)
    v[a] = make_float2(__fdiv_rn(v[a].x, s), __fdiv_rn(v[a].y, s));
}

// Blocks per (antenna, frame) for C chirps, or 0 where no route takes C.
__host__ __forceinline__ int oc_blocks(int C) {
  const int n = (C + OC_ROWS - 1) / OC_ROWS;
  return (C > 0 && n <= OC_MAX_CLUSTER) ? n : 0;
}

// The launch of cube_onchip_kernel<SRC, IMPL, OUT> (p.nblk set): one block
// per (antenna, frame), or a cluster of p.nblk blocks, whose scheduling at
// this shared memory cudaOccupancyMaxActiveClusters confirms first.
template <int SRC, int IMPL, int OUT>
cudaError_t launch_oc_kernel(const OcArgs& p, int F, size_t smem,
                             cudaStream_t st) {
  auto kern = cube_onchip_kernel<SRC, IMPL, OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (p.nblk == 1) {
    kern<<<dim3(p.A, F), OC_THREADS, smem, st>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.A * p.nblk, F);
  cfg.blockDim = dim3(OC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nblk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launch the on-chip cube kernel and its second launch: the antenna sum
// p [F, C, S] (OUT_Z_PCS) or [F, S, C] (OUT_PSC) of the planes p.pa, or the
// normalization of p.sig (OUT_SIG).  SRC_SPLIT: e_fast is first composed
// into efast [F, Sc, S].  SRC_CUBE draws no noise (impl unused).
template <int SRC, int OUT>
cudaError_t launch_cube_onchip(OcArgs p, float2* efast, float* out, int F,
                               int impl, float inv_a, cudaStream_t st) {
  p.nblk = oc_blocks(p.C);
  if (p.nblk == 0 || F <= 0 || F > 65535 || p.A <= 0 || p.S <= 0 ||
      (OUT == OUT_SIG && (p.K <= 0 || p.K > 2 * OC_STAGE)) ||
      (long long)p.A * p.nblk > 2147483647LL)
    return cudaErrorInvalidValue;
  const size_t smem = oc_smem_bytes(p.S);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (SRC == SRC_SPLIT) {
    compose_efast_kernel<<<dim3((p.Sc * p.S + 255) / 256, F), 256, 0, st>>>(
        p.fa, efast, p.S, p.Sc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    p.fa.coarse = efast;
  }
  if constexpr (SRC == SRC_CUBE)
    err = launch_oc_kernel<SRC, IMPL_FAST, OUT>(p, F, smem, st);
  else
    err = impl == IMPL_BOX_MULLER
              ? launch_oc_kernel<SRC, IMPL_BOX_MULLER, OUT>(p, F, smem, st)
              : launch_oc_kernel<SRC, IMPL_FAST, OUT>(p, F, smem, st);
  if (err != cudaSuccess) return err;
  if constexpr (OUT == OUT_SIG) {
    const int n = F * p.K;
    sig_normalize_kernel<<<(n + 255) / 256, 256, 0, st>>>(p.sig, n, p.A);
  } else {
    const int n = p.C * p.S;
    antenna_sum_kernel<<<dim3((n + 255) / 256, F), 256, 0, st>>>(
        p.pa, out, p.A, n, inv_a);
  }
  return cudaGetLastError();
}

}  // namespace
