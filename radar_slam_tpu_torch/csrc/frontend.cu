// One-pass radar front end for NVIDIA Hopper (sm_90a): factored range DFT,
// 3xTF32 tensor-core products, the time-domain cube kept on chip.
//
// Replaces, in every branch of their shared body _frontend_body (:186), the
// two kernels of radar_slam_tpu/ops/frontend_pallas.py:
//   K1  radar_frontend_split  _frontend_kernel_split (:308), split
//       synthesis factors -- the kernel of the scatterer drivers' one-pass
//       route;
//   K3  radar_frontend_dense  _frontend_kernel (:296), dense factor planes
//       e_ac [F, Sc, A*C] and e_fast [F, Sc, S] (frontend_factors="dense").
// The two differ only in how the factor tiles are loaded (a template
// parameter SPLIT: composed from the split tables, or copied by cp.async);
// everything after the loads is one code path.
//
// Branches (K1' are the non-default ones; launch arguments select them):
//   noise domain  range-frequency (T = rows of e_fast through the range DFT,
//                 Z = e_at T + sigma sqrt(S) (g (*) taps), column 0 zeroed)
//                 or time (X = e_at e_fast + sigma n, the ADC cube, kept on
//                 chip, then its range DFT: cube_onchip.cuh, shared with K4;
//                 n at element (a*C + c) * S + s, so K3 on the time domain
//                 builds K4's cube from the same seeds);
//   noise impl    the "fast" transform or Box-Muller (philox.cuh);
//   CFAR          clipped box sums (the reference's banded products) or
//                 log-shift prefix sums in the reference's add order
//                 (_cfar_threshold_cumsum, :118);
//   clutter       an optional background power map [F, C, S]: a cell must
//                 exceed ln(max(c, 1e-12)) * 10 / ln 10 + clutter_offset_db;
//   range DFT     the mixed-radix FFT of range_fft.cuh, or its dense route
//                 where S has a prime factor above 5 (the wrapper counts it).
//
// What bounds it on this card.  Per frame (A*C = 256, S = 400, Sc = 128):
// the one true product (e_at T, or e_at e_fast in the time domain) is
// 13.1 M complex MACs, 315 M TF32 MACs in 3xTF32; the factored range DFT
// 0.9 M (range frequency: Sc rows) or 1.8 M (time: A*C rows) complex MACs
// where the dense one took 20.5 M or 41 M; the Doppler DFT 3.3 M in
// 3xTF32; the Philox noise ~0.1 M draws of two Philox-4x32-10 blocks (one
// for Box-Muller), ~300 integer operations a draw on the INT32 pipe --
// with the product, the largest term.  Against ~1.3 MB of device memory
// (factors in; Z, p, score out; T 0.41 MB out and in through L2).
//
// What the design does about it.
// - Range frequency, three launches: range_fft_kernel (8 rows of e_fast
//   per block through the FFT -> T [F, Sc, S]); z_power_kernel (one block
//   of four warpgroups per 32 range bins of a frame: Z = e_at T for all
//   A*C rows, 256 a chunk, in 3xTF32 on warpgroup MMA -- wgmma.m64n64k8,
//   A' from registers, each warpgroup composing and splitting its rows of
//   e_at once (K1 from the split tables' dopp and ant rows, K3 from e_ac),
//   B' = the stacked real form of T split once per stage into shared
//   memory, the A factors and T arriving by cp.async a stage ahead --,
//   the noise drawn once per tile plus a halo of the window taps' reach
//   (4 of 36 columns redrawn), DC zeroed, Z kept in shared memory, written
//   transposed, and its Doppler power, a second 3xTF32 product per antenna
//   (mma.sync), summed over antennas in antenna order in registers -> p);
//   then the CFAR.  Where the A*C rows of Z do not fit a block (A*C >
//   ~540: A = 16 at C = 64, the 8 x 4 URA), the block runs the product, Z
//   store and Doppler power per group of antennas ("tiled rows"), the
//   running power sum carried across groups in antenna order.
// - Time domain, three launches: cube_onchip_kernel (X never leaves shared
//   memory; Z and one power plane per antenna out; a cluster of
//   ceil(C / 32) blocks per antenna where C > 32), antenna_sum_kernel, the
//   CFAR.
// - The CFAR kernels hold a frame's [C, S] map in shared memory; the
//   prefix-sum CFAR the map and two scan planes (154 KB at C = 32).  The
//   box-sum CFAR spreads a small batch's frames over up to four blocks
//   each (a block per frame leaves most SMs idle below 132 frames).
// What still holds it back (PERF.md §6, clock64 profile): the product runs
// at a third to a half of its 3xTF32 bound -- a warpgroup composes its A'
// (~55 instructions a warp per k-step, four warps an SM sub-partition)
// and waits for each k-step's products, and once a stage copies and stages
// B' (~1,000-1,700 cycles, its cp.async issue the most of it), while its
// 64 accumulators a thread hold a 512-thread block at the 128-register
// cap, so a second A' register set (composing under the products) spills
// or is serialized; then the noise, near its INT32 bound, and one block
// per SM leaving the two unoverlapped.
// No floating-point atomics: every output repeats bit for bit.
//
// Built as a shared library with a plain C interface (no PyTorch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// No fast math: the noise needs accurate logf/sqrtf/cosf/sinf and the dB
// map uses logf(x) * 10/ln(10), as the reference kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cube_onchip.cuh"
#include "philox.cuh"
#include "range_fft.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

constexpr int MAX_TAPS = 5;     // a 3-term cosine window has 5 taps
constexpr int MAX_HALO = 2;
constexpr int CFAR_THREADS = 512;
constexpr float NEG_SCORE = -1e30f;
constexpr float LOG10E_10 = 4.3429448190325176f;   // 10 / ln(10)
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

// ---- 1. T[f] = (e_fast[f] * mix) W_rng, DC zeroed: RF_ROWS rows a block --

constexpr int RF_ROWS = 8;
constexpr int RF_THREADS = 256;

__host__ __forceinline__ size_t rf_smem_bytes(int S, bool dense) {
  return sizeof(float2) * ((size_t)RF_ROWS * S + S +
                           (dense ? (size_t)(RF_THREADS / 32) * S : 0)) +
         sizeof(int) * (size_t)S;
}

template <bool SPLIT>
__global__ void __launch_bounds__(RF_THREADS)
range_fft_kernel(Factors fa, const float2* __restrict__ mix,
                 const float2* __restrict__ twg, const int* __restrict__ posg,
                 FftPlan plan, int dc_removal, float2* __restrict__ tout,
                 int S, int Sc) {
  extern __shared__ __align__(16) float2 rsm[];
  const int f = blockIdx.y, r0 = blockIdx.x * RF_ROWS;
  float2* X = rsm;                                  // [RF_ROWS][S]
  float2* tw = X + RF_ROWS * S;                     // [S]
  float2* scratch = tw + S;                         // dense route: [8][S]
  int* pos = reinterpret_cast<int*>(
      scratch + (plan.nst == 0 ? (RF_THREADS / 32) * S : 0));
  for (int e = threadIdx.x; e < S; e += RF_THREADS) {
    tw[e] = twg[e];
    pos[e] = posg[e];
  }
  __syncthreads();
  // Four elements a pass, their loads made before their stores.
  for (int e0 = threadIdx.x; e0 < RF_ROWS * S; e0 += 4 * RF_THREADS) {
    float2 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * RF_THREADS;
      const int row = e / S, s = e - row * S, sc = r0 + row;
      v[u] = (e < RF_ROWS * S && sc < Sc)
                 ? cmul(efast_at<SPLIT>(fa, f, sc, s, Sc, S), mix[s])
                 : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * RF_THREADS;
      if (e < RF_ROWS * S) X[(e / S) * S + pos[e % S]] = v[u];
    }
  }
  fft_rows(X, RF_ROWS, S, S, plan, tw, scratch);
  for (int e = threadIdx.x; e < RF_ROWS * S; e += RF_THREADS) {
    const int row = e / S, k = e - row * S, sc = r0 + row;
    if (sc >= Sc) continue;
    tout[((size_t)f * Sc + sc) * S + k] =
        (dc_removal && k == 0) ? make_float2(0.f, 0.f) : X[row * S + k];
  }
}

// ---- 2. Z = e_at T + noise, Doppler power: one block per ZK_NT range bins
//
// The product on warpgroup MMA: four warpgroups of 64 Z rows, each a
// 64 x 64 tile of wgmma.m64n64k8 in 3xTF32 whose 64 columns are the real
// and the imaginary parts of the block's 32 range bins.  The complex
// product is the stacked real one: per 4 complex k, A' = [Ar | Ai] (8
// columns) and B' = [[Tr, Ti], [-Ti, Tr]] (8 x 64), so A' B' = [Zr | Zi].
// A' comes from registers: each thread composes e_at[m, k] (K1: dopp[k, c]
// ant[k, a]; K3: e_ac) for its two fragment rows and splits it into TF32
// high and low parts, every element once per block and chunk.  B' is
// staged per ring stage from the stage's T tile (copied by cp.async): each
// thread splits one T element into its four B' places, high and low, in
// the layout wgmma reads (csrc/wgmma.cuh).  hi hi goes to the main
// accumulators, hi lo and lo hi to separate small-term ones.

constexpr int ZK_THREADS = 512;  // 4 warpgroups x 64 rows
constexpr int ZK_MC = 256;      // rows per chunk
constexpr int ZK_NT = 32;       // range bins per block (64 wgmma columns)
constexpr int ZK_KC = 8;        // complex reduction depth per ring stage (dense)
constexpr int ZK_KCS = 16;      // the same for the split tables
constexpr int ZK_LDA = 260;     // e_ac rows of a stage: pitch (float2)
constexpr int ZK_LDZ = 36;      // Z tile pitch
constexpr int ZK_GW = ZK_NT + 2 * MAX_HALO;          // noise tile pitch

// The ring (float2), two stages of each: B' (KC / 4 k-steps, high then
// low parts, WG_TILE_WORDS words each: KC * 128 float2), the T tile
// [KC][ZK_NT] and the A factors -- K1 the dopp rows [KC][frag_pitch(C)]
// and the ant rows [KC][frag_pitch(A)], K3 the e_ac rows [KC][ZK_LDA].
__host__ __device__ __forceinline__ int zk_ring(bool split, int A, int C) {
  const int kc = split ? ZK_KCS : ZK_KC;
  const int d = split ? frag_pitch(C) + frag_pitch(A) : ZK_LDA;
  return kc * 2 * (128 + ZK_NT + d);
}

// A 16-byte cp.async (two complex values), L2 only, zero-filled when
// !valid.
__device__ __forceinline__ void cp_async16(float2* smem, const float2* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

// The first region of shared memory (float2): the ring, then the noise
// tile, then W_dop^T [C16][frag_pitch(Cp)].
__host__ __device__ __forceinline__ int zk_r0(bool split, int A, int C) {
  const int ring = zk_ring(split, A, C), noise = ZK_MC * ZK_GW;
  const int w = ((C + 15) & ~15) * frag_pitch((C + 7) & ~7);
  const int r = ring > noise ? ring : noise;
  return r > w ? r : w;
}

// The region, and the Z tile [rows + 8][ZK_LDZ] for rows = ag C of ag
// antennas (bytes).
__host__ __forceinline__ size_t zk_smem_bytes(bool split, int A, int C,
                                              int ag) {
  return sizeof(float2) * ((size_t)zk_r0(split, A, C) +
                           ((size_t)ag * C + 8) * ZK_LDZ);
}

// Antennas whose Z rows a block holds at once: all A, or, where their
// (A C + 8) rows do not fit (A C > ~540), the most that do ("tiled rows":
// the block then runs the product, Z store and Doppler power per group of
// antennas, the power carried across groups in antenna order); 0 where not
// even one antenna fits.
__host__ __forceinline__ int zk_group_antennas(bool split, int A, int C) {
  if (zk_smem_bytes(split, A, C, A) <= 232448) return A;
  const long long room = 232448 / (long long)sizeof(float2) -
                         zk_r0(split, A, C);
  const long long ag = (room / ZK_LDZ - 8) / C;
  return ag < 1 ? 0 : (int)(ag < A ? ag : A);
}

// Whether z_power_kernel's copies can move 16 bytes: every row of the A
// factors (K1: dopp [C], ant [A]; K3: e_ac [A C]) and of T [S] starts
// 16-byte aligned.
__host__ __forceinline__ bool zk_wide(bool split, const Factors& fa,
                                      const float2* T, int A, int C, int S) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(T) |
                          reinterpret_cast<uintptr_t>(fa.ant) |
                          (split ? reinterpret_cast<uintptr_t>(fa.dopp) : 0);
  return ((C | S | (split ? A : 0)) & 1) == 0 && (bases & 15) == 0;
}

// TILED: the rows of ag antennas a pass (zk_group_antennas); otherwise all
// A in one pass, the loop below folded away at compile time.  WIDE: the
// copies move 16 bytes (two complex values), where every row of the tables
// and of T starts 16-byte aligned (zk_wide), else 8.
template <bool SPLIT, int IMPL, bool TILED, bool WIDE>
__global__ void __launch_bounds__(ZK_THREADS, 1)
z_power_kernel(Factors fa, const float2* __restrict__ tin,
               const int* __restrict__ seeds, const float2* __restrict__ wdt,
               float* __restrict__ zr, float* __restrict__ zi,
               float* __restrict__ p, int A, int C, int S, int Sc, float sn,
               NoiseTaps taps, int dc_removal, float inv_a, int ag) {
  extern __shared__ __align__(16) float2 zsm[];
  constexpr int KC = SPLIT ? ZK_KCS : ZK_KC;
  constexpr int KS = KC / 4;                 // wgmma k-steps a stage
  constexpr int BSTAGE = 2 * KS * WG_TILE_WORDS;   // words of a B' stage
  const int f = blockIdx.y, n0 = blockIdx.x * ZK_NT;
  const int M = A * C;
  const int ldd = frag_pitch(C), ldn = frag_pitch(A);
  const int dstage = KC * (SPLIT ? ldd + ldn : ZK_LDA);
  float2* R0 = zsm;
  uint32_t* Bc = reinterpret_cast<uint32_t*>(zsm);   // [2][BSTAGE]
  float2* Traw = zsm + KC * 256;                     // [2][KC][ZK_NT]
  float2* Draw = Traw + 2 * KC * ZK_NT;              // [2][dstage]
  float2* Zt = zsm + zk_r0(SPLIT, A, C);            // [ag C + 8][ZK_LDZ]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;   // rows 64 wg + 16 wq + g (+ 8)
  const int nk = (Sc + KC - 1) / KC;
  const bool noisy = sn != 0.0f;
  const unsigned seed = noisy ? (unsigned)seeds[f] : 0u;
  const float2* tf = tin + (size_t)f * Sc * S;
  // The T element of a stage this thread splits into B', where
  // threadIdx.x < KC * 32: k 4 wg + t (k-step wg, B' row t), range bin
  // 8 wq + g -- a warp's 32 stores of one B' row then hit 32 consecutive
  // words.
  const bool t_own = threadIdx.x < KC * 32;
  const int t_k = 4 * wg + t, t_n = 8 * wq + g;
  static_assert(ZK_KCS == ZK_THREADS / 32 && 2 * ZK_KC == ZK_THREADS / 32,
                "a warp copies one row of a stage's A factors (K3: half)");
  // Rows ag C.. ag C + 7 are read by the Doppler product's last tile:
  // zeros (a smaller last group reads finite rows of the one before,
  // against zero columns of W_dop^T).
  for (int e = threadIdx.x; e < 8 * ZK_LDZ; e += ZK_THREADS)
    Zt[ag * C * ZK_LDZ + e] = make_float2(0.f, 0.f);

  // Antennas a0.. a1 - 1 a pass: Z rows mlo..mhi-1.
  const int passes = TILED ? (A + ag - 1) / ag : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const int a0 = TILED ? pass * ag : 0;
    const int a1 = TILED ? min(A, a0 + ag) : A;
    const int mlo = a0 * C, mhi = a1 * C;
    for (int m0 = mlo; m0 < mhi; m0 += ZK_MC) {
      // Copies by cp.async, zero beyond Sc, S and the group: stage it's A
      // factors into ring slot it & 1 -- the split tables' dopp and ant
      // rows, warp q copying row q (loops kept rolled: one pass where C,
      // A <= 32 or 64), or the e_ac rows, warp q half of row q / 2 ...
      auto load_a = [&](int it) {
        float2* As = Draw + (it & 1) * dstage;
        if constexpr (SPLIT) {
          const int sc = it * KC + warp;
          const bool ok = sc < Sc;
          const float2* dr = fa.dopp + ((size_t)f * Sc + sc) * C;
          const float2* ar = fa.ant + ((size_t)f * Sc + sc) * A;
          float2* dd = As + warp * ldd;
          float2* ad = As + KC * ldd + warp * ldn;
          if constexpr (WIDE) {
#pragma unroll 1
            for (int c = 2 * lane; c < C; c += 64)
              cp_async16(dd + c, ok ? dr + c : fa.dopp, ok);
#pragma unroll 1
            for (int a = 2 * lane; a < A; a += 64)
              cp_async16(ad + a, ok ? ar + a : fa.ant, ok);
          } else {
#pragma unroll 1
            for (int c = lane; c < C; c += 32)
              cp_async8(dd + c, ok ? dr + c : fa.dopp, ok);
#pragma unroll 1
            for (int a = lane; a < A; a += 32)
              cp_async8(ad + a, ok ? ar + a : fa.ant, ok);
          }
        } else {
          const int sc = it * KC + (warp >> 1);
          const float2* er = fa.ant + ((size_t)f * Sc + sc) * M + m0;
          float2* ed = As + (warp >> 1) * ZK_LDA + (warp & 1) * (ZK_MC / 2);
          er += (warp & 1) * (ZK_MC / 2);
          const int mo = m0 + (warp & 1) * (ZK_MC / 2);
          if constexpr (WIDE) {
#pragma unroll
            for (int j = 0; j < ZK_MC / 128; ++j) {
              const int mm = 64 * j + 2 * lane;
              const bool ok = sc < Sc && mo + mm < mhi;
              cp_async16(ed + mm, ok ? er + mm : fa.ant, ok);
            }
          } else {
#pragma unroll
            for (int j = 0; j < ZK_MC / 64; ++j) {
              const int mm = 32 * j + lane;
              const bool ok = sc < Sc && mo + mm < mhi;
              cp_async8(ed + mm, ok ? er + mm : fa.ant, ok);
            }
          }
        }
      };
      // ... and stage it's T tile into slot it & 1.
      auto load_t = [&](int it) {
        float2* Ts = Traw + (it & 1) * KC * ZK_NT;
        if constexpr (WIDE) {
          // Row e / 16, range bins 2 (e % 16) and the next.
          const int e = threadIdx.x;
          if (e < KC * ZK_NT / 2) {
            const int r = e >> 4, nn = 2 * (e & 15), sc = it * KC + r;
            const bool ok = sc < Sc && n0 + nn < S;
            cp_async16(Ts + r * ZK_NT + nn,
                       ok ? tf + (size_t)sc * S + n0 + nn : tf, ok);
          }
        } else if (t_own) {
          const int sc = it * KC + t_k, n = n0 + t_n;
          const bool ok = sc < Sc && n < S;
          cp_async8(Ts + t_k * ZK_NT + t_n,
                    ok ? tf + (size_t)sc * S + n : tf, ok);
        }
      };
      // One cp.async group: stage ia's A factors and stage jt's T tile
      // (a stage out of range skipped).
      auto load_stage = [&](int ia, int jt) {
        if (ia >= 0 && ia < nk) load_a(ia);
        if (jt < nk) load_t(jt);
        cp_async_commit();
      };
      // ... split into its four B' places of ring stage (it & 1): (t, n)
      // Tr, (t, 32 + n) Ti, (t + 4, n) -Ti, (t + 4, 32 + n) Tr, at o =
      // bt_offset(t, n) = 64 wq + lane, o + 256, o + 32 and o + 288.
      static_assert(bt_offset(0, 32) == 256 && bt_offset(4, 0) == 32 &&
                        bt_offset(4, 32) == 288,
                    "B' places of one T element");
      auto stage_b = [&](int it) {
        if (t_own) {
          const float2 v = Traw[((it & 1) * KC + t_k) * ZK_NT + t_n];
          uint32_t rh, rl, ih, il;
          tf32_pair(v.x, rh, rl);
          tf32_pair(v.y, ih, il);
          uint32_t* hi =
              Bc + (it & 1) * BSTAGE + wg * WG_TILE_WORDS + 64 * wq + lane;
          uint32_t* lo = hi + KS * WG_TILE_WORDS;
          hi[0] = rh;
          hi[256] = ih;
          hi[32] = ih ^ 0x80000000u;
          hi[288] = rh;
          lo[0] = rl;
          lo[256] = il;
          lo[32] = il ^ 0x80000000u;
          lo[288] = rl;
          fence_proxy_async();
        }
      };
      // This thread's fragment rows m = m0 + 64 wg + 16 wq + g + 8 h: where
      // they lie in a stage's A factors, at k = t.  The split tables: (c, a)
      // of m, a clamped into the table beyond the group (such rows of Z
      // are never stored, and each row of a product depends on its own
      // row of A' alone).
      int pd[2], pa[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = 64 * wg + 16 * wq + g + 8 * h, m = m0 + mm;
        if constexpr (SPLIT) {
          const int a = min(m / C, A - 1);
          pd[h] = t * ldd + m % C;
          pa[h] = KC * ldd + t * ldn + a;
        } else {
          pd[h] = t * ZK_LDA + mm;
          pa[h] = 0;
        }
      }
      // A' of k-step ks of stage it: (row, t) Ar, (row, t + 4) Ai of
      // e_at[row, 4 ks + t], high and low.
      auto compose_a = [&](const float2* As, int ks, uint32_t (&ah)[4],
                           uint32_t (&al)[4]) {
        float2 v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (SPLIT) {
            // e_at[m, k] = dopp[k, c] ant[k, a].
            const float2 d = As[pd[h] + 4 * ks * ldd];
            const float2 w = As[pa[h] + 4 * ks * ldn];
            v[h] = make_float2(d.x * w.x - d.y * w.y, d.x * w.y + d.y * w.x);
          } else {
            v[h] = As[pd[h] + 4 * ks * ZK_LDA];
          }
        }
        tf32_pair(v[0].x, ah[0], al[0]);
        tf32_pair(v[1].x, ah[1], al[1]);
        tf32_pair(v[0].y, ah[2], al[2]);
        tf32_pair(v[1].y, ah[3], al[3]);
      };

      // Accumulators: column 8 j + 2 t + e of row 8 h of this thread's
      // 16 at [4 j + 2 h + e]; columns 0-31 Zr, 32-63 Zi.
      float zm[32], zs[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) zm[i] = zs[i] = 0.f;
      // The pipeline: while stage it - 1's products run, each warpgroup
      // under its own k-step's (warpgroup w: k-step w mod KS, so the other
      // three keep issuing products meanwhile), stage it's B' is staged
      // from its T tile, and stage it's A factors and stage it + 1's T
      // tile are copied.  A warpgroup waits for each k-step's products
      // before it composes the next k-step's A' into the same registers,
      // so at the barrier no product of the stage before is in flight.
      load_stage(0, 0);
      load_stage(-1, 1);
      cp_async_wait<0>();
      __syncthreads();
      stage_b(0);
      for (int it = 0; it < nk; ++it) {
        // Stage it's A factors and B' and stage it + 1's T tile are in
        // place for every thread; no thread reads the slots that stage
        // it + 1's A factors and B' and stage it + 2's T tile take.
        cp_async_wait<0>();
        __syncthreads();
        const float2* As = Draw + (it & 1) * dstage;
        const uint64_t desc = wg_desc(Bc + (it & 1) * BSTAGE);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t ah[4], al[4];
          compose_a(As, ks, ah, al);
          wg_operands(ah);
          wg_operands(al);
          wg_fence();
          // B' tiles: high parts of k-step ks, then the low parts.
          const uint64_t bh = desc + wg_desc_step(ks);
          const uint64_t bl = desc + wg_desc_step(KS + ks);
          wgmma_tf32_m64n64k8(zm, ah, bh);
          wgmma_tf32_m64n64k8(zs, ah, bl);
          wgmma_tf32_m64n64k8(zs, al, bh);
          wg_commit();
          if (ks == wg % KS) {
            if (it + 1 < nk) stage_b(it + 1);
            load_stage(it + 1, it + 2);
          }
          wg_wait<0>();
        }
      }
      wg_operands(zm);
      wg_operands(zs);
      cp_async_wait<0>();
      __syncthreads();

      // Epilogue: sigma sqrt(S) (g (*) taps), each value drawn once per tile
      // (columns n0 - H .. n0 + ZK_NT + H - 1 mod S) into the free ring.
      float2* G = R0;                                 // [ZK_MC][ZK_GW]
      const int H = taps.halo, w = ZK_NT + 2 * H;
      if (noisy) {
        // Four draws per pass, unconditionally: independent Philox chains.
        const int n_g = ZK_MC * w;
        for (int e0 = threadIdx.x; e0 < n_g; e0 += 4 * ZK_THREADS) {
          float2 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * ZK_THREADS;
            const int mm = e / w, jj = e - mm * w;
            const int col = ((n0 - H + jj) % S + S) % S;
            v[u] = normal_pair<IMPL>(seed, (unsigned)((m0 + mm) * S + col));
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * ZK_THREADS;
            const int mm = e / w, jj = e - mm * w;
            if (e < n_g)
              G[mm * ZK_GW + jj] =
                  m0 + mm < mhi ? v[u] : make_float2(0.f, 0.f);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mm = 64 * wg + 16 * wq + g + 8 * (i >> 1);
          const int nn = 8 * j + 2 * t + (i & 1);
          const int m = m0 + mm, n = n0 + nn;
          if (m >= mhi) continue;
          float vr = zm[4 * j + i] + zs[4 * j + i];
          float vi = zm[16 + 4 * j + i] + zs[16 + 4 * j + i];
          if (n >= S) {
            vr = vi = 0.f;
          } else {
            if (noisy) {
              float cr = 0.f, ci = 0.f;
              for (int q = 0; q < taps.n; ++q) {
                // roll by off: the tap reads column n - off.
                const float2 gv = G[mm * ZK_GW + nn + H - taps.off[q]];
                const float tr = __fmul_rn(taps.coef[q], gv.x);
                const float ti = __fmul_rn(taps.coef[q], gv.y);
                cr = (q == 0) ? tr : __fadd_rn(cr, tr);
                ci = (q == 0) ? ti : __fadd_rn(ci, ti);
              }
              vr = __fadd_rn(vr, __fmul_rn(sn, cr));
              vi = __fadd_rn(vi, __fmul_rn(sn, ci));
            }
            if (dc_removal && n == 0) vr = vi = 0.f;
          }
          Zt[(m - mlo) * ZK_LDZ + nn] = make_float2(vr, vi);
        }
      }
      __syncthreads();
    }

    // Z transposed: zr/zi[f, n, m], consecutive threads on consecutive m.
    const int Mg = mhi - mlo;
    for (int e = threadIdx.x; e < Mg * ZK_NT; e += ZK_THREADS) {
      const int mm = e % Mg, nn = e / Mg, n = n0 + nn;
      if (n >= S) continue;
      const float2 v = Zt[mm * ZK_LDZ + nn];
      const size_t o = ((size_t)f * S + n) * M + mlo + mm;
      zr[o] = v.x;
      zi[o] = v.y;
    }

    // Doppler power p[f, d, n] = inv_a sum_a |sum_c W_dop^T[d, c]
    // Z[a*C + c, n]|^2: per (16 Doppler bins x 8 range bins) tile, one 3xTF32
    // product per antenna, the |.|^2 summed in registers in antenna order;
    // across antenna groups the running sum waits in p (the thread that
    // wrote it reads it back).
    const int Cp = (C + 7) & ~7, C16 = (C + 15) & ~15;
    const int ldw = frag_pitch(Cp);
    float2* Ws = R0;                                  // [C16][ldw]
    for (int e = threadIdx.x; e < C16 * ldw; e += ZK_THREADS) {
      const int d = e / ldw, c = e % ldw;
      Ws[e] = (d < C && c < C) ? wdt[d * C + c] : make_float2(0.f, 0.f);
    }
    __syncthreads();
    const int mtiles = C16 / 16;
    for (int ti = warp; ti < mtiles * (ZK_NT / 8); ti += ZK_THREADS / 32) {
      const int m16 = (ti % mtiles) * 16, nb = (ti / mtiles) * 8;
      if (n0 + nb >= S) continue;
      float ps[4] = {0.f, 0.f, 0.f, 0.f};
      if (a0 > 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = m16 + g + 8 * (i >> 1), n = n0 + nb + 2 * t + (i & 1);
          if (d < C && n < S) ps[i] = p[((size_t)f * C + d) * S + n];
        }
      }
      for (int a = a0; a < a1; ++a) {
        float orr[4] = {}, oii[4] = {}, err[4] = {}, eii[4] = {};
        for (int kb = 0; kb < Cp; kb += 8) {
          const FragA wf = load_frag_a(Ws, ldw, 1, m16, kb);
          const FragB zf = load_frag_b(Zt + (size_t)(a - a0) * C * ZK_LDZ,
                                       ZK_LDZ, kb, nb);
          cmma3_split(orr, oii, err, eii, wf, zf);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float o_r = orr[i] + err[i], o_i = oii[i] + eii[i];
          const float pw = __fadd_rn(__fmul_rn(o_r, o_r),
                                     __fmul_rn(o_i, o_i));
          ps[i] = (a == 0) ? pw : __fadd_rn(ps[i], pw);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = m16 + g + 8 * (i >> 1), n = n0 + nb + 2 * t + (i & 1);
        if (d < C && n < S)
          p[((size_t)f * C + d) * S + n] =
              a1 == A ? __fmul_rn(ps[i], inv_a) : ps[i];
      }
    }
    __syncthreads();   // the next group reuses the ring and the Z tile
  }
}

// ---- 3. the CFAR ----------------------------------------------------------

__device__ __forceinline__ float window_count(int i, int pad, int n) {
  return (float)(min(i + pad, n - 1) - max(i - pad, 0) + 1);
}

// The clutter gate's level in dB: ln(max(c, 1e-12)) * 10 / ln 10 + offset.
__device__ __forceinline__ float clutter_level(float c, float offset_db) {
  return __fadd_rn(__fmul_rn(logf(fmaxf(c, 1e-12f)), LOG10E_10), offset_db);
}

// 3a. CA-CFAR + local max + range gate (+ clutter gate) -> score.  One
// block per frame; the whole [C, S] map and its Doppler-axis
// training-window sums live in shared memory (2 C S floats: 205 KB at
// C = 64, S = 400).  Box sums run along Doppler first, then range, as the
// reference's banded products do.  clutter: [F, C, S] or null.
__global__ void __launch_bounds__(CFAR_THREADS)
cfar_kernel(const float* __restrict__ p, float* __restrict__ score,
            const float* __restrict__ clutter,
            int C, int S, int train, int guard, int neighborhood,
            float offset_db, float threshold_db, int gate_lo, int gate_hi,
            float clutter_offset_db, int parts) {
  extern __shared__ float csm[];
  const int n = C * S;
  float* p1 = csm;
  float* tcol = p1 + n;     // training-window sums along Doppler
  // Block (f, part) scores the cells [e0, e1) of frame f: a few blocks per
  // frame when there are few frames.
  const int f = blockIdx.x / parts, part = blockIdx.x % parts;
  const int e0 = (int)((long long)n * part / parts);
  const int e1 = (int)((long long)n * (part + 1) / parts);
  const float* pf = p + (size_t)f * n;
  const int tpad = train + guard, gpad = guard;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += blockDim.x) p1[e] = pf[e] + 1e-12f;
  __syncthreads();
  if (train > 0) {
    // The row sums the cells [e0, e1) read: their rows, +-tpad columns.
    const int t0 = max(e0 - tpad, 0), t1 = min(e1 + tpad, n);
    for (int e = t0 + threadIdx.x; e < t1; e += blockDim.x) {
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
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
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

// ---- 3b. the prefix-sum CA-CFAR (cfar_impl "cumsum") ---------------------

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

// The launches.  SPLIT: fa holds the split tables; otherwise ant is e_ac
// [F, Sc, A*C] and coarse e_fast [F, Sc, S].  tw / pos / plan: the range
// DFT's twiddle table, input positions and radices (ops/range_dft.py).
// scratch holds T [F, Sc, S] (complex) in the range-frequency domain and
// the per-antenna power planes [F, A, C, S] (float) in the time domain,
// where efast [F, Sc, S] (complex; SPLIT only) takes the composed e_fast;
// sn is sigma sqrt(S) on the window taps in the former, sigma in the
// latter.
template <bool SPLIT>
int launch_frontend(const Factors& fa, const void* seeds, const void* mix,
                    const void* tw, const void* pos, int nst,
                    const int* radix, const void* wdopt, void* scratch,
                    void* efast, void* zr, void* zi, void* p, void* score,
                    const void* clutter, int F, int A, int C, int S, int Sc,
                    int device, float sn, int n_taps, const int* tap_off,
                    const float* tap_coef, int dc_removal, int train,
                    int guard, int neighborhood, float offset_db,
                    float threshold_db, int gate_lo, int gate_hi, int domain,
                    int impl, int cfar_impl, float clutter_offset_db,
                    void* stream) {
  if (F <= 0 || F > 65535 || A <= 0 || C <= 0 || S <= 0 || Sc <= 0 ||
      n_taps < 0 || n_taps > MAX_TAPS || nst < 0 || nst > FFT_MAX_STAGES ||
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
  FftPlan plan{};
  plan.nst = nst;
  for (int t = 0; t < nst; ++t) plan.radix[t] = radix[t];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv_a = 1.0f / (float)A;
  const int* sd = static_cast<const int*>(seeds);
  const float2* mx = static_cast<const float2*>(mix);
  const float2* twp = static_cast<const float2*>(tw);
  const int* psp = static_cast<const int*>(pos);
  const float2* wd = static_cast<const float2*>(wdopt);
  float* zro = static_cast<float*>(zr);
  float* zio = static_cast<float*>(zi);
  float* pp = static_cast<float*>(p);

  if (domain == DOMAIN_RANGE_FREQ) {
    const size_t rf_smem = rf_smem_bytes(S, nst == 0);
    const int ag = zk_group_antennas(SPLIT, A, C);
    if (rf_smem > 232448 || ag == 0) return (int)cudaErrorInvalidValue;
    const size_t zk_smem = zk_smem_bytes(SPLIT, A, C, ag);
    err = cudaFuncSetAttribute(range_fft_kernel<SPLIT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)rf_smem);
    if (err != cudaSuccess) return (int)err;
    float2* T = static_cast<float2*>(scratch);
    range_fft_kernel<SPLIT><<<dim3((Sc + RF_ROWS - 1) / RF_ROWS, F),
                              RF_THREADS, rf_smem, st>>>(
        fa, mx, twp, psp, plan, dc_removal, T, S, Sc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const bool tiled = ag < A;
    const bool wide = zk_wide(SPLIT, fa, T, A, C, S);
    auto zk = impl == IMPL_BOX_MULLER
                  ? (tiled ? (wide ? z_power_kernel<SPLIT, IMPL_BOX_MULLER,
                                                    true, true>
                                   : z_power_kernel<SPLIT, IMPL_BOX_MULLER,
                                                    true, false>)
                           : (wide ? z_power_kernel<SPLIT, IMPL_BOX_MULLER,
                                                    false, true>
                                   : z_power_kernel<SPLIT, IMPL_BOX_MULLER,
                                                    false, false>))
                  : (tiled ? (wide ? z_power_kernel<SPLIT, IMPL_FAST, true,
                                                    true>
                                   : z_power_kernel<SPLIT, IMPL_FAST, true,
                                                    false>)
                           : (wide ? z_power_kernel<SPLIT, IMPL_FAST, false,
                                                    true>
                                   : z_power_kernel<SPLIT, IMPL_FAST, false,
                                                    false>));
    err = cudaFuncSetAttribute(zk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)zk_smem);
    if (err != cudaSuccess) return (int)err;
    zk<<<dim3((S + ZK_NT - 1) / ZK_NT, F), ZK_THREADS, zk_smem, st>>>(
        fa, T, sd, wd, zro, zio, pp, A, C, S, Sc, sn, taps, dc_removal,
        inv_a, ag);
  } else {
    if (SPLIT && efast == nullptr) return (int)cudaErrorInvalidValue;
    OcArgs oc{};
    oc.fa = fa;
    oc.seeds = sd;
    oc.mix = mx;
    oc.tw = twp;
    oc.pos = psp;
    oc.plan = plan;
    oc.wdt = wd;
    oc.zr = zro;
    oc.zi = zio;
    oc.pa = static_cast<float*>(scratch);
    oc.A = A;
    oc.C = C;
    oc.S = S;
    oc.Sc = Sc;
    oc.sigma = sn;
    oc.dc_removal = dc_removal;
    err = launch_cube_onchip<SPLIT ? SRC_SPLIT : SRC_DENSE, OUT_Z_PCS>(
        oc, static_cast<float2*>(efast), pp, F, impl, inv_a, st);
    if (err != cudaSuccess) return (int)err;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const float* cl = static_cast<const float*>(clutter);
  if (cfar_impl == CFAR_BOX) {
    const size_t cfar_smem = sizeof(float) * 2 * (size_t)C * S;
    err = cudaFuncSetAttribute(cfar_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfar_smem);
    if (err != cudaSuccess) return (int)err;
    // Up to four blocks per frame while they fill no more than the card
    // twice (two blocks fit an SM): each scores a quarter of the map.
    const int parts = F >= 264 ? 1 : (F >= 132 ? 2 : 4);
    cfar_kernel<<<F * parts, CFAR_THREADS, cfar_smem, st>>>(
        pp, static_cast<float*>(score), cl, C, S, train, guard, neighborhood,
        offset_db, threshold_db, gate_lo, gate_hi, clutter_offset_db, parts);
  } else {
    const size_t cfar_smem = sizeof(float) * 3 * (size_t)C * S;
    err = cudaFuncSetAttribute(cfar_cumsum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfar_smem);
    if (err != cudaSuccess) return (int)err;
    cfar_cumsum_kernel<<<F, CFAR_THREADS, cfar_smem, st>>>(
        pp, static_cast<float*>(score), cl, C, S, train, guard, neighborhood,
        offset_db, threshold_db, gate_lo, gate_hi, clutter_offset_db);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K1: split synthesis factors.
extern "C" int radar_frontend_split(
    const void* ant, const void* dopp, const void* coarse, const void* fine,
    const void* tau, const void* tvec, const void* seeds, const void* mix,
    const void* tw, const void* pos, int nst, const int* radix,
    const void* wdopt, void* scratch, void* efast, void* zr, void* zi,
    void* p, void* score, const void* clutter, int F, int A, int C, int S,
    int Sc, int B, int Q, int device, int has_upper, float echo_upper, float sn,
    int n_taps, const int* tap_off, const float* tap_coef, int dc_removal,
    int train, int guard, int neighborhood, float offset_db,
    float threshold_db, int gate_lo, int gate_hi, int domain, int impl,
    int cfar_impl, float clutter_offset_db, void* stream) {
  if (B <= 0 || Q <= 0 || (long long)B * Q < S)
    return (int)cudaErrorInvalidValue;
  const Factors fa{static_cast<const float2*>(ant),
                   static_cast<const float2*>(dopp),
                   static_cast<const float2*>(coarse),
                   static_cast<const float2*>(fine),
                   static_cast<const float*>(tau),
                   static_cast<const float*>(tvec), B, Q, has_upper,
                   echo_upper};
  return launch_frontend<true>(
      fa, seeds, mix, tw, pos, nst, radix, wdopt, scratch, efast, zr, zi, p,
      score, clutter, F, A, C, S, Sc, device, sn, n_taps, tap_off, tap_coef,
      dc_removal, train, guard, neighborhood, offset_db, threshold_db,
      gate_lo, gate_hi, domain, impl, cfar_impl, clutter_offset_db, stream);
}

// K3: dense factor planes e_ac [F, Sc, A*C] and e_fast [F, Sc, S].
extern "C" int radar_frontend_dense(
    const void* e_ac, const void* e_fast, const void* seeds, const void* mix,
    const void* tw, const void* pos, int nst, const int* radix,
    const void* wdopt, void* scratch, void* zr, void* zi, void* p,
    void* score, const void* clutter, int F, int A, int C, int S, int Sc,
    int device, float sn, int n_taps, const int* tap_off,
    const float* tap_coef, int dc_removal, int train, int guard,
    int neighborhood, float offset_db, float threshold_db, int gate_lo,
    int gate_hi, int domain, int impl, int cfar_impl,
    float clutter_offset_db, void* stream) {
  const Factors fa{static_cast<const float2*>(e_ac), nullptr,
                   static_cast<const float2*>(e_fast), nullptr, nullptr,
                   nullptr, 1, 1, 0, 0.0f};
  return launch_frontend<false>(
      fa, seeds, mix, tw, pos, nst, radix, wdopt, scratch, nullptr, zr, zi,
      p, score, clutter, F, A, C, S, Sc, device, sn, n_taps, tap_off,
      tap_coef, dc_removal, train, guard, neighborhood, offset_db,
      threshold_db, gate_lo, gate_hi, domain, impl, cfar_impl,
      clutter_offset_db, stream);
}
