// Cube-input front-end kernels for NVIDIA Hopper (sm_90a).
//
// Four kernels of the ADC-cube path, each replacing one TPU kernel:
//
//   K7  cube_rds_power  radar_slam_tpu/ops/power_pallas.py:_kernel
//       (rds_power_fused): cube [F, A, C, S] times the mix, its range DFT
//       (e^{+j}, DC bin zeroed with the DC projector), then per antenna the
//       Doppler DFT W_dop^T [D, C], |.|^2, mean over antennas -> power map
//       [F, S, D] (range, Doppler), written in the detection layout.
//   K8  cube_rds        radar_slam_tpu/ops/rds_pallas.py:_kernel (rds_fused):
//       cube [F, A, C, S] times the mix, its range DFT (e^{+j}, DC bin
//       zeroed), then per antenna the complex Doppler DFT W_dop^T [D, C]
//       with the fftshift in its row order -> RDS [F, A, S, D] complex
//       (range unshifted).
//   K9  cube_dechirp    radar_slam_tpu/ops/dechirp_pallas.py:_kernel
//       (dechirp_window_dc): y = x * mix minus the per-row mean over S.
//   K10 cube_cfar       radar_slam_tpu/ops/cfar_pallas.py:_kernel (cfar_mask):
//       mean over antennas of |rds|^2, 10 log10(p + 1e-12), separable local
//       max with -inf fill, CA-CFAR with guard band on p (no 1e-12),
//       threshold -> power_db [F, R, D], mask [F, R, D] (uint8).
//
// Precision: every product keeps FP32 accuracy.  On the TPU, K7's range
// product runs as one bf16 MXU pass by default
// (PipelineConfig.power_precision = "default"); the port does not copy that
// deviation: its power map is held to 1e-5 of its maximum, which bf16
// cannot meet.
//
// What bounds them on this card:
// - K7: the cube's bytes.  Per frame (A*C = 256, S = 400, C = 32) the cube
//   read is 0.82 MB; the factored range DFT is 1.8 M complex MACs and the
//   Doppler DFT 3.3 M (in 3xTF32 on the tensor cores).  Design: the
//   on-chip cube kernel of cube_onchip.cuh with its load producer -- one
//   block per (antenna, frame), a cluster of ceil(C / 32) blocks where
//   C > 32, loads its rows by 8-byte cp.async straight to the FFT's input
//   positions, runs the FFT and the Doppler product in shared memory and
//   writes the antenna's power plane; a second launch sums the planes in
//   antenna order.  The per-antenna planes (0.41 MB a frame out and back
//   in) are the traffic beyond the cube.
// - K8: the bytes.  Per frame the cube read and the RDS written are 0.82 MB
//   each; the factored range DFT (1.8 M complex MACs) and the Doppler DFT
//   (3.3 M, 3xTF32) sit below the tensor cores' and the FP32 pipe's rates
//   for that traffic.  The TPU kernel's dense [S, S] range product (41 M
//   complex MACs a frame) and its Z round trip through memory are gone.
//   Design: K7's kernel with the complex-RDS consumer (cube_onchip.cuh:
//   SRC_CUBE, OUT_RDS) -- one launch, one block per (antenna, frame) or a
//   cluster of ceil(C / 32) blocks where C > 32; the rows stay on chip
//   from the load to the Doppler product; the output is staged in the ring
//   a chunk of range bins at a time and leaves as contiguous runs.
// - K9: memory.  8 bytes read and 8 written per sample, ~6 FLOP: one warp
//   per row, the row read twice (the second read hits L1/L2), a warp
//   shuffle reduction for the mean; no shared memory.
// - K10: the bytes.  The RDS read (A R D complex, 0.82 MB a frame) against
//   5 bytes a cell written; the box sums and maxima are ~100 operations a
//   cell.  Design: one block per (tile of T range rows, frame), T chosen by
//   the wrapper (ops/cfar.py:cfar_tile_plan) so that two or more blocks
//   fit an SM; each block computes the power of its rows plus a halo of
//   max(train + guard, neighborhood / 2) rows each side (the neighbours'
//   rows read again, 1.63x the cube at T = 32 with a halo of 10) with
//   16-byte loads (two Doppler bins) and the antenna loads of a cell in
//   flight together, then the range-axis training and guard sums once per
//   cell, the dB map with the CFAR test, the local max: three barriers.
//   The buffers carry zero (sums) and -inf (dB map) borders, so no window
//   loop tests a bound.  Sums and maxima run in the reference kernel's order
//   (centre, +1, -1, +2, -2, ... along range, then along Doppler), and the
//   round-to-nearest intrinsics keep nvcc from contracting the float
//   arithmetic into FMAs, so the kernel rounds as its plain PyTorch version
//   does.
//
// Built as a shared library with a plain C interface (no PyTorch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// No fast math: the dB map needs accurate logf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cube_onchip.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;   // K9: one warp per row
constexpr int CFAR_THREADS = 256;
constexpr int CFAR_AB = 8;        // antenna loads of a cell in flight
constexpr int CFAR_RB = 4;        // cells whose box sums a thread takes
constexpr float LOG10E = 0.4342944819032518f;   // 1 / ln(10)

// ---- K9: y = x * mix - mean_s(x * mix), one warp per row -----------------
__device__ __forceinline__ float2 cmul_rn(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
dechirp_kernel(const float2* __restrict__ x, const float2* __restrict__ mix,
               float2* __restrict__ y, long long rows, int S, int dc) {
  const int lane = threadIdx.x % 32;
  const long long row =
      (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;
  const float2* xr = x + row * S;
  float2* yr = y + row * S;
  float mr = 0.f, mi = 0.f;
  if (dc) {
    float sr = 0.f, si = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float2 v = cmul_rn(xr[s], mix[s]);
      sr = __fadd_rn(sr, v.x);
      si = __fadd_rn(si, v.y);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sr = __fadd_rn(sr, __shfl_xor_sync(0xffffffffu, sr, off));
      si = __fadd_rn(si, __shfl_xor_sync(0xffffffffu, si, off));
    }
    mr = __fdiv_rn(sr, (float)S);
    mi = __fdiv_rn(si, (float)S);
  }
  for (int s = lane; s < S; s += 32) {
    const float2 v = cmul_rn(xr[s], mix[s]);
    yr[s] = make_float2(__fsub_rn(v.x, mr), __fsub_rn(v.y, mi));
  }
}

// ---- K10: power map + local max + CA-CFAR -> power_db, mask --------------

__device__ __forceinline__ float db10(float v) {
  return __fmul_rn(10.0f, __fmul_rn(logf(v), LOG10E));
}

// Box sums of CFAR_RB cells x[j l] (j < CFAR_RB), each x[j l] + x[(j+1) l]
// + x[(j-1) l] + ... + x[(j+h) l] + x[(j-h) l] in the reference kernel's
// order, on a buffer padded with zeros (adding +0.0 to a sum of powers
// leaves it unchanged, as skipping the term would).  The window's values
// roll through registers, so a step loads two.  acc: the sums; mid: the
// sums after g steps (the guard box, g <= h).
__device__ __forceinline__ void box_sums(const float* x, int l, int h, int g,
                                         float (&acc)[CFAR_RB],
                                         float (&mid)[CFAR_RB]) {
  float up[CFAR_RB], dn[CFAR_RB];
#pragma unroll
  for (int j = 0; j < CFAR_RB; ++j) acc[j] = mid[j] = up[j] = dn[j] = x[j * l];
  for (int k = 1; k <= h; ++k) {
#pragma unroll
    for (int j = 0; j < CFAR_RB - 1; ++j) up[j] = up[j + 1];
    up[CFAR_RB - 1] = x[(CFAR_RB - 1 + k) * l];
#pragma unroll
    for (int j = CFAR_RB - 1; j > 0; --j) dn[j] = dn[j - 1];
    dn[0] = x[-k * l];
#pragma unroll
    for (int j = 0; j < CFAR_RB; ++j)
      acc[j] = __fadd_rn(__fadd_rn(acc[j], up[j]), dn[j]);
    if (k == g) {
#pragma unroll
      for (int j = 0; j < CFAR_RB; ++j) mid[j] = acc[j];
    }
  }
}

__device__ __forceinline__ float window_count(int i, int h, int n) {
  return (float)(min(i, h) + min(max(n - 1 - i, 0), h) + 1);
}

// The power (1/A) sum_a |rds[a]|^2 of two Doppler bins d, d + 1 (d + 1 < D
// when two) at src, the antennas n apart, summed in order with the loads
// of CFAR_AB antennas in flight.  VEC: one 16-byte load for both bins.
template <bool VEC>
__device__ __forceinline__ float2 power_pair(const float2* src, size_t n,
                                             int A, bool two, float inv_a) {
  float acc0 = 0.f, acc1 = 0.f;
  for (int a0 = 0; a0 < A; a0 += CFAR_AB) {
    float4 v[CFAR_AB];
#pragma unroll
    for (int j = 0; j < CFAR_AB; ++j) {
      if (a0 + j >= A) break;
      const float2* q = src + (size_t)(a0 + j) * n;
      if constexpr (VEC) {
        v[j] = __ldg(reinterpret_cast<const float4*>(q));
      } else {
        const float2 x0 = __ldg(q);
        const float2 x1 = two ? __ldg(q + 1) : make_float2(0.f, 0.f);
        v[j] = make_float4(x0.x, x0.y, x1.x, x1.y);
      }
    }
#pragma unroll
    for (int j = 0; j < CFAR_AB; ++j) {
      if (a0 + j >= A) break;
      acc0 = __fadd_rn(acc0, __fadd_rn(__fmul_rn(v[j].x, v[j].x),
                                       __fmul_rn(v[j].y, v[j].y)));
      acc1 = __fadd_rn(acc1, __fadd_rn(__fmul_rn(v[j].z, v[j].z),
                                       __fmul_rn(v[j].w, v[j].w)));
    }
  }
  return make_float2(__fmul_rn(acc0, inv_a), __fmul_rn(acc1, inv_a));
}

// Row pitches of K10's buffers (floats): odd, so CFAR_RB-cell blocks of
// consecutive rows fall in distinct banks.
__device__ __forceinline__ int cfar_pitch(int n) { return n | 1; }

// One block per (range tile, frame): tile t of frame f is block
// f * tiles + t.  The block owns rows [r0, r0 + T) and holds the power of
// rows [r0 - halo, r0 + T + halo), zero outside the map, with nh border
// columns (-inf in the dB map), and the training and guard sums of its own
// rows with th and guard zero columns each side, so no window loop tests a
// bound.  VEC: D even and the RDS 16-byte aligned, so two Doppler bins
// arrive in one load.
template <bool VEC>
__global__ void __launch_bounds__(CFAR_THREADS)
cfar_kernel(const float2* __restrict__ rds, float* __restrict__ pdb_out,
            uint8_t* __restrict__ mask_out, int A, int R, int D, int T,
            int halo, int tiles, float inv_a, float threshold_db,
            int neighborhood, int train, int guard, float offset_db,
            float t2, float g2) {
  extern __shared__ float csm[];
  const int f = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - f * tiles) * T;
  const int own = min(T, R - r0);
  const bool cfar = train > 0, gsum = cfar && guard > 0;
  const int th = train + guard, nh = neighborhood / 2;
  const int rows = T + 2 * halo;     // buffer row i: map row r0 - halo + i
  const int pd = cfar_pitch(D + 2 * nh), tp = cfar_pitch(D + 2 * th),
            gp = cfar_pitch(D + 2 * guard);
  // The layout ops/cfar.py:_smem_bytes sizes.
  float* p = csm;                                          // [rows][pd]
  float* tbuf = p + rows * pd + CFAR_RB;                   // [T][tp]
  float* gbuf = tbuf + (cfar ? T * tp + CFAR_RB : 0);      // [T][gp]
  uint8_t* hit = reinterpret_cast<uint8_t*>(
      gbuf + (gsum ? T * gp + CFAR_RB : 0));               // [T][D]
  const size_t n = (size_t)R * D;
  const float2* rf = rds + (size_t)f * A * n;

  // 1. The power of the buffer's rows (zero outside the map), two Doppler
  // bins a thread; the sums' zero columns.
  const int Dh = (D + 1) / 2;
  for (int e = threadIdx.x; e < rows * Dh; e += CFAR_THREADS) {
    const int i = e / Dh, d = 2 * (e - i * Dh);
    const int r = r0 - halo + i;
    const bool two = d + 1 < D;
    float2 v = make_float2(0.f, 0.f);
    if (r >= 0 && r < R)
      v = power_pair<VEC>(rf + (size_t)r * D + d, n, A, two, inv_a);
    p[i * pd + nh + d] = v.x;
    if (two) p[i * pd + nh + d + 1] = v.y;
  }
  if (cfar)
    for (int e = threadIdx.x; e < T * 2 * th; e += CFAR_THREADS) {
      const int i = e / (2 * th), c = e - i * 2 * th;
      tbuf[i * tp + (c < th ? c : D + c)] = 0.f;
      if (gsum && c < 2 * guard)
        gbuf[i * gp + (c < guard ? c : D + c)] = 0.f;
    }
  __syncthreads();

  // 2. Range-axis training and guard sums of the own cells, CFAR_RB rows
  // of one column a thread.
  const int nrb = (own + CFAR_RB - 1) / CFAR_RB;
  if (cfar) {
    for (int e = threadIdx.x; e < nrb * D; e += CFAR_THREADS) {
      const int d = e % D, il0 = (e / D) * CFAR_RB;
      float acc[CFAR_RB], mid[CFAR_RB];
      box_sums(p + (halo + il0) * pd + nh + d, pd, th, guard, acc, mid);
#pragma unroll
      for (int j = 0; j < CFAR_RB; ++j) {
        if (il0 + j >= own) break;
        tbuf[(il0 + j) * tp + th + d] = acc[j];
        if (gsum) gbuf[(il0 + j) * gp + guard + d] = mid[j];
      }
    }
    __syncthreads();
  }

  // 3. power_db and the CFAR test of the own cells, CFAR_RB Doppler bins
  // of one row a thread (the cell's dB written in place); the dB map (-inf
  // outside the map) of the other cells the local max reads.
  const int ncb = (D + CFAR_RB - 1) / CFAR_RB;
  float* pdb = pdb_out + (size_t)f * n + (size_t)r0 * D;
  uint8_t* mask = mask_out + (size_t)f * n + (size_t)r0 * D;
  const bool vec4 = D % CFAR_RB == 0;    // whole blocks: 16-byte stores
  for (int e = threadIdx.x; e < own * ncb; e += CFAR_THREADS) {
    const int il = e / ncb, d0 = (e - il * ncb) * CFAR_RB, r = r0 + il;
    float ts[CFAR_RB], gs[CFAR_RB], unused[CFAR_RB];
    if (cfar) box_sums(tbuf + il * tp + th + d0, 1, th, 0, ts, unused);
    if (gsum) box_sums(gbuf + il * gp + guard + d0, 1, guard, 0, gs, unused);
    float* cell = p + (halo + il) * pd + nh + d0;
    float vs[CFAR_RB] = {};
    uint8_t hs[CFAR_RB] = {};
#pragma unroll
    for (int j = 0; j < CFAR_RB; ++j) {
      const int d = d0 + j;
      if (d >= D) break;
      const float v = db10(__fadd_rn(cell[j], 1e-12f));
      cell[j] = v;
      float thresh = threshold_db;
      if (cfar) {
        const float tc = __fmul_rn(window_count(r, th, R),
                                   window_count(d, th, D));
        float noise = __fdiv_rn(ts[j], tc);
        if (gsum) {
          const float gc = __fmul_rn(window_count(r, guard, R),
                                     window_count(d, guard, D));
          noise = __fdiv_rn(__fsub_rn(__fmul_rn(noise, t2),
                                      __fmul_rn(__fdiv_rn(gs[j], gc), g2)),
                            __fsub_rn(t2, g2));
        }
        thresh = fmaxf(__fadd_rn(db10(fmaxf(noise, 1e-12f)), offset_db),
                       threshold_db);
      }
      vs[j] = v;
      hs[j] = v > thresh;
    }
    if (vec4) {
      *reinterpret_cast<float4*>(pdb + il * D + d0) =
          make_float4(vs[0], vs[1], vs[2], vs[3]);
      *reinterpret_cast<uchar4*>(hit + il * D + d0) =
          make_uchar4(hs[0], hs[1], hs[2], hs[3]);
    } else {
      for (int j = 0; j < CFAR_RB && d0 + j < D; ++j) {
        pdb[il * D + d0 + j] = vs[j];
        hit[il * D + d0 + j] = hs[j];
      }
    }
  }
  for (int e = threadIdx.x; e < (own + 2 * nh) * pd; e += CFAR_THREADS) {
    const int i = halo - nh + e / pd, c = e % pd, d = c - nh;
    const int r = r0 - halo + i;
    const bool in_map = r >= 0 && r < R && d >= 0 && d < D;
    if (in_map && i >= halo && i < halo + own) continue;   // own: above
    float* cell = p + i * pd + c;
    *cell = in_map ? db10(__fadd_rn(*cell, 1e-12f)) : -INFINITY;
  }
  __syncthreads();

  // 4. Local max: a cell is a peak when no neighbour exceeds it (-inf
  // outside the map never does); CFAR_RB Doppler bins of one row a thread,
  // each neighbour row's values rolling through registers.
  for (int e = threadIdx.x; e < own * ncb; e += CFAR_THREADS) {
    const int il = e / ncb, d0 = (e - il * ncb) * CFAR_RB;
    const float* c = p + (halo + il) * pd + nh + d0;
    float v[CFAR_RB];
    bool peak[CFAR_RB];
#pragma unroll
    for (int j = 0; j < CFAR_RB; ++j) {
      v[j] = c[j];
      peak[j] = true;
    }
    for (int dr = -nh; dr <= nh; ++dr) {
      const float* x = c + dr * pd;
      float w[CFAR_RB];
#pragma unroll
      for (int j = 0; j < CFAR_RB; ++j) w[j] = x[j - nh];
      for (int dd = -nh; dd <= nh; ++dd) {
#pragma unroll
        for (int j = 0; j < CFAR_RB; ++j) peak[j] = peak[j] && !(w[j] > v[j]);
#pragma unroll
        for (int j = 0; j < CFAR_RB - 1; ++j) w[j] = w[j + 1];
        w[CFAR_RB - 1] = x[CFAR_RB + dd];
      }
    }
    uint8_t m[CFAR_RB];
#pragma unroll
    for (int j = 0; j < CFAR_RB; ++j)
      m[j] = (d0 + j < D && hit[il * D + d0 + j] && peak[j]) ? 1 : 0;
    if (vec4)
      *reinterpret_cast<uchar4*>(mask + il * D + d0) =
          make_uchar4(m[0], m[1], m[2], m[3]);
    else
      for (int j = 0; j < CFAR_RB && d0 + j < D; ++j)
        mask[il * D + d0 + j] = m[j];
  }
}

}  // namespace

// The on-chip kernel's arguments for cubes x [F, A, C, S]: tw / pos / nst /
// radix are the range DFT's table, input positions and radices
// (ops/range_dft.py), wdopt W_dop^T [C, C].
static OcArgs cube_args(const void* x, const void* mix, const void* tw,
                        const void* pos, int nst, const int* radix,
                        const void* wdopt, int A, int C, int S,
                        int dc_removal) {
  OcArgs a{};
  a.cube = static_cast<const float2*>(x);
  a.mix = static_cast<const float2*>(mix);
  a.tw = static_cast<const float2*>(tw);
  a.pos = static_cast<const int*>(pos);
  a.plan.nst = nst;
  for (int t = 0; t < nst; ++t) a.plan.radix[t] = radix[t];
  a.wdt = static_cast<const float2*>(wdopt);
  a.A = A;
  a.C = C;
  a.S = S;
  a.dc_removal = dc_removal;
  return a;
}

// K7: power map p [F, S, C] of cubes x [F, A, C, S], the rows kept on chip
// (cube_onchip.cuh); pa holds the per-antenna power planes [F, A, S, C].
extern "C" int cube_rds_power(const void* x, const void* mix, const void* tw,
                              const void* pos, int nst, const int* radix,
                              const void* wdopt, void* pa, void* p, int F,
                              int A, int C, int S, float inv_a,
                              int dc_removal, int device, void* stream) {
  if (F <= 0 || A <= 0 || C <= 0 || S <= 0 || nst < 0 ||
      nst > FFT_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  OcArgs a = cube_args(x, mix, tw, pos, nst, radix, wdopt, A, C, S,
                       dc_removal);
  a.pa = static_cast<float*>(pa);
  return (int)launch_cube_onchip<SRC_CUBE, OUT_PSC>(
      a, nullptr, static_cast<float*>(p), F, IMPL_FAST, inv_a,
      static_cast<cudaStream_t>(stream));
}

// K8: RDS out [F, A, S, C] of cubes x [F, A, C, S], one launch of the
// on-chip kernel with the complex-RDS consumer.
extern "C" int cube_rds(const void* x, const void* mix, const void* tw,
                        const void* pos, int nst, const int* radix,
                        const void* wdopt, void* out, int F, int A, int C,
                        int S, int dc_removal, int device, void* stream) {
  if (F <= 0 || A <= 0 || C <= 0 || S <= 0 || nst < 0 ||
      nst > FFT_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  OcArgs a = cube_args(x, mix, tw, pos, nst, radix, wdopt, A, C, S,
                       dc_removal);
  a.rds = static_cast<float2*>(out);
  return (int)launch_cube_onchip<SRC_CUBE, OUT_RDS>(
      a, nullptr, nullptr, F, IMPL_FAST, 1.0f,
      static_cast<cudaStream_t>(stream));
}

// K9: y = x * mix (- row mean) over rows [rows, S].
extern "C" int cube_dechirp(const void* x, const void* mix, void* y,
                            long long rows, int S, int dc, int device,
                            void* stream) {
  if (rows <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dechirp_kernel<<<(unsigned)blocks, 32 * ROWS_PER_BLOCK, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(mix),
      static_cast<float2*>(y), rows, S, dc);
  return (int)cudaGetLastError();
}

// K10: power_db [F, R, D] and mask [F, R, D] (uint8) of RDS [F, A, R, D],
// in tiles of T range rows with `halo` rows each side and `smem` bytes of
// shared memory a block (ops/cfar.py:cfar_tile_plan).
extern "C" int cube_cfar(const void* rds, void* pdb, void* mask, int F,
                         int A, int R, int D, int T, int halo, int smem,
                         float inv_a, float threshold_db, int neighborhood,
                         int train, int guard, float offset_db, float t2,
                         float g2, int device, void* stream) {
  if (F <= 0 || A <= 0 || R <= 0 || D <= 0 || T <= 0 || T % CFAR_RB ||
      neighborhood < 1 || train < 0 || guard < 0 ||
      halo < neighborhood / 2 || (train > 0 && halo < train + guard))
    return (int)cudaErrorInvalidValue;
  const int tiles = (R + T - 1) / T;
  if (smem <= 0 || smem > 232448 || (long long)F * tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = D % 2 == 0 && reinterpret_cast<uintptr_t>(rds) % 16 == 0;
  auto kern = vec ? cfar_kernel<true> : cfar_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<(unsigned)((long long)F * tiles), CFAR_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(rds), static_cast<float*>(pdb),
      static_cast<uint8_t*>(mask), A, R, D, T, halo, tiles, inv_a,
      threshold_db, neighborhood, train, guard, offset_db, t2, g2);
  return (int)cudaGetLastError();
}
