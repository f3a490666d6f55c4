// Cube-input front-end kernels for NVIDIA Hopper (sm_90a), FP32 SIMT.
//
// Four kernels of the ADC-cube path, each replacing one TPU kernel:
//
//   K7  cube_rds_power  radar_slam_tpu/ops/power_pallas.py:_kernel
//       (rds_power_fused): cube [F, A*C, S] x W_rng [S, S] (mix, DC
//       projector and e^{+j} range DFT folded into one matrix), then per
//       antenna the Doppler DFT W_dop^T [D, C], |.|^2, mean over antennas
//       -> power map [F, S, D] (range, Doppler), written in the detection
//       layout directly.
//   K8  cube_rds        radar_slam_tpu/ops/rds_pallas.py:_kernel (rds_fused):
//       the same range product, then the complex Doppler DFT with the
//       fftshift in W_dop's column order -> RDS [F, A, S, D] complex.
//   K9  cube_dechirp    radar_slam_tpu/ops/dechirp_pallas.py:_kernel
//       (dechirp_window_dc): y = x * mix minus the per-row mean over S.
//   K10 cube_cfar       radar_slam_tpu/ops/cfar_pallas.py:_kernel (cfar_mask):
//       mean over antennas of |rds|^2, 10 log10(p + 1e-12), separable local
//       max with -inf fill, CA-CFAR with guard band on p (no 1e-12),
//       threshold -> power_db [F, R, D], mask [F, R, D] (uint8).
//
// Precision: every product runs in FP32.  On the TPU, K7's range product
// runs as one bf16 MXU pass by default (PipelineConfig.power_precision =
// "default"); the port does not copy that deviation: its power map is held
// to 1e-5 of its maximum, which bf16 cannot meet.
//
// What bounds them on this card:
// - K7/K8: arithmetic.  Per frame at A*C = 256, S = 400, C = 32 the range
//   product is 41 M complex MACs (328 MFLOP at four real products per
//   complex MAC) and the Doppler stage 26 MFLOP, about 354 MFLOP against
//   0.82 MB of cube read (plus the Z scratch out and back in, 1.6 MB) --
//   ~140 FLOP per byte, above the FP32 SIMT ridge of the H100 (67 TFLOP/s
//   over 3.35 TB/s = 20 FLOP/byte).  Design: the range product is a
//   shared-memory-tiled FP32 SIMT matmul (64 x 64 output tile, depth 16,
//   4 x 4 complex accumulators per thread, four real FMAs per complex MAC)
//   into a Z scratch [F, A*C, S]; a second launch stages 32 range bins of Z
//   and W_dop^T in shared memory and either accumulates the antenna-mean
//   power (K7) or stores the complex RDS (K8).  Fusing the Doppler stage
//   into the product's epilogue (Z never in device memory) and tensor
//   cores (3xTF32 on wgmma) are later work.
// - K9: memory.  8 bytes read and 8 written per sample, ~6 FLOP: one warp
//   per row, the row read twice (the second read hits L1/L2), a warp
//   shuffle reduction for the mean; no shared memory.
// - K10: the shared-memory passes.  One block per frame holds the [R, D]
//   power map and the range-axis training sums (2 R D floats, 102 KB at
//   R = 400, D = 32); the cube read (A R D complex, 0.82 MB per frame) is
//   the device-memory traffic.  Sums and maxima run in the reference
//   kernel's order (centre, +1, -1, +2, -2, ... along range, then along
//   Doppler), and the round-to-nearest intrinsics keep nvcc from
//   contracting the float arithmetic into FMAs, so the kernel rounds as
//   its plain PyTorch version does.
//
// Built as a shared library with a plain C interface (no PyTorch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// No fast math: the dB map needs accurate logf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output tile rows
constexpr int BN = 64;          // output tile columns
constexpr int BK = 16;          // reduction depth per stage
constexpr int LDA = BM + 1;     // A-tile row pitch (transposing store)
constexpr int TPB = 256;        // 16 x 16 threads, 4 x 4 outputs each
constexpr int PS = 32;          // range bins per Doppler block
constexpr int ROWS_PER_BLOCK = 8;   // K9: one warp per row
constexpr int CFAR_THREADS = 512;
constexpr float LOG10E = 0.4342944819032518f;   // 1 / ln(10)

// ---- range product: Z[f] = X[f] @ W_rng, M = A*C, N = K = S ------------
// smem layout: Ar, Ai [BK][LDA] then Br, Bi [BK][BN].  Thread (ty, tx)
// accumulates rows ty + 16 i and columns tx + 16 j of the output tile.
// The A tile is read from the cube along k (coalesced) and stored
// transposed; the padded pitch keeps that store nearly free of bank
// conflicts.

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

__global__ void __launch_bounds__(TPB)
range_product_kernel(const float2* __restrict__ x,
                     const float2* __restrict__ wrng,
                     float2* __restrict__ z, int M, int S) {
  __shared__ float sm[2 * BK * LDA + 2 * BK * BN];
  const int f = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float accr[4][4] = {}, acci[4][4] = {};
  const float2* xf = x + (size_t)f * M * S;

  for (int k0 = 0; k0 < S; k0 += BK) {
    // A tile: 16 consecutive samples of a row per 16 threads.
    for (int e = threadIdx.x; e < BM * BK; e += TPB) {
      const int kk = e % BK, mm = e / BK;
      const int m = m0 + mm, k = k0 + kk;
      const float2 v = (m < M && k < S) ? xf[(size_t)m * S + k]
                                        : make_float2(0.f, 0.f);
      sm[kk * LDA + mm] = v.x;
      sm[BK * LDA + kk * LDA + mm] = v.y;
    }
    for (int e = threadIdx.x; e < BK * BN; e += TPB) {
      const int nn = e % BN, kk = e / BN;
      const int k = k0 + kk, n = n0 + nn;
      const float2 w = (k < S && n < S) ? wrng[(size_t)k * S + n]
                                        : make_float2(0.f, 0.f);
      sm[2 * BK * LDA + kk * BN + nn] = w.x;
      sm[2 * BK * LDA + BK * BN + kk * BN + nn] = w.y;
    }
    __syncthreads();
    mma_stage(sm, ty, tx, accr, acci);
    __syncthreads();
  }
  float2* zf = z + (size_t)f * M * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < S)
        zf[(size_t)m * S + n] = make_float2(accr[i][j], acci[i][j]);
    }
  }
}

// ---- Doppler stage over PS range bins of one frame ----------------------
// o[a, s, d] = sum_c WdT[d, c] Z[a*C + c, s].  POWER: p[f, s, d] =
// inv_a * sum_a |o|^2 (K7); otherwise rds[f, a, s, d] = o (K8).  Z rows
// and WdT staged in shared memory (WdT rows padded by one float against
// bank conflicts); thread o -> (s = o / C, d = o % C), so a warp reads one
// Z value (broadcast) and stores contiguous Doppler bins.
template <bool POWER>
__global__ void __launch_bounds__(TPB)
doppler_kernel(const float2* __restrict__ z, const float2* __restrict__ wdt,
               float* __restrict__ p, float2* __restrict__ rds, int A,
               int C, int S, float inv_a) {
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
      if (POWER) {
        acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(orr, orr),
                                       __fmul_rn(oii, oii)));
      } else {
        rds[(((size_t)f * A + a) * S + s) * C + d] = make_float2(orr, oii);
      }
    }
    if (POWER) p[((size_t)f * S + s) * C + d] = __fmul_rn(acc, inv_a);
  }
}

// ---- K9: y = x * mix - mean_s(x * mix), one warp per row -----------------
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
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
      const float2 v = cmul(xr[s], mix[s]);
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
    const float2 v = cmul(xr[s], mix[s]);
    yr[s] = make_float2(__fsub_rn(v.x, mr), __fsub_rn(v.y, mi));
  }
}

// ---- K10: power map + local max + CA-CFAR -> power_db, mask --------------

__device__ __forceinline__ float db10(float v) {
  return __fmul_rn(10.0f, __fmul_rn(logf(v), LOG10E));
}

// Sum of map[r + k, d] for k in (0, +1, -1, ..., +h, -h), zero outside.
__device__ __forceinline__ float range_sum(const float* map, int r, int d,
                                           int h, int R, int D) {
  float acc = map[r * D + d];
  for (int k = 1; k <= h; ++k) {
    if (r + k < R) acc = __fadd_rn(acc, map[(r + k) * D + d]);
    if (r - k >= 0) acc = __fadd_rn(acc, map[(r - k) * D + d]);
  }
  return acc;
}

__device__ __forceinline__ float window_count(int i, int h, int n) {
  return (float)(min(i, h) + min(max(n - 1 - i, 0), h) + 1);
}

__global__ void __launch_bounds__(CFAR_THREADS)
cfar_kernel(const float2* __restrict__ rds, float* __restrict__ pdb_out,
            uint8_t* __restrict__ mask_out, int A, int R, int D,
            float inv_a, float threshold_db, int neighborhood, int train,
            int guard, float offset_db, float t2, float g2) {
  extern __shared__ float csm[];
  const int n = R * D;
  float* p = csm;           // power map
  float* buf = p + n;       // range-axis training sums, then the dB map
  const int f = blockIdx.x;
  const float2* rf = rds + (size_t)f * A * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    float acc = 0.f;
    for (int a = 0; a < A; ++a) {
      const float2 v = rf[(size_t)a * n + e];
      acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(v.x, v.x),
                                     __fmul_rn(v.y, v.y)));
    }
    p[e] = __fmul_rn(acc, inv_a);
  }
  __syncthreads();
  const int th = train + guard;
  if (train > 0) {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      buf[e] = range_sum(p, e / D, e % D, th, R, D);
    __syncthreads();
  }
  float* pdb = pdb_out + (size_t)f * n;
  uint8_t* mask = mask_out + (size_t)f * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const float v = db10(__fadd_rn(p[e], 1e-12f));
    float thresh = threshold_db;
    if (train > 0) {
      float ts = buf[e];
      for (int k = 1; k <= th; ++k) {
        if (d + k < D) ts = __fadd_rn(ts, buf[e + k]);
        if (d - k >= 0) ts = __fadd_rn(ts, buf[e - k]);
      }
      const float tc = __fmul_rn(window_count(r, th, R),
                                 window_count(d, th, D));
      float noise = __fdiv_rn(ts, tc);
      if (guard > 0) {
        float gs = range_sum(p, r, d, guard, R, D);
        for (int k = 1; k <= guard; ++k) {
          if (d + k < D) gs = __fadd_rn(gs, range_sum(p, r, d + k, guard, R, D));
          if (d - k >= 0) gs = __fadd_rn(gs, range_sum(p, r, d - k, guard, R, D));
        }
        const float gc = __fmul_rn(window_count(r, guard, R),
                                   window_count(d, guard, D));
        noise = __fdiv_rn(__fsub_rn(__fmul_rn(noise, t2),
                                    __fmul_rn(__fdiv_rn(gs, gc), g2)),
                          __fsub_rn(t2, g2));
      }
      thresh = fmaxf(__fadd_rn(db10(fmaxf(noise, 1e-12f)), offset_db),
                     threshold_db);
    }
    pdb[e] = v;
    mask[e] = (v > thresh) ? 1 : 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    buf[e] = db10(__fadd_rn(p[e], 1e-12f));
  __syncthreads();
  // Local max with -inf outside the map: a cell is a peak when no
  // in-bounds neighbour exceeds it.  Each thread revisits its own cells.
  const int h = neighborhood / 2;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const float v = buf[e];
    bool peak = true;
    for (int dr = -h; dr <= h; ++dr) {
      for (int dd = -h; dd <= h; ++dd) {
        const int rr = r + dr, c = d + dd;
        if (rr >= 0 && rr < R && c >= 0 && c < D)
          peak = peak && !(buf[rr * D + c] > v);
      }
    }
    mask[e] = (mask[e] && peak) ? 1 : 0;
  }
}

}  // namespace

namespace {

int launch_cube(const void* x, const void* wrng, const void* wdopt,
                void* zbuf, void* p, void* rds, int F, int A, int C, int S,
                float inv_a, int device, void* stream) {
  if (F <= 0 || F > 65535 || A <= 0 || C <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = A * C;
  dim3 g1((S + BN - 1) / BN, (M + BM - 1) / BM, F);
  range_product_kernel<<<g1, TPB, 0, st>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(wrng),
      static_cast<float2*>(zbuf), M, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem = sizeof(float) * (2 * (size_t)M * PS + 2 * C * (C + 1));
  dim3 g2((S + PS - 1) / PS, F);
  if (p != nullptr) {
    err = cudaFuncSetAttribute(doppler_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    doppler_kernel<true><<<g2, TPB, smem, st>>>(
        static_cast<const float2*>(zbuf), static_cast<const float2*>(wdopt),
        static_cast<float*>(p), nullptr, A, C, S, inv_a);
  } else {
    err = cudaFuncSetAttribute(doppler_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    doppler_kernel<false><<<g2, TPB, smem, st>>>(
        static_cast<const float2*>(zbuf), static_cast<const float2*>(wdopt),
        nullptr, static_cast<float2*>(rds), A, C, S, inv_a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cube_rds_power(const void* x, const void* wrng,
                              const void* wdopt, void* zbuf, void* p, int F,
                              int A, int C, int S, float inv_a, int device,
                              void* stream) {
  return launch_cube(x, wrng, wdopt, zbuf, p, nullptr, F, A, C, S, inv_a,
                     device, stream);
}

extern "C" int cube_rds(const void* x, const void* wrng, const void* wdopt,
                        void* zbuf, void* out, int F, int A, int C, int S,
                        int device, void* stream) {
  return launch_cube(x, wrng, wdopt, zbuf, nullptr, out, F, A, C, S, 1.0f,
                     device, stream);
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

// K10: power_db [F, R, D] and mask [F, R, D] (uint8) of RDS [F, A, R, D].
extern "C" int cube_cfar(const void* rds, void* pdb, void* mask, int F,
                         int A, int R, int D, float inv_a,
                         float threshold_db, int neighborhood, int train,
                         int guard, float offset_db, float t2, float g2,
                         int device, void* stream) {
  if (F <= 0 || A <= 0 || R <= 0 || D <= 0 ||
      neighborhood < 1 || train < 0 || guard < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * 2 * (size_t)R * D;
  err = cudaFuncSetAttribute(cfar_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cfar_kernel<<<F, CFAR_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(rds), static_cast<float*>(pdb),
      static_cast<uint8_t*>(mask), A, R, D, inv_a, threshold_db,
      neighborhood, train, guard, offset_db, t2, g2);
  return (int)cudaGetLastError();
}
