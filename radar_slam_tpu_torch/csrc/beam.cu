// The beamforming grid search's peak for NVIDIA Hopper (sm_90a), without
// a spectrum in device memory.
//
// Replaces no TPU kernel: the reference leaves this search to XLA
// (radar_slam_tpu/aoa/estimators.py: the |S A^H|^2 product, argmax and
// gathers).  The port's plain route (aoa/estimators.py:beamforming_spectrum,
// then the argmax and the neighbour taps of _refine_peak_2d) writes a float32
// spectrum [N, G] and reads it back for one argmax and five taps a
// signature: at the URA's 131,072 signatures x 11,041 grid points that is
// 5.8 GB written and ~80 GB moved a call, and the chain is bound by device
// memory.  Here no spectrum leaves the registers.
//
// beam_peak_kernel, for signatures s [N, A] (A = A_el * A_az, row-major
// [el, az]) over the el-major grid of G_el x G_az points, writes
//   idx  [N]    the first maximum of |s . a(g)^H|^2 over the flattened grid
//               (torch.argmax's index);
//   taps [N, 5] the powers at the peak (y0), at az - 1, az + 1, el - 1 and
//               el + 1, each index clamped to the grid as _refine_peak_2d
//               clamps it.
//
// What bounds it: the products.  The steering of a planar array factors:
// element (m, n) has phase k (n d_az u_y + m d_el u_z) with u_z = sin el
// one value per grid row, so
//   s . a(e, a)^H = sum_n t_n(e) P_n(e, a),
//   t_n(e) = sum_m s_mn E_m(e),  E_m(e) = exp(-j k m d_el u_z(e)),
//   P_n(e, a) = exp(-j k n d_az u_y(e, a)),
// the same sum reordered: A_az complex MACs a grid point and signature
// (8 at the URA, against A = 32 for the direct product) plus A per row for
// t.  At the URA cell's 131,072 signatures that is 4.6e10 FP32 FMAs a call,
// 1.38 ms on the FP32 pipe (67 TFLOP/s); the direct 3xTF32 product on the
// tensor cores is bounded at 2.24 ms.  On an H100 (700 W) the factored
// kernel took ~2.95 ms there, a direct wgmma 3xTF32 kernel (A' = [Sr | Si]
// from registers, B' = [[Ar, Ai], [-Ai, Ar]] split hi / lo, staged by
// cp.async, running argmax in the epilogue) 3.80 ms.  The phasor tables E
// [G_el, A_el] and P [G_el, G_az, A_azp] (A_azp: A_az rounded up to whole
// chunks of 8, the rest zero phasors) are built once per configuration in
// float64 and rounded once (ops/beam.py:grid_constants).
//
// Design: a block owns 128 signatures for the whole grid, so the argmax
// needs no pass across blocks.  Each lane of a warp owns 4 of them; warp
// w takes the points a0 + w, a0 + w + 8, ... of each tile of points.  The
// grid is walked in tiles of up to BM_P_WORDS / A_azp points of one row
// (a whole row at the URA's and the ULAs' widths), whose phasors come to
// shared memory by 16-byte cp.async one tile ahead; before a row's first
// tile its t is formed from the signature tile (in shared memory for the
// whole block) into the other half of a double buffer.  At a row's start
// each thread takes its signatures' first chunk of 8 t values into
// registers, then runs its points: 8 complex MACs a signature against
// phasors every lane of the warp reads at one address, and, for A_az > 8,
// the further chunks with t from shared memory (rows padded by 2 so that
// the lanes' 16-byte loads fall in distinct banks); |.|^2 and a running
// (max, index) a signature that keeps the first of equal values (points
// are visited in increasing index; two points an iteration where A_az <=
// 8, ~7 % faster than one, and one where further chunks need the
// registers).  One barrier a tile.  At the end the eight warps' maxima
// meet in shared memory (ties to the lower index), and the five taps are
// recomputed as direct FP32 dot products against the grid's steering rows
// (the port's steering matrix, as the plain route takes it), y0 included,
// so the parabola sees one arithmetic whatever the tiled sums round to.
// No atomics: two runs give the same bits.  The kernel allocates nothing
// and launches on the given stream, so a CUDA graph captures it.  Shared
// memory is bm_smem_bytes: it grows with A_azp and A and not with the
// grid, and holds arrays up to 64 elements on a line (ops/beam.py:fits).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM_THREADS = 256;
constexpr int BM_WARPS = BM_THREADS / 32;
constexpr int BM_R = 4;                   // signatures a lane
constexpr int BM_SIGS = 32 * BM_R;        // signatures a block
constexpr int BM_CHUNK = 8;               // azimuth elements a chunk
// float2 of a tile of phasors: 240 points at A_azp = 8 (a whole row of
// the cells' grids); sized so that a 64-element line fits the budget.
constexpr int BM_P_WORDS = 1920;
constexpr int BM_TAPS = 5;
constexpr long long BM_SMEM_MAX = 232448;  // sm_90's opt-in per block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes of shared memory a block takes: two tiles of phasors (the warps'
// maxima reuse them at the end), two t buffers of padded rows, the
// signature tile.
__host__ __device__ constexpr long long bm_smem_bytes(int azp, int A) {
  return 8LL * (2LL * BM_P_WORDS + 2LL * BM_SIGS * (azp + 2) +
                (long long)BM_SIGS * A);
}

// A row's t: t[j][n] = sum_m s[j][m A_az + n] E[m] for the block's
// signatures j, zero for n >= A_az; rows of azp + 2.
__device__ __forceinline__ void form_t(float2* __restrict__ t,
                                       const float2* __restrict__ sig,
                                       const float2* __restrict__ erow,
                                       int A, int a_az, int a_el, int azp) {
  for (int o = threadIdx.x; o < BM_SIGS * azp; o += BM_THREADS) {
    const int j = o / azp, n = o % azp;
    float re = 0.f, im = 0.f;
    if (n < a_az) {
      const float2* sj = sig + j * A + n;
      for (int m = 0; m < a_el; ++m) {
        const float2 s = sj[m * a_az], e = erow[m];
        re = fmaf(s.x, e.x, re);
        re = fmaf(-s.y, e.y, re);
        im = fmaf(s.x, e.y, im);
        im = fmaf(s.y, e.x, im);
      }
    }
    t[j * (azp + 2) + n] = make_float2(re, im);
  }
}

// Starts the copy of tile ``s`` (row s / nt, points from (s % nt) tp) of P
// into its half of the phasor buffer.
__device__ __forceinline__ void issue_tile(float2* __restrict__ Ps,
                                           const float2* __restrict__ P,
                                           int s, int nt, int tp, int g_az,
                                           int azp) {
  const int e = s / nt, a0 = (s % nt) * tp;
  const int words = min(tp, g_az - a0) * azp;
  float2* dst = Ps + (s & 1) * BM_P_WORDS;
  const float2* src = P + ((long long)e * g_az + a0) * azp;
  for (int o = threadIdx.x; o < words / 2; o += BM_THREADS)
    cp_async16(dst + 2 * o, src + 2 * o);
  cp_async_commit();
}

// Eight complex values from 16-byte-aligned shared memory.
__device__ __forceinline__ void load8(float2 (&out)[BM_CHUNK],
                                      const float2* src) {
  const float4* v = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int n = 0; n < BM_CHUNK / 2; ++n) {
    const float4 w = v[n];
    out[2 * n] = make_float2(w.x, w.y);
    out[2 * n + 1] = make_float2(w.z, w.w);
  }
}

// re + j im (+)= sum_n t[n] p[n] over one chunk; ``first`` starts the sum.
__device__ __forceinline__ void cmac8(float& re, float& im,
                                      const float2 (&t)[BM_CHUNK],
                                      const float2 (&p)[BM_CHUNK],
                                      bool first) {
  if (first) {
    re = t[0].x * p[0].x;
    im = t[0].x * p[0].y;
  } else {
    re = fmaf(t[0].x, p[0].x, re);
    im = fmaf(t[0].x, p[0].y, im);
  }
  re = fmaf(-t[0].y, p[0].y, re);
  im = fmaf(t[0].y, p[0].x, im);
#pragma unroll
  for (int n = 1; n < BM_CHUNK; ++n) {
    re = fmaf(t[n].x, p[n].x, re);
    re = fmaf(-t[n].y, p[n].y, re);
    im = fmaf(t[n].x, p[n].y, im);
    im = fmaf(t[n].y, p[n].x, im);
  }
}

// |re + j im|^2 into a running (max, first index).
__device__ __forceinline__ void keep_max(float re, float im, float& best,
                                         int& bidx, int k) {
  const float pw = fmaf(re, re, im * im);
  if (pw > best) {
    best = pw;
    bidx = k;
  }
}

// A tile's points for A_az <= 8: t in registers, two points an
// iteration.
__device__ __forceinline__ void scan_one_chunk(
    const float2 (&t)[BM_R][BM_CHUNK], const float2* tile, int np, int base,
    int warp, float (&best)[BM_R], int (&bidx)[BM_R]) {
#pragma unroll 2
  for (int a = warp; a < np; a += BM_WARPS) {
    float2 p[BM_CHUNK];
    load8(p, tile + a * BM_CHUNK);
#pragma unroll
    for (int i = 0; i < BM_R; ++i) {
      float re, im;
      cmac8(re, im, t[i], p, true);
      keep_max(re, im, best[i], bidx[i], base + a);
    }
  }
}

// A tile's points for A_az > 8: the first chunk's t in registers, the
// further chunks' from shared memory (t rows ``tb`` of ``ts``), one point
// an iteration.
__device__ __forceinline__ void scan_chunks(
    const float2 (&t)[BM_R][BM_CHUNK], const float2* tile,
    const float2* tb, int np, int base, int warp, int lane, int azp, int ts,
    float (&best)[BM_R], int (&bidx)[BM_R]) {
#pragma unroll 1
  for (int a = warp; a < np; a += BM_WARPS) {
    const float2* pa = tile + a * azp;
    float re[BM_R], im[BM_R];
    {
      float2 p[BM_CHUNK];
      load8(p, pa);
#pragma unroll
      for (int i = 0; i < BM_R; ++i) cmac8(re[i], im[i], t[i], p, true);
    }
#pragma unroll 1
    for (int c = BM_CHUNK; c < azp; c += BM_CHUNK) {
      float2 p[BM_CHUNK];
      load8(p, pa + c);
#pragma unroll
      for (int i = 0; i < BM_R; ++i) {
        float2 tc[BM_CHUNK];
        load8(tc, tb + (lane + 32 * i) * ts + c);
        cmac8(re[i], im[i], tc, p, false);
      }
    }
#pragma unroll
    for (int i = 0; i < BM_R; ++i)
      keep_max(re[i], im[i], best[i], bidx[i], base + a);
  }
}

__global__ void __launch_bounds__(BM_THREADS, 2)
beam_peak_kernel(const float2* __restrict__ sigs, int N, int a_az, int a_el,
                 int g_az, int g_el, int azp, const float2* __restrict__ E,
                 const float2* __restrict__ P,
                 const float2* __restrict__ steer,
                 long long* __restrict__ out_idx,
                 float* __restrict__ out_taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int A = a_el * a_az;
  const int ts = azp + 2;                       // float2 a t row
  const int tp = BM_P_WORDS / azp;              // points a tile
  const int nt = (g_az + tp - 1) / tp;          // tiles a row
  const int tiles = g_el * nt;
  float2* Ps = reinterpret_cast<float2*>(smem_raw);   // [2][BM_P_WORDS]
  float2* Ts = Ps + 2 * BM_P_WORDS;                   // [2][SIGS][ts]
  float2* Ss = Ts + 2 * BM_SIGS * ts;                 // [SIGS][A]
  float* red_v = reinterpret_cast<float*>(Ps);        // [W][SIGS], at the end
  int* red_i = reinterpret_cast<int*>(red_v + BM_WARPS * BM_SIGS);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n0 = (long long)blockIdx.x * BM_SIGS;

  issue_tile(Ps, P, 0, nt, tp, g_az, azp);
  // The signature tile, zero rows past N.
  for (int o = threadIdx.x; o < BM_SIGS * A; o += BM_THREADS) {
    const long long f = n0 * A + o;
    Ss[o] = f < (long long)N * A ? sigs[f] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  form_t(Ts, Ss, E, A, a_az, a_el, azp);
  cp_async_wait_all();
  __syncthreads();

  float best[BM_R];
  int bidx[BM_R];
#pragma unroll
  for (int i = 0; i < BM_R; ++i) {
    best[i] = -1.f;
    bidx[i] = 0;
  }
  float2 t[BM_R][BM_CHUNK];

  for (int s = 0; s < tiles; ++s) {
    const int e = s / nt, a0 = (s % nt) * tp;
    const int np = min(tp, g_az - a0);
    if (s + 1 < tiles) {
      issue_tile(Ps, P, s + 1, nt, tp, g_az, azp);
      if ((s + 1) % nt == 0)
        form_t(Ts + ((e + 1) & 1) * BM_SIGS * ts, Ss, E + (e + 1) * a_el, A,
               a_az, a_el, azp);
    }
    const float2* tb = Ts + (e & 1) * BM_SIGS * ts;
    if (a0 == 0) {
#pragma unroll
      for (int i = 0; i < BM_R; ++i) load8(t[i], tb + (lane + 32 * i) * ts);
    }
    const float2* tile = Ps + (s & 1) * BM_P_WORDS;
    if (azp == BM_CHUNK)
      scan_one_chunk(t, tile, np, e * g_az + a0, warp, best, bidx);
    else
      scan_chunks(t, tile, tb, np, e * g_az + a0, warp, lane, azp, ts, best,
                  bidx);
    cp_async_wait_all();
    __syncthreads();
  }

  // The warps' maxima: the largest value, the lower index among equals.
#pragma unroll
  for (int i = 0; i < BM_R; ++i) {
    red_v[warp * BM_SIGS + lane + 32 * i] = best[i];
    red_i[warp * BM_SIGS + lane + 32 * i] = bidx[i];
  }
  __syncthreads();
  int* peak = red_i;        // row 0 of red_i, once reduced
  if (threadIdx.x < BM_SIGS) {
    const int j = threadIdx.x;
    float v = red_v[j];
    int k = red_i[j];
    for (int w = 1; w < BM_WARPS; ++w) {
      const float vw = red_v[w * BM_SIGS + j];
      const int kw = red_i[w * BM_SIGS + j];
      if (vw > v || (vw == v && kw < k)) {
        v = vw;
        k = kw;
      }
    }
    peak[j] = k;
    if (n0 + j < N) out_idx[n0 + j] = k;
  }
  __syncthreads();

  // The five taps (ops/beam.py:TAP_STEPS) by direct dot products against
  // the steering rows.
  for (int o = threadIdx.x; o < BM_TAPS * BM_SIGS; o += BM_THREADS) {
    const int tap = o / BM_SIGS, j = o % BM_SIGS;
    if (n0 + j >= N) continue;
    const int k = peak[j];
    int ie = k / g_az, ia = k % g_az;
    if (tap == 1) ia = max(ia - 1, 0);
    if (tap == 2) ia = min(ia + 1, g_az - 1);
    if (tap == 3) ie = max(ie - 1, 0);
    if (tap == 4) ie = min(ie + 1, g_el - 1);
    const float2* st = steer + (long long)(ie * g_az + ia) * A;
    const float2* sj = Ss + j * A;
    float re = 0.f, im = 0.f;
    for (int c = 0; c < A; ++c) {
      const float2 s = sj[c], g = st[c];
      re = fmaf(s.x, g.x, re);
      re = fmaf(s.y, g.y, re);
      im = fmaf(s.y, g.x, im);
      im = fmaf(-s.x, g.y, im);
    }
    out_taps[(n0 + j) * BM_TAPS + tap] =
        __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
  }
}

}  // namespace

// idx [N] (int64) and taps [N, 5] (float32) of signatures [N, A_el * A_az]
// (complex64) over the G_el x G_az grid: E [G_el, A_el], P [G_el, G_az,
// azp] (azp: A_az rounded up to a multiple of 8) and the steering
// [G_el * G_az, A_el * A_az], all complex64.
extern "C" int beam_peak(const void* sigs, int N, int a_az, int a_el,
                         int g_az, int g_el, int azp, const void* E,
                         const void* P, const void* steer, void* out_idx,
                         void* out_taps, int device, void* stream) {
  if (N <= 0 || a_az < 1 || a_el < 1 || g_az < 1 || g_el < 1 ||
      azp != (a_az + BM_CHUNK - 1) / BM_CHUNK * BM_CHUNK ||
      (long long)g_el * g_az > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // ops/beam.py:smem_bytes is the same sum.
  const long long smem = bm_smem_bytes(azp, a_el * a_az);
  if (smem > BM_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(beam_peak_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)N + BM_SIGS - 1) / BM_SIGS;
  beam_peak_kernel<<<(unsigned)blocks, BM_THREADS, (size_t)smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(sigs), N, a_az, a_el, g_az, g_el, azp,
      static_cast<const float2*>(E), static_cast<const float2*>(P),
      static_cast<const float2*>(steer), static_cast<long long*>(out_idx),
      static_cast<float*>(out_taps));
  return (int)cudaGetLastError();
}
