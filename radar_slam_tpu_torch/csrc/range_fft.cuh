// The range DFT of the front-end kernels, factored (ops/range_dft.py is
// the plan, the tables and the plain form):
//
//   Y = (x * mix) W,  W[s, r] = e^{+2j pi s r / S},  Y[0] = 0 with dc_removal
//
// run on rows held in shared memory as an in-place mixed-radix
// decimation-in-time FFT.  The caller stores sample s of each row at
// position pos[s] (the plan's digit reversal); stage t of radix R
// (2, 3, 4 or 5) on sub-transforms of length L = Q_0 ... Q_t, Lp = L / R,
//
//   v[r] = x[b L + j + r Lp] w[j r S / L],   x[b L + j + q Lp] =
//          sum_r v[r] w[((r q) mod R) S / R]
//
// leaves the natural-order spectrum.  w is one table e^{+2j pi k / S}
// built on the host in float64 and rounded to float32: no trigonometry
// here.  At S = 400 = 4 4 5 5 a row costs 7.2 k complex MACs against the
// dense product's 160 k.  An S with a prime factor above 5 has no plan
// (nst = 0) and takes the dense route: the same table, S^2 MACs per row,
// one warp per row through a scratch row.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int FFT_MAX_STAGES = 16;   // ops/range_dft.py: MAX_STAGES

struct FftPlan {
  int nst;                       // 0: the dense route
  int radix[FFT_MAX_STAGES];
};

__device__ __forceinline__ float2 fft_cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One radix-R butterfly at x[0], x[Lp], ... x[(R-1) Lp]; jt = j S / L.
template <int R>
__device__ __forceinline__ void butterfly(float2* x, int Lp, int jt, int S,
                                          const float2* tw) {
  float2 v[R];
  v[0] = x[0];
#pragma unroll
  for (int r = 1; r < R; ++r) v[r] = fft_cmul(x[r * Lp], tw[jt * r]);
  if constexpr (R == 2) {
    x[0] = make_float2(v[0].x + v[1].x, v[0].y + v[1].y);
    x[Lp] = make_float2(v[0].x - v[1].x, v[0].y - v[1].y);
  } else if constexpr (R == 4) {
    // w_4 = +j: y1 = b + j d, y3 = b - j d.
    const float2 a = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
    const float2 b = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
    const float2 c = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
    const float2 d = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
    x[0] = make_float2(a.x + c.x, a.y + c.y);
    x[Lp] = make_float2(b.x - d.y, b.y + d.x);
    x[2 * Lp] = make_float2(a.x - c.x, a.y - c.y);
    x[3 * Lp] = make_float2(b.x + d.y, b.y - d.x);
  } else {
    const int step = S / R;
    float2 y[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      y[q] = v[0];
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 p = fft_cmul(v[r], tw[((r * q) % R) * step]);
        y[q].x += p.x;
        y[q].y += p.y;
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) x[q * Lp] = y[q];
  }
}

// In-place transform of rows 0..rows-1 of x (row pitch ld) with all
// threads of the block; tw: the table [S] (shared memory); scratch: one
// row of S per warp, for the dense route.  Ends with a __syncthreads.
__device__ void fft_rows(float2* x, int rows, int ld, int S,
                         const FftPlan& plan, const float2* tw,
                         float2* scratch) {
  __syncthreads();
  if (plan.nst == 0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    float2* out = scratch + warp * S;
    for (int row = warp; row < rows; row += nwarps) {
      float2* xr = x + row * ld;
      for (int k = lane; k < S; k += 32) {
        float2 acc = make_float2(0.f, 0.f);
        int idx = 0;                      // (s k) mod S
        for (int s = 0; s < S; ++s) {
          const float2 p = fft_cmul(xr[s], tw[idx]);
          acc.x += p.x;
          acc.y += p.y;
          idx += k;
          if (idx >= S) idx -= S;
        }
        out[k] = acc;
      }
      __syncwarp();
      for (int k = lane; k < S; k += 32) xr[k] = out[k];
      __syncwarp();
    }
    __syncthreads();
    return;
  }
  int L = 1;
  for (int t = 0; t < plan.nst; ++t) {
    const int R = plan.radix[t];
    const int Lp = L;
    L *= R;
    const int nb = S / R, tstep = S / L;
    for (int e = threadIdx.x; e < rows * nb; e += blockDim.x) {
      const int row = e / nb, bi = e - row * nb;
      const int b = bi / Lp, j = bi - b * Lp;
      float2* base = x + row * ld + b * L + j;
      switch (R) {
        case 2: butterfly<2>(base, Lp, j * tstep, S, tw); break;
        case 3: butterfly<3>(base, Lp, j * tstep, S, tw); break;
        case 4: butterfly<4>(base, Lp, j * tstep, S, tw); break;
        default: butterfly<5>(base, Lp, j * tstep, S, tw); break;
      }
    }
    __syncthreads();
  }
}

}  // namespace
