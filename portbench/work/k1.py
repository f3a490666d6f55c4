"""The work of K1, the one-pass front end, and the least time the card
could take for it.

The count is a function of the configuration's shapes and the number of
frames alone, whatever implements it (frozen from
``chip_smoke.py:kernel_work``, ``dft_ops`` and ``philox_ops`` at commit
d8c8661, with two changes): every complex product counts at the TF32
tensor-core peak over three, the fastest float32-accurate rate on the
card, whichever pipe a kernel runs it on; and the INT32 rate uses the
H100 SXM's published boost clock, not the clock the card reports.

Per frame:

- products: e_at T (or, in the time domain, e_at e_fast), A*C x Sc x S
  complex MACs at 8 operations each;
- float operations: the range DFT of the Sc rows of e_fast (of the A*C
  rows of the cube in the time domain) and the Doppler
  DFT of every (antenna, range bin), each at the lesser of the dense
  product and an FFT's 5 n log2 n;
- INT32: the Philox words of the A*C x S noise values (two blocks of 50
  instructions and four byte sums of 20 a value for the "fast" transform,
  one block for Box-Muller);
- bytes: the split tables and delays read once, Z (real and imaginary),
  the power map and the score written once, the fast-time base.
"""

from __future__ import annotations

import math
from typing import Dict

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W).
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
INT32_OPS_PER_SM_CLOCK = 64
H100_SMS = 132
BOOST_CLOCK_HZ = 1.980e9
PHILOX_BLOCK_OPS = 50
BYTE_SUM_OPS = 20
SPLIT_BLOCK = 128          # fine-table length of the split factors


def dft_ops(n: int, bins: int, rows: int) -> float:
    """Operations of ``rows`` DFTs of ``n`` complex points at ``bins``
    frequencies: the lesser of the dense product and an FFT."""
    return rows * min(8 * n * bins, 5 * n * math.log2(n))


def philox_ops(draws: int, impl: str) -> float:
    per = (PHILOX_BLOCK_OPS if impl == "box_muller"
           else 2 * PHILOX_BLOCK_OPS + BYTE_SUM_OPS)
    return draws * per


def shapes(pipeline: Dict) -> Dict[str, int]:
    """(A, C, S, Sc) of a configuration's ``pipeline`` dict."""
    r = pipeline["radar"]
    return {"A": r["num_antennas"] * r.get("num_antennas_el", 1),
            "C": r["num_chirps"],
            "S": int(r["chirp_duration"] * r["sampling_rate"]),
            "Sc": pipeline["max_scatterers"]}


def work(pipeline: Dict, frames: int) -> Dict[str, float]:
    """K1's work on ``frames`` frames: {"products", "fp32", "int32",
    "bytes"}."""
    sh = shapes(pipeline)
    A, C, S, Sc = sh["A"], sh["C"], sh["S"], sh["Sc"]
    M, Q = A * C, -(-S // SPLIT_BLOCK)
    ins = Sc * (A + C + Q + SPLIT_BLOCK) * 8 + Sc * 4 + 4
    outs = 2 * S * M * 4 + 2 * C * S * 4
    # The time domain synthesizes the cube (e_at e_fast, M x Sc x S MACs)
    # and takes the range DFT of its M rows; the range-frequency domain
    # takes it of e_fast's Sc rows, then e_at T.
    time_domain = pipeline.get("noise_domain") == "time"
    range_rows = M if time_domain else Sc
    return {"products": frames * 8.0 * M * Sc * S,
            "fp32": frames * (dft_ops(S, S, range_rows)
                              + dft_ops(C, C, A * S)),
            "int32": frames * philox_ops(M * S, pipeline["noise_impl"]),
            "bytes": frames * (ins + outs) + S * 4}


def least_time_s(w: Dict[str, float]) -> float:
    """The largest of the work's times on each pipe and of its bytes."""
    return max(w["products"] / (PEAK_TF32_FLOPS / 3),
               w["fp32"] / PEAK_FP32_FLOPS,
               w["int32"] / (INT32_OPS_PER_SM_CLOCK * H100_SMS
                             * BOOST_CLOCK_HZ),
               w["bytes"] / PEAK_BYTES_S)
