"""The work of K4 (the power map from the dense synthesis factors) and of
K5 (the detected cells' signatures from them), and the least time the
card could take for each.

Counted as ``work/k1.py`` counts K1's, from the configuration's shapes
and the number of frames alone, whatever implements them: every complex
product at the TF32 tensor-core peak over three, DFTs at the lesser of
the dense product and an FFT's 5 n log2 n on the FP32 pipe, the Philox
words on INT32 at the H100 SXM's published boost clock, bytes at
3.35 TB/s.  Both kernels synthesize the cube X = e_ac^T e_fast + sigma n
(A*C x Sc x S complex MACs and the A*C x S noise values a frame) and take
its range DFT (the A*C rows, at every bin for K4 and at the K detected
bins for K5); then, per frame:

- K4: the Doppler DFT of every (antenna, range bin), |.|^2 and the mean
  over antennas; bytes: the dense factors and the seed read once, the
  power map [S, C] written once;
- K5: for each of the K detected cells the Doppler row against its range
  column (A*C complex MACs) and the unit-power scale (A complex squares,
  a square root and A divisions); bytes: the dense factors, the seed and
  the cells' bins read once, the signatures [K, A] written once.
"""

from __future__ import annotations

from typing import Dict

from portbench.work.k1 import dft_ops, least_time_s, philox_ops, shapes

__all__ = ["k4_work", "k5_work", "least_time_s"]


def _cube(sh: Dict[str, int], impl: str, bins: int) -> Dict[str, float]:
    """The shared cube, one frame: its synthesis, noise and range DFT at
    ``bins`` range bins."""
    A, C, S, Sc = sh["A"], sh["C"], sh["S"], sh["Sc"]
    M = A * C
    return {"products": 8.0 * M * Sc * S, "fp32": dft_ops(S, bins, M),
            "int32": philox_ops(M * S, impl),
            "bytes": 8.0 * Sc * (M + S) + 4}


def k4_work(pipeline: Dict, frames: int) -> Dict[str, float]:
    """K4's work on ``frames`` frames: {"products", "fp32", "int32",
    "bytes"}."""
    sh = shapes(pipeline)
    A, C, S = sh["A"], sh["C"], sh["S"]
    w = _cube(sh, pipeline["noise_impl"], S)
    w["fp32"] += dft_ops(C, C, A * S) + 4.0 * A * C * S
    w["bytes"] += 4.0 * S * C
    return {k: frames * v for k, v in w.items()}


def k5_work(pipeline: Dict, frames: int) -> Dict[str, float]:
    """K5's work on ``frames`` frames at the configuration's K detections
    a frame."""
    sh = shapes(pipeline)
    A, C = sh["A"], sh["C"]
    K = pipeline["detection"]["max_detections"]
    w = _cube(sh, pipeline["noise_impl"], K)
    w["products"] += 8.0 * K * A * C
    w["fp32"] += K * (4.0 * A + 1 + 2.0 * A)
    w["bytes"] += 8.0 * K + 8.0 * K * A
    return {k: frames * v for k, v in w.items()}
