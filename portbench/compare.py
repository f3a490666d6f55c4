"""The numbers that decide ``correct``: the program's outputs of the sampled
units against the reference's, frame by frame.

Columns of a frame row (``common.frame_numbers``; the stream's analyzer
rows leave out detections): pose x, y, yaw, velocity (3), angular
velocity (3), success, then the counts.  Each number is a share of the
compared frames or slots, or a median over them:

- ``counts_off``: share of frames where a count (detections, reliable
  targets, associations) or the solve's success differs;
- ``motion_off``: share of frames whose velocity or angular velocity
  differs by more than ``MOTION_TOL`` in a component;
- ``targets_off``: share of target slots, valid on either side, that are
  valid on one side only or lie more than ``XY_TOL`` apart;
- ``pose_gap_m``: the largest gap between the two sides' (x, y) over the
  frames (the absolute pose error; a non-finite pose reads infinite).
  ``control.py`` reports it; no cell's limits hold it, since one frame
  whose association count flips at rounding turns the heading by ~1e-3
  rad and the gap grows with the rest of the drive (0.3 m in a sound
  2,048-frame recording), so it swings from ~1e-3 m to the control's
  readings with where and whether such a flip falls;
- ``pose_rpe_m``: the median, over every window of ``RPE_WINDOW`` frames,
  of the gap between the two sides' displacements across the window, each
  in its own pose's frame at the window's start (a relative pose error; a
  non-finite pose reads infinite).  A flipped frame moves the absolute pose
  for the rest of the sequence, but only the windows that hold it.

A detection flips where its cell lies within rounding of its CFAR
threshold or of a neighbour; a flip moves that frame's counts, the slots
after it and the frame's solve, so the shares count such frames.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

MOTION_TOL = 1e-3     # m/s, rad/s per component
XY_TOL = 0.01         # m
RPE_WINDOW = 64       # frames (6.4 s at 100 ms)

VEL, ANG, SUCCESS = slice(3, 6), slice(6, 9), 9


def _share(x: np.ndarray) -> float:
    return float(np.mean(x)) if x.size else 0.0


def numbers(prog: np.ndarray, ref: np.ndarray,
            counts: Dict[str, int],
            prog_xy: Optional[np.ndarray] = None,
            prog_valid: Optional[np.ndarray] = None,
            ref_xy: Optional[np.ndarray] = None,
            ref_valid: Optional[np.ndarray] = None) -> Dict[str, float]:
    """The numbers of frame rows ``prog`` against ``ref`` [F, n];
    ``counts`` maps each count's name to its column."""
    if prog.shape != ref.shape:
        raise ValueError(f"rows {prog.shape} against {ref.shape}")
    counts = list(counts.values()) + [SUCCESS]
    out = {"counts_off": _share(np.any(prog[:, counts] != ref[:, counts],
                                       axis=-1))}
    dm = np.maximum(np.abs(prog[:, VEL] - ref[:, VEL]).max(-1),
                    np.abs(prog[:, ANG] - ref[:, ANG]).max(-1))
    out["motion_off"] = _share(~(dm <= MOTION_TOL))
    if prog_xy is not None:
        either = prog_valid | ref_valid
        gap = np.linalg.norm(prog_xy - ref_xy, axis=-1)
        off = (prog_valid != ref_valid) | ~(gap <= XY_TOL)
        out["targets_off"] = _share(off[either])
    finite = bool(np.all(np.isfinite(prog[:, :3])))
    out["pose_gap_m"] = (float(np.linalg.norm(prog[:, :2] - ref[:, :2],
                                              axis=-1).max())
                         if finite else math.inf)
    out["pose_rpe_m"] = (float(np.median(rpe(prog, ref))) if finite
                         else math.inf)
    return out


def _local_steps(rows: np.ndarray, w: int) -> np.ndarray:
    """Displacements [F - w, 2] across each window of ``w`` frames, in the
    frame of the pose (x, y, yaw) at the window's start."""
    d = rows[w:, :2] - rows[:-w, :2]
    c, s = np.cos(rows[:-w, 2]), np.sin(rows[:-w, 2])
    return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]],
                    axis=-1)


def rpe(prog: np.ndarray, ref: np.ndarray, w: int = RPE_WINDOW):
    """Per-window relative pose error (m) of frame rows; one window of the
    whole sequence where it is shorter than ``w`` frames."""
    w = min(w, prog.shape[0] - 1)
    if w < 1:
        return np.zeros(1)
    return np.linalg.norm(_local_steps(prog, w) - _local_steps(ref, w),
                          axis=-1)


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, reading, limit)]) over the limits' names; a
    reading that is missing or not a number fails."""
    rows = []
    ok = True
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        ok = ok and bool(value <= limit)
        rows.append((name, value, limit))
    return ok, rows


def numbers_of(got, want, counts: Dict[str, int]) -> Dict[str, float]:
    """:func:`numbers` of two ``common.Sample``s."""
    return numbers(got.rows, want.rows, counts, got.target_xy,
                   got.target_valid, want.target_xy, want.target_valid)
