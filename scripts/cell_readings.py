#!/usr/bin/env python3
"""A benchmark cell's readings against its reference, on the card.

    python3 scripts/cell_readings.py --workload <cell> --seeds 1,2,3 \
        [--precisions tf32,float32] [--units N]

``portbench/control.py``'s readings, with three additions: the numbers a
driver adds to the comparison (its ``numbers_of``, as the URA cell's
``heights_off``), the reference at more than one precision in the
program's place (``tf32``: the control; ``float32``: plain float32 with
TF32 off, the configuration's own precision, a witness of how far
rounding alone moves the numbers), and what the units did (set-up and
unit seconds, peak device memory, counters per unit, the heights' gaps,
and on a scene of constant 3-D motion the median |v - v_body| of v_x and
v_z over the kept unit's frames 1..F-1, tests/test_elevation.py's gates).

For each seed, in one process: the cell's set-up, the mix's
``control_units`` units back to back (or ``--units``), then the numbers
of the program and of each precision against the float64 reference.  One
JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))


def add_float32():
    """The reference's plain float32 (TF32 off) beside its two precisions."""
    import numpy as np
    import torch

    from portbench.reference import estimation, frontend
    estimation.PRECISIONS["float32"] = estimation.Precision(
        np.float32, np.complex64, False)
    frontend.PRECISIONS["float32"] = (torch.float32, torch.complex64, False)


def height_gaps(got, want):
    """Quantiles (50, 99, 100 %) of |dz| over target slots valid on both
    sides (m); None without heights."""
    import numpy as np
    if getattr(got, "target_z", None) is None:
        return None
    both = got.target_valid & want.target_valid
    dz = np.abs(got.target_z - want.target_z)[both]
    return np.quantile(dz, [0.5, 0.99, 1.0]).tolist() if dz.size else None


def accuracy(got, scene):
    """Median |v_x - v_x0| and |v_z - v_z0| (m/s) over frames 1..F-1 on a
    scene of constant 3-D body velocity; None on any other."""
    import numpy as np
    vb = scene.get("v_body", ())
    if len(vb) != 3:
        return None
    v = got.rows[1:, 3:6]
    return {"median_abs_vx_err": float(np.median(np.abs(v[:, 0] - vb[0]))),
            "median_abs_vz_err": float(np.median(np.abs(v[:, 2] - vb[2]))),
            "success": float(got.rows[:, 9].mean())}


def readings(cell, seed: int, units: int, precisions, device="cuda"):
    import torch

    from portbench import compare as cmp
    from portbench.control import merge
    from torch_span_pass import counters, per_unit
    card = device == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    if card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    drv = cell.driver.Driver(cell, seed, torch.device(device))
    drv.warm()
    sync()
    setup_s = time.perf_counter() - t0
    units = units or int(cell.mix["control_units"])
    before = counters()
    t0 = time.perf_counter()
    failed = 0
    for i in range(units):
        drv.prepare(i)
        failed += drv.step(i)
    sync()
    out = {"cell": cell.name, "seed": seed, "units": units, "failed": failed,
           "setup_s": setup_s,
           "unit_s": (time.perf_counter() - t0) / units,
           "peak_bytes": torch.cuda.max_memory_allocated() if card else None,
           "per_unit": per_unit(counters(), before, units)}
    drv.release()
    if card:
        torch.cuda.empty_cache()
    numbers_of = getattr(drv, "numbers_of",
                         lambda got, want: cmp.numbers_of(got, want,
                                                          drv.counts))
    t0 = time.perf_counter()
    sides = {"program": {}, **{p: {} for p in precisions}}
    gaps = {}
    for i, got in sorted(drv.kept.items()):
        want = drv.expected(i, "float64")
        out["accuracy"] = accuracy(got, cell.config["scene"])
        for side in sides:
            low = got if side == "program" else drv.expected(i, side)
            merge(sides[side], numbers_of(low, want))
            gaps[side] = height_gaps(low, want)
    out.update(sides, height_gap_quantiles_m=gaps,
               reference_s=time.perf_counter() - t0, **drv.compared())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--precisions", default="tf32")
    p.add_argument("--units", type=int, default=0)
    args = p.parse_args(argv)
    import torch

    from portbench import registry
    from portbench.run import fixed_caches
    fixed_caches()
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("cell_readings: no CUDA device", file=sys.stderr)
        return 3
    add_float32()
    cell = registry.Cell(args.workload, registry.load_benchmark())
    precisions = [s for s in args.precisions.split(",") if s]
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(cell, seed, args.units, precisions)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
