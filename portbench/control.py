#!/usr/bin/env python3
"""Readings for the limits that decide ``correct``, on the card.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--units N] [--control 0|1]

For each seed, in one process: the cell's set-up, then ``--units`` units
back to back at the cell's own load (the sampled ones among them; by
default the mix's ``control_units``), then
the program's numbers against the reference (what a run compares) and,
with ``--control 1``, the control's: the reference computed at TF32 (the
front end's products on TF32 tensor cores, phase B in float32 with every
product's operands rounded to TF32), the precision one step below the
configuration's float32 with TF32 off, put in the program's place.  One
JSON line a seed, with the quantiles of the target slots' (x, y) gaps
beside the numbers.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def merge(into, numbers):
    """The largest reading of each number over the compared units."""
    for k, v in numbers.items():
        into[k] = max(into.get(k, v), v)


def slot_gaps(got, want):
    """Quantiles (50, 90, 99, 99.9, 100 %) of the (x, y) gap of the target
    slots valid on both sides (m), where the sample has targets."""
    import numpy as np
    if got.target_xy is None:
        return None
    both = got.target_valid & want.target_valid
    gap = np.linalg.norm(got.target_xy - want.target_xy, axis=-1)[both]
    if not gap.size:
        return None
    return np.quantile(gap, [0.5, 0.9, 0.99, 0.999, 1.0]).tolist()


def readings(name: str, seed: int, units: int, control: bool,
             device: str = "cuda", bench=None):
    import torch

    from portbench import registry
    cell = registry.Cell(name, bench or registry.load_benchmark())
    units = units or int(cell.mix["control_units"])
    drv = cell.driver.Driver(cell, seed, torch.device(device))
    drv.warm()
    failed = 0
    t0 = time.perf_counter()
    for i in range(units):
        drv.prepare(i)
        failed += drv.step(i)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    drv.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    from portbench import compare as cmp
    t0 = time.perf_counter()
    prog, ctl = {}, {}
    gaps = {}
    for i, got in sorted(drv.kept.items()):
        want = drv.expected(i, "float64")
        merge(prog, cmp.numbers_of(got, want, drv.counts))
        gaps["program"] = slot_gaps(got, want)
        if control:
            low = drv.expected(i, "tf32")
            merge(ctl, cmp.numbers_of(low, want, drv.counts))
            gaps["control"] = slot_gaps(low, want)
    out = {"cell": name, "seed": seed, "units": units, "failed": failed,
           "window_s": seconds, "program": prog, **drv.compared(),
           "reference_s": time.perf_counter() - t0,
           "slot_gap_quantiles_m": gaps}
    if control:
        out["control"] = ctl
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--units", type=int, default=None)
    p.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(args.workload, seed, args.units,
                                  bool(args.control))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
