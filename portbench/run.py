#!/usr/bin/env python3
"""Run one cell of the benchmark of ``radar_slam_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name (``portbench/registry.py``).  Set-up
(import, the card, the kernels' builds, the inputs from the seed, one warm
unit of every shape) is ``setup_s``.  Then:

- ``--trace 0``: the window -- units back to back for ``--seconds``
  seconds, each timed on the host clock -- and the cell's end-to-end
  metrics (``end_to_end/<metric>.py``);
- ``--trace 1``: a CUDA-only profiler trace of ``trace_units`` units, then
  a CPU + CUDA trace of ``breakdown_units`` more for the breakdown, and
  the cell's per-layer metrics (``layer_metrics/<metric>.py``).

Then the program's state is freed and the sampled units' outputs are
compared with the plain reference (``portbench/reference/``), each number
against its limit (``limits/<cell>.json``); the numbers go to standard
error and, last, into the result.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` with ``--trace 1``), then ``checked``.

Without a card, or with fewer cards than the cell asks for, it exits 3 and
prints no result; so it does if ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded when the window has closed.  Kernel builds and caches
stay in the checkout (``radar_slam_tpu_torch/_build/``, and
``.portbench_cache/`` for anything that honours ``TORCH_EXTENSIONS_DIR`` or
``TRITON_CACHE_DIR``).
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
# One process with one host thread for the math libraries: their worker
# pools would contend with the launching thread for the host's cores.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "radar_slam_tpu")


class Refused(Exception):
    """The run cannot give a result (exit 3, nothing on standard output)."""


def forbidden_modules():
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole (``radar_slam_tpu_torch`` is not
    ``radar_slam_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def fixed_caches(root: Path = ROOT) -> None:
    cache = root / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def guarded_step(drv, i: int) -> int:
    """Unit ``i``'s failed frames: all of them where it raised (the
    traceback goes to standard error and the window goes on)."""
    try:
        return drv.step(i)
    except Exception:  # noqa: BLE001 -- the window reports and goes on
        traceback.print_exc(file=sys.stderr)
        return drv.unit_frames


def window(drv, seconds: float):
    """Units back to back until ``seconds`` have passed: (per-unit host
    times (start, end), frames completed, frames failed, units)."""
    import torch
    spans, failed, i = [], 0, 0
    t0 = time.perf_counter()
    while True:
        drv.prepare(i)
        ts = time.perf_counter()
        failed += guarded_step(drv, i)
        te = time.perf_counter()
        spans.append((ts, te))
        i += 1
        if te - t0 >= seconds:
            break
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    return {"t0": t0, "t1": spans[-1][1], "spans": spans,
            "frames": i * drv.unit_frames, "failed": failed, "units": i}


def traced(drv, n_trace: int, n_breakdown: int, start: int, cell):
    """The CUDA-only trace of ``n_trace`` units from unit ``start`` and a
    CPU + CUDA trace of ``n_breakdown`` more: (Traced record, breakdown,
    units run, frames failed)."""
    from torch.profiler import ProfilerActivity

    from portbench import trace as tr
    pads = tr.Pads()
    state = {"i": start, "failed": 0}

    def units(n):
        def fn():
            for _ in range(n):
                drv.prepare(state["i"])
                state["failed"] += guarded_step(drv, state["i"])
                state["i"] += 1
        return fn

    _, raw, wall = tr.device_trace(units(n_trace), [ProfilerActivity.CUDA],
                                   pads)
    rec = tr.Traced(tr.device_events(raw), wall, n_trace,
                    n_trace * drv.unit_frames, n_trace * drv.unit_k1_frames,
                    {"config": cell.config})
    prof, _, _ = tr.device_trace(units(n_breakdown),
                                 [ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA], pads)
    return rec, tr.breakdown(prof), state["i"] - start, state["failed"]


def device_info(torch, chips: int):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench=None, mutate=None):
    """One run of cell ``name``; returns the result dict and the compared
    numbers.  ``device="cpu"`` (tests only) runs the program's plain
    versions; ``mutate(driver)`` (tests only) plants a fault."""
    import torch

    from portbench import compare, registry
    from portbench import trace as tr
    torch.set_num_threads(1)
    bench = bench or registry.load_benchmark()
    cell = registry.Cell(name, bench)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("no CUDA device is available")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"the cell needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} are visible")
    dev = torch.device(device)
    drv = cell.driver.Driver(cell, seed, dev)
    if mutate is not None:
        mutate(drv)
    drv.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    metrics, extra = {}, {}
    if trace:
        mix = cell.mix
        rec, brk, n_units, failed = traced(drv, int(mix["trace_units"]),
                                           int(mix["breakdown_units"]), 0,
                                           cell)
        attempted = n_units * drv.unit_frames
        readers = cell.readers("layer_metrics", cell.per_layer)
        for m in cell.per_layer:
            value = readers[m["name"]].read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = brk
        busy = {"busy_s": tr.interval_busy_s(rec.events),
                "window_s": rec.window_s}
    else:
        win = window(drv, seconds)
        win["setup_s"] = setup_s
        attempted, failed = win["frames"], win["failed"]
        readers = cell.readers("end_to_end", cell.end_to_end)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": readers[m["name"]].read(win),
                                  "unit": m["unit"]}
        busy = {}
    info = (device_info(torch, cell.chips) if device == "cuda"
            else {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0})
    info.update(busy)
    found = forbidden_modules()
    if found:
        raise Refused(f"modules the benchmark may not load: {found}")
    drv.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    readings, cmp_info = drv.compare("float64")
    found = forbidden_modules()
    if found:
        raise Refused(f"modules the benchmark may not load: {found}")
    ok, rows = compare.judge(readings, cell.limits["numbers"])
    result = {"correct": bool(ok and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": info}
    result.update(extra)
    result["checked"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, rows, cmp_info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_caches()
    sys.path.insert(0, str(ROOT))
    try:
        result, rows, info = run_cell(args.workload, args.seed,
                                      args.seconds, bool(args.trace))
    except (Refused, ImportError, FileNotFoundError, KeyError) as e:
        print(f"portbench: no result: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 3
    print(f"compared: {json.dumps(info)}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(_plain(result)))
    return 0


def _plain(x):
    """``x`` with every number a JSON number (a non-finite one a string)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return x
    if isinstance(x, int):
        return x
    x = float(x)
    return x if math.isfinite(x) else str(x)


if __name__ == "__main__":
    sys.exit(main())
