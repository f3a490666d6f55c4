#!/usr/bin/env python3
"""The program's spans in one cell of the benchmark, on the profiler's
clock, and the per-layer numbers they give.

    python3 scripts/torch_span_pass.py --workload <cell> --seed <n> \
        [--units N] [--window-s S] [--out FILE]

Set-up is ``portbench/run.py``'s (the cell's driver from the seed, one
warm unit of every shape), with the spans on: its ``build`` spans give
``setup_build_s``.  Then three traces of ``--units`` units each (the mix's
``trace_units`` by default), between ``portbench/trace.py``'s spin
kernels:

1. CUDA only, spans off: the run's first pass, for the on-cost;
2. CUDA only, spans on: the span pass, whose spans ``collect()`` puts on
   the profiler's clock;
3. CPU + CUDA, spans off, of one unit: the lag from each kernel's launch
   on the host to its start on the device, which bounds how far the two
   clocks can disagree.

From the span pass:

- ``step_host_ms.<stage>`` (front_end, aoa, tail, fetch): ms per traced
  eager step (``step`` span with ``path`` "eager") of the
  ``step.<stage>`` spans, the K1 wrapper's ``k1`` and ``finalize`` spans
  counted inside ``front_end``; ``step_self`` the ``step`` span less its
  stages; their sum against the mean ``step``;
- ``replay_host_ms.<stage>`` (replay, fetch): the same over the steps
  that replayed the analyzer's CUDA graph (``path`` "replay"), whose host
  work before the fetch is one ``step.replay`` span; every path's stages
  are in ``step_ms_by_path``;
- ``idle_share_by_span.<phase>`` (phase_a, phase_b, ingest): the device's
  idle gaps in the pass's window whose middle falls in that phase (the
  innermost span open there, or one of its parents, is ``phase_a``,
  ``phase_b`` or an ``ingest.*`` span), over the pass's host wall;
  ``other`` (under another span) and ``none`` (under no span) complete
  the family, whose sum is held against the pass's own idle share;
- the clock check: every K1 ``range_fft_kernel`` starts after the start of
  the ``k1`` span that launched it, and no device event before the pass's
  first span;
- ``span_host_ms.<name>`` (``aoa_features``, its ``aoa_grid`` and
  ``aoa_confidence``; the three-dispatch route's ``k4``, ``os_cfar`` and
  ``k5``): ms per unit of those spans, with the first ``aoa_grid``'s
  attrs (signatures, grid points, elements, route) and the first attrs of
  each three-dispatch span, and the counters per unit over the pass:
  ``beamforming_spectrum``'s calls, chunks and products, the fused
  search's launches and products (``peak_taps``), K1's launches by branch
  (a URA call's ``tiled_rows``), K4's and K5's launches and the order
  statistic's calls, chunks and samples (``_os_noise``).

Besides: each pass's host wall per unit, and the host cost of ``span()``
off and on.  With ``--window-s``, before the traces and again after them,
units untraced for that long, spans off and on in turn, each timed on the
host clock as ``portbench/run.py``'s window times it: the on-cost; in a
stream cell also each spans-on step's stages (the first window's), the
steps split into a fast and a slow side by step time (each row in
``--out``).  One JSON line (also appended to ``--out``).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from radar_slam_tpu_torch.utils import profiling  # noqa: E402

STAGES = ("front_end", "aoa", "tail", "fetch")
# Each step path's stages: an eager step's, a captured step's (the front
# end, AoA and tail recorded while capturing, then its first replay) and a
# replayed step's.
PATH_STAGES = {"eager": STAGES, "capture": STAGES[:3] + ("replay", "fetch"),
               "replay": ("replay", "fetch")}
ROW_STAGES = PATH_STAGES["capture"]
PHASES = ("phase_a", "phase_b", "ingest")
AOA_SPANS = ("aoa_features", "aoa_grid", "aoa_confidence")
THREE_DISPATCH_SPANS = ("k4", "os_cfar", "k5")


def on_clock(spans: List[profiling.Span], origin_ns: int):
    """Collected spans with their times in seconds from ``origin_ns`` (a
    profile's ``trace_start_ns()``, the origin of its events' times)."""
    return [s._replace(start_ns=(s.start_ns - origin_ns) * 1e-9,
                       end_ns=(s.end_ns - origin_ns) * 1e-9) for s in spans]


def step_host_ms(spans, path: str = "eager"
                 ) -> Optional[Dict[str, float]]:
    """Per traced step of ``path`` (ms; a ``step`` span without the
    attribute counts as eager): each of the path's stages'
    ``step.<stage>`` spans, the ``step`` span's self time (less its
    stages) and the mean ``step``."""
    steps = {s.id: s for s in spans if s.name == "step"
             and s.attrs.get("path", "eager") == path}
    if not steps:
        return None
    n = len(steps)
    out = {stage: sum(s.end_ns - s.start_ns for s in spans
                      if s.name == f"step.{stage}" and s.parent in steps)
           / n * 1e3 for stage in PATH_STAGES[path]}
    own = profiling.self_ns(spans)
    out["step_self"] = sum(own[i] for i in steps) / n * 1e3
    out["step"] = sum(s.end_ns - s.start_ns for s in steps.values()) / n * 1e3
    return out


def step_rows(spans) -> List[List[float]]:
    """One row a step (ms; spans in s): the ``step`` span, then its
    stages (``ROW_STAGES``, 0 where its path has none)."""
    rows = {s.id: [(s.end_ns - s.start_ns) * 1e3] + [0.0] * len(ROW_STAGES)
            for s in spans if s.name == "step"}
    for s in spans:
        if s.parent in rows and s.name.startswith("step."):
            rows[s.parent][1 + ROW_STAGES.index(s.name[5:])] += (
                (s.end_ns - s.start_ns) * 1e3)
    return list(rows.values())


def window_ab(times: Dict[bool, List[float]], rows: List[List[float]]
              ) -> Dict:
    """Units timed on the host clock, spans off and on in turn: each
    side's count, median and 95th percentile (s), the on-cost (ratio of
    the medians less 1, and the mean over adjacent off / on pairs); with
    stream rows, the steps split at the middle of the 10th and 90th
    percentiles of the spans-on step times, each side's count and mean
    row (ms) and the share of the spans-off steps above the cut."""
    out = {}
    for on in (False, True):
        t = sorted(times[on])
        out["on" if on else "off"] = {"units": len(t),
                                      "median_s": statistics.median(t),
                                      "p95_s": t[int(0.95 * (len(t) - 1))]}
    out["on_cost"] = out["on"]["median_s"] / out["off"]["median_s"] - 1
    out["on_cost_paired"] = statistics.fmean(
        b / a for a, b in zip(times[False], times[True])) - 1
    if rows:
        steps = sorted(r[0] for r in rows)
        cut = 0.5 * (steps[len(steps) // 10] + steps[len(steps) * 9 // 10])
        out["cut_ms"] = cut
        for side, pick in (("fast", lambda r: r[0] <= cut),
                           ("slow", lambda r: r[0] > cut)):
            sel = [r for r in rows if pick(r)]
            out[side] = {"steps": len(sel), "mean_ms": dict(zip(
                ("step",) + ROW_STAGES,
                [statistics.fmean(c) for c in zip(*sel)] if sel else []))}
        out["slow_share_off"] = statistics.fmean(
            t * 1e3 > cut for t in times[False])
    return out


def _category(span, by_id) -> str:
    while span is not None:
        if span.name in ("phase_a", "phase_b"):
            return span.name
        if span.name.startswith("ingest."):
            return "ingest"
        span = by_id.get(span.parent)
    return "other"


def idle_gaps(events, t0: float, t1: float) -> List[tuple]:
    """The device's idle intervals in [t0, t1]: the complement of the
    union of the events' intervals (kernels and copies on any stream)."""
    gaps, end = [], t0
    for s, e in sorted((ev.start, ev.end) for ev in events):
        if s > end and end < t1:
            gaps.append((end, min(s, t1)))
        end = max(end, e)
    if end < t1:
        gaps.append((end, t1))
    return gaps


def idle_by_innermost(spans, events, t0: float, t1: float
                      ) -> Dict[Optional[int], float]:
    """Idle seconds of the window [t0, t1] by the id of the innermost span
    open at each gap's middle (None: no span), spans and events on one
    clock, in seconds."""
    order = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    starts = [s.start_ns for s in order]
    out: Dict[Optional[int], float] = {}
    for a, b in idle_gaps(events, t0, t1):
        mid = 0.5 * (a + b)
        inner = None
        # The latest-started span that still holds ``mid`` is the
        # innermost one: the spans of one thread nest.
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s = order[k]
            if s.end_ns >= mid:
                inner = s.id
                break
            if s.parent is None:
                break
        out[inner] = out.get(inner, 0.0) + (b - a)
    return out


def idle_by_span(spans, events, t0: float, t1: float
                 ) -> Optional[Dict[str, float]]:
    """Idle seconds of the window [t0, t1] by the phase of the innermost
    span open at each gap's middle: the phases, ``other`` (another span)
    and ``none`` (no span).  None without spans."""
    if not spans:
        return None
    by_id = {s.id: s for s in spans}
    out = dict.fromkeys(PHASES + ("other", "none"), 0.0)
    for i, t in idle_by_innermost(spans, events, t0, t1).items():
        out["none" if i is None else _category(by_id[i], by_id)] += t
    return out


def idle_by_name(spans, events, t0: float, t1: float) -> Dict[str, float]:
    """Idle seconds of the window by the name of the innermost span."""
    names = {s.id: s.name for s in spans}
    out: Dict[str, float] = {}
    for i, t in idle_by_innermost(spans, events, t0, t1).items():
        name = names.get(i, "none")
        out[name] = out.get(name, 0.0) + t
    return out


def k1_clock_check(spans, events) -> Dict:
    """Each ``k1`` span against the ``range_fft_kernel`` it launched (in
    order): the lag of the kernel's start after the span's start (s)."""
    k1 = sorted(s.start_ns for s in spans if s.name == "k1")
    ffts = sorted(ev.start for ev in events
                  if ev.kind == "kernel" and ev.name.startswith(
                      "range_fft_kernel"))
    lags = [f - s for s, f in zip(k1, ffts)]
    first = min((s.start_ns for s in spans), default=None)
    return {"k1_spans": len(k1), "range_fft_kernels": len(ffts),
            "all_after": bool(lags) and len(k1) == len(ffts)
            and min(lags) > 0,
            "lag_s_min": min(lags, default=None),
            "lag_s_median": statistics.median(lags) if lags else None,
            "events_before_first_span": sum(
                1 for ev in events if first is not None
                and ev.start < first)}


def span_host_ms(spans, names, units: int) -> Dict[str, float]:
    """Host ms per unit of each span name in ``names`` (spans in s)."""
    return {name: sum(s.end_ns - s.start_ns for s in spans
                      if s.name == name) / units * 1e3 for name in names}


def counters() -> Dict[str, float]:
    """The program's launch counters: ``beamforming_spectrum``'s calls,
    chunks and products, the fused search's (``ops/beam.py:peak_taps``)
    launches and products, K1's launches and launches by branch, K4's and
    K5's launches and the order statistic's calls, chunks and samples."""
    from radar_slam_tpu_torch.aoa import estimators
    from radar_slam_tpu_torch.ops import beam, frontend, synthpower
    from radar_slam_tpu_torch.signal import detect
    bf, k1 = estimators.beamforming_spectrum, frontend.frontend_kernel_split
    out = {f"beamforming_spectrum.{k}": getattr(bf, k)
           for k in ("calls", "chunks", "products")}
    out.update({f"peak_taps.{k}": getattr(beam.peak_taps, k)
                for k in ("launches", "products")})
    out["k1.launches"] = k1.launches
    out.update({f"k1.branch_launches.{b}": n
                for b, n in k1.branch_launches.items()})
    out["k4.launches"] = synthpower.scatterer_power.launches
    out["k5.launches"] = synthpower.scatterer_signatures.launches
    out.update({f"os_noise.{k}": getattr(detect._os_noise, k)
                for k in ("calls", "chunks", "samples")})
    return out


def per_unit(after: Dict, before: Dict, units: int) -> Dict:
    """Counter increments per unit between two :func:`counters` readings."""
    return {k: (v - before[k]) / units for k, v in after.items()}


def launch_lags_s(prof) -> Optional[Dict[str, float]]:
    """From a CPU + CUDA profile: each kernel's start on the device less
    the start of its launch on the host (s), matched by correlation id."""
    events = prof.profiler.kineto_results.events()
    launch = {ev.correlation_id(): ev.start_ns() for ev in events
              if "Launch" in ev.name()
              and not str(ev.device_type()).endswith("CUDA")}
    lags = sorted((ev.start_ns() - launch[ev.correlation_id()]) * 1e-9
                  for ev in events
                  if str(ev.device_type()).endswith("CUDA")
                  and ev.correlation_id() in launch)
    if not lags:
        return None
    return {"n": len(lags), "min": lags[0],
            "median": statistics.median(lags)}


def span_cost_ns(blocks: int = 2000, per: int = 100) -> Dict[str, float]:
    """Host ns of one ``with span(...)``, off and on: blocks of ``per``
    spans, the recorder emptied between blocks as a pass empties it
    between units (untimed)."""
    out = {}
    for on in (False, True):
        total = 0
        for _ in range(blocks):
            (profiling.enable if on else profiling.disable)()
            t0 = time.perf_counter_ns()
            for _ in range(per):
                with profiling.span("cost"):
                    pass
            total += time.perf_counter_ns() - t0
            profiling.disable()
            profiling.collect()
        out["on" if on else "off"] = total / (blocks * per)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--window-s", type=float, default=0.0,
                    help="untraced units for this long, spans off and on "
                    "in turn: the on-cost, and a stream's stages a step")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch
    from torch.profiler import ProfilerActivity

    from portbench import registry
    from portbench import trace as tr
    from portbench.run import fixed_caches, guarded_step
    fixed_caches()
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("torch_span_pass: needs a CUDA device", file=sys.stderr)
        return 3
    cell = registry.Cell(args.workload, registry.load_benchmark())
    profiling.enable()
    drv = cell.driver.Driver(cell, args.seed, torch.device("cuda"))
    drv.warm()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    builds = [s for s in profiling.collect() if s.name == "build"]
    profiling.disable()

    n = args.units or int(cell.mix["trace_units"])
    state = {"i": 0, "failed": 0}
    window = {}

    def units(k):
        def fn():
            window["t0"] = time.time_ns()
            profiling.collect()        # a retried trace starts afresh
            window["counters0"] = counters()
            for _ in range(k):
                drv.prepare(state["i"])
                state["failed"] += guarded_step(drv, state["i"])
                state["i"] += 1
            torch.cuda.synchronize()
            window["counters1"] = counters()
            window["t1"] = time.time_ns()
        return fn

    def ab_window(seconds):
        """Units for ``seconds``, spans off and on in turn, each timed on
        the host clock around its step (as run.py's window times it):
        (:func:`window_ab` of them, the stream's rows)."""
        times, rows = {False: [], True: []}, []
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            on = len(times[False]) > len(times[True])
            drv.prepare(state["i"])
            if on:
                profiling.enable()
            ts = time.perf_counter()
            state["failed"] += guarded_step(drv, state["i"])
            times[on].append(time.perf_counter() - ts)
            profiling.disable()
            state["i"] += 1
            rows += step_rows(on_clock(profiling.collect(), 0))
        return (window_ab(times, rows) if times[True] else None), rows

    before, rows = ab_window(args.window_s)
    pads = tr.Pads()
    _, raw, wall_off = tr.device_trace(units(n),
                                       [ProfilerActivity.CUDA], pads)
    rec_off = tr.Traced(tr.device_events(raw), wall_off, n, 0, 0)
    profiling.enable()
    prof, raw, wall_on = tr.device_trace(units(n),
                                         [ProfilerActivity.CUDA], pads)
    profiling.disable()
    counted = per_unit(window["counters1"], window["counters0"], n)
    origin = prof.profiler.kineto_results.trace_start_ns()
    spans = on_clock(profiling.collect(), origin)
    rec_on = tr.Traced(tr.device_events(raw), wall_on, n, 0, 0)
    t0, t1 = [(window[k] - origin) * 1e-9 for k in ("t0", "t1")]
    prof_cpu, _, _ = tr.device_trace(
        units(1), [ProfilerActivity.CPU, ProfilerActivity.CUDA], pads)
    after, _ = ab_window(args.window_s)

    by_path = {p: step_host_ms(spans, p) for p in PATH_STAGES}
    stages = by_path["eager"]
    idle = idle_by_span(spans, rec_on.events, t0, t1)
    by_name = idle_by_name(spans, rec_on.events, t0, t1)
    names = {s.name.split(".")[0] for s in spans}
    metrics = {}
    if stages is not None:
        metrics.update({f"step_host_ms.{k}": stages[k] for k in STAGES})
    if by_path["replay"] is not None:
        metrics.update({f"replay_host_ms.{k}": by_path["replay"][k]
                        for k in PATH_STAGES["replay"]})
    if idle is not None:
        metrics.update({f"idle_share_by_span.{k}": idle[k] / wall_on
                        for k in PHASES if k in names})
    if builds:
        metrics["setup_build_s"] = sum(s.end_ns - s.start_ns
                                       for s in builds) * 1e-9
    result = {
        "workload": args.workload, "seed": args.seed, "units": n,
        "metrics": metrics,
        "step_ms_by_path": by_path,
        "steps_by_path": {p: sum(1 for s in spans if s.name == "step"
                                 and s.attrs.get("path", "eager") == p)
                          for p in PATH_STAGES},
        "window": before,
        "window_after_traces": after,
        "step_sum_off": {p: (sum(m[k] for k in PATH_STAGES[p])
                             + m["step_self"]) / m["step"] - 1
                         for p, m in by_path.items() if m is not None},
        "idle_s": idle,
        "idle_s_by_span": by_name,
        "idle_share_pass": tr.idle_share(rec_on),
        "idle_share_sum": (None if idle is None
                           else sum(idle.values()) / wall_on),
        "idle_share_cuda_only_pass": tr.idle_share(rec_off),
        "wall_per_unit_s": {"cuda_only": wall_off / n, "spans": wall_on / n},
        "window_s": {"host_wall": wall_on, "mapped": t1 - t0},
        "clock": k1_clock_check(spans, rec_on.events),
        "span_host_ms": span_host_ms(spans,
                                     AOA_SPANS + THREE_DISPATCH_SPANS, n),
        "aoa_grid_attrs": next((s.attrs for s in spans
                                if s.name == "aoa_grid"), None),
        "three_dispatch_attrs": {name: next((s.attrs for s in spans
                                             if s.name == name), None)
                                 for name in THREE_DISPATCH_SPANS},
        "counters_per_unit": counted,
        "launch_lag_s": launch_lags_s(prof_cpu),
        "builds": [{"name": s.attrs["name"], "compiled": s.attrs["compiled"],
                    "s": (s.end_ns - s.start_ns) * 1e-9} for s in builds],
        "setup_s": setup_s,
        "span_cost_ns": span_cost_ns(),
        "failed": state["failed"],
        "trace_retries": pads.retries,
        "device": torch.cuda.get_device_name(0),
    }
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(dict(result, window_rows_ms=rows)) + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
