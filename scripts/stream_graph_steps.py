#!/usr/bin/env python3
"""The streaming analyzer's step by path on a CUDA card, and the host's
waits for the device inside a step and a batched call.

    python3 scripts/stream_graph_steps.py [--frames N] [--analyzers N] \
        [--seed N] [--syncs-only] [--out FILE]

At the benchmark's operating point (``complete_analysis_config`` at
S_max 128, the constant-motion scene), with K1 built by a first analyzer:

- ``episodes``: ``--analyzers`` fresh analyzers over ``--frames`` frames
  each, the host time (ms, ``perf_counter`` around ``process_frame``) of
  the eager step, of the capture and of the replays (median, max), and
  ``step_paths``;
- ``eager_only_ms_median``: an analyzer held eager over the same frames
  (its first step left out);
- ``graph_device_ms``: one replay of the last analyzer's graph on the
  device, from CUDA events around 200 back-to-back replays;
  ``replay_call_host_ms_median``: the host time of one ``replay()`` call,
  the device idle before each;
- ``stream_cell_episodes``: the ``stream.bench_s128`` cell's driver
  (``portbench/drivers/stream.py``) over two episodes from ``--seed``, each
  episode's analyzer's ``step_paths``;
- ``syncs``: the host's waits for the device
  (``torch.cuda.set_sync_debug_mode("warn")``) in one
  ``process_sequence_batched`` call of 512 frames and in one eager
  ``process_scatterers`` step, by the program line that caused them (the
  second call of each; the first fills the caches).

``--syncs-only`` measures ``syncs`` alone (a tree without the analyzer's
graph has no ``step_paths``).  One JSON line, also appended to ``--out``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import sys
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def host_syncs(torch, fn):
    """The host's waits for the device in the second call of ``fn``, by
    ``file:line`` relative to the repository."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return dict(collections.Counter(
        f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in got))


def timed_steps(an, batch, frames):
    """Host ms of each ``process_frame`` of ``an`` over ``frames`` frames."""
    from radar_slam_tpu_torch.pipeline import frame as fr
    out = []
    for i in range(frames):
        t0 = time.perf_counter()
        an.process_frame(fr._frame(batch, i, i + 1))
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def graph_times(torch, graph, n=200):
    """(device ms of one replay from CUDA events over ``n`` back-to-back
    replays, median host ms of one ``replay()`` call)."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    for _ in range(n):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    host = []
    for _ in range(n):
        t0 = time.perf_counter()
        graph.replay()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n, statistics.median(host)


def stream_cell_paths(torch, seed):
    """The stream cell's driver over two episodes: each episode's
    ``step_paths``."""
    from portbench import registry
    cell = registry.Cell("stream.bench_s128", registry.load_benchmark())
    drv = cell.driver.Driver(cell, seed, torch.device("cuda"))
    drv.warm()
    out = []
    for i in range(2 * drv.L):
        drv.prepare(i)
        drv.step(i)
        if (i + 1) % drv.L == 0:
            out.append(dict(drv.analyzer.step_paths))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--analyzers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=2147491201)
    ap.add_argument("--syncs-only", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch

    from portbench.run import fixed_caches
    from radar_slam_tpu_torch.core import config
    from radar_slam_tpu_torch.io.synthetic import (SceneConfig,
                                                   constant_motion_scene)
    from radar_slam_tpu_torch.pipeline import frame as fr
    from radar_slam_tpu_torch.pipeline.streaming import StreamingAnalyzer
    fixed_caches()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(config.complete_analysis_config(),
                              max_scatterers=128)

    def scene(seed, frames):
        return constant_motion_scene(
            seed, frames, cfg.frame_dt, (8.0, 0.5), 0.05,
            SceneConfig(num_points=96, max_scatterers=128), device=dev)[0]

    out = {"device": torch.cuda.get_device_name(0)}
    batch = scene(0, 512)
    state = fr.init_state(cfg, device=dev)
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    out["syncs"] = {
        "batched_call": host_syncs(torch, lambda: fr.process_sequence_batched(
            batch, torch.Generator().manual_seed(0), cfg)),
        "eager_step": host_syncs(torch, lambda: fr.process_scatterers(
            state, fr._frame(batch, 0, 1), seed, cfg))}
    if not args.syncs_only:
        batch = scene(5, args.frames)
        timed_steps(StreamingAnalyzer(cfg, device=dev), batch, args.frames)
        out["episodes"] = []
        for _ in range(args.analyzers):
            an = StreamingAnalyzer(cfg, device=dev)
            ts = timed_steps(an, batch, args.frames)
            out["episodes"].append({
                "eager_ms": ts[0], "capture_ms": ts[1],
                "replay_ms_median": statistics.median(ts[2:]),
                "replay_ms_max": max(ts[2:]), "paths": an.step_paths})
        eager = StreamingAnalyzer(cfg, device=dev)
        eager._eager_only = True
        out["eager_only_ms_median"] = statistics.median(
            timed_steps(eager, batch, args.frames)[1:])
        graph = next(iter(an._graphs.values()))[0]
        out["graph_device_ms"], out["replay_call_host_ms_median"] = \
            graph_times(torch, graph)
        out["stream_cell_episodes"] = stream_cell_paths(torch, args.seed)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
