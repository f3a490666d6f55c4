"""Profiling / timing utilities.

Counterpart of ``radar_slam_tpu/utils/profiling.py``:

- :func:`synchronize` -- wait for the CUDA device's queued work (nothing
  to wait for on a CPU run), so that a host clock read after it measures
  the work and not only its launches;
- :class:`StageTimer` -- named wall-clock sections with rolling statistics;
- :func:`trace` -- context manager around ``torch.profiler`` writing a
  Chrome trace (view in Perfetto or ``chrome://tracing``);
- :func:`benchmark` -- warm-up-then-measure helper.
"""

from __future__ import annotations

import collections
import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch


def synchronize(device=None) -> None:
    """Wait for the queued work of the CUDA ``device`` (the current one
    when None).  A CPU device, or a process that never initialized CUDA,
    has no queued device work: nothing to wait for."""
    if device is not None and torch.device(device).type != "cuda":
        return
    if torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


class StageTimer:
    def __init__(self, window: int = 200):
        self.window = window
        self._times: Dict[str, collections.deque] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = False):
        """Time the body; ``sync`` waits for the device work it queued
        before reading the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                synchronize()
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._times.setdefault(
            name, collections.deque(maxlen=self.window)).append(seconds)

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, dq in self._times.items():
            a = np.asarray(dq)
            out[name] = {
                "count": int(len(a)),
                "mean_s": float(a.mean()),
                "p50_s": float(np.percentile(a, 50)),
                "p95_s": float(np.percentile(a, 95)),
                "max_s": float(a.max()),
            }
        return out


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the body (CPU activity, and CUDA activity
    where a card is present); writes ``<logdir>/trace.json``, a Chrome
    trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            synchronize()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def benchmark(fn: Callable, *args, warmup: int = 1, reps: int = 5,
              name: Optional[str] = None) -> Dict[str, float]:
    """Warm up, then measure the steady-state wall time of ``fn(*args)``,
    the device's queued work included."""
    for _ in range(max(warmup, 1)):
        fn(*args)
    synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    synchronize()
    dt = (time.perf_counter() - t0) / reps
    return {"name": name or getattr(fn, "__name__", "fn"),
            "mean_s": dt, "reps": reps}
