"""Profiler traces of the timed path, and what the metric readers read.

``device_trace``, ``interval_busy_s`` and ``kernel_name`` are frozen copies
of ``chip_smoke.py:device_trace``, ``interval_busy_ms`` and ``kernel_name``
at commit d8c8661 (``interval_busy_ms`` returns seconds here, and the pad
state lives in a :class:`Pads` object): on an H100 the profiler can lose
the first device records of a trace, so the traced work sits between two
spin kernels after a host sleep, and the trace is taken again with a
longer sleep until both spin kernels are in it.

The CUDA-only trace is what the metrics read (a trace of CPU activity
inflates the host wall); a CPU + CUDA trace of a few more units gives the
breakdown: the device operations that took most time, and the longest
idle gaps of the device named by what the host was doing then.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

PADS_S = (0.02, 0.5, 2.0, 5.0, 10.0)


@dataclass
class DeviceEvent:
    name: str          # the kernel's short name, or "Memcpy HtoD ..."
    start: float       # s, profiler clock
    end: float
    kind: str          # "kernel", "h2d", "d2h", "copy" or "memset"
    full: str = ""     # the profiler's name: the demangled signature


@dataclass
class Traced:
    """One CUDA-only trace of ``units`` units of the timed path."""
    events: List[DeviceEvent]
    window_s: float    # host wall: the first unit to the card's sync
    units: int         # calls or steps traced
    frames: int        # radar frames completed in them
    k1_frames: int     # frames through the front-end kernel
    info: Dict = field(default_factory=dict)   # what the readers need


@dataclass
class Pads:
    index: int = 0
    retries: List[Dict] = field(default_factory=list)


def kernel_name(full: str) -> str:
    """A kernel's short name: its function name and template arguments,
    without the return type, namespaces and parameter list."""
    name = re.sub(r"\(anonymous namespace\)::|^void |at::native::", "", full)
    depth, end = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            end = i
            break
    return name[:end][:80]


def parameter_types(full: str) -> List[str]:
    """The parameter types of a demangled kernel signature, without
    namespaces of the anonymous kind, qualifiers or spaces
    (``"float const* __restrict__"`` reads ``"float*"``); empty where the
    name has no parameter list."""
    name = full.replace("(anonymous namespace)::", "")
    depth, start = 0, None
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            start = i
            break
    if start is None or not name.endswith(")"):
        return []
    params, depth, cur = [], 0, ""
    for ch in name[start + 1:-1]:
        depth += ch in "<("
        depth -= ch in ">)"
        if ch == "," and depth == 0:
            params.append(cur)
            cur = ""
        else:
            cur += ch
    params.append(cur)
    return [re.sub(r"\b(const|volatile|__restrict__)\b|\s", "", p)
            for p in params if p.strip()]


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        if "htod" in low:
            return "h2d"
        if "dtoh" in low:
            return "d2h"
        return "copy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def device_trace(fn: Callable[[], None], activities, pads: Pads):
    """The profile of one traced call of ``fn`` between two spin kernels,
    its device events and its host wall time (s, ``fn`` to the card's
    synchronization).  Raises if the longest pad still loses a spin
    kernel."""
    from torch.profiler import profile
    while pads.index < len(PADS_S):
        pad = PADS_S[pads.index]
        with profile(activities=activities) as prof:
            time.sleep(pad)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PADS_S[0])
        events = [ev for ev in prof.events()
                  if str(ev.device_type).endswith("CUDA")]
        spins = [ev.time_range.start for ev in events
                 if "spin_kernel" in ev.name]
        body = [ev for ev in events if "spin_kernel" not in ev.name]
        if len(spins) == 2:
            return prof, body, wall
        first = min((ev.time_range.start for ev in body), default=0)
        pads.retries.append(dict(
            pad_s=pad, kernels=len(body),
            lead_spin=any(t <= first for t in spins),
            trail_spin=any(t > first for t in spins)))
        pads.index += 1
    raise RuntimeError(f"the profiler lost a bracketing kernel at every "
                       f"pad {PADS_S}")


def device_events(raw) -> List[DeviceEvent]:
    return [DeviceEvent(kernel_name(ev.name), ev.time_range.start * 1e-6,
                        ev.time_range.end * 1e-6, _kind(ev.name), ev.name)
            for ev in raw]


def interval_busy_s(events: List[DeviceEvent]) -> float:
    """Device busy time: the union of the events' intervals (kernels and
    copies on any stream)."""
    spans = sorted((ev.start, ev.end) for ev in events)
    busy, end = 0.0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_share(rec: Traced) -> float:
    """1 - the union of the device intervals over the traced host wall."""
    return max(0.0, 1.0 - interval_busy_s(rec.events) / rec.window_s)


def breakdown(prof, top: int = 10) -> Dict[str, List[Tuple[str, float]]]:
    """From a CPU + CUDA trace: the ``top`` device operations by total time
    (s), and the ``top`` longest gaps between device activity, each named
    by the innermost host operation running at its middle."""
    dev, cpu = [], []
    for ev in prof.events():
        span = (ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
        if str(ev.device_type).endswith("CUDA"):
            if "spin_kernel" not in ev.name:
                dev.append((kernel_name(ev.name), *span))
        elif ev.time_range.end > ev.time_range.start:
            cpu.append((ev.name, *span))
    per: Dict[str, float] = {}
    for name, s, e in dev:
        per[name] = per.get(name, 0.0) + (e - s)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    end = None
    for name, s, e in sorted(dev, key=lambda x: x[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        over = [c for c in cpu if c[1] <= mid <= c[2]]
        host = max(over, key=lambda c: c[1])[0] if over else "host idle"
        named.append([host, e - s])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}
