#!/usr/bin/env python3
"""How many device kernels a torch.profiler trace loses on this card, with
and without ``chip_smoke.py``'s bracketing (``device_trace``).

    python3 scripts/torch_trace_window.py [--traces N] [--long-traces M]

Two calls are traced: ``short`` (four small PyTorch kernels, about 20 us
of device work; N traces each way) and ``long`` (3,000 small kernels,
about the launch count of one call of a batched driver; M traces each
way).  The ways, in this order:

- ``short_plain``: ``profile(activities=[CUDA])`` around the call and a
  synchronization, as ``kernel_profile`` traced before the bracketing,
  before any trace of CPU activity;
- ``long_plain``: CPU and CUDA activity around the call, as
  ``phase_profile`` traced before the bracketing;
- ``short_plain_after_cpu``: as ``short_plain``, after those;
- ``short_bracketed``, ``long_bracketed``: ``chip_smoke.device_trace``
  (two spin kernels and host sleeps around the call, retried with a
  longer sleep until both spin kernels are in it), with its retries.

For each: the traces, those that kept every kernel, and the kernels lost
in all.  One JSON line and then the card's name and power limit.  Needs a
CUDA device.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=200)
    ap.add_argument("--long-traces", type=int, default=20)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("torch_trace_window: no CUDA device", file=sys.stderr)
        return 2
    x = torch.empty(4096, device="cuda")

    def short():
        x.fill_(1.0)
        y = x * 2.0
        y.add_(x)
        return y.sum()

    def long():
        for _ in range(1000):
            y = x * 2.0
            y.add_(x)
            x.copy_(y)

    count = {short: 4, long: 3000}
    cuda = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def plain(fn, acts):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(str(ev.device_type).endswith("CUDA")
                   for ev in prof.events())

    def tally(fn, kept):
        return dict(traces=len(kept),
                    complete=sum(k == count[fn] for k in kept),
                    kernels_lost=sum(count[fn] - k for k in kept))

    def bracketed(fn, acts, n):
        del cs.TRACE_RETRIES[:]
        out = tally(fn, [len(cs.device_trace(torch, fn, acts)[0])
                         for _ in range(n)])
        out["retries"] = list(cs.TRACE_RETRIES)
        return out

    short()
    long()
    torch.cuda.synchronize()
    n, m = args.traces, args.long_traces
    out = {"short_plain": tally(short, [plain(short, cuda)
                                        for _ in range(n)]),
           "long_plain": tally(long, [plain(long, both) for _ in range(m)]),
           "short_plain_after_cpu": tally(short, [plain(short, cuda)
                                                  for _ in range(n)]),
           "short_bracketed": bracketed(short, cuda, n),
           "long_bracketed": bracketed(long, both, m),
           "torch": torch.__version__}
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
