"""``h2d_exposed_share``: the share of host-to-device copy time in the
traced window that no kernel overlaps (the prefetch uploader's copies left
on the critical path)."""


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def read(rec):
    copies = _union([(e.start, e.end) for e in rec.events if e.kind == "h2d"])
    total = sum(e - s for s, e in copies)
    if total <= 0:
        return None
    kernels = _union([(e.start, e.end) for e in rec.events
                      if e.kind == "kernel"])
    covered = 0.0
    for s, e in copies:
        for ks, ke in kernels:
            lo, hi = max(s, ks), min(e, ke)
            if hi > lo:
                covered += hi - lo
    return (total - covered) / total
