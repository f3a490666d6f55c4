"""``launches_per_step``: device kernels per traced step (the eager host
launch path of one streaming step)."""


def read(rec):
    n = sum(1 for e in rec.events if e.kind == "kernel")
    return n / rec.units if rec.units and n else None
