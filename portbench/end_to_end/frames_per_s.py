"""``frames_per_s``: radar frames completed in the window (their outputs
on the host) over the window's seconds, the window from the first unit's
start to the last unit's end.  A rig frame counts one radar frame per
sensor."""


def read(win):
    return win["frames"] / (win["t1"] - win["t0"])
