"""``analyze --dataset --merged``: a RadarScenes drive processed frame by
frame as one merged point cloud through ``StreamingAnalyzer``.

The stream of ``drivers/stream.py`` (closed loop, one frame a step, a new
analyzer between episodes, untimed; the first ``check_steps`` steps of
the first episode compared) on the configuration's rig recording with its
sensors merged as the port's loader merges them
(``io/radarscenes.py:_host_frame(combine_sensors=True)``): each sensor's
returns, sensor by sensor, turned from sensor-frame polar into
vehicle-frame polar through the sensor's mount (x, y, yaw) in float32,
then padded to S_max.  The analyzer sees one radar at the vehicle's
origin.
"""

from __future__ import annotations

import numpy as np

from portbench.drivers import stream


def merged(cols, rig, max_scatterers: int):
    """Columns [F, S_max] of rig columns [F, B, S] merged in the vehicle
    frame: sensor 0's returns, then sensor 1's, ..."""
    F, B, S = cols["valid"].shape
    r = np.empty((F, B, S), np.float32)
    az = np.empty((F, B, S), np.float32)
    for b, (mx, my, myaw) in enumerate(rig):
        a = cols["azimuth_rad"][:, b] + np.float32(myaw)
        x = np.float32(mx) + cols["range_m"][:, b] * np.cos(a)
        y = np.float32(my) + cols["range_m"][:, b] * np.sin(a)
        r[:, b] = np.hypot(x, y)
        az[:, b] = np.arctan2(y, x)
    out = {"range_m": r, "azimuth_rad": az, "rcs_db": cols["rcs_db"],
           "vr": cols["vr"], "valid": cols["valid"]}
    order = np.argsort(~cols["valid"].reshape(F, B * S), axis=-1,
                       kind="stable")[:, :max_scatterers]
    return {k: np.take_along_axis(v.reshape(F, B * S), order, axis=-1)
            for k, v in out.items()}


class Driver(stream.Driver):
    def make_inputs(self, frames: int):
        cols, rig = super().make_inputs(frames)
        return [merged(c, rig, self.cfg.max_scatterers) for c in cols], None
