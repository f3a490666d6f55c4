"""RadarScenes dataset ingest: host-side HDF5 -> padded scatterer batches.

Counterpart of ``radar_slam_tpu/io/radarscenes.py`` (parity with the
reference's ``src/datasets/radarscenes_loader.py``, class
``RadarScenesLoader``): sequence loading, 100 ms frame windowing,
nearest-timestamp odometry lookup within 1 s, scatterer conversion,
per-sensor mounting from ``sensors.json``, dataset statistics.

Everything is built with numpy on the host.  ``host=True`` returns numpy
leaves for the prefetch ingest drivers (``io/prefetch.py``), which own the
transfer schedule; ``host=False`` uploads the stacked sequence once, through
``scatterer_batch_from_numpy``, to ``device`` (the card unless the caller
names another).  ``h5py`` is imported only by :meth:`RadarScenesLoader.
load_sequence_data`; the later stages take the dict it returns.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from radar_slam_tpu_torch.core.device import DEFAULT
from radar_slam_tpu_torch.core.types import (ScattererBatch,
                                             scatterer_batch_from_numpy)

SCATTERER_FIELDS = ("range_sc", "azimuth_sc", "rcs", "vr", "x_cc", "y_cc")


class RadarScenesLoader:
    """Loader for the RadarScenes dataset layout
    (``<root>/data/sensors.json``, ``<root>/data/sequence_*/radar_data.h5``).
    """

    def __init__(self, dataset_path: str):
        self.dataset_path = Path(dataset_path)
        self.sensors_info = self._load_json("data/sensors.json")
        self.sequence_info = self._load_json("data/sequences.json")

    def _load_json(self, rel: str) -> Dict:
        p = self.dataset_path / rel
        if p.exists():
            with open(p) as f:
                return json.load(f)
        return {}

    # ------------------------------------------------------------------
    # Sequence loading (radarscenes_loader.py:55-112)
    # ------------------------------------------------------------------

    def load_sequence_data(self, sequence_id: str) -> Dict:
        import h5py

        seq = self.dataset_path / "data" / sequence_id
        if not seq.exists():
            raise ValueError(f"Sequence {sequence_id} not found under "
                             f"{self.dataset_path}/data")
        with h5py.File(seq / "radar_data.h5", "r") as f:
            radar = {k: np.asarray(f["radar_data"][k])
                     for k in f["radar_data"].dtype.names}
            odometry = {k: np.asarray(f["odometry"][k])
                        for k in f["odometry"].dtype.names}
        scenes = {}
        scenes_file = seq / "scenes.json"
        if scenes_file.exists():
            with open(scenes_file) as f:
                scenes = json.load(f)
        # Sort odometry by timestamp once; lookups are searchsorted.
        order = np.argsort(odometry["timestamp"])
        odometry = {k: v[order] for k, v in odometry.items()}
        return {
            "sequence_id": sequence_id,
            "radar_data": radar,
            "odometry_data": odometry,
            "scenes_data": scenes,
            "sensors_info": self.sensors_info,
            "metadata": {
                "first_timestamp": scenes.get("first_timestamp"),
                "last_timestamp": scenes.get("last_timestamp"),
                "category": scenes.get("category", "unknown"),
            },
        }

    # ------------------------------------------------------------------
    # Frame windowing (radarscenes_loader.py:139-192)
    # ------------------------------------------------------------------

    def extract_radar_frames(self, sequence_data: Dict,
                             frame_duration_ms: float = 100.0) -> List[Dict]:
        radar = sequence_data["radar_data"]
        ts = radar["timestamp"]
        order = np.argsort(ts, kind="stable")
        ts_sorted = ts[order]
        start, end = int(ts_sorted[0]), int(ts_sorted[-1])
        width = int(frame_duration_ms * 1000)          # us

        edges = np.arange(start, end + width, width, dtype=np.int64)
        lo = np.searchsorted(ts_sorted, edges[:-1], side="left")
        hi = np.searchsorted(ts_sorted, edges[1:], side="left")

        frames = []
        frame_id = 0
        for k in range(len(lo)):
            if hi[k] <= lo[k]:
                continue       # reference skips empty windows (:171)
            sel = order[lo[k]:hi[k]]
            sensor_ids = radar["sensor_id"][sel]
            groups = {int(sid): sel[sensor_ids == sid]
                      for sid in np.unique(sensor_ids)}
            frames.append({
                "frame_id": frame_id,
                "timestamp": int(edges[k]),
                "frame_end_time": int(edges[k + 1]),
                "sensor_indices": groups,     # row indices into radar arrays
                "total_measurements": int(len(sel)),
                "sensors": sorted(groups.keys()),
            })
            frame_id += 1
        return frames

    # ------------------------------------------------------------------
    # Odometry lookup (radarscenes_loader.py:194-224)
    # ------------------------------------------------------------------

    def get_odometry_at_time(self, sequence_data: Dict,
                             timestamp: int,
                             max_gap_us: int = 1_000_000) -> Optional[Dict]:
        odo = sequence_data["odometry_data"]
        ts = odo["timestamp"]
        i = int(np.searchsorted(ts, timestamp))
        cands = [j for j in (i - 1, i) if 0 <= j < len(ts)]
        if not cands:
            return None
        j = min(cands, key=lambda j: abs(int(ts[j]) - int(timestamp)))
        if abs(int(ts[j]) - int(timestamp)) >= max_gap_us:
            return None
        return {
            "timestamp": int(ts[j]),
            "x": float(odo["x_seq"][j]),
            "y": float(odo["y_seq"][j]),
            "yaw": float(odo["yaw_seq"][j]),
            "vx": float(odo["vx"][j]),
            "yaw_rate": float(odo["yaw_rate"][j]),
        }

    # ------------------------------------------------------------------
    # Scatterer conversion (radarscenes_loader.py:226-254)
    # ------------------------------------------------------------------

    def sensor_mount(self, sensor_id: int) -> Optional[Dict]:
        """Mounting pose {x, y, yaw} for a sensor from sensors.json, if any."""
        try:
            for s in self.sensors_info.get("sensors", []):
                if int(s.get("id", -1)) == sensor_id:
                    return {"x": float(s.get("x", 0.0)),
                            "y": float(s.get("y", 0.0)),
                            "yaw": float(s.get("yaw", 0.0))}
        except (TypeError, ValueError):
            pass
        return None

    def convert_radar_to_scatterers(self, sequence_data: Dict, frame: Dict,
                                    sensor_id: int,
                                    apply_mounting: bool = True
                                    ) -> Dict[str, np.ndarray]:
        radar = sequence_data["radar_data"]
        sel = frame["sensor_indices"].get(sensor_id)
        if sel is None or len(sel) == 0:
            return {k: np.zeros(0, np.float32) for k in SCATTERER_FIELDS}
        out = {k: radar[k][sel].astype(np.float32) for k in SCATTERER_FIELDS}
        if apply_mounting:
            m = self.sensor_mount(sensor_id)
            if m is not None and (m["x"] or m["y"] or m["yaw"]):
                # Sensor-frame polar -> vehicle-frame polar.
                az = out["azimuth_sc"] + m["yaw"]
                x = m["x"] + out["range_sc"] * np.cos(az)
                y = m["y"] + out["range_sc"] * np.sin(az)
                out["range_sc"] = np.hypot(x, y).astype(np.float32)
                out["azimuth_sc"] = np.arctan2(y, x).astype(np.float32)
        return out

    def _host_frame(self, sequence_data: Dict, frame: Dict,
                    max_scatterers: int,
                    combine_sensors: bool = True) -> Dict[str, np.ndarray]:
        """One frame's scatterers (all sensors merged, in the vehicle
        frame) as padded numpy columns [S] keyed by ``ScattererBatch``
        field."""
        cols = {k: [] for k in SCATTERER_FIELDS}
        for sid in frame["sensors"]:
            sc = self.convert_radar_to_scatterers(sequence_data, frame, sid)
            for k in SCATTERER_FIELDS:
                cols[k].append(sc[k])
            if not combine_sensors:
                break
        cat = {k: (np.concatenate(v) if v else np.zeros(0, np.float32))
               for k, v in cols.items()}
        n = len(cat["range_sc"])

        def p(x):
            x = x[:max_scatterers]
            return np.pad(x, (0, max(max_scatterers - len(x), 0)))

        valid = np.zeros(max_scatterers, bool)
        valid[:min(n, max_scatterers)] = True
        return {"range_m": p(cat["range_sc"]),
                "azimuth_rad": p(cat["azimuth_sc"]),
                "rcs_db": p(cat["rcs"]), "vr": p(cat["vr"]),
                "valid": valid}

    def _host_frame_rig(self, sequence_data: Dict, frame: Dict, sensor_ids,
                        max_scatterers: int) -> Dict[str, np.ndarray]:
        """One frame's scatterers per sensor, sensor-frame polar (no
        mounting transform: the rig pipeline owns the geometry), as padded
        numpy columns [B, S]."""
        cols = {k: [] for k in SCATTERER_FIELDS}
        valid = []
        for sid in sensor_ids:
            sc = self.convert_radar_to_scatterers(sequence_data, frame, sid,
                                                  apply_mounting=False)
            n = len(sc["range_sc"])

            def p(x):
                x = np.asarray(x, np.float32)[:max_scatterers]
                return np.pad(x, (0, max(max_scatterers - len(x), 0)))

            for k in SCATTERER_FIELDS:
                cols[k].append(p(sc[k]))
            valid.append(np.arange(max_scatterers) < min(n, max_scatterers))
        return {"range_m": np.stack(cols["range_sc"]),
                "azimuth_rad": np.stack(cols["azimuth_sc"]),
                "rcs_db": np.stack(cols["rcs"]),
                "vr": np.stack(cols["vr"]), "valid": np.stack(valid)}

    @staticmethod
    def _batch(per_frame: List[Dict[str, np.ndarray]], host: bool,
               device) -> ScattererBatch:
        """Frames stacked on the host: numpy leaves (``host=True``), or one
        upload to ``device``."""
        stack = {k: np.stack([f[k] for f in per_frame])
                 for k in per_frame[0]}
        if host:
            return ScattererBatch(**stack)
        return scatterer_batch_from_numpy(stack, device)

    def frame_scatterer_batch(self, sequence_data: Dict, frame: Dict,
                              max_scatterers: int,
                              combine_sensors: bool = True,
                              host: bool = False,
                              device=DEFAULT) -> ScattererBatch:
        """One frame's scatterers (all sensors merged) as a padded batch
        [1, S] (the port's one-frame layout).  ``host=True`` keeps the
        leaves numpy (no device upload)."""
        return self._batch([self._host_frame(sequence_data, frame,
                                             max_scatterers,
                                             combine_sensors)],
                           host, device)

    def frames_as_batches(self, sequence_data: Dict, frames: List[Dict],
                          max_scatterers: int, host: bool = False,
                          device=DEFAULT):
        """Stacked padded batches [F, S] + ground truth arrays.

        Returns (ScattererBatch [F, S], gt dict with poses [F, 3],
        velocities [F, 2] (vx, yaw_rate), timestamps_s [F], valid [F]).
        ``host=True`` -> numpy leaves for the prefetch ingest drivers."""
        per_frame = [self._host_frame(sequence_data, f, max_scatterers)
                     for f in frames]
        _, gt_arrays = self._ground_truth_arrays(frames, sequence_data)
        return self._batch(per_frame, host, device), gt_arrays

    # ------------------------------------------------------------------
    # Per-sensor rig batches (mounted-radar geometry; pipeline/rig.py)
    # ------------------------------------------------------------------

    def sequence_rig(self, sequence_data: Dict):
        """Static rig tuple ((x, y, yaw), ...) for the sequence's sensors.

        Sensor order = sorted sensor ids present in the data; unknown mounts
        default to the vehicle origin (colocated)."""
        ids = sorted(int(s) for s in
                     np.unique(sequence_data["radar_data"]["sensor_id"]))
        rig = []
        for sid in ids:
            m = self.sensor_mount(sid)
            rig.append((m["x"], m["y"], m["yaw"]) if m else (0.0, 0.0, 0.0))
        return tuple(ids), tuple(rig)

    def frame_scatterer_batch_rig(self, sequence_data: Dict, frame: Dict,
                                  sensor_ids, max_scatterers: int,
                                  host: bool = False,
                                  device=DEFAULT) -> ScattererBatch:
        """One frame's scatterers per sensor [B, S], sensor-frame polar.
        ``host=True`` -> numpy leaves (prefetch ingest)."""
        cols = self._host_frame_rig(sequence_data, frame, sensor_ids,
                                    max_scatterers)
        if host:
            return ScattererBatch(**cols)
        return scatterer_batch_from_numpy(cols, device)

    def frames_as_batches_rig(self, sequence_data: Dict, frames: List[Dict],
                              max_scatterers: int, host: bool = False,
                              device=DEFAULT):
        """Stacked per-sensor batches [F, B, S] + rig + ground truth.

        Returns (ScattererBatch [F, B, S], rig tuple, gt dict as in
        :meth:`frames_as_batches`); ``host=True`` -> numpy leaves for the
        prefetch ingest drivers."""
        sensor_ids, rig = self.sequence_rig(sequence_data)
        per_frame = [self._host_frame_rig(sequence_data, f, sensor_ids,
                                          max_scatterers) for f in frames]
        _, gt_arrays = self._ground_truth_arrays(frames, sequence_data)
        return self._batch(per_frame, host, device), rig, gt_arrays

    def _ground_truth_arrays(self, frames, sequence_data):
        t0 = frames[0]["timestamp"]
        ts, poses, vels, ok = [], [], [], []
        for f in frames:
            ts.append((f["timestamp"] - t0) * 1e-6)
            gt = self.get_odometry_at_time(sequence_data, f["timestamp"])
            if gt is None:
                poses.append([0.0, 0.0, 0.0]); vels.append([0.0, 0.0])
                ok.append(False)
            else:
                poses.append([gt["x"], gt["y"], gt["yaw"]])
                vels.append([gt["vx"], gt["yaw_rate"]])
                ok.append(True)
        return None, {
            "poses": np.asarray(poses, np.float64),
            "velocities": np.asarray(vels, np.float64),
            "timestamps_s": np.asarray(ts, np.float64),
            "valid": np.asarray(ok, bool),
        }

    # ------------------------------------------------------------------
    # Statistics (radarscenes_loader.py:324-395, analyze_radarscenes_dataset)
    # ------------------------------------------------------------------

    def analyze_sequence_quality(self, sequence_data: Dict) -> Dict:
        """Sequence data-quality analysis (radarscenes_loader.py:324-395):
        measurement/odometry rates, range/azimuth/velocity/yaw-rate stats,
        total distance and average speed."""
        radar = sequence_data["radar_data"]
        odo = sequence_data["odometry_data"]
        meta = sequence_data.get("metadata", {})
        first = meta.get("first_timestamp")
        last = meta.get("last_timestamp")
        if first is not None and last is not None:
            duration_s = (last - first) / 1e6
        else:
            ts = radar["timestamp"]
            duration_s = (int(ts.max()) - int(ts.min())) / 1e6 if len(ts) else 0.0

        def stats(x):
            x = np.asarray(x, np.float64)
            return {"min": float(x.min()), "max": float(x.max()),
                    "mean": float(x.mean()), "std": float(x.std())} \
                if len(x) else {}

        analysis = {
            "sequence_id": sequence_data["sequence_id"],
            "duration_seconds": duration_s,
            "radar_measurements": int(len(radar["timestamp"])),
            "odometry_records": int(len(odo["timestamp"])),
            "sensors_used": sorted(int(s) for s in
                                   np.unique(radar["sensor_id"])),
            "measurement_rate": (len(radar["timestamp"]) / duration_s
                                 if duration_s else 0.0),
            "odometry_rate": (len(odo["timestamp"]) / duration_s
                              if duration_s else 0.0),
            "range_stats": stats(radar["range_sc"]),
            "azimuth_stats": stats(radar["azimuth_sc"]),
            "velocity_stats": stats(odo["vx"]),
            "yaw_rate_stats": stats(odo["yaw_rate"]),
        }
        if len(odo["timestamp"]) > 1:
            d = np.hypot(np.diff(odo["x_seq"]), np.diff(odo["y_seq"]))
            analysis["total_distance"] = float(d.sum())
            analysis["average_speed"] = (float(d.sum()) / duration_s
                                         if duration_s else 0.0)
        return analysis

    def sequence_statistics(self, sequence_data: Dict) -> Dict:
        radar = sequence_data["radar_data"]
        r = radar["range_sc"]
        return {
            "num_measurements": int(len(r)),
            "range_min": float(np.min(r)) if len(r) else 0.0,
            "range_max": float(np.max(r)) if len(r) else 0.0,
            "range_mean": float(np.mean(r)) if len(r) else 0.0,
            "rcs_mean": float(np.mean(radar["rcs"])) if len(r) else 0.0,
            "vr_abs_mean": float(np.mean(np.abs(radar["vr"]))) if len(r) else 0.0,
            "num_sensors": int(len(np.unique(radar["sensor_id"]))),
            "odometry_records": int(len(sequence_data["odometry_data"]["timestamp"])),
        }


def load_radarscenes_sequence(dataset_path: str, sequence_id: str,
                              frame_duration_ms: float = 100.0):
    """Convenience entry (radarscenes_loader.py:397-410)."""
    loader = RadarScenesLoader(dataset_path)
    data = loader.load_sequence_data(sequence_id)
    frames = loader.extract_radar_frames(data, frame_duration_ms)
    return loader, data, frames


def dataset_available(dataset_path: str) -> bool:
    return (Path(dataset_path) / "data").exists()
