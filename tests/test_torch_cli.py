"""The port's CLI (``pipeline/cli.py``, ``python -m radar_slam_tpu_torch``)
and RadarScenes loader (``io/radarscenes.py``) on miniature RadarScenes-
layout recordings written here (the h5py fixtures of
tests/test_cli_dataset.py:12-112, copied, at 6 and 12 frames).

- Loader parity: the port's loader against the reference's on the same
  files: the frames list, the merged and the rig batches bit for bit, the
  rig tuple, the ground-truth arrays, the odometry lookup and the
  statistics.
- CLI runs on the CPU (``--device cpu``): ``analyze --dataset`` (the rig by
  default for off-origin mounts), ``--merged``, ``--rig``,
  ``--checkpoint-dir`` / ``--resume`` and ``quick-compare``, each held to
  the reference test's bounds and keys (test_cli_dataset.py:116-220).  The
  CLI's noise is Philox where the reference's is threefry, so numeric
  parity lives in the sigma-0 module tests (test_torch_streaming.py).
- Errors: an unknown subcommand is argparse's.  The other subcommands
  have their own files: ``analyze --slam`` tests/test_torch_slam_cli.py;
  ``analyze-data``, ``evaluate``, ``visualize`` and ``analyze --out``'s
  figure tests/test_torch_viz.py; ``bench`` tests/test_torch_bench.py.
"""

import json

import numpy as np
import pytest

from radar_slam_tpu.io.radarscenes import RadarScenesLoader as JLoader
from radar_slam_tpu_torch.io.radarscenes import (RadarScenesLoader,
                                                 dataset_available,
                                                 load_radarscenes_sequence)
from radar_slam_tpu_torch.pipeline.cli import main as cli_main

RADAR_DTYPE = [("timestamp", "i8"), ("sensor_id", "u1"), ("range_sc", "f4"),
               ("azimuth_sc", "f4"), ("rcs", "f4"), ("vr", "f4"),
               ("x_cc", "f4"), ("y_cc", "f4")]
ODO_DTYPE = [("timestamp", "i8"), ("x_seq", "f8"), ("y_seq", "f8"),
             ("yaw_seq", "f8"), ("vx", "f8"), ("yaw_rate", "f8")]


@pytest.fixture()
def mini_dataset(tmp_path):
    """tests/test_cli_dataset.py:12-42: 6 frames x ~40 targets of two
    mounted sensors; static world, ego at rest."""
    h5py = pytest.importorskip("h5py")
    root = tmp_path / "rs"
    (root / "data" / "sequence_9").mkdir(parents=True)
    rng = np.random.default_rng(3)
    n_frames, per = 6, 40
    rows = []
    for f in range(n_frames):
        t0 = f * 100_000
        for _ in range(per):
            rows.append((t0 + int(rng.integers(0, 90_000)),
                         int(rng.integers(1, 3)),
                         rng.uniform(5, 50), rng.uniform(-0.8, 0.8),
                         rng.uniform(5, 20), 0.0, 0.0, 0.0))
    radar = np.array(rows, dtype=RADAR_DTYPE)
    odo = np.zeros(10, dtype=ODO_DTYPE)
    odo["timestamp"] = np.linspace(0, 600_000, 10).astype(np.int64)
    with h5py.File(root / "data" / "sequence_9" / "radar_data.h5", "w") as f:
        f.create_dataset("radar_data", data=radar)
        f.create_dataset("odometry", data=odo)
    (root / "data" / "sensors.json").write_text(json.dumps({"sensors": [
        {"id": 1, "x": 1.8, "y": 0.9, "yaw": 0.35},
        {"id": 2, "x": 1.8, "y": -0.9, "yaw": -0.35}]}))
    return root


@pytest.fixture()
def mini_dataset_moving(tmp_path):
    """tests/test_cli_dataset.py:45-113: four mounted sensors, ~70 returns
    per sensor and frame, a moving ego (5 m/s), 12 frames of world-
    consistent returns."""
    h5py = pytest.importorskip("h5py")
    root = tmp_path / "rs_mv"
    (root / "data" / "sequence_77").mkdir(parents=True)
    rng = np.random.default_rng(11)
    mounts = [(3.6, 0.8, 0.44), (3.6, -0.8, -0.44),
              (3.3, 0.9, 1.48), (3.3, -0.9, -1.48)]
    n_frames, v_ego = 12, 5.0
    dt_frame = 0.1
    n_world = 900
    wx = rng.uniform(-40, v_ego * n_frames * dt_frame + 70, n_world)
    wy = np.concatenate([rng.uniform(3, 9, n_world // 2),
                         rng.uniform(-9, -3, n_world - n_world // 2)])
    rcs = rng.uniform(0, 25, n_world)
    rows = []
    per_sensor_counts = []
    for f in range(n_frames):
        t0 = f * 100_000
        ex = v_ego * f * dt_frame
        for sid, (mx, my, myaw) in enumerate(mounts, start=1):
            dx, dy = wx - (ex + mx), wy - my
            r_v = np.hypot(dx, dy)
            az_v = np.arctan2(dy, dx)
            az_s = az_v - myaw
            az_s = np.arctan2(np.sin(az_s), np.cos(az_s))
            vr = -np.cos(az_v) * v_ego
            keep = (np.abs(az_s) < 0.9) & (r_v > 1.5) & (r_v < 60.0)
            idx = np.nonzero(keep)[0]
            idx = rng.permutation(idx)[:70]
            per_sensor_counts.append(len(idx))
            for i in idx:
                rows.append((t0 + int(rng.integers(0, 90_000)), sid,
                             r_v[i], az_s[i], rcs[i], vr[i],
                             wx[i], wy[i]))
    assert min(per_sensor_counts) >= 25
    radar = np.array(rows, dtype=RADAR_DTYPE)
    n_odo = n_frames + 2
    odo = np.zeros(n_odo, dtype=ODO_DTYPE)
    ts = np.arange(n_odo) * 100_000
    odo["timestamp"] = ts
    odo["x_seq"] = v_ego * ts * 1e-6
    odo["vx"] = v_ego
    with h5py.File(root / "data" / "sequence_77" / "radar_data.h5",
                   "w") as f:
        f.create_dataset("radar_data", data=radar)
        f.create_dataset("odometry", data=odo)
    (root / "data" / "sensors.json").write_text(json.dumps({"sensors": [
        {"id": i + 1, "x": m[0], "y": m[1], "yaw": m[2]}
        for i, m in enumerate(mounts)]}))
    return root


def _json(out):
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


# ---- the loader --------------------------------------------------------------

@pytest.mark.parametrize("fixture,seq", [("mini_dataset", "sequence_9"),
                                         ("mini_dataset_moving",
                                          "sequence_77")])
def test_loader_matches_reference(fixture, seq, request):
    root = str(request.getfixturevalue(fixture))
    ref, port = JLoader(root), RadarScenesLoader(root)
    jdata, data = ref.load_sequence_data(seq), port.load_sequence_data(seq)
    jframes = ref.extract_radar_frames(jdata, 100.0)
    frames = port.extract_radar_frames(data, 100.0)
    assert len(frames) == len(jframes) > 0
    for f, g in zip(frames, jframes):
        assert f.keys() == g.keys()
        for k in f:
            if k == "sensor_indices":
                assert f[k].keys() == g[k].keys()
                for sid in f[k]:
                    np.testing.assert_array_equal(f[k][sid], g[k][sid])
            else:
                assert f[k] == g[k], k
    # Merged batches [F, S]: numpy and device forms, bit for bit.
    want, jgt = ref.frames_as_batches(jdata, jframes, 128, host=True)
    got, gt = port.frames_as_batches(data, frames, 128, host=True)
    dev, _ = port.frames_as_batches(data, frames, 128, device="cpu")
    for name in ("range_m", "azimuth_rad", "rcs_db", "vr", "valid"):
        assert isinstance(getattr(got, name), np.ndarray)
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)
        np.testing.assert_array_equal(getattr(dev, name).numpy(),
                                      getattr(want, name), name)
    assert got.elevation_rad is None and dev.elevation_rad is None
    for k in jgt:
        np.testing.assert_array_equal(gt[k], jgt[k], k)
    # Per-sensor batches [F, B, S], the rig tuple.
    want, jrig, jgt = ref.frames_as_batches_rig(jdata, jframes, 64,
                                                host=True)
    got, rig, gt = port.frames_as_batches_rig(data, frames, 64, host=True)
    assert rig == jrig
    for name in ("range_m", "azimuth_rad", "rcs_db", "vr", "valid"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)
    for k in jgt:
        np.testing.assert_array_equal(gt[k], jgt[k], k)
    # Odometry lookup and statistics.
    for t in (frames[0]["timestamp"], frames[-1]["timestamp"] + 50_000,
              10 ** 9):
        assert (port.get_odometry_at_time(data, t)
                == ref.get_odometry_at_time(jdata, t))
    assert (port.analyze_sequence_quality(data)
            == ref.analyze_sequence_quality(jdata))
    assert port.sequence_statistics(data) == ref.sequence_statistics(jdata)


def test_loader_one_frame_and_helpers(mini_dataset):
    loader, data, frames = load_radarscenes_sequence(str(mini_dataset),
                                                     "sequence_9")
    assert dataset_available(str(mini_dataset))
    assert not dataset_available(str(mini_dataset / "nothing"))
    one = loader.frame_scatterer_batch(data, frames[0], 64, host=True)
    many, _ = loader.frames_as_batches(data, frames[:1], 64, host=True)
    np.testing.assert_array_equal(one.range_m, many.range_m)
    ids, rig = loader.sequence_rig(data)
    per = loader.frame_scatterer_batch_rig(data, frames[0], ids, 64,
                                           device="cpu")
    assert tuple(per.range_m.shape) == (2, 64)
    # Sensor-frame azimuths: the raw measurements, no mounting rotation.
    assert float(per.azimuth_rad.abs().max()) <= 0.8 + 1e-6
    with pytest.raises(ValueError):
        loader.load_sequence_data("sequence_404")


# ---- the CLI -----------------------------------------------------------------

def test_cli_analyze_dataset_defaults_to_rig(mini_dataset, capsys):
    """sensors.json declares off-origin mounts, so the rig path is taken
    without --rig (test_cli_dataset.py:182-194)."""
    rc = cli_main(["analyze", "--dataset", str(mini_dataset),
                   "--seq", "sequence_9", "--max-frames", "6",
                   "--device", "cpu"])
    assert rc == 0
    m = _json(capsys.readouterr().out)
    assert m["rig"] == [[1.8, 0.9, 0.35], [1.8, -0.9, -0.35]]
    assert m["frames"] == 6
    assert m["position_rmse"] < 0.5
    assert set(m) == {"rig", "frames", "position_rmse", "yaw_rmse",
                      "mean_associations", "mean_yaw_rate"}


def test_cli_analyze_dataset_merged(mini_dataset, tmp_path, capsys):
    """--merged forces the merged-sensor streaming path
    (test_cli_dataset.py:197-206); --out writes analysis_results.json and
    the overview figure complete_analysis.png (cli.py:217-221)."""
    out_dir = tmp_path / "out"
    rc = cli_main(["analyze", "--merged", "--dataset", str(mini_dataset),
                   "--seq", "sequence_9", "--max-frames", "6",
                   "--out", str(out_dir), "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    m = _json(out)
    assert m["frames_processed"] == 6
    assert m["position_rmse"] < 0.5
    assert json.loads((out_dir / "analysis_results.json").read_text()) == m
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "analysis_results.json", "complete_analysis.png"]


def test_cli_analyze_dataset_rig(mini_dataset, capsys):
    """test_cli_dataset.py:209-219."""
    rc = cli_main(["analyze", "--rig", "--dataset", str(mini_dataset),
                   "--seq", "sequence_9", "--max-frames", "6",
                   "--device", "cpu"])
    assert rc == 0
    m = _json(capsys.readouterr().out)
    assert m["frames"] == 6
    assert m["rig"] == [[1.8, 0.9, 0.35], [1.8, -0.9, -0.35]]
    assert m["position_rmse"] < 0.5


def test_cli_rig_moving_ego_recovers_motion(mini_dataset_moving, capsys):
    """The four-sensor rig chosen from sensors.json tracks the moving ego
    (test_cli_dataset.py:116-130)."""
    rc = cli_main(["analyze", "--dataset", str(mini_dataset_moving),
                   "--seq", "sequence_77", "--max-frames", "12",
                   "--device", "cpu"])
    assert rc == 0
    m = _json(capsys.readouterr().out)
    assert m["frames"] == 12
    assert len(m["rig"]) == 4
    assert m["position_rmse"] < 0.6, m
    assert abs(m["mean_yaw_rate"]) < 0.15, m


def test_cli_checkpoint_and_resume(mini_dataset_moving, tmp_path, capsys):
    """--checkpoint-dir writes the streaming state every 4 frames; a second
    invocation with --resume continues from it and reports the full count
    (test_cli_dataset.py:133-161, without --slam)."""
    ck = tmp_path / "ck"
    args = ["analyze", "--merged", "--dataset", str(mini_dataset_moving),
            "--seq", "sequence_77", "--max-frames", "12",
            "--checkpoint-dir", str(ck), "--checkpoint-every", "4",
            "--device", "cpu"]
    assert cli_main(args) == 0
    m = _json(capsys.readouterr().out)
    assert m["frames_processed"] == 12
    assert m["position_rmse"] < 0.8, m
    assert sorted(p.name for p in ck.glob("state_*.npz")) == [
        "state_000004.npz", "state_000008.npz", "state_000012.npz"]
    for p in ck.glob("*_000012.*"):
        p.unlink()
    assert cli_main(args + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at frame 8" in out
    m2 = _json(out)
    assert m2["frames_processed"] == 12
    np.testing.assert_allclose(m2["position_rmse"], m["position_rmse"],
                               rtol=0, atol=1e-9)


def test_cli_analyze_synthetic_and_quick_compare(capsys):
    """The synthetic ``analyze`` (streaming) and ``analyze --rig`` (two-
    sensor rig), and ``quick-compare --frames 4``: the reference's keys,
    PARITY: PASS, exit 0."""
    assert cli_main(["analyze", "--max-frames", "4", "--device", "cpu"]) == 0
    m = _json(capsys.readouterr().out)
    assert m["frames_processed"] == 4
    assert m["position_rmse"] < 0.777
    assert cli_main(["analyze", "--rig", "--max-frames", "4",
                     "--device", "cpu"]) == 0
    m = _json(capsys.readouterr().out)
    assert m["frames"] == 4 and len(m["rig"]) == 2
    assert cli_main(["quick-compare", "--frames", "4",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    r = _json(out)
    assert set(r) == {"frames", "position_rmse_m", "yaw_rmse_rad",
                      "velocity_rmse_mps", "processing_time_s",
                      "compile_time_s", "reference_bounds"}
    assert r["frames"] == 4 and r["position_rmse_m"] <= 0.777
    assert out.strip().splitlines()[-1] == "PARITY: PASS"


def test_cli_unknown_subcommand_is_an_argparse_error(capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["frobnicate"])
    assert e.value.code == 2
