"""The port's six-step artifact pipeline (``pipeline/pipeline.py``,
``io/artifacts.py``) and its subcommands against the JAX reference.

One module-scoped reference run: 6 frames of the bench scene (64 points,
128 scatterers) at ``complete_analysis_config()`` with 16 chirps and MUSIC,
with artifacts.  The port resumes from its ``raw_sim`` frames (the same
noisy cubes), and each stage is compared:

- RDS: relative error 1e-6 of max |rds| (two FFTs of one cube);
- detections: equal sets;
- targets: equal masks, azimuths 1e-6 rad and confidences 1e-6 on the
  valid targets, signatures 1e-6;
- motions: 1e-5 m/s and rad/s, equal success; trajectory 1e-5 m;
- step 4 fed the reference's targets (velocities 1e-5, phase residual
  statistics 1e-3 relative), and step 5 fed its motions (1e-6), each on
  its own;
- step 1 at noise 0 against the reference under ``jax.disable_jit()``
  (the port follows the eager rounding) at 1e-6 of the maximum.

Then the artifacts: each package's loaders read the other's files (same
keys, dtypes and shapes), ``pipeline_config.json`` byte for byte; the
``fft_mode="pallas"`` route (K8's wrapper) against the ``"fft"`` route; and
the ``simulate`` -> ``process`` -> ``pipeline`` subcommands on the CPU.
"""

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np

from radar_slam_tpu.io import artifacts as jart
from radar_slam_tpu.pipeline.pipeline import EgoMotionPipeline as JaxPipeline
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.core.types import (Detections, MotionEstimate,
                                             Targets,
                                             scatterer_batch_from_numpy)
from radar_slam_tpu_torch.io import artifacts as tart
from radar_slam_tpu_torch.ops import rds as rds_op
from radar_slam_tpu_torch.pipeline.cli import main as cli_main
from radar_slam_tpu_torch.pipeline.pipeline import EgoMotionPipeline

F = 6


def small_config(noise_power=None):
    cfg = bench_config(noise_power)
    return dataclasses.replace(
        cfg, radar=dataclasses.replace(cfg.radar, num_chirps=16),
        aoa=dataclasses.replace(cfg.aoa, method="music"))


def ground_truth(gt):
    """Velocities [F, 6] and poses [F, 7] (xyz + wxyz) of the scene."""
    p = np.asarray(gt["poses"])
    vel = np.zeros((F, 6))
    vel[:, :2] = np.asarray(gt["velocity_body"])[:2]
    vel[:, 5] = float(gt["yaw_rate"])
    z = np.zeros(F)
    poses7 = np.column_stack([p[:, 0], p[:, 1], z, np.cos(p[:, 2] / 2), z, z,
                              np.sin(p[:, 2] / 2)])
    return vel, poses7


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's six steps with artifacts; its in-memory stages."""
    cfg = small_config()
    jbatch, fields, gt = scene_fields(F, num_points=64)
    gt_vel, gt7 = ground_truth(gt)
    root = tmp_path_factory.mktemp("jax_run")
    pipe = JaxPipeline(cfg, root)
    res = pipe.run_complete_pipeline(jbatch, gt_velocities=gt_vel,
                                     gt_poses7=gt7)
    return dict(cfg=cfg, pipe=pipe, res=res, root=root, fields=fields,
                gt_vel=gt_vel, gt7=gt7)


@pytest.fixture(scope="module")
def port_run(reference_run, tmp_path_factory):
    """The port's pipeline resumed from the reference's raw frames: steps 2-6
    with artifacts."""
    root = tmp_path_factory.mktemp("torch_run")
    shutil.copytree(reference_run["root"] / "raw_sim", root / "raw_sim")
    cfg = config_from_dict(dataclasses.asdict(reference_run["cfg"]))
    pipe = EgoMotionPipeline(cfg, root, device="cpu")
    pipe.step2_process_signals()
    pipe.step3_extract_angles()
    pipe.step4_estimate_velocity()
    pipe.step5_integrate_pose()
    evals = pipe.step6_evaluate(reference_run["gt_vel"],
                                reference_run["gt7"])
    return dict(cfg=cfg, pipe=pipe, root=root, evals=evals)


def rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def detection_sets(det):
    rb, db, v = (np.asarray(to_np(x)) for x in (det.range_bin,
                                                 det.doppler_bin, det.valid))
    return [{(int(r), int(d)) for r, d, ok in zip(rb[f], db[f], v[f]) if ok}
            for f in range(rb.shape[0])]


def test_stages_match_reference(reference_run, port_run):
    jp, tp = reference_run["pipe"], port_run["pipe"]
    assert tp._signals.shape == (F, 8, 16, 400)
    np.testing.assert_array_equal(to_np(tp._signals), np.asarray(jp._signals))
    assert rel(to_np(tp._rds), np.asarray(jp._rds)) < 1e-6
    sets = detection_sets(tp._detections)
    assert sets == detection_sets(jp._detections)
    assert all(len(s) > 5 for s in sets)

    tt, jt = tp._targets, jp._targets
    valid = np.asarray(jt.valid)
    np.testing.assert_array_equal(to_np(tt.valid), valid)
    np.testing.assert_array_equal(to_np(tt.is_reliable),
                                  np.asarray(jt.is_reliable))
    assert valid.sum() > 5 * F
    for field in ("azimuth_rad", "confidence"):
        np.testing.assert_allclose(to_np(getattr(tt, field))[valid],
                                   np.asarray(getattr(jt, field))[valid],
                                   rtol=0, atol=1e-6, err_msg=field)
    np.testing.assert_allclose(to_np(tt.spatial_signature)[valid],
                               np.asarray(jt.spatial_signature)[valid],
                               rtol=0, atol=1e-6)

    tm, jm = tp._motions, jp._motions
    np.testing.assert_array_equal(to_np(tm.success), np.asarray(jm.success))
    assert to_np(tm.success)[1:].all()
    for field in ("velocity", "angular_velocity"):
        np.testing.assert_allclose(to_np(getattr(tm, field)),
                                   np.asarray(getattr(jm, field)),
                                   rtol=0, atol=1e-5, err_msg=field)
    for field in tp._trajectory._fields:
        np.testing.assert_allclose(
            to_np(getattr(tp._trajectory, field)),
            np.asarray(getattr(jp._trajectory, field)), rtol=0, atol=1e-5,
            err_msg=field)

    ev, jev = port_run["evals"], reference_run["res"]["evaluation"]
    assert ev.keys() == jev.keys() == {"velocity", "ape", "rte"}
    for key in ("position_rmse", "orientation_rmse", "pose_rmse"):
        assert ev["ape"][key] == pytest.approx(jev["ape"][key], abs=1e-5)
    assert (ev["velocity"]["overall_metrics"]["rmse"] == pytest.approx(
        jev["velocity"]["overall_metrics"]["rmse"], abs=1e-5))
    assert set(tp.step_times) == {f"step{i}" for i in range(2, 7)}


def test_step4_and_step5_fed_reference_inputs(reference_run, port_run,
                                              tmp_path):
    """Step 4 on the reference's targets and step 5 on its motions, each
    alone: the association, the 6-DoF solve and the pose integration."""
    jp = reference_run["pipe"]
    pipe = EgoMotionPipeline(port_run["cfg"], tmp_path, save_artifacts=False,
                             device="cpu")
    pipe._targets = Targets(*(None if x is None else torch.from_numpy(
        np.array(x)) for x in jp._targets))
    m = pipe.step4_estimate_velocity()
    jm = jp._motions
    for field in ("num_targets", "success"):
        np.testing.assert_array_equal(to_np(getattr(m, field)),
                                      np.asarray(getattr(jm, field)))
    for field in ("velocity", "angular_velocity"):
        np.testing.assert_allclose(to_np(getattr(m, field)),
                                   np.asarray(getattr(jm, field)),
                                   rtol=0, atol=1e-5, err_msg=field)
    # The phase residuals move by 4 pi dt / lambda (~320 rad) per m/s of
    # velocity and ~320 r rad per rad/s of angular velocity at range r, so
    # float32-level differences of the solution move them by ~1e-4
    # relative: 1e-3.
    for field in ("rmse", "max_residual", "cost"):
        np.testing.assert_allclose(to_np(getattr(m, field)),
                                   np.asarray(getattr(jm, field)),
                                   rtol=1e-3, atol=0, err_msg=field)
    pipe._motions = MotionEstimate(*(torch.from_numpy(np.array(x))
                                     for x in jm))
    traj = pipe.step5_integrate_pose()
    for field in traj._fields:
        np.testing.assert_allclose(to_np(getattr(traj, field)),
                                   np.asarray(getattr(jp._trajectory, field)),
                                   rtol=0, atol=1e-6, err_msg=field)
    ts = np.arange(F) * 0.25
    traj = pipe.step5_integrate_pose(timestamps=ts)
    np.testing.assert_array_equal(to_np(traj.timestamps),
                                  ts.astype(np.float32))


def test_step1_noiseless_matches_reference(tmp_path):
    cfg = small_config(noise_power=0.0)
    jbatch, fields, _ = scene_fields(2, num_points=64)
    with jax.disable_jit():
        want = np.asarray(JaxPipeline(cfg, tmp_path / "j",
                                      save_artifacts=False)
                          .step1_synthesize(jbatch))
    pipe = EgoMotionPipeline(config_from_dict(dataclasses.asdict(cfg)),
                             tmp_path / "t", device="cpu")
    got = to_np(pipe.step1_synthesize(
        scatterer_batch_from_numpy(fields, "cpu"), seed=3))
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert rel(got, want) < 1e-6
    meta = json.loads((tmp_path / "t" / "raw_sim" /
                       "synthesis_metadata.json").read_text())
    assert meta["processing_stats"] == {
        "total_frames": 2, "processed_frames": 2,
        "valid_scatterers": int(fields["valid"].sum())}
    np.testing.assert_array_equal(
        tart.load_raw_frame(tmp_path / "t" / "raw_sim", 1), got[1])


ARTIFACTS = [("rds", "load_rds_frame"), ("angles", "load_angles_frame"),
             ("velocities", "load_velocity_frame"), ("raw_sim",
                                                     "load_raw_frame")]


def same_layout(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            same_layout(x, y)
        return
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            same_layout(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("stage,loader", ARTIFACTS)
def test_each_package_reads_the_others_artifacts(reference_run, port_run,
                                                 stage, loader):
    jroot, troot = reference_run["root"], port_run["root"]
    for i in (0, F - 1):
        t_reads_j = getattr(tart, loader)(jroot / stage, i)
        j_reads_t = getattr(jart, loader)(troot / stage, i)
        same_layout(t_reads_j, getattr(jart, loader)(jroot / stage, i))
        same_layout(j_reads_t, getattr(tart, loader)(troot / stage, i))
        same_layout(t_reads_j, j_reads_t)


def test_trajectory_config_and_reports_interoperate(reference_run, port_run):
    jroot, troot = reference_run["root"], port_run["root"]
    tj = tart.load_trajectory(jroot / "poses")
    jt = jart.load_trajectory(troot / "poses")
    same_layout(tj, jt)
    assert list(jt) == ["timestamps", "positions", "orientations",
                        "rotations", "quaternions", "velocities",
                        "angular_velocities"]
    np.testing.assert_allclose(jt["positions"], tj["positions"], atol=1e-5)
    jtxt = (jroot / "poses" / "trajectory.txt").read_text().splitlines()
    ttxt = (troot / "poses" / "trajectory.txt").read_text().splitlines()
    assert len(jtxt) == len(ttxt) == F + 1 and jtxt[0] == ttxt[0]
    np.testing.assert_allclose(np.loadtxt(ttxt[1:]), np.loadtxt(jtxt[1:]),
                               atol=2e-6)
    assert ((troot / "pipeline_config.json").read_bytes()
            == (jroot / "pipeline_config.json").read_bytes())
    for name in ("velocity_report.md", "pose_report.md", "summary.json"):
        assert (troot / "evaluation" / name).exists(), name
    js = json.loads((jroot / "evaluation" / "summary.json").read_text())
    ts = json.loads((troot / "evaluation" / "summary.json").read_text())
    assert js.keys() == ts.keys() == {"ape", "rte"}
    assert js["ape"].keys() == ts["ape"].keys()


def test_per_frame_savers_take_tensors(tmp_path, port_run):
    """A saver given one frame's tensors writes what it writes from their
    numpy (the pipeline passes numpy slices of one host copy)."""
    tp = port_run["pipe"]
    det = Detections(*(x[2] for x in tp._detections))
    tart.save_rds_frame(tmp_path, 2, tp._rds[2], det)
    tart.save_angles_frame(tmp_path, 2, Targets(*(
        None if x is None else x[2] for x in tp._targets)))
    tart.save_velocity_frame(tmp_path, 2, MotionEstimate(*(
        x[2] for x in tp._motions)))
    root = port_run["root"]
    for stage, loader in ARTIFACTS[:3]:
        a = getattr(tart, loader)(tmp_path, 2)
        b = getattr(tart, loader)(root / stage, 2)
        same_layout(a, b)
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            a, b = a[1], b[1]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_pallas_route_runs_k8_wrapper(reference_run, port_run, tmp_path,
                                      monkeypatch):
    """``fft_mode="pallas"`` runs K8's wrapper once over the [F, ...] batch
    (here its plain version, the tensors being on the CPU).  K8's own
    arithmetic (``rds_fused_factored_reference``: the exact DFT, as the
    kernel computes it) is within 1e-5 of max |rds| of the FFT route; the
    CPU plain version keeps the reference's float32 range constant, 2e-5
    from an exact transform (the tolerance tests/test_torch_cube.py holds
    that form to), and the detection sets stay equal."""
    calls = []
    real = rds_op.rds_fused

    def counting(signals, *args, **kw):
        calls.append(signals.shape)
        return real(signals, *args, **kw)

    monkeypatch.setattr(rds_op, "rds_fused", counting)
    tp = port_run["pipe"]
    cfg = dataclasses.replace(port_run["cfg"], fft_mode="pallas")
    pipe = EgoMotionPipeline(cfg, tmp_path, save_artifacts=False,
                             device="cpu")
    rds, det = pipe.step2_process_signals(tp._signals)
    assert calls == [tp._signals.shape]
    fft = to_np(tp._rds)
    assert rel(to_np(rds), fft) < 2e-5
    assert detection_sets(det) == detection_sets(tp._detections)
    from radar_slam_tpu_torch.signal.rds import _mix_vector
    mix = _mix_vector(cfg.radar, cfg.window, "baseband", 400, device="cpu")
    exact = rds_op.rds_fused_factored_reference(tp._signals, mix, True,
                                                cfg.doppler_window)
    assert rel(to_np(exact), fft) < 1e-5


def test_subcommands_simulate_process_pipeline(tmp_path, capsys):
    """``simulate`` -> ``process`` -> ``pipeline`` on the CPU: exit codes,
    the artifact tree, ``process``'s RDS equal to step 2's on the same
    frames, and exit 2 for a directory without frames."""
    raw, rds_dir, run = tmp_path / "raw", tmp_path / "rds", tmp_path / "run"
    assert cli_main(["simulate", "--out", str(raw), "--max-frames", "3",
                     "--num-chirps", "16", "--device", "cpu"]) == 0
    assert "wrote 3 frames" in capsys.readouterr().out
    assert sorted(p.name for p in raw.iterdir()) == [
        "frame_0000.npy", "frame_0001.npy", "frame_0002.npy",
        "synthesis_metadata.json"]
    assert cli_main(["process", "--raw", str(raw), "--out", str(rds_dir),
                     "--num-chirps", "16", "--device", "cpu"]) == 0
    assert "processed 3 frames" in capsys.readouterr().out
    rds2, peaks2 = tart.load_rds_frame(rds_dir, 2)
    assert rds2.shape == (8, 400, 16) and rds2.dtype == np.complex64
    # Step 2 of the pipeline on the same raw frames: the same RDS.
    from radar_slam_tpu_torch.core.config import complete_analysis_config
    cfg = dataclasses.replace(complete_analysis_config(), radar=(
        dataclasses.replace(complete_analysis_config().radar,
                            num_chirps=16)))
    pipe = EgoMotionPipeline(cfg, tmp_path / "p", device="cpu")
    shutil.copytree(raw, tmp_path / "p" / "raw_sim", dirs_exist_ok=True)
    rds, det = pipe.step2_process_signals()
    np.testing.assert_array_equal(to_np(rds)[2], rds2)
    np.testing.assert_array_equal(to_np(det.range_bin)[2],
                                  peaks2["range_bin"])
    # Chirp subset: the RDS of chirps 0-7.
    assert cli_main(["process", "--raw", str(raw), "--out",
                     str(tmp_path / "sub"), "--num-chirps", "16",
                     "--chirp-start", "0", "--chirp-end", "8",
                     "--device", "cpu"]) == 0
    assert tart.load_rds_frame(tmp_path / "sub", 0)[0].shape == (8, 400, 8)
    (tmp_path / "empty").mkdir()
    assert cli_main(["process", "--raw", str(tmp_path / "empty"), "--out",
                     str(tmp_path / "x"), "--device", "cpu"]) == 2
    capsys.readouterr()

    assert cli_main(["pipeline", "--out", str(run), "--max-frames", "3",
                     "--num-chirps", "16", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out["step_times"]) == {f"step{i}" for i in range(1, 7)}
    cfg = json.loads((run / "pipeline_config.json").read_text())
    assert cfg["aoa"]["method"] == "music" and cfg["max_scatterers"] == 512
    for f in ("raw_sim/frame_0002.npy", "rds/frame_0002_rds.npy",
              "rds/frame_0002_peaks.npz", "angles/frame_0002_angles.npz",
              "velocities/frame_0002_velocity.npz", "poses/trajectory.npz",
              "poses/trajectory.txt", "evaluation/velocity_report.md"):
        assert (run / f).exists(), f
    v = tart.load_velocity_frame(run / "velocities", 2)
    assert bool(v["success"]) and abs(float(v["velocity"][0]) - 8.0) < 0.3
