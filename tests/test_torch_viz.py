"""The port's visualization and analysis (``radar_slam_tpu_torch/viz/
{analyze,plots}.py``, ``evaluate/plots.py``) and the ``analyze-data``,
``visualize``, ``evaluate`` and ``analyze --out`` subcommands, against the
JAX package's on the CPU.

- ``viz/analyze.py``: every function bit for bit the reference's on the
  same arrays (numpy and tensors);
- each plot function: its PNG, read back with ``matplotlib.image.imread``,
  equal as an image array to the reference's on the same inputs;
- on one run directory written by the port's ``pipeline --max-frames 4``:
  ``analyze-data`` (one frame, ``--compare``, ``--insights``, two runs) the
  same JSON and files as the reference's; ``visualize`` the reference's
  figures, equal as images; ``evaluate`` the reference's file names, and
  its printed metrics within float32 of the reference's;
- ``analyze --out`` writes the reference's ``analysis_results.json`` and
  ``complete_analysis.png``; without matplotlib it and ``visualize`` fail
  at their start, before any work.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from radar_slam_tpu.core.config import complete_analysis_config as jcfg
from radar_slam_tpu.evaluate import plots as jeplots
from radar_slam_tpu.pipeline.cli import main as jmain
from radar_slam_tpu.viz import analyze as jan
from radar_slam_tpu.viz import plots as jplots
from radar_slam_tpu_torch.core.config import complete_analysis_config as tcfg
from radar_slam_tpu_torch.evaluate import plots as teplots
from radar_slam_tpu_torch.pipeline.cli import main as tmain
from radar_slam_tpu_torch.viz import analyze as tan
from radar_slam_tpu_torch.viz import plots as tplots

REPO = Path(__file__).resolve().parents[1]


def peaks(seed, n=24):
    rng = np.random.default_rng(seed)
    return {"range_m": rng.uniform(1, 80, n).astype(np.float32),
            "doppler_hz": rng.normal(0, 300, n).astype(np.float32),
            "vr_mps": rng.normal(0, 3, n).astype(np.float32),
            "power_db": rng.normal(-20, 6, n).astype(np.float32),
            "valid": rng.uniform(size=n) > 0.3}


def tensors(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def files(d):
    return sorted(p.name for p in Path(d).iterdir())


def same_images(a, b):
    for name in files(a):
        if name.endswith(".png"):
            np.testing.assert_array_equal(mpimg.imread(Path(a) / name),
                                          mpimg.imread(Path(b) / name),
                                          err_msg=name)


def test_analyze_functions_bit_for_bit():
    frames = [peaks(s) for s in range(5)]
    rds = (np.random.default_rng(9).standard_normal((8, 64, 32))
           + 1j * np.random.default_rng(10).standard_normal((8, 64, 32))
           ).astype(np.complex64)
    for got_frames, got_rds in ((frames, rds),
                                ([tensors(f) for f in frames],
                                 torch.from_numpy(rds))):
        assert tan.analyze_detections(got_frames[0]) == \
            jan.analyze_detections(frames[0])
        assert tan.analyze_rds_quality(got_rds, antenna=3) == \
            jan.analyze_rds_quality(rds, antenna=3)
        assert tan.compare_frames(got_frames) == jan.compare_frames(frames)
        assert tan.analyze_sequence_detections(got_frames) == \
            jan.analyze_sequence_detections(frames)
        ins = tan.insights_report(got_frames)
        assert ins == jan.insights_report(frames)
        assert tan.insights_markdown(ins) == jan.insights_markdown(ins)
        ds = tan.analyze_dataset({"a": got_frames, "b": got_frames[:2]})
        assert ds == jan.analyze_dataset({"a": frames, "b": frames[:2]})
        assert tan.insights_markdown(ds) == jan.insights_markdown(ds)
    empty = dict(peaks(0), valid=np.zeros(24, bool))
    assert tan.analyze_detections(empty) == jan.analyze_detections(empty)


def _plot_inputs():
    rng = np.random.default_rng(3)
    sig = (rng.standard_normal((8, 4, 64))
           + 1j * rng.standard_normal((8, 4, 64))).astype(np.complex64)
    rds = (rng.standard_normal((8, 40, 32))
           + 1j * rng.standard_normal((8, 40, 32))).astype(np.complex64)
    F = 40
    t = np.arange(F, dtype=np.float32) * 0.05
    pos = np.stack([8 * t, 0.5 * t, 0 * t], -1).astype(np.float32)
    orient = np.stack([0 * t, 0 * t, 0.05 * t], -1).astype(np.float32)
    vel = (np.tile([8, 0.5, 0, 0, 0, 0.05], (F, 1))
           + rng.normal(0, 0.1, (F, 6))).astype(np.float32)
    gt_vel = np.tile([8, 0.5, 0, 0, 0, 0.05], (F, 1)).astype(np.float32)
    results = {"estimated_trajectory": list(pos + 0.1),
               "ground_truth_trajectory": list(pos),
               "velocity_estimates": list(vel),
               "num_targets": list(range(F)),
               "processing_times": list(0.01 + 0.001 * t)}
    ape = {"position_errors": np.abs(rng.normal(0, 0.2, F)),
           "orientation_errors": np.abs(rng.normal(0, 0.02, F)),
           "position_rmse": 0.2, "orientation_rmse": 0.02}
    rte = {f"seg_{s}m": {"rmse": 0.1 * s, "mean": 0.08 * s,
                         "std": 0.01 * s} for s in (10.0, 20.0, 5.0)}
    grid = np.linspace(-60, 60, 121).astype(np.float32)
    spectra = np.abs(rng.normal(1, 0.3, (5, 121))).astype(np.float32)
    return dict(sig=sig, rds=rds, det=peaks(4), t=t, pos=pos, orient=orient,
                vel=vel, gt_vel=gt_vel, results=results, ape=ape, rte=rte,
                grid=grid, spectra=spectra,
                angles=np.array([-30, -10, 0, 12, 40], np.float32))


def _plots(mod, emod, cfg, x, T):
    """(file name, call) per plot function; ``T`` wraps array inputs
    (tensors for the port)."""
    return {
        "raw_signals": lambda p: mod.plot_raw_signals(T(x["sig"]), p,
                                                      antenna=2, chirp=1),
        "rds": lambda p: mod.plot_rds(T(x["rds"]), cfg.radar, p,
                                      detections=x["det"]),
        "angle_spectrum": lambda p: mod.plot_angle_spectrum(
            x["grid"], x["spectra"], x["angles"], p),
        "trajectory": lambda p: mod.plot_trajectory(
            T(x["pos"]), p, gt_positions=T(x["pos"] * 1.01),
            orientations=T(x["orient"])),
        "velocity_profile": lambda p: mod.plot_velocity_profile(
            T(x["t"]), T(x["vel"]), p, gt_velocities=x["gt_vel"]),
        "overview": lambda p: mod.comprehensive_overview(x["results"], p),
        "velocity_errors": lambda p: emod.plot_velocity_errors(
            T(x["vel"]), T(x["gt_vel"]), p),
        "pose_errors": lambda p: emod.plot_pose_errors(
            x["ape"], p, est_positions=T(x["pos"]),
            gt_positions=x["pos"] * 1.01),
        "rte": lambda p: emod.plot_rte(x["rte"], p),
    }


PLOTS = list(_plots(tplots, teplots, None, {}, None))


@pytest.mark.parametrize("name", PLOTS)
def test_plot_png_equals_reference(name, tmp_path):
    x = _plot_inputs()
    want = _plots(jplots, jeplots, jcfg(), x, lambda a: a)[name](
        tmp_path / "want.png")
    got = _plots(tplots, teplots, tcfg(), x, torch.from_numpy)[name](
        tmp_path / "got.png")
    assert got == tmp_path / "got.png" and want == tmp_path / "want.png"
    np.testing.assert_array_equal(mpimg.imread(got), mpimg.imread(want))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A 4-frame run of the port's six-step pipeline, with ground truth
    for ``evaluate``."""
    d = tmp_path_factory.mktemp("viz") / "run"
    rc, _ = run(tmain, ["pipeline", "--out", str(d), "--max-frames", "4",
                        "--device", "cpu"])
    assert rc == 0
    traj = np.load(d / "poses" / "trajectory.npz")
    n = len(traj["positions"])
    gt_v = np.tile([8.0, 0.5, 0.0, 0.0, 0.0, 0.05], (4, 1))
    np.save(d.parent / "gt_vel.npy", gt_v)
    gt7 = np.column_stack([traj["positions"] * 1.02, traj["quaternions"]])
    assert gt7.shape == (n, 7)
    np.save(d.parent / "gt_poses.npy", gt7)
    return d


@pytest.mark.parametrize("flags", [
    ["--frame", "2", "--antenna", "3"], ["--compare"], ["--insights"],
    ["--output", "{run}"]], ids=["frame", "compare", "insights", "two_runs"])
def test_analyze_data_matches_reference(run_dir, tmp_path, flags):
    flags = [f.format(run=run_dir) for f in flags]
    outs = {}
    for name, main in (("port", tmain), ("ref", jmain)):
        argv = ["analyze-data", "--output", str(run_dir), *flags, "--out",
                str(tmp_path / name)]
        if name == "port":
            argv += ["--device", "cpu"]
        rc, text = run(main, argv)
        assert rc == 0
        outs[name] = text
    assert outs["port"] == outs["ref"].replace(str(tmp_path / "ref"),
                                               str(tmp_path / "port"))
    assert files(tmp_path / "port") == files(tmp_path / "ref")
    for name in files(tmp_path / "ref"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "ref" / name).read_text(), name


def test_analyze_data_needs_rds(tmp_path, capsys):
    assert tmain(["analyze-data", "--output", str(tmp_path),
                  "--device", "cpu"]) == 2
    assert "no rds artifacts" in capsys.readouterr().err


def test_visualize_matches_reference(run_dir, tmp_path):
    for name, main in (("port", tmain), ("ref", jmain)):
        argv = ["visualize", "--run-dir", str(run_dir), "--out",
                str(tmp_path / name)]
        assert run(main, argv + (["--device", "cpu"] if name == "port"
                                 else []))[0] == 0
    assert files(tmp_path / "port") == files(tmp_path / "ref") == [
        "raw_signals.png", "rds.png", "trajectory.png", "velocities.png"]
    same_images(tmp_path / "port", tmp_path / "ref")
    assert tmain(["visualize", "--run-dir", str(tmp_path / "none"),
                  "--device", "cpu"]) == 2


def test_evaluate_matches_reference(run_dir, tmp_path):
    gt = ["--gt-velocities", str(run_dir.parent / "gt_vel.npy"),
          "--gt-poses", str(run_dir.parent / "gt_poses.npy")]
    printed = {}
    for name, main in (("port", tmain), ("ref", jmain)):
        argv = ["evaluate", "--run-dir", str(run_dir), *gt, "--out",
                str(tmp_path / name)]
        rc, text = run(main, argv + (["--device", "cpu"] if name == "port"
                                     else []))
        assert rc == 0
        printed[name] = json.loads(text.splitlines()[0])
    assert files(tmp_path / "port") == files(tmp_path / "ref")
    assert {"velocity_report.md", "velocity_errors.png", "pose_report.md",
            "pose_errors.png"} <= set(files(tmp_path / "port"))
    for key in ("position_rmse", "orientation_rmse"):
        np.testing.assert_allclose(printed["port"][key], printed["ref"][key],
                                   rtol=1.2e-7, atol=1e-9)
    assert tmain(["evaluate", "--run-dir", str(run_dir), "--device",
                  "cpu"]) == 2


def test_analyze_out_writes_the_reference_files(tmp_path):
    out = tmp_path / "an"
    rc, text = run(tmain, ["analyze", "--max-frames", "3", "--out", str(out),
                           "--device", "cpu"])
    assert rc == 0
    assert files(out) == ["analysis_results.json", "complete_analysis.png"]
    assert json.loads((out / "analysis_results.json").read_text())[
        "frames_processed"] == 3
    assert mpimg.imread(out / "complete_analysis.png").ndim == 3


def test_drawing_commands_fail_first_without_matplotlib(tmp_path):
    """Without matplotlib, ``analyze --out`` and ``visualize`` raise at
    their start (nothing written); ``analyze`` alone still runs."""
    code = textwrap.dedent(f"""
        import builtins, json, sys
        sys.path.insert(0, {str(REPO)!r})
        real = builtins.__import__
        def guarded(name, *a, **kw):
            if name.split(".")[0] in ("matplotlib", "jax", "radar_slam_tpu"):
                raise ImportError(f"{{name}} is blocked in this process")
            return real(name, *a, **kw)
        builtins.__import__ = guarded
        from radar_slam_tpu_torch.pipeline.cli import main
        out = {{}}
        for key, argv in (
                ("analyze_out", ["analyze", "--max-frames", "2", "--out",
                                 {str(tmp_path / "an")!r}]),
                ("visualize", ["visualize", "--run-dir", {str(tmp_path)!r}])):
            try:
                main(argv + ["--device", "cpu"])
                out[key] = "ran"
            except ImportError as e:
                out[key] = str(e)
        out["analyze"] = main(["analyze", "--max-frames", "2",
                               "--device", "cpu"])
        print(json.dumps(out))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, MPLBACKEND="Agg"))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "matplotlib is blocked" in out["analyze_out"]
    assert "matplotlib is blocked" in out["visualize"]
    assert out["analyze"] == 0
    assert not (tmp_path / "an").exists()
