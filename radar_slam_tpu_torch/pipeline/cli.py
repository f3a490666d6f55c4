"""Command-line interface of the port: one entry point with subcommands.

Counterpart of ``radar_slam_tpu/pipeline/cli.py``, with the same
subcommands, flags, printed keys and exit codes:

    python -m radar_slam_tpu_torch simulate --out ... [--dataset --seq]
    python -m radar_slam_tpu_torch process  --raw ... --out ...
    python -m radar_slam_tpu_torch pipeline --out ... [--dataset --seq]
    python -m radar_slam_tpu_torch analyze [--dataset ... --seq ...]
                                           [--rig | --merged] [--max-frames N]
    python -m radar_slam_tpu_torch quick-compare [--frames N] [--adversarial]
    python -m radar_slam_tpu_torch analyze-data --output RUN [--output ...]
    python -m radar_slam_tpu_torch evaluate --run-dir RUN [--gt-velocities
                                            ... --gt-poses ...]
    python -m radar_slam_tpu_torch visualize --run-dir RUN
    python -m radar_slam_tpu_torch bench

Every subcommand takes ``--device`` (default ``cuda``; ``--device cpu``
runs the kernels' plain PyTorch versions on the CPU), the counterpart of the
reference's choice of JAX platform.  ``quick-compare`` runs the real
pipeline on a short synthetic workload and reports its errors against the
ground truth; ``analyze`` runs the streaming analyzer (synthetic, or a
RadarScenes recording with ``--dataset``) or, for mounted rigs, the
batched rig driver through the double-buffered ingest; ``analyze --slam``
then re-runs the batched driver for the target clouds and refines the
trajectory with loop closures (``parallel/slam.py``; ``--slam-solver
cg|schur``, ``--slam-proposer pose|scancontext``).  ``simulate``
writes raw frames, ``process`` their RDS and detections, and ``pipeline``
runs the six-step artifact pipeline (``pipeline/pipeline.py``; MUSIC
unless ``--aoa-method`` says otherwise), each in the reference's artifact
schema (``io/artifacts.py``).  ``analyze-data`` reports peak, RDS and
dataset statistics of a run's ``rds/`` artifacts (``viz/analyze.py``,
numpy only); ``evaluate`` holds a run's velocity and trajectory artifacts
against ground truth and draws its error figures
(``evaluate/plots.py``); ``visualize`` draws a run's artifacts
(``viz/plots.py``); ``analyze --out`` also draws the overview figure.
These draw with matplotlib, which no module of the port imports with
itself: they import it when they start, and fail there where it is
missing (the card's machine has none).

``bench`` runs the root script ``bench_torch.py`` (the counterpart of
``bench.py``, which the reference's ``bench`` runs) on ``--device`` and
prints its one JSON line.  As in the reference, ``--fast`` is on whatever
is passed, so every other subcommand runs ``complete_analysis_config()``
(``max_scatterers=512``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _cfg_from_args(args):
    from radar_slam_tpu_torch.core.config import (complete_analysis_config,
                                                  default_config)
    cfg = (complete_analysis_config() if getattr(args, "fast", True)
           else default_config())
    if getattr(args, "num_chirps", None):
        cfg = dataclasses.replace(
            cfg, radar=dataclasses.replace(cfg.radar,
                                           num_chirps=args.num_chirps))
    if getattr(args, "aoa_method", None):
        cfg = dataclasses.replace(
            cfg, aoa=dataclasses.replace(cfg.aoa, method=args.aoa_method))
    return cfg


def _synthetic_scene(cfg, frames: int, device, seed: int = 7):
    from radar_slam_tpu_torch.io.synthetic import (SceneConfig,
                                                   constant_motion_scene)
    return constant_motion_scene(
        int(seed), num_frames=frames, dt=cfg.frame_dt,
        v_body=(8.0, 0.5), yaw_rate=0.05,
        scene=SceneConfig(num_points=96, max_scatterers=cfg.max_scatterers),
        device=device)


def _load_dataset_frames(args, cfg, device):
    """A RadarScenes recording's frames as one batch on ``device``, and its
    ground-truth arrays."""
    from radar_slam_tpu_torch.io.radarscenes import RadarScenesLoader
    loader = RadarScenesLoader(args.dataset)
    data = loader.load_sequence_data(args.seq)
    frames = loader.extract_radar_frames(data, cfg.frame_duration_ms)
    if args.max_frames:
        frames = frames[:args.max_frames]
    return loader.frames_as_batches(data, frames, cfg.max_scatterers,
                                    device=device)


def cmd_simulate(args) -> int:
    """Synthesize raw frames to ``frame_XXXX.npy`` artifacts (the
    reference's ``simulate_raw.py``), noise seeds from generator seed 0."""
    from radar_slam_tpu_torch.io import artifacts
    from radar_slam_tpu_torch.signal.synth import synthesize_frames_batch
    from radar_slam_tpu_torch.utils.host import device_get

    device = torch.device(args.device)
    cfg = _cfg_from_args(args)
    if args.dataset:
        batches, _ = _load_dataset_frames(args, cfg, device)
    else:
        batches, _ = _synthetic_scene(cfg, args.max_frames or 16, device)
    signals = device_get(synthesize_frames_batch(
        batches, cfg.radar, torch.Generator().manual_seed(0)))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(signals.shape[0]):
        artifacts.save_raw_frame(out, i, signals[i])
    artifacts.save_synthesis_metadata(
        out, cfg.radar, {"processed_frames": int(signals.shape[0])})
    print(f"wrote {signals.shape[0]} frames to {out}")
    return 0


def cmd_process(args) -> int:
    """RDS + peaks of saved raw frames (the reference's ``dechirp.py``);
    exit 2 when ``--raw`` holds no frames."""
    from radar_slam_tpu_torch.core.types import signals_from_numpy
    from radar_slam_tpu_torch.io import artifacts
    from radar_slam_tpu_torch.signal.detect import detect_peaks
    from radar_slam_tpu_torch.signal.rds import range_doppler_spectrum
    from radar_slam_tpu_torch.utils.host import device_get, tree_map

    device = torch.device(args.device)
    cfg = _cfg_from_args(args)
    raw_dir = Path(args.raw)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    files = sorted(raw_dir.glob("frame_*.npy"))
    if not files:
        print(f"error: no frame_*.npy under {raw_dir}", file=sys.stderr)
        return 2
    subset = (args.chirp_start, args.chirp_end) \
        if args.chirp_start is not None else None
    # One batch of all frames: one upload, one RDS call, one read-back.
    sig = signals_from_numpy(np.stack([np.load(f) for f in files]), device)
    rds = range_doppler_spectrum(sig, cfg.radar, chirp_subset=subset,
                                 doppler_window=cfg.doppler_window)
    rds_h, det_h = device_get((rds, detect_peaks(rds, cfg.radar,
                                                 cfg.detection)))
    for i in range(len(files)):
        artifacts.save_rds_frame(out, i, rds_h[i],
                                 tree_map(lambda x: x[i], det_h))
    print(f"processed {len(files)} frames -> {out}")
    return 0


def cmd_pipeline(args) -> int:
    """The six-step artifact pipeline (the reference's
    ``run_ego_motion_pipeline.py``)."""
    from radar_slam_tpu_torch.pipeline.pipeline import EgoMotionPipeline

    device = torch.device(args.device)
    cfg = _cfg_from_args(args)
    if not getattr(args, "aoa_method", None):
        # The reference's batch pipeline runs MUSIC as its step-3
        # estimator (run_ego_motion_pipeline.py:183).
        cfg = dataclasses.replace(
            cfg, aoa=dataclasses.replace(cfg.aoa, method="music"))
    if args.dataset:
        batches, _ = _load_dataset_frames(args, cfg, device)
        gt_vel = None
    else:
        batches, gt = _synthetic_scene(cfg, args.max_frames or 16, device)
        F = batches.range_m.shape[0]
        gt_vel = np.zeros((F, 6))
        gt_vel[:, :2] = np.asarray(gt["velocity_body"])[:2]
        gt_vel[:, 5] = float(gt["yaw_rate"])
    pipe = EgoMotionPipeline(cfg, args.out, device=device)
    res = pipe.run_complete_pipeline(batches, gt_velocities=gt_vel)
    print(json.dumps({"step_times": res["step_times"]}, indent=2))
    return 0


def cmd_analyze(args) -> int:
    """Streaming analysis with ground-truth comparison; ``--out`` also
    writes ``analysis_results.json`` and the overview figure
    ``complete_analysis.png``."""
    from radar_slam_tpu_torch.pipeline.streaming import StreamingAnalyzer
    from radar_slam_tpu_torch.viz.plots import comprehensive_overview, pyplot
    if args.out:
        pyplot()    # without matplotlib, fail before any work

    device = torch.device(args.device)
    cfg = _cfg_from_args(args)
    if args.rig:
        return _cmd_analyze_rig(args, cfg, device)
    if args.dataset:
        from radar_slam_tpu_torch.io.radarscenes import RadarScenesLoader
        loader = RadarScenesLoader(args.dataset)
        data = loader.load_sequence_data(args.seq)
        # Sensor-origin geometry (the rig) is the default for recordings
        # whose sensors.json declares off-origin mounts; --merged forces
        # the merged-sensor path.
        _, rig = loader.sequence_rig(data)
        if not args.merged and any(any(abs(c) > 1e-9 for c in mount)
                                   for mount in rig):
            return _cmd_analyze_rig(args, cfg, device, loader, data)
        frames = loader.extract_radar_frames(data, cfg.frame_duration_ms)
        if args.max_frames:
            frames = frames[:args.max_frames]
        # Host-resident: analyze_sequence ingests through the
        # double-buffered prefetch uploader.
        batches, gt = loader.frames_as_batches(data, frames,
                                               cfg.max_scatterers, host=True)
        gt_poses = gt["poses"]
    else:
        batches, gt = _synthetic_scene(cfg, args.max_frames or 10, device)
        gt_poses = np.asarray(gt["poses"])
    an = StreamingAnalyzer(cfg, gt_fallback=args.gt_fallback,
                           checkpoint_dir=args.checkpoint_dir,
                           checkpoint_every=args.checkpoint_every,
                           device=device)
    if args.resume and an.checkpoint_dir:
        if an.restore_latest():
            print(f"resumed from checkpoint at frame {an.frame_idx}")
    metrics = an.analyze_sequence(batches, gt_poses=gt_poses)
    if args.slam:
        metrics.update(_slam_metrics(args, cfg, batches, gt_poses, device))
    print(json.dumps(metrics, indent=2, default=float))
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        comprehensive_overview(an.results, out / "complete_analysis.png")
        with open(out / "analysis_results.json", "w") as f:
            json.dump(metrics, f, indent=2, default=float)
    return 0


def _slam_metrics(args, cfg, batches, gt_poses, device) -> dict:
    """``analyze --slam``: the analyzer's frames re-run through the batched
    driver (generator seed 0) for their target clouds, then loop-closure
    pose-graph refinement on ``device`` (the Schur solver over one block,
    the reference on one device)."""
    from radar_slam_tpu_torch.evaluate.pose_metrics import planar_pose_errors
    from radar_slam_tpu_torch.io.prefetch import is_host_resident
    from radar_slam_tpu_torch.parallel import slam
    from radar_slam_tpu_torch.pipeline import frame as frame_mod
    from radar_slam_tpu_torch.utils.host import device_put

    if is_host_resident(batches):
        batches = device_put(batches, device)
    out = frame_mod.process_sequence_batched(
        batches, torch.Generator().manual_seed(0), cfg)
    res = slam.refine_sequence_output(out, cfg.frame_dt, n_blocks=1,
                                      solver=args.slam_solver,
                                      proposer=args.slam_proposer)
    metrics = {"slam_loop_closures": len(res["loop_closures"])}
    if gt_poses is not None:
        F = len(gt_poses)
        m = planar_pose_errors(res["poses"][1:F + 1], np.asarray(gt_poses))
        metrics["slam_position_rmse"] = m["position_rmse"]
        metrics["slam_yaw_rmse"] = m["yaw_rmse"]
    return metrics


def _cmd_analyze_rig(args, cfg, device, loader=None, data=None) -> int:
    """Mounted-rig analysis: per-sensor processing in each sensor's frame
    with exact mounting geometry (``pipeline/rig.py``).  With a RadarScenes
    recording the rig comes from sensors.json; the synthetic fallback is a
    two-sensor front rig."""
    from radar_slam_tpu_torch.evaluate.pose_metrics import planar_pose_errors
    from radar_slam_tpu_torch.io.prefetch import (
        is_host_resident, process_sequence_rig_batched_prefetch)
    from radar_slam_tpu_torch.pipeline import rig as rigmod

    if args.dataset:
        if loader is None:
            from radar_slam_tpu_torch.io.radarscenes import RadarScenesLoader
            loader = RadarScenesLoader(args.dataset)
            data = loader.load_sequence_data(args.seq)
        frames = loader.extract_radar_frames(data, cfg.frame_duration_ms)
        if args.max_frames:
            frames = frames[:args.max_frames]
        batches, rig, gt = loader.frames_as_batches_rig(
            data, frames, cfg.max_scatterers, host=True)
        gt_poses = gt["poses"]
    else:
        from radar_slam_tpu_torch.io.synthetic import (
            SceneConfig, constant_motion_scene_rig)
        rig = ((1.8, 0.9, 0.4), (1.8, -0.9, -0.4))
        batches, gt = constant_motion_scene_rig(
            7, num_frames=args.max_frames or 10, dt=cfg.frame_dt,
            v_body=(8.0, 0.5), yaw_rate=0.1, rig=rig,
            scene=SceneConfig(num_points=96,
                              max_scatterers=cfg.max_scatterers),
            device=device)
        gt_poses = np.asarray(gt["poses"])

    generator = torch.Generator().manual_seed(0)
    if is_host_resident(batches):
        # Phase A per uploaded chunk while the next one is copied, one
        # whole-sequence phase B.
        out = process_sequence_rig_batched_prefetch(batches, generator, cfg,
                                                    rig, device=device)
    else:
        out = rigmod.process_sequence_rig_batched(batches, generator, cfg,
                                                  rig)
    m = planar_pose_errors(out.pose, gt_poses)
    metrics = {
        "rig": [list(s) for s in rig],
        "frames": int(batches.range_m.shape[0]),
        "position_rmse": m["position_rmse"],
        "yaw_rmse": m["yaw_rmse"],
        "mean_associations": float(
            out.num_associations.to(torch.float32).mean()),
        "mean_yaw_rate": float(out.motion.angular_velocity[1:, 2].mean()),
    }
    print(json.dumps(metrics, indent=2, default=float))
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        with open(Path(args.out) / "rig_analysis.json", "w") as f:
            json.dump(metrics, f, indent=2, default=float)
    return 0


def _adversarial_suite(cfg, frames: int, device):
    """The mismatch-scenario suite (tests/test_adversarial.py's scenarios):
    per-scenario errors against the parity bound."""
    from radar_slam_tpu_torch.core.config import reference_fidelity_config
    from radar_slam_tpu_torch.evaluate.pose_metrics import planar_pose_errors
    from radar_slam_tpu_torch.io.synthetic import (MismatchConfig,
                                                   SceneConfig,
                                                   mismatch_scene)
    from radar_slam_tpu_torch.pipeline import frame as pipe_mod

    scenarios = {
        "reference_fidelity": (reference_fidelity_config(), MismatchConfig()),
        "moving_objects": (cfg, MismatchConfig(
            num_movers=5, mover_points=3, mover_oncoming=True,
            mover_speed_min=6.0, mover_speed_max=12.0)),
        "transient_clutter": (cfg, MismatchConfig(clutter_per_frame=16)),
        "extended_targets": (cfg, MismatchConfig(extent_points=3,
                                                 extent_size_m=0.8)),
        "timing_jitter": (cfg, MismatchConfig(dt_jitter_frac=0.2)),
        "dropped_frames": (cfg, MismatchConfig(drop_frame_prob=0.25)),
    }
    results = {}
    for name, (scfg, mm) in scenarios.items():
        scene = SceneConfig(num_points=48,
                            max_scatterers=scfg.max_scatterers)
        batches, gt = mismatch_scene(3, frames, scfg.frame_dt, (8.0, 0.5),
                                     0.1, scene, mm, device=device)
        out = pipe_mod.process_sequence(batches,
                                        torch.Generator().manual_seed(0),
                                        scfg)
        m = planar_pose_errors(out.pose, gt["poses"])
        results[name] = {
            "position_rmse_m": m["position_rmse"],
            "yaw_rmse_rad": m["yaw_rmse"],
            "pass": bool(m["position_rmse"] <= 0.777
                         and m["yaw_rmse"] <= 0.466),
        }
    return results


def cmd_quick_compare(args) -> int:
    """Quick comparison: the real pipeline on a short synthetic workload.
    ``compile_time_s`` is the first call's time less the steady call's; on
    the card the first call includes the kernels' build when their cache
    is cold."""
    from radar_slam_tpu_torch.evaluate.pose_metrics import planar_pose_errors
    from radar_slam_tpu_torch.pipeline import frame as pipe_mod

    device = torch.device(args.device)
    cfg = _cfg_from_args(args)
    frames = args.frames
    if args.adversarial:
        results = _adversarial_suite(cfg, frames, device)
        print(json.dumps(results, indent=2, default=float))
        ok = all(r["pass"] for r in results.values())
        print("ADVERSARIAL PARITY:", "PASS" if ok else "FAIL")
        return 0 if ok else 1
    batches, gt = _synthetic_scene(cfg, frames, device)

    def run():
        t0 = time.time()
        out = pipe_mod.process_sequence(
            batches, torch.Generator().manual_seed(0), cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.time() - t0

    _, compile_and_run = run()
    out, steady = run()

    m = planar_pose_errors(out.pose, gt["poses"])
    vx = out.motion.velocity[1:, 0].cpu().numpy().astype(np.float64)
    result = {
        "frames": frames,
        "position_rmse_m": m["position_rmse"],
        "yaw_rmse_rad": m["yaw_rmse"],
        "velocity_rmse_mps": float(np.sqrt(np.mean(
            (vx - float(gt["velocity_body"][0])) ** 2))),
        "processing_time_s": steady,
        "compile_time_s": compile_and_run - steady,
        "reference_bounds": {"position_rmse_m": 0.777,
                             "yaw_rmse_rad": 0.466,
                             "quick_time_10_frames_s": 0.20},
    }
    print(json.dumps(result, indent=2))
    ok = (m["position_rmse"] <= 0.777 and m["yaw_rmse"] <= 0.466)
    print("PARITY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def cmd_visualize(args) -> int:
    """Plot the artifacts of a pipeline run directory (the reference's
    ``visualize_results.py``); exit 2 where the directory is missing."""
    from radar_slam_tpu_torch.core.config import complete_analysis_config
    from radar_slam_tpu_torch.io import artifacts
    from radar_slam_tpu_torch.viz import plots

    plots.pyplot()    # without matplotlib, fail before any work
    run = Path(args.run_dir)
    if not run.is_dir():
        print(f"error: run directory not found: {run}", file=sys.stderr)
        return 2
    out = Path(args.out or run / "visualizations")
    out.mkdir(parents=True, exist_ok=True)
    cfg = complete_analysis_config()
    made = []
    raw = sorted((run / "raw_sim").glob("frame_*.npy"))
    if raw:
        made.append(plots.plot_raw_signals(np.load(raw[0]),
                                           out / "raw_signals.png"))
    rds_files = sorted((run / "rds").glob("frame_*_rds.npy"))
    if rds_files:
        rds, peaks = artifacts.load_rds_frame(run / "rds", 0)
        made.append(plots.plot_rds(rds, cfg.radar, out / "rds.png",
                                   detections=peaks))
    if (run / "poses" / "trajectory.npz").exists():
        traj = artifacts.load_trajectory(run / "poses")
        made.append(plots.plot_trajectory(traj["positions"],
                                          out / "trajectory.png",
                                          orientations=traj["orientations"]))
        made.append(plots.plot_velocity_profile(
            traj["timestamps"],
            np.concatenate([traj["velocities"],
                            traj["angular_velocities"]], axis=1),
            out / "velocities.png"))
    print(f"wrote {len(made)} figures to {out}")
    return 0


def cmd_analyze_data(args) -> int:
    """Peak / RDS / dataset-level analysis of pipeline artifacts (the
    reference's ``analyze_data.py``: ``--frame`` / ``--antenna`` one frame,
    ``--compare`` across frames, ``--insights`` the aggregate, repeated
    ``--output`` across runs); exit 2 where a run has no ``rds/``."""
    from radar_slam_tpu_torch.evaluate.reports import save_json, write_report
    from radar_slam_tpu_torch.io import artifacts
    from radar_slam_tpu_torch.viz import analyze as an

    def load_frames(run: Path):
        frames = []
        for f in sorted((run / "rds").glob("frame_*_peaks.npz")):
            with np.load(f) as z:
                frames.append({k: z[k] for k in z.files})
        return frames

    runs = [Path(r) for r in args.output]
    for r in runs:
        if not (r / "rds").is_dir():
            print(f"error: no rds artifacts under {r}", file=sys.stderr)
            return 2
    out_dir = Path(args.out or runs[0] / "analysis")
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.insights or len(runs) > 1:
        seqs = {r.name or str(r): load_frames(r) for r in runs}
        result = (an.analyze_dataset(seqs) if len(runs) > 1
                  else an.insights_report(next(iter(seqs.values()))))
        save_json(result, out_dir / "insights.json")
        write_report(an.insights_markdown(result), out_dir / "insights.md")
        print(json.dumps({k: v for k, v in result.items()
                          if k != "per_sequence"}, indent=2, default=float))
        print(f"wrote insights.json + insights.md to {out_dir}")
        return 0
    if args.compare:
        result = an.compare_frames(load_frames(runs[0]))
        save_json(result, out_dir / "frame_comparison.json")
        print(json.dumps(result, indent=2, default=float))
        return 0
    rds, peaks = artifacts.load_rds_frame(runs[0] / "rds", args.frame)
    result = {
        "frame": args.frame,
        "peaks": an.analyze_detections(peaks),
        "rds_quality": an.analyze_rds_quality(rds, antenna=args.antenna),
    }
    save_json(result, out_dir / f"frame_{args.frame:04d}_analysis.json")
    print(json.dumps(result, indent=2, default=float))
    return 0


def cmd_evaluate(args) -> int:
    """Evaluate a run's velocity / trajectory artifacts against ground
    truth (the reference's ``compute_velocity_error.py`` and
    ``compute_pose_error.py``): markdown reports and, through
    ``emit_error_plots``, their figures; exit 2 where nothing matches."""
    from radar_slam_tpu_torch.evaluate import (pose_metrics, reports,
                                               velocity_metrics)
    from radar_slam_tpu_torch.evaluate.plots import emit_error_plots
    from radar_slam_tpu_torch.io import artifacts
    from radar_slam_tpu_torch.viz.plots import pyplot

    pyplot()    # without matplotlib, fail before any work
    run = Path(args.run_dir)
    out = Path(args.out or run / "evaluation")
    out.mkdir(parents=True, exist_ok=True)
    wrote = []

    vel_dir = run / "velocities"
    if args.gt_velocities and vel_dir.exists():
        n = len(sorted(vel_dir.glob("frame_*_velocity.npz")))
        est = []
        for i in range(n):
            v = artifacts.load_velocity_frame(vel_dir, i)
            est.append(np.concatenate([v["velocity"], v["angular_velocity"]]))
        est = np.asarray(est)
        gt = np.load(args.gt_velocities)
        if gt.shape != (n, 6):
            print(f"error: GT velocities shape {gt.shape} != ({n}, 6)",
                  file=sys.stderr)
            return 2
        res = velocity_metrics.compute_velocity_errors(est, gt)
        trends = velocity_metrics.analyze_error_trends(res)
        reports.write_report(reports.velocity_report_markdown(res, trends),
                             out / "velocity_report.md")
        wrote.append("velocity_report.md")
        wrote += [p.name for p in emit_error_plots(
            out, velocities_est=est, velocities_gt=gt)]

    if args.gt_poses and (run / "poses" / "trajectory.npz").exists():
        traj = artifacts.load_trajectory(run / "poses")
        est7 = np.column_stack([traj["positions"], traj["quaternions"]])
        gt7 = np.load(args.gt_poses)
        if gt7.shape != est7.shape:
            print(f"error: GT poses shape {gt7.shape} != {est7.shape}",
                  file=sys.stderr)
            return 2
        ape = pose_metrics.compute_ape(est7, gt7)
        rte = pose_metrics.compute_rte(est7, gt7)
        reports.write_report(reports.pose_report_markdown(ape, rte),
                             out / "pose_report.md")
        print(json.dumps({"position_rmse": ape["position_rmse"],
                          "orientation_rmse": ape["orientation_rmse"]}))
        wrote.append("pose_report.md")
        wrote += [p.name for p in emit_error_plots(
            out, ape=ape, rte=rte, est_positions=est7[:, :3],
            gt_positions=gt7[:, :3])]

    if not wrote:
        print("error: nothing to evaluate (need --gt-velocities and/or "
              "--gt-poses plus matching artifacts)", file=sys.stderr)
        return 2
    print(f"wrote {wrote} to {out}")
    return 0


def cmd_bench(args) -> int:
    """The benchmark, ``bench_torch.py`` at the root of the checkout this
    package sits in (imported once as ``bench_torch``), on ``--device``."""
    bench = sys.modules.get("bench_torch")
    if bench is None:
        import importlib.util
        path = Path(__file__).resolve().parents[2] / "bench_torch.py"
        spec = importlib.util.spec_from_file_location("bench_torch", path)
        bench = importlib.util.module_from_spec(spec)
        sys.modules["bench_torch"] = bench
        spec.loader.exec_module(bench)
    return bench.main(["--device", args.device])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="radar_slam_tpu_torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, fn, **kw):
        sp = sub.add_parser(name, **kw)
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; cpu "
                             "runs the kernels' plain versions)")
        sp.set_defaults(fn=fn)
        return sp

    def common(sp, dataset=True):
        sp.add_argument("--max-frames", type=int, default=None)
        sp.add_argument("--num-chirps", type=int, default=None)
        sp.add_argument("--fast", action="store_true", default=True)
        sp.add_argument("--aoa-method", default=None,
                        choices=("beamforming", "music", "esprit"),
                        help="AoA estimator (default: config; the six-step "
                             "pipeline defaults to music for reference "
                             "parity)")
        if dataset:
            sp.add_argument("--dataset", default=None,
                            help="RadarScenes root (synthetic scene if unset)")
            sp.add_argument("--seq", default="sequence_125")

    sp = add("simulate", cmd_simulate, help="synthesize raw FMCW frames")
    common(sp)
    sp.add_argument("--out", required=True)

    sp = add("process", cmd_process, help="RDS + peak extraction")
    sp.add_argument("--raw", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--chirp-start", type=int, default=None)
    sp.add_argument("--chirp-end", type=int, default=None)
    sp.add_argument("--num-chirps", type=int, default=None)

    sp = add("pipeline", cmd_pipeline, help="full six-step pipeline")
    common(sp)
    sp.add_argument("--out", required=True)

    sp = add("analyze", cmd_analyze,
             help="streaming analysis + GT comparison")
    common(sp)
    sp.add_argument("--out", default=None)
    sp.add_argument("--gt-fallback", action="store_true")
    sp.add_argument("--rig", action="store_true",
                    help="force the per-sensor mounted-rig pipeline (exact "
                         "mounting geometry; yaw rate Doppler-observable). "
                         "Datasets with off-origin mounts in sensors.json "
                         "use it by default")
    sp.add_argument("--merged", action="store_true",
                    help="force the merged-sensor path (reference parity: "
                         "vehicle-origin LOS, sensor-radial vr)")
    sp.add_argument("--slam", action="store_true",
                    help="loop-closure pose-graph refinement")
    sp.add_argument("--slam-solver", choices=("cg", "schur"), default="cg",
                    help="pose-graph solver (with --slam)")
    sp.add_argument("--slam-proposer", choices=("pose", "scancontext"),
                    default="pose",
                    help="loop-closure candidate proposer (with --slam)")
    sp.add_argument("--checkpoint-dir", default=None,
                    help="persist streaming state every N frames for crash "
                         "recovery (utils/checkpointing.py)")
    sp.add_argument("--checkpoint-every", type=int, default=10)
    sp.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--checkpoint-dir")

    sp = add("quick-compare", cmd_quick_compare,
             help="honest quick benchmark (real pipeline)")
    sp.add_argument("--frames", type=int, default=10)
    sp.add_argument("--num-chirps", type=int, default=None)
    sp.add_argument("--adversarial", action="store_true",
                    help="run the model-mismatch scenario suite (reference-"
                         "fidelity synthesis, movers, clutter, extended "
                         "targets, jitter, dropped frames) against the "
                         "parity bound")

    sp = add("analyze-data", cmd_analyze_data,
             help="peak/RDS/dataset statistics from artifacts")
    sp.add_argument("--output", action="append", required=True,
                    help="pipeline run directory (repeat for multi-"
                         "sequence aggregation)")
    sp.add_argument("--frame", type=int, default=0)
    sp.add_argument("--antenna", type=int, default=0)
    sp.add_argument("--compare", action="store_true",
                    help="cross-frame comparison")
    sp.add_argument("--insights", action="store_true",
                    help="aggregate insights report (JSON + markdown)")
    sp.add_argument("--out", default=None)

    sp = add("evaluate", cmd_evaluate,
             help="evaluate saved artifacts vs GT")
    sp.add_argument("--run-dir", required=True)
    sp.add_argument("--gt-velocities", default=None,
                    help=".npy file of GT velocities [F, 6]")
    sp.add_argument("--gt-poses", default=None,
                    help=".npy file of GT poses [F, 7] (xyz + wxyz quat)")
    sp.add_argument("--out", default=None)

    sp = add("visualize", cmd_visualize,
             help="plot pipeline artifacts")
    sp.add_argument("--run-dir", required=True)
    sp.add_argument("--out", default=None)

    add("bench", cmd_bench, help="run the benchmark (bench_torch.py)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
