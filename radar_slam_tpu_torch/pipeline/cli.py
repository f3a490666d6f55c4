"""Command-line interface of the port: one entry point with subcommands.

Counterpart of ``radar_slam_tpu/pipeline/cli.py``, with the same
subcommands, flags, printed keys and exit codes:

    python -m radar_slam_tpu_torch analyze [--dataset ... --seq ...]
                                           [--rig | --merged] [--max-frames N]
    python -m radar_slam_tpu_torch quick-compare [--frames N] [--adversarial]

Every subcommand takes ``--device`` (default ``cuda``; ``--device cpu``
runs the kernels' plain PyTorch versions on the CPU), the counterpart of the
reference's choice of JAX platform.  ``quick-compare`` runs the real
pipeline on a short synthetic workload and reports its errors against the
ground truth; ``analyze`` runs the streaming analyzer (synthetic, or a
RadarScenes recording with ``--dataset``) or, for mounted rigs, the
batched rig driver through the double-buffered ingest.

``simulate``, ``process``, ``pipeline``, ``analyze-data``, ``evaluate``,
``visualize`` and ``bench`` are registered with the reference's flags and
raise ``NotImplementedError`` naming the ROADMAP item that ports them, as
does ``analyze --slam``.  As in the reference, ``--fast`` is on whatever is
passed, so every subcommand runs ``complete_analysis_config()``
(``max_scatterers=512``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

ROADMAP_ARTIFACTS = "ROADMAP section 1, 'The six-step artifact pipeline'"
ROADMAP_VIZ = "ROADMAP section 1, 'Visualization'"
ROADMAP_SLAM = "ROADMAP section 1, 'Distributed back ends'"
ROADMAP_BENCH = "ROADMAP section 1, 'The port's benchmark'"


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


def _not_ported(what: str, item: str):
    def cmd(args) -> int:
        raise NotImplementedError(f"{what} is not ported yet ({item})")
    return cmd


def cmd_analyze(args) -> int:
    """Streaming analysis with ground-truth comparison."""
    from radar_slam_tpu_torch.pipeline.streaming import StreamingAnalyzer

    if args.slam:
        raise NotImplementedError(
            f"analyze --slam (loop-closure pose-graph refinement) is not "
            f"ported yet ({ROADMAP_SLAM})")
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
    print(json.dumps(metrics, indent=2, default=float))
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "analysis_results.json", "w") as f:
            json.dump(metrics, f, indent=2, default=float)
        print(f"wrote {out / 'analysis_results.json'}; the overview figure "
              f"(complete_analysis.png) waits for the port of viz "
              f"({ROADMAP_VIZ})")
    return 0


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

    sp = add("simulate", _not_ported("simulate", ROADMAP_ARTIFACTS),
             help="synthesize raw FMCW frames")
    common(sp)
    sp.add_argument("--out", required=True)

    sp = add("process", _not_ported("process", ROADMAP_ARTIFACTS),
             help="RDS + peak extraction")
    sp.add_argument("--raw", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--chirp-start", type=int, default=None)
    sp.add_argument("--chirp-end", type=int, default=None)
    sp.add_argument("--num-chirps", type=int, default=None)

    sp = add("pipeline", _not_ported("pipeline", ROADMAP_ARTIFACTS),
             help="full six-step pipeline")
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
                    help="loop-closure pose-graph refinement (not ported "
                         "yet)")
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

    sp = add("analyze-data", _not_ported("analyze-data", ROADMAP_VIZ),
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

    sp = add("evaluate", _not_ported("evaluate", ROADMAP_ARTIFACTS),
             help="evaluate saved artifacts vs GT")
    sp.add_argument("--run-dir", required=True)
    sp.add_argument("--gt-velocities", default=None,
                    help=".npy file of GT velocities [F, 6]")
    sp.add_argument("--gt-poses", default=None,
                    help=".npy file of GT poses [F, 7] (xyz + wxyz quat)")
    sp.add_argument("--out", default=None)

    sp = add("visualize", _not_ported("visualize", ROADMAP_VIZ),
             help="plot pipeline artifacts")
    sp.add_argument("--run-dir", required=True)
    sp.add_argument("--out", default=None)

    add("bench", _not_ported("bench", ROADMAP_BENCH),
        help="run the benchmark")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
