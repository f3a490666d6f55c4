#!/usr/bin/env python3
"""Multi-process dry run of the port's SPMD back ends on N ranks.

    python dryrun_multichip_torch.py --ranks 4 --device cpu
    torchrun --nproc-per-node 4 dryrun_multichip_torch.py --device cpu

Counterpart of ``__graft_entry__.py:dryrun_multichip``: runs every
collective path of ``radar_slam_tpu_torch/parallel`` on tiny shapes -- the
frame-parallel driver over ADC cubes and over scatterers (all-gathered
smoothing tables, the halo, the prefix-sum pose), the factor-sharded GN-CG
(all-reduced gradient, diagonal and products, planar and z-aware), the
ranked Schur step (all-reduced boundary system and Woodbury products), the
sequence-sharded batch and the Schur solve of a stacked batch.  Each rank
holds its result against the one-rank run of the same function in its own
process.

Without ``torchrun``'s variables it starts the N ranks itself, as
processes on this host joined over ``tcp://127.0.0.1:<free port>``.  The
backend is gloo on the CPU; with ``--device cuda`` it is NCCL where there
is a card a rank, gloo where the ranks share one card.  Exits non-zero if
any rank fails.
"""

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def tiny_config():
    """The reference dry run's radar: 32 fast-time samples, 8 chirps,
    8 antennas."""
    from radar_slam_tpu_torch.core.config import (AoAConfig, DetectionConfig,
                                                  PipelineConfig, RadarConfig,
                                                  VelocityConfig)
    return PipelineConfig(
        radar=RadarConfig(chirp_duration=3.2e-6, num_chirps=8,
                          noise_power=1e-6),
        detection=DetectionConfig(threshold_db=-25.0, max_detections=8),
        aoa=AoAConfig(search_resolution_deg=5.0, max_targets=8,
                      track_capacity=16),
        velocity=VelocityConfig(gn_iterations=2),
    )


def chain(n, device, use_z=False, loop_capacity=1):
    import torch
    from radar_slam_tpu_torch.parallel import posegraph
    vel = torch.tensor([5.0, 0.0, 0.3 if use_z else 0.0],
                       device=device).repeat(n - 1, 1)
    return posegraph.from_velocities(
        vel, torch.full((n - 1,), 0.1, device=device),
        torch.ones(n - 1, dtype=torch.bool, device=device), dt=0.1,
        loop_capacity=loop_capacity, use_z=use_z)


def close(a, b, atol, what):
    gap = float((a - b).abs().max())
    if not gap <= atol:
        raise AssertionError(f"{what}: {gap} > {atol}")
    return gap


def rank_main(device):
    import torch
    from radar_slam_tpu_torch.io.synthetic import (SceneConfig,
                                                   constant_motion_scene)
    from radar_slam_tpu_torch.parallel import (ba, distributed, dp, multiseq,
                                               posegraph)
    from radar_slam_tpu_torch.parallel.mesh import make_mesh

    topo = distributed.initialize(device=device)
    dev = torch.device(topo["device"])
    mesh = make_mesh(device=dev)
    alone = make_mesh(1, device=dev)
    n = mesh.size
    cfg = tiny_config()
    A, C, S = 8, 8, cfg.radar.samples_per_chirp
    F = 2 * n

    gen = torch.Generator().manual_seed(0)
    signals = torch.complex(torch.randn((F, A, C, S), generator=gen),
                            torch.randn((F, A, C, S), generator=gen)).to(dev)
    out = dp.process_frames_dp(signals, cfg, mesh)
    ref = dp.process_frames_dp(signals, cfg, alone)
    assert out["pose"].shape == (F, 3)
    close(out["pose"], ref["pose"], 1e-4, "process_frames_dp pose")

    batches, _ = constant_motion_scene(
        3, num_frames=F, dt=cfg.frame_dt, v_body=(5.0, 0.0), yaw_rate=0.05,
        scene=SceneConfig(num_points=16, max_scatterers=cfg.max_scatterers),
        device=dev)
    out = dp.process_frames_dp_scatterers(
        batches, torch.Generator().manual_seed(1), cfg, mesh)
    ref = dp.process_frames_dp_scatterers(
        batches, torch.Generator().manual_seed(1), cfg, alone)
    assert out["pose"].shape == (F, 3)
    close(out["pose"], ref["pose"], 1e-4, "process_frames_dp_scatterers")

    # Pose graphs: N keyframes a multiple of the mesh, N factors.
    N = 4 * n
    for use_z in (False, True):
        graph = chain(N, dev, use_z)
        poses, _ = ba.gauss_newton_cg(graph, mesh=mesh, gn_iters=2,
                                      cg_iters=10)
        want, _ = ba.gauss_newton_cg(graph, gn_iters=2, cg_iters=10)
        assert poses.shape == (N, 4 if use_z else 3)
        close(poses, want, 1e-3, f"gauss_newton_cg use_z={use_z}")
        step = ba.schur_gn_step(graph, mesh=mesh)
        close(step, ba.schur_gn_step(graph, n), 1e-4,
              f"schur_gn_step use_z={use_z}")

    # Config 5: a stacked batch through the ranked Schur solve, and a
    # sequence-sharded batch (one sequence a rank).
    graph = chain(N, dev)
    batch = posegraph.PoseGraph(*[torch.stack([x, x]) for x in graph])
    poses_b, _ = multiseq.solve_graphs_mesh(batch, mesh, steps=2)
    assert poses_b.shape == (2, N, 3)
    seqs = multiseq._stack([batches] * n)
    out, poses, _ = multiseq.process_sequences_sharded(
        seqs, [torch.Generator().manual_seed(m) for m in range(n)], cfg,
        mesh, gn_iters=2, cg_iters=10)
    assert poses.shape == (n, F + 1, 3)
    # One write a line: the ranks share the launcher's stdout.
    print(f"rank {mesh.rank}/{n} ({topo['backend']}, {dev}): OK\n", end="",
          flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(ranks, device):
    """Start ``ranks`` copies of this script as the ranks of one group and
    wait for all; returns the first non-zero exit code, or 0."""
    port = str(free_port())
    procs = []
    for r in range(ranks):
        env = dict(os.environ, WORLD_SIZE=str(ranks), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(ranks),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--device", device], env=env))
    codes = []
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((c for c in codes if c), 0) if len(codes) == ranks else 1


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=4,
                   help="ranks to start when not under torchrun")
    p.add_argument("--device", default="cuda",
                   help="device of every rank (cuda or cpu)")
    args = p.parse_args()
    sys.path.insert(0, str(REPO))
    if "RANK" not in os.environ:
        rc = spawn(args.ranks, args.device)
        print(f"dryrun_multichip_torch({args.ranks}) "
              f"{'OK' if rc == 0 else 'FAILED'}", flush=True)
        return rc
    import torch
    torch.set_num_threads(1)
    rank_main(args.device)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
