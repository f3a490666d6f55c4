"""Rank worker for the port's multi-process tests (tests/test_torch_*.py).

Not collected by pytest (leading underscore).  :func:`run_ranks` starts
``world`` copies of this file as ``python _torch_rank_worker.py <world>
<rank> <port> <workdir>``; each joins a gloo process group on the CPU
through ``parallel.distributed.initialize``, runs every job of
``<workdir>/jobs.pkl`` on ``make_mesh(world)`` and writes its results to
``<workdir>/rank<r>.pkl`` as numpy.  A worker imports the port only, never
JAX, the JAX package or a test module (the port's counterpart of
``tests/_distributed_worker.py``).
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(jobs: dict, world: int, workdir, timeout: float = 300.0):
    """Run ``jobs`` ({name: (task, kwargs)}) on ``world`` gloo ranks;
    returns each rank's {name: result}, rank order."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(world), str(r), str(port),
         str(workdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} exited "
                               f"{p.returncode}:\n{out[-4000:]}")
    results = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---- tasks: each takes the mesh and numpy / config-dict arguments --------

def _np(tree):
    from radar_slam_tpu_torch.utils.host import device_get
    return device_get(tree)


def _graph(arrays):
    from radar_slam_tpu_torch.parallel import posegraph
    import torch
    if arrays["poses"].ndim == 3:
        graphs = [posegraph.posegraph_from_numpy(
            {k: v[m] for k, v in arrays.items()}, device="cpu")
            for m in range(arrays["poses"].shape[0])]
        return posegraph.PoseGraph(*[torch.stack(x) for x in zip(*graphs)])
    return posegraph.posegraph_from_numpy(arrays, device="cpu")


def task_topology(mesh, topology):
    import torch
    from radar_slam_tpu_torch.parallel import distributed
    total = mesh.all_reduce(torch.tensor([mesh.rank + 1.0]))
    return {"topology": topology, "multihost": distributed.is_multihost(),
            "all_reduce": float(total[0]), "size": mesh.size,
            "rank": mesh.rank,
            "gather": _np(mesh.gather(torch.full((2,), mesh.rank)))}


def task_dp_cubes(mesh, signals, cfg):
    import torch
    from radar_slam_tpu_torch.core.config import config_from_dict
    from radar_slam_tpu_torch.parallel import dp
    return _np(dp.process_frames_dp(torch.from_numpy(signals),
                                    config_from_dict(cfg), mesh))


def task_dp_scatterers(mesh, fields, cfg, seed):
    import torch
    from radar_slam_tpu_torch.core.config import config_from_dict
    from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
    from radar_slam_tpu_torch.parallel import dp
    return _np(dp.process_frames_dp_scatterers(
        scatterer_batch_from_numpy(fields, "cpu"),
        torch.Generator().manual_seed(seed), config_from_dict(cfg), mesh))


def task_cg(mesh, graph, gn_iters, cg_iters):
    from radar_slam_tpu_torch.parallel import ba
    return _np(ba.gauss_newton_cg(_graph(graph), mesh=mesh,
                                  gn_iters=gn_iters, cg_iters=cg_iters))


def task_schur(mesh, graph, steps, damping=1e-5):
    from radar_slam_tpu_torch.parallel import ba
    g = _graph(graph)
    poses = g.poses
    for _ in range(steps):
        poses = ba.schur_gn_step(g._replace(poses=poses), mesh=mesh,
                                 damping=damping)
    return _np(poses)


def task_solve_graphs(mesh, graphs, steps):
    from radar_slam_tpu_torch.parallel import multiseq
    return _np(multiseq.solve_graphs_mesh(_graph(graphs), mesh, steps=steps))


def _sequences(fields, seeds):
    import torch
    from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
    return (scatterer_batch_from_numpy(fields, "cpu"),
            [torch.Generator().manual_seed(s) for s in seeds])


def task_sharded(mesh, fields, seeds, cfg, **kw):
    from radar_slam_tpu_torch.core.config import config_from_dict
    from radar_slam_tpu_torch.parallel import multiseq
    batch, gens = _sequences(fields, seeds)
    return _np(multiseq.process_sequences_sharded(
        batch, gens, config_from_dict(cfg), mesh, **kw))


def task_sequences_schur(mesh, fields, seeds, cfg, **kw):
    from radar_slam_tpu_torch.core.config import config_from_dict
    from radar_slam_tpu_torch.parallel import multiseq
    batch, gens = _sequences(fields, seeds)
    return _np(multiseq.process_sequences_schur(
        batch, gens, config_from_dict(cfg), mesh, **kw))


def task_refine(mesh, out, cfg, lc, **kw):
    import torch
    from radar_slam_tpu_torch.core.config import config_from_dict
    from radar_slam_tpu_torch.core.types import FrameOutput, MotionEstimate
    from radar_slam_tpu_torch.parallel import multiseq
    from radar_slam_tpu_torch.parallel.loopclosure import LoopClosureConfig
    t = {k: torch.from_numpy(v) for k, v in out.items()}
    motion = MotionEstimate(**{k: t[k] for k in MotionEstimate._fields})
    fo = FrameOutput(motion=motion, **{k: t[k] for k in FrameOutput._fields
                                       if k != "motion"})
    _, poses, costs, loops = multiseq.refine_sequences_mesh(
        None, None, config_from_dict(cfg), mesh,
        lc_cfg=LoopClosureConfig(**lc), out=fo, **kw)
    return _np((poses, costs)), [[(lc["i"], lc["j"]) for lc in m]
                                 for m in loops]


TASKS = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("task_")}


def main():
    world, rank, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), Path(sys.argv[4]))
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from radar_slam_tpu_torch.parallel import distributed
    from radar_slam_tpu_torch.parallel.mesh import make_mesh
    topology = distributed.initialize(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        backend="gloo", device="cpu")
    mesh = make_mesh(world, device="cpu")
    with open(workdir / "jobs.pkl", "rb") as f:
        jobs = pickle.load(f)
    results = {}
    for name, (task, kw) in jobs.items():
        if task == "topology":
            kw = dict(kw, topology=topology)
        results[name] = TASKS[task](mesh, **kw)
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "radar_slam_tpu")
                   for m in sys.modules), "a rank worker imported JAX"
    with open(workdir / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
