"""Process-group initialization and the multi-process smoke runs of the
port (``radar_slam_tpu_torch/parallel/distributed.py``,
``dryrun_multichip_torch.py``), on the CPU over gloo.

- ``initialize`` with no world is one process, with the reference's
  topology keys (tests/test_host_utils.py:32);
- ``initialize`` from torchrun's variables (one rank) and from its
  arguments (the two ranks of the smoke run);
- two ranks: a cross-rank all-reduce and gather, and one frame-parallel
  step over the reference dry run's tiny radar (tests/test_distributed.py,
  tests/_distributed_worker.py): finite, the same on both ranks, and
  within 1e-5 of the one-rank run;
- ``dryrun_multichip_torch.py`` at 4 ranks: every collective path, each
  rank held to its one-rank run.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch
from _torch_rank_worker import free_port, run_ranks

from radar_slam_tpu.parallel import distributed as jdist
from radar_slam_tpu_torch.parallel import distributed as tdist
from radar_slam_tpu_torch.parallel import dp
from radar_slam_tpu_torch.parallel.mesh import make_mesh

REPO = Path(__file__).resolve().parents[1]


def tiny():
    sys.path.insert(0, str(REPO))
    from dryrun_multichip_torch import tiny_config
    return tiny_config()


def test_initialize_without_a_world_is_one_process(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    info = tdist.initialize(device="cpu")
    want = jdist.initialize()
    assert set(want) <= set(info)
    for key in ("process_index", "process_count"):
        assert info[key] == want[key], key
    # One device a rank (the reference's process here holds 8 virtual
    # CPU devices).
    assert info["local_devices"] == info["global_devices"] == 1
    assert info["backend"] is None
    assert not tdist.is_multihost()


def test_initialize_from_environment():
    """torchrun's variables at one rank: a gloo group of one."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        from radar_slam_tpu_torch.parallel import distributed
        from radar_slam_tpu_torch.parallel.mesh import make_mesh
        topo = distributed.initialize(device="cpu")
        mesh = make_mesh(device="cpu")
        print(json.dumps(dict(topo, multihost=distributed.is_multihost(),
                              size=mesh.size)))
    """)
    env = dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    topo = json.loads(out.stdout.strip().splitlines()[-1])
    assert topo == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1,
                    "backend": "gloo", "device": "cpu", "multihost": False,
                    "size": 1}


def test_two_process_smoke(tmp_path):
    cfg = tiny()
    rng = np.random.default_rng(0)
    A, C, S = 8, 8, cfg.radar.samples_per_chirp
    cubes = (rng.standard_normal((4, A, C, S)).astype(np.float32)
             + 1j * rng.standard_normal((4, A, C, S)).astype(np.float32)
             ).astype(np.complex64)
    res = run_ranks({"topo": ("topology", {}),
                     "dp": ("dp_cubes", dict(signals=cubes,
                                             cfg=dataclasses.asdict(cfg)))},
                    2, tmp_path)
    want = dp.process_frames_dp(torch.from_numpy(cubes), cfg,
                                make_mesh(1, device="cpu"))
    for rank, r in enumerate(res):
        t = r["topo"]
        assert t["topology"]["process_index"] == rank
        assert t["topology"]["process_count"] == 2
        assert t["topology"]["backend"] == "gloo"
        assert t["multihost"] and t["size"] == 2 and t["rank"] == rank
        assert t["all_reduce"] == 3.0
        np.testing.assert_array_equal(t["gather"], [0, 0, 1, 1])
        assert np.isfinite(r["dp"]["pose"]).all()
        assert r["dp"]["pose"].shape == (4, 3)
        for key, v in r["dp"].items():
            np.testing.assert_array_equal(v, res[0]["dp"][key])
            np.testing.assert_allclose(v, want[key].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=key)


def test_dryrun_multichip_torch_at_four_ranks():
    out = subprocess.run(
        [sys.executable, str(REPO / "dryrun_multichip_torch.py"), "--ranks",
         "4", "--device", "cpu"], capture_output=True, text=True,
        timeout=300, cwd=str(REPO))
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "dryrun_multichip_torch(4) OK"
    assert sorted(ln for ln in lines if ln.startswith("rank ")) == [
        f"rank {r}/4 (gloo, cpu): OK" for r in range(4)]
