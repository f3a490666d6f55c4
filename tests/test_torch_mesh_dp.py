"""The port's mesh and frame-parallel driver (``radar_slam_tpu_torch/
parallel/{mesh,dp}.py``) on 1, 2 and 4 gloo ranks on the CPU.

Inputs are tests/test_multiseq.py's configuration (16 chirps, 128 samples)
on an 8-frame constant-motion scene made by the reference's numpy core:

- over ADC cubes (the reference's noisy synthesis), ``process_frames_dp``
  against the reference's on ``make_mesh(1/2/4)`` at the tolerances of
  tests/test_torch_cube_pipeline.py (success equal; velocity within 0.05
  m/s and half the frames within 1e-3; pose 1e-2 m), and against the
  port's ``process_signal_sequence_batched`` within 1e-5;
- over scatterers, ``process_frames_dp_scatterers`` against the port's
  ``process_sequence_batched`` on the same generator within 1e-5 (that
  driver is held to the reference's composition elsewhere) and success
  equal;
- the prefix-sum pose tracks the ground truth (tests/test_parallel.py:
  103-110).

Each world size is started once, by the module fixture ``ranks``; every
rank's gathered output is the same.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_rank_worker import run_ranks

from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
from radar_slam_tpu.parallel import dp as jdp
from radar_slam_tpu.parallel import mesh as jmesh
from radar_slam_tpu.signal.synth import synthesize_frames_batch as jsynth
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.core.types import (scatterer_batch_from_numpy,
                                             signals_from_numpy)
from radar_slam_tpu_torch.parallel import mesh as tmesh
from radar_slam_tpu_torch.pipeline import frame as tframe
from tests.test_multiseq import CFG

WORLDS = (1, 2, 4)
SEED = 5


@pytest.fixture(scope="module")
def scene():
    batch, gt = constant_motion_scene(
        3, num_frames=8, dt=CFG.frame_dt, v_body=(6.0, 0.0), yaw_rate=0.1,
        scene=SceneConfig(num_points=40, max_scatterers=CFG.max_scatterers))
    fields = {k: np.asarray(v) for k, v in batch._asdict().items()
              if v is not None}
    cubes = np.asarray(jsynth(batch, CFG.radar, jax.random.key(1)))
    return fields, cubes, gt


@pytest.fixture(scope="module")
def ranks(scene, tmp_path_factory):
    fields, cubes, _ = scene
    cfg = dataclasses.asdict(CFG)
    jobs = {"cubes": ("dp_cubes", dict(signals=cubes, cfg=cfg)),
            "scatterers": ("dp_scatterers",
                           dict(fields=fields, cfg=cfg, seed=SEED))}
    out = {}
    for w in WORLDS:
        res = run_ranks(jobs, w, tmp_path_factory.mktemp(f"dp{w}"))
        for r in res[1:]:
            for job in jobs:
                for k, v in r[job].items():
                    np.testing.assert_array_equal(v, res[0][job][k])
        out[w] = res[0]
    return out


def test_mesh_without_a_process_group():
    m = tmesh.make_mesh(device="cpu")
    assert (m.size, m.rank, m.device) == (1, 0, torch.device("cpu"))
    assert tmesh.make_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError, match="requested 2 devices"):
        tmesh.make_mesh(2, device="cpu")
    x = torch.arange(6)
    assert m.gather(x) is x and m.all_reduce(x) is x
    assert m.block(6) == slice(0, 6)
    two = tmesh.Mesh(None, 2, 1, torch.device("cpu"))
    assert two.block(6) == slice(3, 6)
    np.testing.assert_array_equal(two.take({"a": x})["a"], [3, 4, 5])
    with pytest.raises(ValueError, match="equal blocks"):
        two.block(5)
    for n, d in ((16, 8), (17, 8), (1, 4), (9, 2)):
        assert tmesh.pad_frames_to_devices(n, d) == \
            jmesh.pad_frames_to_devices(n, d)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_cubes_match_reference(scene, ranks, world):
    _, cubes, _ = scene
    want = jdp.process_frames_dp(cubes, CFG, jmesh.make_mesh(world))
    got = ranks[world]["cubes"]
    np.testing.assert_array_equal(got["success"], np.asarray(want["success"]))
    dv = np.abs(got["velocity"] - np.asarray(want["velocity"]))
    assert dv.max() < 0.05, dv
    assert (dv.max(axis=1) < 1e-3).sum() >= len(dv) // 2, dv
    np.testing.assert_allclose(got["pose"], np.asarray(want["pose"]),
                               rtol=0, atol=1e-2)
    assert got["success"][1:].all()


@pytest.mark.parametrize("world", WORLDS)
def test_dp_cubes_match_batched_driver(scene, ranks, world):
    _, cubes, _ = scene
    ref = tframe.process_signal_sequence_batched(
        signals_from_numpy(cubes, "cpu"), config_from_dict(
            dataclasses.asdict(CFG)))
    got = ranks[world]["cubes"]
    np.testing.assert_array_equal(got["success"], ref.motion.success.numpy())
    for key, want in (("velocity", ref.motion.velocity),
                      ("angular_velocity", ref.motion.angular_velocity),
                      ("pose", ref.pose)):
        np.testing.assert_allclose(got[key], want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_scatterers_match_batched_driver(scene, ranks, world):
    fields, _, _ = scene
    ref = tframe.process_sequence_batched(
        scatterer_batch_from_numpy(fields, "cpu"),
        torch.Generator().manual_seed(SEED),
        config_from_dict(dataclasses.asdict(CFG)))
    got = ranks[world]["scatterers"]
    np.testing.assert_array_equal(got["success"], ref.motion.success.numpy())
    np.testing.assert_array_equal(got["num_associations"],
                                  ref.motion.num_targets.numpy())
    for key, want in (("velocity", ref.motion.velocity),
                      ("rmse", ref.motion.rmse), ("pose", ref.pose)):
        np.testing.assert_allclose(got[key], want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_dp_pose_prefix_sum(scene, ranks):
    """The distributed prefix-sum pose tracks the ground truth loosely
    (open loop), as tests/test_parallel.py::test_dp_pose_prefix_sum
    asks of the reference."""
    _, _, gt = scene
    pose = ranks[4]["cubes"]["pose"]
    err = np.linalg.norm(pose[:, :2] - np.asarray(gt["poses"])[:, :2], axis=1)
    assert err[-1] < 1.5, err
