"""Shared setup for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made once with numpy (the scene generator's numpy core) and
handed to both packages: the JAX reference as jnp arrays, the port through
``scatterer_batch_from_numpy``.  Results come back as numpy for comparison.
"""

import dataclasses

import numpy as np

from radar_slam_tpu.core.config import complete_analysis_config


def bench_config(noise_power=None):
    """The bench operating point: complete_analysis_config with
    max_scatterers=128 (bench.py:364)."""
    cfg = dataclasses.replace(complete_analysis_config(), max_scatterers=128)
    if noise_power is not None:
        cfg = dataclasses.replace(
            cfg, radar=dataclasses.replace(cfg.radar,
                                           noise_power=noise_power))
    return cfg


def scene_fields(num_frames, seed=7, num_points=96, max_scatterers=128):
    """The bench scene (bench.py:69-74) as numpy columns + ground truth,
    generated by the reference's numpy core."""
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
    cfg = bench_config()
    batch, gt = constant_motion_scene(
        seed, num_frames=num_frames, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=num_points,
                          max_scatterers=max_scatterers))
    fields = {k: np.asarray(v) for k, v in batch._asdict().items()
              if v is not None}
    return batch, fields, gt


def to_np(x):
    """numpy view of a torch tensor or a JAX array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
