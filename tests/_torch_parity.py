"""Shared setup for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made once with numpy (the scene generator's numpy core) and
handed to both packages: the JAX reference as jnp arrays, the port through
``scatterer_batch_from_numpy``.  Results come back as numpy for comparison.
"""

import dataclasses
import functools

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


def patch_eager_synthesis(monkeypatch, *modules):
    """Replace ``synthesize_frame`` in each of the reference's ``modules``
    by its eager evaluation off the trace: a host callback into the port's
    synthesis, which equals the reference's eager form.  Jitted, the
    reference rounds its float32 synthesis phases otherwise than eagerly.
    For configurations with noise_power 0 (the noise key is unused)."""
    import jax
    import jax.numpy as jnp
    import torch

    from radar_slam_tpu_torch.core import config as tcfg
    from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
    from radar_slam_tpu_torch.signal.synth import synthesize_frame

    def host(radar, fidelity, *cols):
        names = ("range_m", "azimuth_rad", "rcs_db", "vr", "valid",
                 "elevation_rad")
        batch = scatterer_batch_from_numpy(
            {n: np.asarray(c)[None] for n, c in zip(names, cols)}, "cpu")
        return to_np(synthesize_frame(batch, radar,
                                      torch.zeros(1, dtype=torch.int32),
                                      add_noise=False,
                                      fidelity=fidelity))[0]

    def synth(scatterers, cfg, key, output="baseband", add_noise=True,
              fidelity="tpu"):
        assert cfg.noise_power == 0.0 and output == "baseband"
        radar = tcfg.RadarConfig(**dataclasses.asdict(cfg))
        cols = [scatterers.range_m, scatterers.azimuth_rad,
                scatterers.rcs_db, scatterers.vr, scatterers.valid]
        if scatterers.elevation_rad is not None:
            cols.append(scatterers.elevation_rad)
        shape = jax.ShapeDtypeStruct(
            (cfg.num_antennas, cfg.num_chirps, cfg.samples_per_chirp),
            jnp.complex64)
        return jax.pure_callback(functools.partial(host, radar, fidelity),
                                 shape, *cols, vmap_method="sequential")

    for module in modules:
        monkeypatch.setattr(module, "synthesize_frame", synth)
