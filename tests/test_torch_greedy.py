"""Greedy association (``VelocityConfig.association_method="greedy"``) in
the port against the JAX reference on the CPU.

- ``associate_targets`` on the reference's gate scene
  (tests/test_motion.py:112), and on seeded target sets [F, K] that force
  ties (duplicated previous and current targets: ``argmin`` takes the
  first minimum in both), all-unmatchable rows (unreliable targets: every
  distance 1e9) and the gate edge (a distance of exactly 5.0 m is no
  match, 4.99 m is), under both metrics, and with ``group`` and
  ``sensor_pos`` (the mounted rig's blocks and sensor origins).  Indices
  and masks exact, every float output to rtol 1e-6 and atol 1e-4, as
  tests/test_torch_tail.py holds the mutual association (the apparent
  velocity divides float32 position differences by dt = 0.1 s).
- The drivers at greedy against the reference's at sigma = 0, 3 frames of
  the bench scene on the materialized route with the reference's
  synthesis evaluated eagerly (``_torch_parity.patch_eager_synthesis``):
  ``process_sequence_batched`` and ``process_sequence``; counts and solve
  outcomes exact, velocities to 1e-3 m/s, poses to 1e-4 m
  (tests/test_torch_sequential.py's tolerances there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (bench_config, patch_eager_synthesis,
                           scene_fields, to_np)

from radar_slam_tpu.core import types as jtypes
from radar_slam_tpu.core.config import VelocityConfig as JVelocity
from radar_slam_tpu.motion.associate import associate_targets as jassoc
from radar_slam_tpu.pipeline import frame as jframe
from radar_slam_tpu_torch.core import types as ttypes
from radar_slam_tpu_torch.core.config import VelocityConfig, config_from_dict
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.motion.associate import associate_targets as tassoc
from radar_slam_tpu_torch.pipeline import frame as tframe

DT = 0.1
A = 8
JGREEDY = JVelocity(association_method="greedy")
TGREEDY = VelocityConfig(association_method="greedy")


def _targets(rng_m, az, reliable=None, el=None, seed=0):
    """Target fields [F, K] as numpy: the given ranges and azimuths,
    random signatures and confidences."""
    rng_m = np.atleast_2d(np.asarray(rng_m, np.float32))
    F, K = rng_m.shape
    r = np.random.default_rng(seed)
    sig = (r.standard_normal((F, K, A))
           + 1j * r.standard_normal((F, K, A))).astype(np.complex64)
    ones = np.ones((F, K), bool)
    return dict(
        range_bin=np.tile(np.arange(K, dtype=np.int32), (F, 1)),
        doppler_bin=np.zeros((F, K), np.int32), range_m=rng_m,
        doppler_hz=np.zeros((F, K), np.float32),
        vr_mps=r.uniform(-5, 5, (F, K)).astype(np.float32),
        power_db=np.zeros((F, K), np.float32),
        azimuth_rad=np.atleast_2d(np.asarray(az, np.float32)),
        confidence=r.uniform(0.5, 1.0, (F, K)).astype(np.float32),
        num_sources=np.ones((F, K), np.int32),
        is_multipath=~ones,
        is_reliable=ones if reliable is None else np.asarray(reliable),
        spatial_signature=sig, valid=ones,
        elevation_rad=(None if el is None
                       else np.atleast_2d(np.asarray(el, np.float32))))


def _compare(cur, prev, metric="cartesian", sensor_pos=None, group=None):
    """The port over [F, K] and the reference vmapped over frames; returns
    the port's Associations as numpy."""
    def jax_t(d):
        return jtypes.Targets(**{k: None if v is None else jnp.asarray(v)
                                 for k, v in d.items()})

    def torch_t(d):
        return ttypes.Targets(**{k: None if v is None else torch.tensor(v)
                                 for k, v in d.items()})

    jkw = dict(metric=metric,
               sensor_pos=None if sensor_pos is None
               else jnp.asarray(sensor_pos),
               group=None if group is None else jnp.asarray(group))
    want = jax.vmap(lambda c, p: jassoc(c, p, DT, JGREEDY, **jkw))(
        jax_t(cur), jax_t(prev))
    got = tassoc(torch_t(cur), torch_t(prev), DT, TGREEDY, metric=metric,
                 sensor_pos=None if sensor_pos is None
                 else torch.tensor(sensor_pos),
                 group=None if group is None else torch.tensor(group))
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), to_np(getattr(got, name))
        assert g.shape == w.shape, name
        if w.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(g, w, name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4,
                                       err_msg=name)
    return {name: to_np(getattr(got, name)) for name in want._fields}


def test_greedy_gate_scene_matches_reference():
    """tests/test_motion.py:112: targets at 10 and 20 m match their
    neighbours 0.5 and 1 m away; the 40 m one has none inside 5 m."""
    cur = _targets([10.0, 20.0, 40.0], [0.0, 0.3, -0.2])
    prev = _targets([10.5, 21.0, 90.0], [0.0, 0.3, 0.5], seed=1)
    out = _compare(cur, prev)
    np.testing.assert_array_equal(out["valid"], [[True, True, False]])
    np.testing.assert_array_equal(out["prev_index"][0, :2], [0, 1])


def _random_sets(kind, F=4, K=12, seed=0):
    r = np.random.default_rng(seed)
    rng_c = r.uniform(5, 40, (F, K))
    az_c = r.uniform(-0.6, 0.6, (F, K))
    rng_p = rng_c + r.normal(0, 1.5, (F, K))
    az_p = az_c + r.normal(0, 0.05, (F, K))
    rel_c = r.random((F, K)) > 0.15
    rel_p = r.random((F, K)) > 0.15
    if kind == "ties":
        # Previous targets 2 and 3 duplicate 1, current 5 duplicates 4:
        # equal distances; the first minimum and the used mask decide.
        rng_p[:, 2:4], az_p[:, 2:4] = rng_p[:, 1:2], az_p[:, 1:2]
        rng_c[:, 5], az_c[:, 5] = rng_c[:, 4], az_c[:, 4]
        rng_c[:, 6], az_c[:, 6] = rng_p[:, 1], az_p[:, 1]
        rel_c[:] = rel_p[:] = True
    elif kind == "all_big":
        # Frame 0: no reliable previous target (every row 1e9); frame 1:
        # no reliable current target; frame 2: one current target only.
        rel_p[0] = False
        rel_c[1] = False
        rel_c[2] = np.arange(K) == 3
    elif kind == "gate_edge":
        # On the x axis the distance is the range difference: 5.0 m (at
        # the gate: no match) and 4.99 m (a match).
        az_c[:, :4] = az_p[:, :4] = 0.0
        rng_c[:, :4] = [10.0, 20.0, 30.0, 41.0]
        rng_p[:, :4] = [15.0, 24.99, 35.0, 45.99]
        rng_p[:, 4:] += 60.0
        rel_c[:] = rel_p[:] = True
    cur = _targets(rng_c, az_c, rel_c, seed=seed)
    prev = _targets(rng_p, az_p, rel_p, seed=seed + 1)
    return cur, prev


@pytest.mark.parametrize("metric", ["cartesian", "polar"])
@pytest.mark.parametrize("kind", ["random", "ties", "all_big", "gate_edge"])
def test_greedy_claims_match_reference(kind, metric):
    cur, prev = _random_sets(kind)
    out = _compare(cur, prev, metric)
    hit = out["valid"]
    if kind == "ties":
        assert hit.sum() > 0
    if kind == "all_big":
        assert not hit[:2].any() and hit[2].sum() <= 1
    if kind == "gate_edge" and metric == "cartesian":
        np.testing.assert_array_equal(hit[:, :4],
                                      [[False, True, False, True]] * 4)
    # No previous target is claimed twice.
    for f in range(hit.shape[0]):
        claimed = out["prev_index"][f][hit[f]]
        assert len(set(claimed.tolist())) == len(claimed)


def test_greedy_with_groups_and_sensor_origins_matches_reference():
    """Two sensor blocks of 6 slots: matches stay within equal ids, and the
    lines of sight run from each target's sensor."""
    cur, prev = _random_sets("random", K=12, seed=3)
    group = np.repeat(np.arange(2, dtype=np.int32), 6)
    sensor_pos = np.repeat(np.array([[1.8, 0.9, 0.0], [1.8, -0.9, 0.0]],
                                    np.float32), 6, axis=0)
    out = _compare(cur, prev, sensor_pos=sensor_pos, group=group)
    hit = out["valid"]
    assert hit.sum() > 0
    assert (group[out["prev_index"]][hit]
            == np.broadcast_to(group, hit.shape)[hit]).all()


@pytest.mark.parametrize("driver", ["process_sequence_batched",
                                    "process_sequence"])
def test_drivers_at_greedy_match_reference(driver, monkeypatch):
    patch_eager_synthesis(monkeypatch, jframe)
    ref_cfg = dataclasses.replace(
        bench_config(noise_power=0.0), synth_in_kernel=False,
        velocity=dataclasses.replace(bench_config().velocity,
                                     association_method="greedy"))
    cfg = config_from_dict(dataclasses.asdict(ref_cfg))
    jbatch, fields, _ = scene_fields(3)
    batch = scatterer_batch_from_numpy(fields, "cpu")
    ref = getattr(jframe, driver)(jbatch, jax.random.key(0), ref_cfg)
    got = getattr(tframe, driver)(batch, torch.Generator(), cfg)
    assert np.asarray(ref.num_associations)[1:].min() > 5
    for name in ("num_detections", "num_reliable", "num_associations"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_array_equal(to_np(got.motion.success),
                                  np.asarray(ref.motion.success))
    np.testing.assert_allclose(to_np(got.motion.velocity),
                               np.asarray(ref.motion.velocity), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(to_np(got.pose), np.asarray(ref.pose),
                               rtol=0, atol=1e-4)
