"""K1': the one-pass kernel's non-default branches in the port
(radar_slam_tpu_torch/ops/frontend.py) against the reference kernel
(ops/frontend_pallas.py) run in interpret mode.

- Time-domain noise, the prefix-sum CA-CFAR and the clutter input, on K1
  (split factors) and K3 (dense factors), at sigma = 0: interpret mode's
  PRNG is degenerate, so parity with noise is checked on the card (kernel
  against plain version, identical Philox words) and here statistically.
  Tolerances are K1's (tests/test_torch_frontend.py): the power map to
  1e-5 of its maximum (float32 products against the reference's bf16x3),
  signatures of matched valid slots within 2e-4; the detection sets must
  be identical.
- The reference wrappers' defaults (time domain, Box-Muller, plain top-K):
  both packages called with the required arguments only agree.
- The prefix-sum threshold alone against the reference's, within 1e-5 dB.
- The noise each branch adds is ``standard_normals`` of the frame seed at
  element (a*C + c) * S + s, bit for bit, and Box-Muller's is normal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np
from jax.experimental.pallas import tpu as pltpu

from radar_slam_tpu.ops import frontend_pallas as jfe
from radar_slam_tpu.ops.windows import window_freq_taps as jtaps
from radar_slam_tpu.signal import detect as jdet
from radar_slam_tpu.signal.rds import _mix_vector as jmix
from radar_slam_tpu.signal.synth import fast_time_base as jtime
from radar_slam_tpu.signal.synth import synthesis_factors as jdense
from radar_slam_tpu.signal.synth import synthesis_factors_split as jsplit
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops.noise import standard_normals
from radar_slam_tpu_torch.ops.windows import window_freq_taps
from radar_slam_tpu_torch.signal.rds import _mix_vector
from radar_slam_tpu_torch.signal.synth import (fast_time_base,
                                               synthesis_factors,
                                               synthesis_factors_split)

F = 2
SEEDS = np.arange(F, dtype=np.int32) + 29


@pytest.fixture(scope="module")
def scene():
    ref_cfg = bench_config(noise_power=0.0)
    cfg = config_from_dict(dataclasses.asdict(ref_cfg))
    jbatch, fields, _ = scene_fields(F)
    C, S = cfg.radar.num_chirps, cfg.radar.samples_per_chirp
    d = cfg.detection
    lo, hi = jdet.range_gate_bin_interval(ref_cfg.radar, S, d)
    required = dict(train=d.cfar_train_cells, guard=d.guard_cells,
                    neighborhood=d.neighborhood, offset_db=d.cfar_offset_db,
                    threshold_db=d.threshold_db, min_range_bin=lo,
                    max_range_bin=hi)
    return dict(ref_cfg=ref_cfg, cfg=cfg, jbatch=jbatch,
                batch=scatterer_batch_from_numpy(fields, "cpu"), C=C, S=S,
                K=d.max_detections, required=required)


def _reference(sc, kind, **kw):
    """The reference wrapper in interpret mode, waited on (its
    io_callbacks dispatch JAX work of their own)."""
    cfg = sc["ref_cfg"]
    C, S = sc["C"], sc["S"]
    mix = jmix(cfg.radar, cfg.window, "baseband", S)
    with pltpu.force_tpu_interpret_mode():
        if kind == "split":
            f = jax.vmap(lambda s: jsplit(s, cfg.radar))(sc["jbatch"])
            out = jfe.scatterer_frontend_split(
                f.ant, f.dopp, f.coarse, f.fine, f.tau, jtime(cfg.radar),
                jnp.asarray(SEEDS), mix, C, 0.0, sc["K"], **sc["required"],
                **kw)
        else:
            e_ac, e_fast = jax.vmap(lambda s: jdense(s, cfg.radar))(
                sc["jbatch"])
            out = jfe.scatterer_frontend(
                e_ac, e_fast, jnp.asarray(SEEDS), mix, C, 0.0, sc["K"],
                **sc["required"], **kw)
        return tuple(map(np.asarray, jax.block_until_ready(out)))


def _port(sc, kind, **kw):
    cfg = sc["cfg"]
    C, S = sc["C"], sc["S"]
    mix = _mix_vector(cfg.radar, cfg.window, "baseband", S)
    if kind == "split":
        f = synthesis_factors_split(sc["batch"], cfg.radar)
        out = fe.scatterer_frontend_split(
            f.ant, f.dopp, f.coarse, f.fine, f.tau, fast_time_base(cfg.radar),
            torch.tensor(SEEDS), mix, C, 0.0, sc["K"], **sc["required"],
            **kw)
    else:
        e_ac, e_fast = synthesis_factors(sc["batch"], cfg.radar)
        out = fe.scatterer_frontend(e_ac, e_fast, torch.tensor(SEEDS), mix,
                                    C, 0.0, sc["K"], **sc["required"], **kw)
    return tuple(map(to_np, out))


def _detections(rb, db, vals):
    return {(f, int(r), int(d)) for f in range(rb.shape[0])
            for r, d, ok in zip(rb[f], db[f], vals[f] > -np.inf) if ok}


def _assert_matches(ref, got):
    (p1, rb1, db1, v1, s1), (p2, rb2, db2, v2, s2) = ref, got
    assert p2.shape == p1.shape
    assert np.abs(p2 - p1).max() / p1.max() < 1e-5
    set1, set2 = _detections(rb1, db1, v1), _detections(rb2, db2, v2)
    assert len(set1) > 10 * F
    assert set1 == set2, (len(set1 ^ set2), len(set1))
    both = (v1 > -np.inf) & (v2 > -np.inf) & (rb1 == rb2) & (db1 == db2)
    assert np.abs(s1[both] - s2[both]).max() < 2e-4
    assert np.array_equal(np.isneginf(v1), np.isneginf(v2))
    return set1


def _clutter_map(sc, kind):
    """A background map that gates about a third of the cells: the plain
    power map scaled by uniform factors in [0, 0.4] (a cell passes where
    its factor is below 10^-0.6 = 0.25)."""
    p = _port(sc, kind, noise_domain="range_freq",
              noise_taps=window_freq_taps(sc["cfg"].window),
              doppler_window=sc["cfg"].doppler_window)[0]
    u = np.random.default_rng(3).uniform(0.0, 0.4, p.shape)
    return (p * u).astype(np.float32)


BRANCHES = {
    "time": dict(noise_domain="time", noise_impl="fast"),
    "cumsum": dict(noise_domain="range_freq", cfar_impl="cumsum"),
    "clutter": dict(noise_domain="range_freq"),
}


@pytest.mark.parametrize("kind", ["split", "dense"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_k1prime_branch_matches_reference_interpret(scene, kind, branch):
    kw = dict(BRANCHES[branch], doppler_window=scene["cfg"].doppler_window)
    ref_kw, port_kw = dict(kw), dict(kw)
    if kw["noise_domain"] == "range_freq":
        ref_kw["noise_taps"] = jtaps(scene["cfg"].window)
        port_kw["noise_taps"] = window_freq_taps(scene["cfg"].window)
    if branch == "clutter":
        clut = _clutter_map(scene, kind)
        ref_kw["clutter"] = jnp.asarray(clut)
        port_kw["clutter"] = torch.tensor(clut)
    ref = _reference(scene, kind, **ref_kw)
    got = _port(scene, kind, **port_kw)
    dets = _assert_matches(ref, got)
    if branch == "clutter":
        free = _detections(*_port(scene, kind, **dict(
            port_kw, clutter=None))[1:4])
        assert dets < free, (len(dets), len(free))


@pytest.mark.parametrize("kind", ["split", "dense"])
def test_required_arguments_only_agree(scene, kind):
    """The reference wrappers' defaults are the port's: time-domain noise,
    Box-Muller, plain top-K, no Doppler window, DC removal."""
    _assert_matches(_reference(scene, kind), _port(scene, kind))


@pytest.mark.parametrize("shape,train,guard", [
    ((32, 400), 8, 2), ((16, 37), 3, 0), ((7, 5), 2, 1), ((32, 400), 0, 0),
    ((64, 128), 5, 3)])
def test_cumsum_threshold_matches_reference(shape, train, guard):
    """The prefix-sum threshold in the reference's add order: within
    1e-5 dB of the reference's.  The box-sum form sums in another order;
    differencing prefix sums that carry 1e4x-bright cells cancels digits,
    so the two forms agree to 1e-2 dB only."""
    rng = np.random.default_rng(train * 10 + guard)
    p1 = (rng.exponential(1e-6, shape) + 1e-12).astype(np.float32)
    p1[rng.random(shape) < 0.01] *= 1e4                    # bright cells
    C, S = shape
    want = np.asarray(jfe._cfar_threshold_cumsum(
        jnp.asarray(p1), train=train, guard=guard, offset_db=12.0,
        threshold_db=-125.0, C=C, S=S))
    prm = fe.FrontendParams(
        sigma=0.0, noise_taps=(), echo_upper=None, dc_removal=True,
        train=train, guard=guard, neighborhood=3, offset_db=12.0,
        threshold_db=-125.0, min_range_bin=0, max_range_bin=S - 1,
        noise_domain="range_freq", noise_impl="fast", cfar_impl="cumsum",
        clutter_offset_db=6.0)
    got = to_np(fe._cfar_threshold_cumsum(torch.tensor(p1), prm))
    assert np.abs(got - want).max() < 1e-5
    box = to_np(fe._cfar_threshold(torch.tensor(p1), prm))
    assert np.abs(box - want).max() < 1e-2


def _noise_prm(domain, impl, S):
    # Unit noise on the identity range product (time) or on a single unit
    # tap (range frequency): Z is the drawn plane itself.
    return fe.FrontendParams(
        sigma=1.0 if domain == "time" else 1.0 / S ** 0.5,
        noise_taps=((0, 1.0),), echo_upper=None, dc_removal=False, train=8,
        guard=2, neighborhood=3, offset_db=12.0, threshold_db=-25.0,
        min_range_bin=0, max_range_bin=S - 1, noise_domain=domain,
        noise_impl=impl, cfar_impl="matmul", clutter_offset_db=6.0)


@pytest.mark.parametrize("domain", ["time", "range_freq"])
@pytest.mark.parametrize("impl", ["fast", "box_muller"])
def test_branch_noise_is_the_seeded_plane(domain, impl):
    """With zero factors, each branch's Z is the standard-normal plane of
    ``standard_normals`` for the frame seed, at element (a*C + c) * S + s,
    bit for bit -- the words the CUDA kernel draws -- and it is normal."""
    Fn, Sc, A, C, S = 2, 16, 8, 32, 400
    seeds = torch.tensor([7, -123456789], dtype=torch.int32)
    e_ac = torch.zeros((Fn, Sc, A * C), dtype=torch.complex64)
    e_fast = torch.zeros((Fn, Sc, S), dtype=torch.complex64)
    w_rng = torch.eye(S, dtype=torch.complex64)
    w_dop_t = torch.eye(C, dtype=torch.complex64)
    zr, zi, _, _ = fe.frontend_kernel_dense(
        e_ac, e_fast, seeds, w_rng, w_dop_t, _noise_prm(domain, impl, S), C)
    gr, gi = standard_normals(seeds, A * C, S, impl)
    assert torch.equal(zr, gr.transpose(1, 2))
    assert torch.equal(zi, gi.transpose(1, 2))
    x = torch.cat([zr.flatten(), zi.flatten()]).double()
    assert abs(x.mean().item()) < 0.01 and abs(x.std().item() - 1.0) < 0.01
    kurt = ((x - x.mean()) ** 4).mean().item() / x.var().item() ** 2
    assert abs(kurt - 3.0) < 0.05


def test_branch_launch_counts_stay_on_the_cpu(scene):
    """On the CPU the wrappers run the plain version: neither the launch
    count nor a branch count moves."""
    before = (fe.frontend_kernel_split.launches,
              dict(fe.frontend_kernel_split.branch_launches))
    _port(scene, "split", cfar_impl="cumsum", noise_impl="box_muller",
          clutter=torch.zeros(F, scene["S"], scene["C"]))
    assert (fe.frontend_kernel_split.launches,
            fe.frontend_kernel_split.branch_launches) == before
    prm = _noise_prm("time", "box_muller", 400)
    assert fe._branches(prm, None) == ("time", "box_muller")
    prm = dataclasses.replace(prm, cfar_impl="cumsum",
                              noise_domain="range_freq", noise_impl="fast")
    assert fe._branches(prm, torch.zeros(1)) == ("cumsum", "clutter")
