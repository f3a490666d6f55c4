"""The plain reference against the port at a tiny size on the CPU, and
K1's work count."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import common, compare
from portbench.reference import pipeline as ref
from portbench.work import k1

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {p.stem: json.loads(p.read_text())
           for p in sorted((ROOT / "portbench/configs").glob("*.json"))}


def _config(name):
    from radar_slam_tpu_torch.core.config import config_from_dict
    from portbench.reference.core.config import config_from_dict as rc
    d = CONFIGS[name]["pipeline"]
    return config_from_dict(d), rc(d)


def test_reference_matches_the_batched_driver():
    from radar_slam_tpu_torch.pipeline.frame import process_sequence_batched
    from portbench.scenes import constant_motion
    cfg, rcfg = _config("bench_s128")
    cols, _ = constant_motion.make(CONFIGS["bench_s128"]["scene"], 20, 3,
                                   cfg.max_scatterers, cfg.frame_dt)
    out = process_sequence_batched(common.program_batch(cols, "cpu"),
                                   torch.Generator().manual_seed(9), cfg)
    want = ref.batched(common.reference_batch(cols, "cpu"),
                       common.noise_seeds(9, 20, "cpu"), rcfg)
    got = compare.numbers(
        common.frame_numbers(out).numpy(), want.rows,
        {"detections": 10, "reliable": 11, "associations": 12},
        out.target_xy.numpy(), out.target_valid.numpy(),
        want.target_xy, want.target_valid)
    assert int(out.num_detections.sum()) > 0
    # The port's plain front end uses the float32 range constant (~1e-5 of
    # max |Z| from the exact DFT): no flip at this size.
    rpe, gap = got.pop("pose_rpe_m"), got.pop("pose_gap_m")
    assert got == dict.fromkeys(got, 0.0)
    assert rpe < 1e-4 and gap < 1e-3
    # The independent witness: the scene's own motion (8.0, 0.5) m/s and
    # 0.05 rad/s, which neither side is given.
    v = np.median(want.rows[1:, 3:5], axis=0)
    assert np.abs(v - [8.0, 0.5]).max() < 0.05
    assert abs(np.median(want.rows[1:, 8]) - 0.05) < 0.02


def test_reference_matches_the_rig_driver():
    from radar_slam_tpu_torch.io.prefetch import \
        process_sequence_rig_batched_prefetch
    from portbench.scenes import radarscenes_rig
    cfg, rcfg = _config("radarscenes_s512")
    cols, rig = radarscenes_rig.make(CONFIGS["radarscenes_s512"]["scene"], 6,
                                     4, cfg.max_scatterers, cfg.frame_dt)
    out = process_sequence_rig_batched_prefetch(
        common.host_batch(cols), torch.Generator().manual_seed(2), cfg, rig,
        chunk=4, device="cpu")
    want = ref.rig_batched(common.reference_batch(cols, "cpu"),
                           common.noise_seeds(2, 24, "cpu").reshape(6, 4),
                           rcfg, rig)
    rows = common.frame_numbers(out).numpy()
    np.testing.assert_array_equal(rows[:, 9:], want.rows[:, 9:])
    assert np.abs(rows[:, :3] - want.rows[:, :3]).max() < 1e-3
    assert np.abs(rows[:, 3:9] - want.rows[:, 3:9]).max() < 1e-3


def test_reference_matches_the_streaming_analyzer():
    from radar_slam_tpu_torch.pipeline.streaming import StreamingAnalyzer
    from portbench.scenes import constant_motion
    cfg, rcfg = _config("bench_s128")
    cols, _ = constant_motion.make(CONFIGS["bench_s128"]["scene"], 5, 8,
                                   cfg.max_scatterers, cfg.frame_dt)
    a = StreamingAnalyzer(cfg, device="cpu")
    for j in range(5):
        a.process_frame(common.program_batch(
            {k: v[j:j + 1] for k, v in cols.items()}, "cpu"))
    want = ref.stream(common.reference_batch(cols, "cpu"), rcfg).rows
    got = np.asarray(a.results["estimated_trajectory"], np.float32)
    np.testing.assert_allclose(got, want[:, :3], atol=1e-4)
    np.testing.assert_array_equal(a.results["num_associations"], want[:, 11])
    np.testing.assert_array_equal(a.results["num_targets"], want[:, 10])


@pytest.mark.parametrize("over", [
    {}, {"frontend_topk": "sort"}, {"synth_doppler_precision": "highest"},
    {"power_precision": "highest", "doppler_layout": "wide"},
    {"synth_doppler_layout": "loop", "doppler_precision": "default"}])
def test_k1_work_depends_on_the_shapes_and_frames_alone(over):
    """Knobs that pick an implementation (precision names, layouts, the
    top-K lowering) leave the count as it is; so do the kernel's shape
    routes, which follow from the shapes alone."""
    base = CONFIGS["bench_s128"]["pipeline"]
    w0 = k1.work(base, 64)
    w = k1.work({**base, **over}, 64)
    assert w == w0
    S = k1.shapes(base)["S"]
    assert k1.work(base, 128) == {
        k: (2 * v if k != "bytes" else 2 * v - S * 4)
        for k, v in w0.items()}


def test_k1_least_time_uses_the_published_ceilings():
    base = CONFIGS["bench_s128"]["pipeline"]
    w = k1.work(base, 64)
    # Philox-bound at the bench shapes: 120 INT32 operations a noise value
    # of 256 x 400 per frame at 64 x 132 x 1.98 GHz.
    int32_s = 64 * 256 * 400 * 120 / (64 * 132 * 1.98e9)
    assert k1.least_time_s(w) == pytest.approx(int32_s)
    assert k1.PEAK_TF32_FLOPS == 495e12 and k1.BOOST_CLOCK_HZ == 1.98e9


# ---- the reference's stages against answers worked out by hand ------------

def _cfg():
    from portbench.reference.core.config import config_from_dict as rc
    return rc(CONFIGS["bench_s128"]["pipeline"])


@pytest.mark.parametrize("deg", [-60.0, -2.0, 0.0, 14.0, 37.3, 71.1])
def test_beamforming_finds_a_plane_wave(deg):
    from portbench.reference import estimation as est
    cfg = _cfg()
    prec = est.PRECISIONS["float64"]
    s = est.steering(np.deg2rad([[deg]]), cfg.radar, prec)
    s = s / np.linalg.norm(s, axis=-1, keepdims=True)
    az = est.beamforming_azimuth(s, cfg, prec)[0, 0]
    # Within the bias of a parabola through a sin-spaced beam on a
    # 2-degree grid.
    assert abs(az - deg) < 0.3
    conf = est.confidence(s, np.array([[deg]]), cfg, prec)[0, 0]
    # A noise-free plane wave of unit power: |a^H s| = sqrt(A) against
    # unit-modulus steering, no phase error, a flat |s_n|^2 (SNR term
    # log10(1) = 0): 0.4 sqrt(8) + 0.3, clipped to 1.
    assert conf == 1.0
    order, multi = est.mdl_order(s)
    assert order[0, 0] == 1 and not multi[0, 0]


def test_smoothing_follows_a_track_and_drops_a_stale_one():
    from portbench.reference import estimation as est
    aoa = _cfg().aoa          # window 3, factor 0.7, max age 2
    keys = np.array([[5], [5], [5], [5], [9], [9], [9], [9], [9], [5]])
    ang = np.array([[10.0], [20.0], [30.0], [40.0], [0], [0], [0], [0],
                    [0], [50.0]])
    conf = np.ones_like(ang)
    a, c = est.smooth_sequence(keys, ang, conf, np.ones_like(ang, bool),
                               aoa)
    assert a[0, 0] == 10.0                              # a new track
    assert a[1, 0] == pytest.approx(0.7 * 15.0 + 0.3 * 10.0, abs=1e-9)
    assert a[3, 0] == pytest.approx(0.7 * 30.0 + 0.3 * 30.0, abs=1e-9)
    assert a[9, 0] == 50.0      # key 5 last seen 6 frames back: stale
    # The bounded table agrees while it holds every live track.
    table = est.SlotTable(aoa)
    for f in range(10):
        af, cf = table.step(keys[f], ang[f], conf[f], np.ones(1, bool))
        assert af[0] == pytest.approx(a[f, 0]) and cf[0] == c[f, 0]


def test_association_is_mutual_and_gated():
    from portbench.reference import estimation as est
    cfg = _cfg()
    prec = est.PRECISIONS["float64"]

    def tg(xy):
        xy = np.asarray(xy, float)[None]
        pos = np.concatenate([xy, np.zeros_like(xy[..., :1])], -1)
        n = xy.shape[1]
        return {"pos": pos, "los": pos / np.linalg.norm(pos, axis=-1,
                                                        keepdims=True),
                "vr": np.zeros((1, n)), "conf": np.ones((1, n)),
                "sig0": np.ones((1, n), complex), "ok": np.ones((1, n), bool)}
    # Current 0 and 1 both sit nearest previous 0; only current 0 is its
    # nearest too.  Current 2 is 6 m from everything: outside the 5 m gate.
    cur = tg([[10.0, 0.0], [10.5, 0.0], [30.0, 6.0]])
    prev = tg([[10.1, 0.0], [13.0, 0.0], [30.0, 0.0]])
    a = est.associate(cur, prev, np.array([True]), cfg, prec)
    assert a["valid"].tolist() == [[True, False, False]]
    assert a["app_v"][0, 0, 0] == pytest.approx(-0.1 / cfg.frame_dt)


def test_the_solve_recovers_a_known_motion():
    from portbench.reference import estimation as est
    cfg = _cfg()
    prec = est.PRECISIONS["float64"]
    rng = np.random.default_rng(0)
    n = 40
    az = rng.uniform(-1.0, 1.0, n)
    r = rng.uniform(5.0, 50.0, n)
    pos = np.stack([r * np.cos(az), r * np.sin(az), np.zeros(n)], -1)[None]
    los = pos / r[None, :, None]
    x = np.array([7.9, 0.6, 0.0, 0.0, 0.0, 0.04])
    rows = np.concatenate([los, np.cross(pos, los)], -1)
    vr = -(rows @ x)
    scale = 4 * np.pi * cfg.frame_dt / cfg.radar.lambda_c
    # The apparent velocity of a static point is -(v + w x r).
    app = -(x[:3] + np.cross(x[3:], pos))
    assoc = {"valid": np.ones((1, n), bool), "pos": pos, "los": los,
             "vr": vr, "phase": est.wrap(scale * (rows @ x)),
             "app_v": app, "weight": np.full((1, n), 0.8)}
    got, ok, m = est.solve(assoc, cfg, prec)
    assert ok[0] and m[0] == n
    assert np.abs(got[0, :3] - x[:3]).max() < 1e-3
    assert abs(got[0, 5] - x[5]) < 2e-3
