"""The port's three-dispatch route (K4, OS-CFAR, K5) against the benchmark's
plain float64 reference of it (``portbench/reference/
pipeline_three_dispatch.py``), the cell's driver and its trace readers, on
the CPU.

``process_sequence_batched`` runs its plain versions at a small cut of the
``reference_fidelity`` configuration: 16 chirps x 128 samples (a 12.8 us
chirp of 250 MHz), S_max 32, 16 frames of the bench scene with 24 points,
the bench's share of its slots (96 of 128; the scene's 96 points do not fit
32 slots).  At 128 samples the plain K5's float32 DFT columns keep their
phases within ~6e-5 rad; at the deployment's 400 they reach ~2.4e-4 rad,
which moves a target by millimetres and, through the apparent-velocity
rows, a frame's motion past ``MOTION_TOL`` (the card's K5 takes its
columns from the factored FFT).  Seeds 0, 3 and 5, three of the first
twelve whose solve succeeds in 15 of 16 frames, so that the motion is
compared where it is solved; all twelve pass.  Tolerances, with their
reasons:

- counts (detections, reliable targets, associations) and the solve's
  success equal, frame by frame, and target validity equal: the plain
  K4 and the float64 one differ by ~1e-5 of a cell's power (the float32
  range constant), far from an OS-CFAR threshold or a neighbour's power
  in these scenes;
- target (x, y) within ``XY_TOL`` = 1e-3 m (the twelve seeds read at most
  4.7e-4 m: the float32 signatures' phases);
- velocity and angular velocity within the benchmark's ``MOTION_TOL``
  (1e-3 m/s; the twelve read at most 8.4e-4, the chosen three 4.5e-5);
- pose: relative pose error under 1e-4 m and the absolute gap under
  1e-3 m over the 16 frames (the batched reference test's bounds);
- the independent witness: the reference's median v_x within 0.3 m/s of
  the scene's 8.0.

The TF32 control (every product on TF32 tensor cores, phase B's operands
rounded to TF32) and the program at ``os_rank`` 0.5 or at CA-CFAR each
fail them, and the cell's limits; the reference imports no ``jax``, no
JAX package and nothing of the port.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import common, compare, registry, run
from portbench.drivers import batched_three_dispatch
from portbench.reference import frontend_three_dispatch as ref_fe
from portbench.reference import pipeline_three_dispatch
from portbench.reference.core.config import config_from_dict as ref_config
from portbench.scenes import constant_motion
from portbench.trace import DeviceEvent, Traced, kernel_name
from portbench.work import three_dispatch
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.signal import detect

REPO = Path(__file__).resolve().parents[1]
CELL = "batch_8192.reference_fidelity"
DOC = json.loads((REPO / "portbench/configs/reference_fidelity.json")
                 .read_text())
F = 16
XY_TOL = 1e-3
SEEDS = (0, 3, 5)
SCENE = dict(DOC["scene"], num_points=24)
COUNTS = {"detections": 10, "reliable": 11, "associations": 12}
LIMITS = json.loads((REPO / f"portbench/limits/{CELL}.json").read_text())[
    "numbers"]


def _small(**detection):
    d = copy.deepcopy(DOC["pipeline"])
    d["radar"].update(num_chirps=16, bandwidth=250e6, chirp_duration=12.8e-6)
    d["max_scatterers"] = 32
    d["detection"].update(detection)
    return d


CFG = config_from_dict(_small())
RCFG = ref_config(_small())


def _scene(seed):
    cols, _ = constant_motion.make(SCENE, F, seed, CFG.max_scatterers,
                                   CFG.frame_dt)
    return cols


def _program(cols, seed, cfg=CFG):
    out = tframe.process_sequence_batched(
        common.program_batch(cols, "cpu"),
        torch.Generator().manual_seed(seed), cfg)
    return common.Sample(common.frame_numbers(out).numpy(),
                         out.target_xy.numpy(), out.target_valid.numpy())


def _reference(cols, seed, precision="float64"):
    return common.Sample(*pipeline_three_dispatch.batched(
        common.reference_batch(cols, "cpu"),
        common.noise_seeds(seed, F, "cpu"), RCFG, precision))


def _faults(got, want):
    """The tolerances of the module docstring each as a bool: True where
    ``got`` breaks it."""
    both = got.target_valid & want.target_valid
    pose = compare.numbers(got.rows, want.rows, {})
    return {
        "counts": not np.array_equal(got.rows[:, 9:], want.rows[:, 9:]),
        "validity": not np.array_equal(got.target_valid, want.target_valid),
        "xy": bool(np.any(np.abs(got.target_xy - want.target_xy)[both]
                          > XY_TOL)),
        "motion": bool(np.any(np.abs(got.rows[:, 3:9] - want.rows[:, 3:9])
                              > compare.MOTION_TOL)),
        "pose": not (pose["pose_rpe_m"] < 1e-4 and pose["pose_gap_m"] < 1e-3),
    }


@pytest.fixture(scope="module")
def runs():
    out = {}
    for seed in SEEDS:
        cols = _scene(seed)
        out[seed] = (cols, _program(cols, seed), _reference(cols, seed))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_the_three_dispatch_route_matches_its_float64_reference(runs, seed):
    _, got, want = runs[seed]
    assert got.target_valid.any() and want.rows[:, 9].mean() >= 15 / 16
    assert _faults(got, want) == dict.fromkeys(_faults(got, want), False)
    assert compare.judge(compare.numbers_of(got, want, COUNTS), LIMITS)[0]
    assert abs(np.median(want.rows[1:, 3]) - 8.0) < 0.3


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_the_tolerances(runs, seed):
    cols, _, want = runs[seed]
    low = _reference(cols, seed, "tf32")
    faults = _faults(low, want)
    assert faults["motion"], faults
    assert not compare.judge(compare.numbers_of(low, want, COUNTS),
                             LIMITS)[0]


@pytest.mark.parametrize("fault", ["os_rank_0.5", "ca_cfar"])
def test_a_program_on_another_detector_fails(runs, fault):
    """The program at the OS-CFAR rank 0.5, or at CA-CFAR on the same
    route: its detections, counts and motion leave the reference."""
    detection = ({"os_rank": 0.5} if fault == "os_rank_0.5"
                 else {"cfar_mode": "ca"})
    d = _small(**detection)
    d["frontend_one_pass"] = False
    cfg = config_from_dict(d)
    assert tframe._phase_a_route(cfg) == "three_dispatch"
    seed = SEEDS[0]
    cols, _, want = runs[seed]
    got = _program(cols, seed, cfg)
    faults = _faults(got, want)
    assert faults["counts"] and faults["motion"], faults
    assert not compare.judge(compare.numbers_of(got, want, COUNTS),
                             LIMITS)[0]


# ---- the order statistic ------------------------------------------------

def _maps(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g, dtype=torch.float32) + 1e-3


@pytest.mark.parametrize("shape,train,guard,rank", [
    ((3, 20, 12), 3, 1, 0.75),    # edges on both axes: 1..12 samples in
    ((2, 40, 32), 8, 2, 0.75),    # the configuration's cross
    ((2, 16, 9), 2, 1, 0.5),      # rank 0.5: k lands on .5 at odd n - 1
])
def test_the_reference_order_statistic_matches_the_ports(shape, train, guard,
                                                         rank):
    """The k-th smallest of the same float32 samples is the same value;
    k = round-half-even(rank (n_valid - 1)) on both sides."""
    p = _maps(shape)
    got = detect._os_noise(p, train, guard, rank)
    want = ref_fe.os_noise(p.to(torch.float64), train, guard, rank)
    assert torch.equal(got.to(torch.float64), want)
    # The maps' cells hold every count of samples from the edge inwards;
    # at rank 0.5 some land on k + 0.5, which rounds to the even k.
    R, D = shape[1:]
    offs = range(guard + 1, guard + train + 1)
    n = {sum((r - o >= 0) + (r + o < R) + (d - o >= 0) + (d + o < D)
             for o in offs) for r in range(R) for d in range(D)}
    assert min(n) < 4 * train
    if rank == 0.5:
        assert any((rank * (m - 1)) % 1 == 0.5 for m in n)


def test_an_all_invalid_map_falls_back_to_the_frames_mean():
    """Maps smaller than the guard band: no sample lies inside, and each
    cell's estimate is its own frame's mean."""
    p = _maps((3, 2, 2), seed=1)
    got = detect._os_noise(p, 4, 2, 0.75)
    want = ref_fe.os_noise(p.to(torch.float64), 4, 2, 0.75)
    mean = p.to(torch.float64).mean(dim=(1, 2), keepdim=True).expand(3, 2, 2)
    torch.testing.assert_close(want, mean, rtol=0, atol=0)
    torch.testing.assert_close(got.to(torch.float64), want, rtol=1e-6,
                               atol=0)


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.pipeline_three_dispatch;"
            "import portbench.reference.frontend_three_dispatch;"
            "import portbench.work.three_dispatch;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'flax', 'radar_slam_tpu',"
            " 'radar_slam_tpu_torch'}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


# ---- the cell's driver ----------------------------------------------------

@pytest.fixture()
def tiny_mix(monkeypatch):
    read = registry.read_json

    def tiny(path):
        d = read(path)
        if path.parent.name == "traffic" and path.stem == \
                "batch_8192_three_dispatch":
            d.update(frames=16, pool=2, check_among=1)
        return d
    monkeypatch.setattr(registry, "read_json", tiny)


def test_the_driver_runs_set_up_and_a_window_at_a_tiny_mix(tiny_mix):
    """The cell's closed loop on the CPU at 16 frames and a pool of 2:
    set-up with its route check, a window of calls (``run.window``, as a
    timed run takes it), then the comparison's numbers against the cell's
    limits' names.  (``run.run_cell`` itself refuses a process that has
    loaded ``jax``, as this test process has.)"""
    cell = registry.Cell(CELL, registry.load_benchmark())
    drv = cell.driver.Driver(cell, 2**31 + 4321, torch.device("cpu"))
    assert (drv.unit_frames, drv.unit_k1_frames) == (16, 0)
    drv.warm()
    win = run.window(drv, 0.5)
    assert win["frames"] >= 16 and win["failed"] == 0
    drv.release()
    readings, info = drv.compare("float64")
    assert set(cell.limits["numbers"]) <= set(readings)
    assert info["compared_frames"] == 16


def test_a_program_that_does_not_count_its_order_statistic_stops_at_set_up(
        tiny_mix, monkeypatch):
    """A program without the order statistic's counters cannot show the
    route: its run stops at once, before any build, with ``KeyError``
    (``run.py`` exits 3)."""
    monkeypatch.delattr(detect._os_noise, "calls")
    cell = registry.Cell(CELL, registry.load_benchmark())
    with pytest.raises(KeyError, match="order statistic"):
        cell.driver.Driver(cell, 7, torch.device("cpu"))


def test_the_driver_refuses_a_call_without_the_order_statistic(
        tiny_mix, monkeypatch):
    """The warm call must run one order statistic (on the card also one K4
    and one K5 launch and no K1): a call whose threshold is the floor
    alone fails set-up."""
    monkeypatch.setattr(detect, "threshold_db",
                        lambda p_lin, det: det.threshold_db)
    cell = registry.Cell(CELL, registry.load_benchmark())
    drv = cell.driver.Driver(cell, 7, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="three-dispatch route"):
        drv.warm()


# ---- the trace readers ----------------------------------------------------

K4 = "void (anonymous namespace)::cube_onchip_kernel<1, 0, 1>(" \
     "(anonymous namespace)::OcArgs)"
K4_SUM = "void (anonymous namespace)::antenna_sum_kernel(float const*, " \
         "float*, int, int, float)"
K5 = "void (anonymous namespace)::cube_onchip_kernel<1, 0, 2>(" \
     "(anonymous namespace)::OcArgs)"
K5_NORM = "void (anonymous namespace)::sig_normalize_kernel(float2*, int, " \
          "int)"
K7 = "void (anonymous namespace)::cube_onchip_kernel<2, 0, 1>(" \
     "(anonymous namespace)::OcArgs)"
OTHER = "void at::native::elementwise_kernel<128, 2>(int, float)"


def _ev(full, start, end):
    return DeviceEvent(kernel_name(full), start, end, "kernel", full)


def _calls(n, frames):
    """``n`` traced calls: K4 (70 ms + 1 ms), the detection (30 + 10 ms),
    K5 (60 ms + 1 ms), then phase B (100 ms); a K7 power launch and its
    sum before them, which neither roofline counts."""
    evs = [_ev(K7, 0.0, 0.01), _ev(K4_SUM, 0.01, 0.011)]
    t = 0.02
    for _ in range(n):
        evs += [_ev(OTHER, t, t + 0.01), _ev(K4, t + 0.01, t + 0.08),
                _ev(K4_SUM, t + 0.08, t + 0.081),
                _ev(OTHER, t + 0.09, t + 0.12), _ev(OTHER, t + 0.12, t + 0.13),
                _ev(K5, t + 0.13, t + 0.19), _ev(K5_NORM, t + 0.19, t + 0.191),
                _ev(OTHER, t + 0.2, t + 0.3)]
        t += 0.5
    return Traced(evs, t, n, n * frames, 0, {"config": DOC})


def _reader(name):
    return registry.module(registry.HERE / "layer_metrics" / f"{name}.py")


def test_the_readers_find_k4_k5_and_the_detection_between():
    rec = _calls(2, 8192)
    least = {k: three_dispatch.least_time_s(w(DOC["pipeline"], 2 * 8192))
             for k, w in (("k4", three_dispatch.k4_work),
                          ("k5", three_dispatch.k5_work))}
    assert _reader("k4_roofline").read(rec) == pytest.approx(
        100 * least["k4"] / (2 * 0.071))
    assert _reader("k5_roofline").read(rec) == pytest.approx(
        100 * least["k5"] / (2 * 0.061))
    assert _reader("detect_device_ms_per_kframe").read(rec) == \
        pytest.approx(2 * 40.0 / (2 * 8.192))


def test_the_readers_read_nothing_without_the_route():
    rec = Traced([_ev(K7, 0.0, 0.01), _ev(K4_SUM, 0.01, 0.011),
                  _ev(OTHER, 0.02, 0.03)], 1.0, 1, 8192, 8192,
                 {"config": DOC})
    for name in ("k4_roofline", "k5_roofline", "detect_device_ms_per_kframe"):
        assert _reader(name).read(rec) is None


def test_k4_and_k5_are_bound_by_the_philox_noise_at_the_cell():
    """At 8 x 32 x 400 and 128 scatterers both kernels' least time is the
    INT32 pipe's: 0.047 ms a 64-frame call."""
    for work in (three_dispatch.k4_work, three_dispatch.k5_work):
        w = work(DOC["pipeline"], 64)
        t = three_dispatch.least_time_s(w)
        assert t == pytest.approx(w["int32"] / (64 * 132 * 1.98e9))
        assert t == pytest.approx(0.047e-3, rel=0.01)
