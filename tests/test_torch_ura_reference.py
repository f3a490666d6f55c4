"""The port's URA path against the benchmark's plain 3-D reference
(``portbench/reference/pipeline_3d.py``, float64), and the benchmark's 3-D
scene (``portbench/scenes/constant_motion_3d.py``), on the CPU.

``process_sequence_batched`` runs its plain versions at a small URA of the
``ura8x4_s512`` configuration: 4 x 2 elements, 16 chirps, 128 samples (a
12.8 us chirp of 250 MHz), S_max 32, 16 frames of the configuration's 3-D
scene at twice its density (1 point per metre: the small array detects
2-4 of the ~20 points the cell's density keeps in view, too few for the
solve in most frames); the AoA grid is the deployment's (181 x 61
points).  Tolerances, with their reasons:

- counts (detections, reliable targets, associations) and the solve's
  success equal, frame by frame: the plain front end and the float64 one
  differ by ~1e-5 of max |Z| (the float32 range constant), far from a CFAR
  threshold or a neighbour's power in these scenes;
- target validity equal, and heights within ``Z_TOL`` = 1e-3 m: the port's
  float32 spectra and grids move a refined elevation by ~1e-4 of a 1.5 deg
  bin (2.6e-6 rad), 1.4e-4 m at 55 m; the runs read 3-4e-5 m;
- target (x, y) within 1e-3 m for the same reason (the runs read 2e-4);
- velocity and angular velocity, v_z included, within the benchmark's
  ``MOTION_TOL`` (1e-3 m/s; the runs read 4e-5);
- pose: relative pose error under 1e-4 m and the absolute gap under 1e-3 m
  over the 16 frames (the batched reference test's bounds);
- the independent witness: the reference's median v_x within 0.3 m/s of the
  scene's 8.0 (a 4 x 2 aperture sees v_z poorly over 16 frames, so v_z's
  gate is the card's, at the full URA).

The TF32 control (every product's operands rounded to TF32) and a program
whose elevation estimate is zeroed each fail them; the reference imports
no ``jax``, no JAX package and nothing of the port.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import common, compare
from portbench.drivers import batched_ura
from portbench.reference import pipeline_3d
from portbench.reference.core.config import config_from_dict as ref_config
from portbench.reference.core.types import ScattererBatch as RefBatch
from portbench.scenes import constant_motion_3d
from radar_slam_tpu_torch.aoa import estimators
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.pipeline import frame as tframe

REPO = Path(__file__).resolve().parents[1]
DOC = json.loads((REPO / "portbench/configs/ura8x4_s512.json").read_text())
F = 16
Z_TOL = 1e-3
XY_TOL = 1e-3
SEEDS = (5, 11, 23)
SMALL_SCENE = dict(DOC["scene"], points_per_m=1.0)


def _small():
    d = copy.deepcopy(DOC["pipeline"])
    d["radar"].update(num_antennas=4, num_antennas_el=2, num_chirps=16,
                      bandwidth=250e6, chirp_duration=12.8e-6)
    d["max_scatterers"] = 32
    return d


CFG = config_from_dict(_small())
RCFG = ref_config(_small())


def _scene(seed):
    cols, _ = constant_motion_3d.make(SMALL_SCENE, F, seed,
                                      CFG.max_scatterers, CFG.frame_dt)
    return cols


def _program(cols, seed):
    out = tframe.process_sequence_batched(
        batched_ura.Driver._batch(cols, "cpu"),
        torch.Generator().manual_seed(seed), CFG)
    return batched_ura.Sample3D(common.frame_numbers(out).numpy(),
                                out.target_xy.numpy(),
                                out.target_valid.numpy(),
                                out.target_z.numpy())


def _reference(cols, seed, precision="float64"):
    batch = RefBatch(**{k: torch.from_numpy(cols[k])
                        for k in batched_ura.FIELDS})
    return batched_ura.Sample3D(*pipeline_3d.batched_3d(
        batch, common.noise_seeds(seed, F, "cpu"), RCFG, precision))


def _faults(got, want):
    """The tolerances of the module docstring each as a bool: True where
    ``got`` breaks it."""
    both = got.target_valid & want.target_valid
    pose = compare.numbers(got.rows, want.rows, {})
    return {
        "counts": not np.array_equal(got.rows[:, 9:], want.rows[:, 9:]),
        "validity": not np.array_equal(got.target_valid, want.target_valid),
        "heights": bool(np.any(np.abs(got.target_z - want.target_z)[both]
                               > Z_TOL)),
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
def test_the_ura_driver_matches_the_3d_reference(runs, seed):
    _, got, want = runs[seed]
    assert int(got.rows[:, 10].sum()) > 0 and got.target_valid.any()
    # Elevation is seen: the targets spread over metres in height.
    z = want.target_z[want.target_valid]
    assert z.max() - z.min() > 2.0
    assert _faults(got, want) == dict.fromkeys(_faults(got, want), False)
    assert abs(np.median(want.rows[1:, 3]) - 8.0) < 0.3


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_the_tolerances(runs, seed):
    cols, _, want = runs[seed]
    low = _reference(cols, seed, "tf32")
    faults = _faults(low, want)
    assert faults["motion"] and faults["heights"], faults


def test_a_program_without_elevation_fails(runs, monkeypatch):
    """The joint search's elevation zeroed in the program: its heights
    and its solve leave the reference, and the cell's limits refuse it."""
    est2d = estimators.estimate_angles_2d

    def flat(*a, **k):
        az, el, spec = est2d(*a, **k)
        return az, torch.zeros_like(el), spec
    monkeypatch.setattr(tframe.estimators, "estimate_angles_2d", flat)
    seed = SEEDS[0]
    cols, _, want = runs[seed]
    got = _program(cols, seed)
    faults = _faults(got, want)
    assert faults["heights"] and faults["motion"], faults
    drv = batched_ura.Driver.__new__(batched_ura.Driver)
    limits = json.loads((REPO / "portbench/limits/"
                         "batch_2048.ura8x4_s512.json").read_text())
    ok, rows = compare.judge(drv.numbers_of(got, want), limits["numbers"])
    assert not ok, rows


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.pipeline_3d;"
            "import portbench.reference.estimation_3d;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'flax', 'radar_slam_tpu',"
            " 'radar_slam_tpu_torch'}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


@pytest.mark.parametrize("seed", [2**31 + 5, 7, 1234567])
def test_the_3d_scene_keeps_points_in_view_over_2048_frames(seed):
    """Over a call's 2,048 frames at S_max 512, every observable point's
    elevation lies inside +-45 deg, and the frames keep about as many
    points in view as tests/test_elevation.py's scene (20.8 a frame), the
    reason for the density: each frame at least the solve's 3, 99 % at
    least 8 (a corridor drawn at random thins out now and then: over 100
    seeds 5 at the least, 0.03 % of frames under 8)."""
    cols, rig = constant_motion_3d.make(DOC["scene"], 2048, seed, 512,
                                        CFG.frame_dt)
    assert rig is None
    valid = cols["valid"]
    n = valid.sum(axis=1)
    assert 19.0 <= n.mean() <= 23.0
    assert n.min() >= 3 and np.mean(n >= 8) >= 0.99
    el = cols["elevation_rad"][valid]
    assert np.abs(el).max() <= np.float32(np.deg2rad(45.0))
    # The scene has height: points above and below the radar in view.
    assert el.min() < -0.05 and el.max() > 0.05


def test_cell_readings_put_the_plain_float32_reference_beside_the_control(
        monkeypatch):
    """``scripts/cell_readings.py`` at a tiny depth of the URA cell on the
    CPU: the program and the reference in plain float32 read inside the
    cell's limits, heights included, and the TF32 control outside them."""
    from portbench import registry
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import cell_readings
    read = registry.read_json

    def tiny(path):
        d = read(path)
        if path.parent.name == "traffic" and path.stem == "batch_2048":
            d.update(frames=6, pool=1, check_among=1)
        return d
    monkeypatch.setattr(registry, "read_json", tiny)
    cell_readings.add_float32()
    cell = registry.Cell("batch_2048.ura8x4_s512", registry.load_benchmark())
    out = cell_readings.readings(cell, 2**31 + 77, 1, ["tf32", "float32"],
                                 device="cpu")
    limits = json.loads((REPO / "portbench/limits/"
                         "batch_2048.ura8x4_s512.json").read_text())
    for side in ("program", "float32"):
        assert compare.judge(out[side], limits["numbers"])[0], out[side]
    assert not compare.judge(out["tf32"], limits["numbers"])[0]
    assert out["failed"] == 0 and out["per_unit"][
        "beamforming_spectrum.products"] > 0
