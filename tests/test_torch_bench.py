"""The port's benchmark, ``bench_torch.py``, against the reference's
``bench.py``: the same result keys, the same scene bit for bit, the same
adversarial answer at sigma = 0, the three stage routes, and ``main`` and
``python -m radar_slam_tpu_torch bench`` on the CPU at shrunk sizes.

bench.py is read with ``ast`` for its keys (``chip_smoke.bench_py_keys``,
which the card's ``bench`` phase holds the line to) and loaded with
``importlib`` for its functions (it imports only jax and numpy at the
top).  Sizes are shrunk through bench_torch's module constants; the CPU
runs the kernels' plain versions, so no rate here is a device number.
"""

import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
from _torch_parity import bench_config, to_np
from chip_smoke import bench_py_keys
from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.pipeline.cli import main as cli_main

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference_bench():
    spec = importlib.util.spec_from_file_location("bench_reference",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small(monkeypatch):
    """bench_torch's sizes and trial counts shrunk for the CPU."""
    for name, value in (("ACCURACY_FRAMES", 6),
                        ("HEADLINE", bench_torch.Pair(2, 4, 1)),
                        ("SCAN", bench_torch.Pair(2, 3, 1)),
                        ("CHUNKED", bench_torch.Pair(2, 4, 1)),
                        ("MUSIC", bench_torch.Pair(2, 4, 1)),
                        ("RIG_ACCURACY_FRAMES", 3),
                        ("RIG", bench_torch.Pair(2, 3, 1)),
                        ("ONE_TRIALS", 1), ("STAGE_ITERS", 4)):
        monkeypatch.setattr(bench_torch, name, value)


@pytest.mark.parametrize("entry", ["main", "cli"])
def test_bench_prints_one_line_with_bench_py_keys(small, capsys, entry):
    """``main`` and the CLI's ``bench`` print ONE JSON line whose keys (and
    frontend_knobs' keys) equal bench.py's, in its order, on the CPU and
    without chip tests."""
    if entry == "main":
        rc = bench_torch.main(["--skip-chip-tests", "--device", "cpu"])
    else:
        rc = cli_main(["bench", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    r = json.loads(lines[0])
    keys, knob_keys = bench_py_keys()
    assert list(r) == keys
    assert list(r["frontend_knobs"]) == knob_keys
    assert r["device"] == "cpu"
    assert r["chip_tests_ok"] is None and r["chip_tests_passed"] == 0
    assert r["frames_delta"] == 2
    assert set(r["stage_us_per_64f"]) == {"frontend_onepass_kernel",
                                          "frontend_plus_finalize"}
    for k in ("value", "scan_driver_fps", "chunked_driver_fps", "music_fps",
              "rig_fps_4sensor", "dispatch_s_64f"):
        assert np.isfinite(r[k]) and r[k] > 0, (k, r[k])
    # Accuracy over 6 frames of the bench scene is well inside the gates.
    assert r["pos_err_bound_ok"] and r["pos_rmse_ok"] and r["music_ok"]
    assert r["adversarial_ok"]


def test_bench_on_the_card_without_one_raises():
    """``--device cuda`` (the default) does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(["--skip-chip-tests"])


def test_bench_torch_states_no_tpu_floor():
    """bench.py's three speed floors are TPU numbers; the port's floors
    come from its own runs, so none of those numbers is in its source."""
    src = (REPO / "bench_torch.py").read_text()
    assert not re.search(r"\b(3,?800|24,?000|7,?000)(\.0)?\b", src)


@pytest.mark.parametrize("n_frames", [1, 64])
def test_scene_matches_bench_py_bit_for_bit(reference_bench, n_frames):
    cfg = bench_config()
    want, want_gt = reference_bench.scene(cfg, n_frames)
    got, got_gt = bench_torch.scene(
        config_from_dict(dataclasses.asdict(cfg)), n_frames, "cpu")
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(to_np(b), np.asarray(a),
                                          err_msg=name)
    assert set(got_gt) == set(want_gt)
    for k in want_gt:
        np.testing.assert_array_equal(np.asarray(got_gt[k]),
                                      np.asarray(want_gt[k]), err_msg=k)


def test_adversarial_check_matches_bench_py_at_zero_noise(reference_bench):
    """The mismatch scene at sigma = 0 through both packages' checks.  The
    reference takes its materialized route on the CPU, the port the
    one-pass route (the bench config's route on any device); the two
    routes differ by ~1 mm of position RMSE, and each answer is rounded to
    1 mm: 2e-3 m."""
    cfg = bench_config(noise_power=0.0)
    want_rmse, want_ok = reference_bench.adversarial_check(cfg)
    got_rmse, got_ok = bench_torch.adversarial_check(
        config_from_dict(dataclasses.asdict(cfg)), "cpu")
    assert got_ok == want_ok
    assert abs(got_rmse - want_rmse) <= 2e-3, (got_rmse, want_rmse)


STAGE_ROUTES = {
    # bench.py:166-169
    "one_pass": (lambda c: c,
                 {"frontend_onepass_kernel", "frontend_plus_finalize"}),
    # bench.py:215-221
    "three_dispatch": (
        lambda c: dataclasses.replace(c, detection=dataclasses.replace(
            c.detection, cfar_mode="os")),
        {"synth_power_kernel", "detect", "synth_signatures_kernel"}),
    # bench.py:232-253
    "materialized": (lambda c: dataclasses.replace(c, synth_in_kernel=False),
                     {"synth", "power_fused", "detect", "signatures"}),
}


@pytest.mark.parametrize("route", list(STAGE_ROUTES))
def test_stage_breakdown_routes(monkeypatch, route):
    """Each route's stages, named as the reference names them, timed at
    2 frames (host clock here): positive microseconds."""
    from radar_slam_tpu_torch.pipeline.frame import _phase_a_route
    monkeypatch.setattr(bench_torch, "STAGE_ITERS", 4)
    to_route, keys = STAGE_ROUTES[route]
    cfg = to_route(config_from_dict(dataclasses.asdict(bench_config())))
    assert _phase_a_route(cfg) == route
    batch, _ = bench_torch.scene(cfg, 2, "cpu")
    stages = bench_torch.stage_breakdown(cfg, batch,
                                         torch.Generator().manual_seed(0))
    assert set(stages) == keys
    assert all(v > 0 for v in stages.values()), stages


def test_bench_torch_imports_without_jax():
    """A process where ``jax``, ``jaxlib`` and the JAX package cannot be
    imported imports bench_torch and builds its scene."""
    script = textwrap.dedent("""
        import importlib.abc, sys

        BLOCKED = ("jax", "jaxlib", "radar_slam_tpu")

        class NoJax(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is blocked in this process")
                return None

        sys.meta_path.insert(0, NoJax())
        import dataclasses
        import bench_torch
        from radar_slam_tpu_torch.core.config import complete_analysis_config
        cfg = dataclasses.replace(complete_analysis_config(),
                                  max_scatterers=128)
        batch, gt = bench_torch.scene(cfg, 2, "cpu")
        assert batch.range_m.shape == (2, 128)
        assert not [m for m in sys.modules
                    if m.split(".")[0] in BLOCKED], "JAX was imported"
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr
