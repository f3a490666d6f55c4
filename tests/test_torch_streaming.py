"""The port's streaming runtime (``pipeline/streaming.py``) and its
checkpointing (``utils/checkpointing.py``) against the reference's.

- The analyzer against the reference's ``StreamingAnalyzer`` at sigma = 0
  (tests/test_streaming_resume.py's configuration, the reference fed the
  eager cube, ``_torch_parity.patch_eager_synthesis``): trajectory,
  velocities, success and counts, the metrics' keys and values, held as
  tests/test_torch_sequential.py holds its drivers (pose 1e-4 m, velocity
  1e-3 m/s, counts equal).
- Checkpoints: the file layout and leaf order equal the reference's
  (``jax.tree.flatten``'s order and treedef); the port resumes from the
  reference's own checkpoint files and finishes the reference's sequence.
- Resume: in process, and after a hard kill of a JAX-free child process
  (``os._exit``, no cleanup), the resumed trajectory equals the
  uninterrupted run bit for bit (seeds derive from the frame index).
- ``gt_fallback``, the ``FrameBuffer`` memory budget, and the real-time
  runtime: dropped frames are counted and a worker's exception is raised
  again, not lost with its thread.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
from _torch_parity import patch_eager_synthesis, to_np

from radar_slam_tpu.core import config as jcfg
from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
from radar_slam_tpu.pipeline import frame as jframe
from radar_slam_tpu.pipeline import streaming as jstream
from radar_slam_tpu_torch.core import config as tcfg
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.io import synthetic as tsyn
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.pipeline.streaming import (FrameBuffer,
                                                     StreamingAnalyzer,
                                                     create_real_time_estimator,
                                                     frame_seed)
from radar_slam_tpu_torch.utils import checkpointing as tckpt
from radar_slam_tpu_torch.utils.host import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 6
CKPT_EVERY = 3


def fast_test_config(noise_power=0.0):
    """tests/test_streaming_resume.py:31-38, at ``noise_power``."""
    return jcfg.PipelineConfig(
        radar=jcfg.RadarConfig(noise_power=noise_power, num_chirps=32),
        detection=jcfg.DetectionConfig(cfar_train_cells=8, guard_cells=2,
                                       cfar_offset_db=12.0,
                                       max_detections=32),
        aoa=jcfg.AoAConfig(search_resolution_deg=2.0, max_targets=32),
    )


def _port_cfg(ref_cfg):
    return tcfg.config_from_dict(dataclasses.asdict(ref_cfg))


def _scene(cfg, frames=FRAMES):
    """tests/test_streaming_resume.py's scene: the reference's batch, the
    port's copy on the CPU, the ground truth."""
    jbatch, gt = constant_motion_scene(
        0, frames, cfg.frame_dt, (6.0, 0.3), 0.05,
        SceneConfig(num_points=24, max_scatterers=cfg.max_scatterers))
    fields = {k: np.asarray(v) for k, v in jbatch._asdict().items()
              if v is not None}
    return jbatch, scatterer_batch_from_numpy(fields, "cpu"), gt


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference analyzer over the scene at sigma = 0, checkpointing
    every CKPT_EVERY frames: its results, metrics and checkpoint folder."""
    ref_cfg = fast_test_config()
    jbatch, batch, gt = _scene(ref_cfg)
    ckdir = tmp_path_factory.mktemp("ref_ck")
    with pytest.MonkeyPatch.context() as mp:
        patch_eager_synthesis(mp, jframe)
        an = jstream.StreamingAnalyzer(ref_cfg, checkpoint_dir=str(ckdir),
                                       checkpoint_every=CKPT_EVERY)
        metrics = an.analyze_sequence(jbatch, gt_poses=gt["poses"])
    return dict(cfg=ref_cfg, batch=batch, gt=gt, ckdir=ckdir,
                results={k: np.asarray(v) for k, v in an.results.items()},
                metrics=metrics)


def _assert_results(got, ref):
    np.testing.assert_array_equal(np.asarray(got["success"]),
                                  ref["success"])
    for name in ("num_targets", "num_associations"):
        np.testing.assert_array_equal(np.asarray(got[name]), ref[name], name)
    np.testing.assert_allclose(np.asarray(got["estimated_trajectory"]),
                               ref["estimated_trajectory"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got["velocity_estimates"]),
                               ref["velocity_estimates"], rtol=0, atol=1e-3)


def test_analyzer_matches_reference(reference_run):
    """6 frames at sigma = 0: every per-frame result and every metric."""
    ref = reference_run
    an = StreamingAnalyzer(_port_cfg(ref["cfg"]), device="cpu")
    metrics = an.analyze_sequence(ref["batch"], gt_poses=ref["gt"]["poses"])
    assert np.asarray(ref["results"]["success"])[1:].all()
    _assert_results(an.results, ref["results"])
    assert set(metrics) == set(ref["metrics"])
    assert set(an.results) == set(ref["results"])
    for k, v in ref["metrics"].items():
        if k != "mean_processing_time":
            np.testing.assert_allclose(metrics[k], v, rtol=0, atol=1e-4,
                                       err_msg=k)


def test_checkpoint_layout_matches_reference(reference_run, tmp_path):
    """The port writes the reference's file layout, leaf count, leaf order
    (shapes up to the port's leading frame axis of 1) and treedef."""
    ref = reference_run
    an = StreamingAnalyzer(_port_cfg(ref["cfg"]), device="cpu",
                           checkpoint_dir=str(tmp_path),
                           checkpoint_every=CKPT_EVERY)
    for i in range(CKPT_EVERY):
        an.process_frame(tframe._frame(ref["batch"], i, i + 1))
    stem = f"state_{CKPT_EVERY:06d}"
    got, meta = tckpt.load_leaves(tmp_path / stem)
    want, ref_meta = tckpt.load_leaves(ref["ckdir"] / stem)
    assert meta == ref_meta
    assert len(got) == len(want) == 22
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert a.shape in (b.shape, (1,) + b.shape)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"results_{CKPT_EVERY:06d}.npz", f"{stem}.json", f"{stem}.npz"]
    # load_pytree restores onto the template's device and dtype, and
    # refuses another structure.
    state, step = tckpt.load_pytree(tmp_path / stem, an.state)
    assert step == CKPT_EVERY
    for a, b in zip(tree_leaves(state), tree_leaves(an.state)):
        assert a.dtype == b.dtype and a.shape == b.shape
    with pytest.raises(ValueError):
        tckpt.load_pytree(tmp_path / stem, an.state.smoother)


def test_resume_from_reference_checkpoint(reference_run, tmp_path):
    """The port restores the reference's checkpoint at frame 3 (its state
    carried across by ``frame_state_from_numpy``, its results file read)
    and finishes the sequence: the reference's uninterrupted run."""
    ref = reference_run
    ckdir = tmp_path / "ck"
    shutil.copytree(ref["ckdir"], ckdir)
    for p in ckdir.glob(f"*_{FRAMES:06d}.*"):
        p.unlink()
    an = StreamingAnalyzer(_port_cfg(ref["cfg"]), device="cpu",
                           checkpoint_dir=str(ckdir))
    assert an.restore_latest()
    assert an.frame_idx == CKPT_EVERY
    assert len(an.results["estimated_trajectory"]) == CKPT_EVERY
    assert an.state.pose.shape == (1, 3)
    metrics = an.analyze_sequence(ref["batch"], gt_poses=ref["gt"]["poses"])
    assert metrics["frames_processed"] == FRAMES
    _assert_results(an.results, ref["results"])


# ---- resume in the port ------------------------------------------------------

RESUME_FRAMES = 9
CRASH_AFTER = 7


def _noisy_port_scene():
    cfg = _port_cfg(fast_test_config(noise_power=1e-6))
    batch, gt = tsyn.constant_motion_scene(
        0, RESUME_FRAMES, cfg.frame_dt, (6.0, 0.3), 0.05,
        tsyn.SceneConfig(num_points=24, max_scatterers=cfg.max_scatterers),
        device="cpu")
    return cfg, batch, gt


@pytest.fixture(scope="module")
def uninterrupted():
    """The port's analyzer over 9 noisy frames, uninterrupted."""
    cfg, batch, gt = _noisy_port_scene()
    an = StreamingAnalyzer(cfg, device="cpu")
    an.analyze_sequence(batch, gt_poses=gt["poses"])
    return np.asarray(an.results["estimated_trajectory"])


def test_resume_matches_uninterrupted(uninterrupted, tmp_path):
    """Abandon an analyzer after 7 of 9 frames, restore a new one from its
    checkpoints (frame 6), finish: the same trajectory bit for bit, and
    the per-frame seeds those of the frame index."""
    cfg, batch, gt = _noisy_port_scene()
    ckdir = str(tmp_path / "ck")
    a1 = StreamingAnalyzer(cfg, checkpoint_dir=ckdir,
                           checkpoint_every=CKPT_EVERY, device="cpu")
    for i in range(CRASH_AFTER):
        a1.process_frame(tframe._frame(batch, i, i + 1),
                         gt_pose=gt["poses"][i])
    del a1
    a2 = StreamingAnalyzer(cfg, checkpoint_dir=ckdir,
                           checkpoint_every=CKPT_EVERY, device="cpu")
    assert a2.restore_latest()
    assert a2.frame_idx == 6
    a2.analyze_sequence(batch, gt_poses=gt["poses"])
    got = np.asarray(a2.results["estimated_trajectory"])
    np.testing.assert_array_equal(got, uninterrupted)
    assert len(a2.results["ground_truth_trajectory"]) == RESUME_FRAMES
    assert a2.compute_error_metrics()["frames_processed"] == RESUME_FRAMES
    # The analyzer's step is process_scatterers with frame_seed(i).
    state = tframe.init_state(cfg, device="cpu")
    poses = []
    for i in range(RESUME_FRAMES):
        state, out = tframe.process_scatterers(
            state, tframe._frame(batch, i, i + 1), frame_seed(i, "cpu"), cfg)
        poses.append(to_np(out.pose)[0])
    np.testing.assert_array_equal(np.asarray(poses), uninterrupted)


def test_resume_after_hard_kill(uninterrupted, tmp_path):
    """A child process where ``jax`` and ``radar_slam_tpu`` cannot be
    imported runs 7 frames on the CPU and ``os._exit``s (no flush, no
    cleanup); the parent resumes from its checkpoints and matches the
    uninterrupted trajectory bit for bit."""
    ckdir = str(tmp_path / "ck")
    worker = textwrap.dedent(f"""
        import importlib.abc, os, sys

        class NoJax(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "radar_slam_tpu"):
                    raise ImportError(f"{{name}} is blocked in this process")
                return None

        sys.meta_path.insert(0, NoJax())
        from radar_slam_tpu_torch.core.config import (
            AoAConfig, DetectionConfig, PipelineConfig, RadarConfig)
        from radar_slam_tpu_torch.io.synthetic import (SceneConfig,
                                                       constant_motion_scene)
        from radar_slam_tpu_torch.pipeline.frame import _frame
        from radar_slam_tpu_torch.pipeline.streaming import StreamingAnalyzer
        cfg = PipelineConfig(
            radar=RadarConfig(noise_power=1e-6, num_chirps=32),
            detection=DetectionConfig(cfar_train_cells=8, guard_cells=2,
                                      cfar_offset_db=12.0,
                                      max_detections=32),
            aoa=AoAConfig(search_resolution_deg=2.0, max_targets=32))
        batch, gt = constant_motion_scene(
            0, {RESUME_FRAMES}, cfg.frame_dt, (6.0, 0.3), 0.05,
            SceneConfig(num_points=24, max_scatterers=cfg.max_scatterers),
            device="cpu")
        a = StreamingAnalyzer(cfg, checkpoint_dir={json.dumps(ckdir)},
                              checkpoint_every={CKPT_EVERY}, device="cpu")
        for i in range({CRASH_AFTER}):
            a.process_frame(_frame(batch, i, i + 1), gt_pose=gt["poses"][i])
        os._exit(1)
    """)
    proc = subprocess.run([sys.executable, "-c", worker], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    cfg, batch, gt = _noisy_port_scene()
    a2 = StreamingAnalyzer(cfg, checkpoint_dir=ckdir,
                           checkpoint_every=CKPT_EVERY, device="cpu")
    assert a2.restore_latest()
    assert a2.frame_idx == 6
    a2.analyze_sequence(batch, gt_poses=gt["poses"])
    np.testing.assert_array_equal(
        np.asarray(a2.results["estimated_trajectory"]), uninterrupted)


def test_host_resident_ingest_equals_device_input(uninterrupted):
    """numpy input goes through the chunked uploader (chunk 4 of 9 frames:
    a padded tail) and gives the device input's trajectory."""
    cfg, batch, gt = _noisy_port_scene()
    host = tframe._map(lambda x: x.numpy(), batch)
    an = StreamingAnalyzer(cfg, device="cpu")
    an.analyze_sequence(host, gt_poses=gt["poses"], prefetch_chunk=4)
    np.testing.assert_array_equal(
        np.asarray(an.results["estimated_trajectory"]), uninterrupted)


def test_gt_fallback_copies_the_ground_truth_pose():
    """Frame 0 has no previous targets, so its solve fails: with
    ``gt_fallback`` the estimate and the state's pose become the ground
    truth's, and frame 1 moves on from there; without it they stay at the
    origin."""
    cfg, batch, gt = _noisy_port_scene()
    gt_poses = gt["poses"] + np.array([1.0, -2.0, 0.3])
    runs = {}
    for fallback in (True, False):
        an = StreamingAnalyzer(cfg, gt_fallback=fallback, device="cpu")
        for i in range(2):
            an.process_frame(tframe._frame(batch, i, i + 1),
                             gt_pose=gt_poses[i])
        runs[fallback] = an
    est = runs[True].results["estimated_trajectory"]
    assert not runs[True].results["success"][0]
    assert runs[True].results["success"][1]
    np.testing.assert_array_equal(est[0], gt_poses[0])
    assert est[0].dtype == np.float64
    step = np.asarray(runs[False].results["estimated_trajectory"][1])
    assert np.linalg.norm(est[1][:2] - gt_poses[0][:2]) < 2.0
    assert np.linalg.norm(step[:2]) < 2.0
    assert np.linalg.norm(est[1][:2] - step[:2]) > 1.0


def test_frame_buffer_memory_budget():
    """tests/test_orchestration.py:124, with numpy and torch frames."""
    for make in (lambda: {"x": np.zeros(256, np.float32)},
                 lambda: {"x": torch.zeros(256)}):
        buf = FrameBuffer(max_frames=50, max_memory_mb=0.001)
        for _ in range(10):
            buf.add_frame(make())                 # 1 KB each
        assert 1 <= len(buf) < 10
        assert buf.dropped > 0
        assert buf.latest() is not None


def _narrow_cfg():
    return tcfg.PipelineConfig(
        radar=tcfg.RadarConfig(noise_power=1e-6, num_chirps=16,
                               bandwidth=250e6, chirp_duration=12.8e-6),
        detection=tcfg.DetectionConfig(cfar_train_cells=4, guard_cells=1,
                                       cfar_offset_db=12.0,
                                       max_detections=32),
        aoa=tcfg.AoAConfig(search_resolution_deg=2.0, max_targets=32),
        max_scatterers=64)


def _wait(pred, seconds=120.0):
    deadline = time.time() + seconds
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


def test_realtime_estimator_drops_and_reports():
    """12 frames offered at once to a queue of 2: frames are dropped and
    counted, every offered frame is processed or dropped, the latest
    estimate and the metrics are there."""
    cfg = _narrow_cfg()
    batch, _ = tsyn.constant_motion_scene(
        3, 12, cfg.frame_dt, (5.0, 0.3), 0.05,
        tsyn.SceneConfig(num_points=48, max_scatterers=64), device="cpu")
    est = create_real_time_estimator(cfg, queue_size=2, device="cpu")
    proc = est.processor
    est.start_estimation()
    try:
        for i in range(12):
            est.add_frame(tframe._frame(batch, i, i + 1))
        assert _wait(lambda: proc.frames_processed + proc.frames_dropped
                     == proc.frames_in and proc.queue.empty())
    finally:
        est.stop_estimation()
    m = est.get_performance_metrics()
    assert m["frames_in"] == 12
    assert m["frames_processed"] + m["frames_dropped"] == 12
    assert m["frames_dropped"] > 0 and m["frames_processed"] >= 1
    assert m["p99_latency_s"] >= m["p50_latency_s"] > 0
    latest = est.get_latest_velocity_estimate()
    assert latest is not None and latest["pose"].shape == (3,)
    status = proc.get_system_status()
    assert status["device"] == "cpu" and "devices" in status


def test_realtime_worker_error_is_raised_again(monkeypatch):
    """An exception in the worker thread ends it and is raised again by
    ``add_frame``, ``get_performance_metrics`` and ``stop_estimation``."""
    est = create_real_time_estimator(_narrow_cfg(), device="cpu")
    proc = est.processor

    def broken(*args, **kwargs):
        raise ValueError("injected worker failure")

    monkeypatch.setattr(proc.analyzer, "process_frame", broken)
    est.start_estimation()
    assert est.add_frame("any frame")
    thread = proc._thread
    thread.join(timeout=30)
    assert not thread.is_alive()
    for call in (lambda: est.add_frame("another"),
                 est.get_performance_metrics, est.stop_estimation):
        with pytest.raises(ValueError, match="injected worker failure"):
            call()
