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
- The step over static buffers: on the CPU every step is eager (the path
  counter and the ``step`` span's ``path``), ``state`` reads a copy and
  writes the buffers (restore, ``gt_fallback``, ``reset``), and
  the front end's and the solve's cached constants equal the values built
  per call bit for bit.
- On the card (``card``, skipped without one): the analyzer's CUDA graph
  against a plain loop of ``process_scatterers``, bit for bit over two
  512-frame episodes at the benchmark's operating point, with a restore,
  ``gt_fallback`` steps, ``reset()``, a frame of another S_max, the
  real-time worker thread, and a capture that fails.  The JAX package is
  imported inside the CPU tests that use it, so that the card tests run
  where JAX is not installed:

      python -m pytest tests/test_torch_streaming.py -q -m card --noconftest
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

from radar_slam_tpu_torch.core import config as tcfg
from radar_slam_tpu_torch.core.types import scatterer_batch_from_numpy
from radar_slam_tpu_torch.io import synthetic as tsyn
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.pipeline.streaming import (FrameBuffer,
                                                     StreamingAnalyzer,
                                                     create_real_time_estimator,
                                                     frame_seed)
from radar_slam_tpu_torch.utils import checkpointing as tckpt
from radar_slam_tpu_torch.utils import profiling
from radar_slam_tpu_torch.utils.host import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 6
CKPT_EVERY = 3


def fast_test_config(noise_power=0.0):
    """tests/test_streaming_resume.py:31-38, at ``noise_power``."""
    from radar_slam_tpu.core import config as jcfg
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
    from radar_slam_tpu.io.synthetic import SceneConfig, constant_motion_scene
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
    from _torch_parity import patch_eager_synthesis

    from radar_slam_tpu.pipeline import frame as jframe
    from radar_slam_tpu.pipeline import streaming as jstream
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
        poses.append(out.pose.numpy()[0])
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


# ---- the step over static buffers (CPU) --------------------------------------

def _narrow_scene(frames):
    cfg = _narrow_cfg()
    batch, gt = tsyn.constant_motion_scene(
        3, frames, cfg.frame_dt, (5.0, 0.3), 0.05,
        tsyn.SceneConfig(num_points=48, max_scatterers=64), device="cpu")
    return cfg, batch, gt


def _same_bits(a, b):
    a, b = a.detach().cpu(), b.detach().cpu()
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


def test_cpu_steps_are_eager_in_the_counter_and_the_step_span():
    """On the CPU there is no graph: every step is counted ``eager`` and
    its ``step`` span says so, with the eager stages and no
    ``step.replay``."""
    cfg, batch, _ = _narrow_scene(3)
    an = StreamingAnalyzer(cfg, device="cpu")
    profiling.collect()
    profiling.enable()
    try:
        for i in range(3):
            an.process_frame(tframe._frame(batch, i, i + 1))
    finally:
        profiling.disable()
    spans = profiling.collect()
    assert an.step_paths == {"eager": 3, "capture": 0, "replay": 0}
    steps = [s for s in spans if s.name == "step"]
    assert [s.attrs for s in steps] == [{"path": "eager"}] * 3
    for step in steps:
        assert [s.name for s in spans if s.parent == step.id] == [
            "step.front_end", "step.aoa", "step.tail", "step.fetch"]
    assert not an._graphs


def test_state_reads_a_copy_and_writes_the_step_buffers(tmp_path):
    """``state`` reads a copy of the step's buffers, which later steps
    leave as it was; the setter copies into the buffers, each leaf with
    storage of its own: a restore, the ``gt_fallback`` pose and
    ``reset()`` leave the same buffers holding the new values, and a leaf
    of another shape is refused."""
    cfg, batch, gt = _narrow_scene(5)
    gt_poses = gt["poses"] + np.array([1.0, -2.0, 0.3])
    an = StreamingAnalyzer(cfg, gt_fallback=True, device="cpu",
                           checkpoint_dir=str(tmp_path), checkpoint_every=2)
    bufs = tree_leaves(an._state)
    assert len({b.untyped_storage().data_ptr() for b in bufs}) == len(bufs)

    def same_buffers():
        return all(a is b for a, b in zip(tree_leaves(an._state), bufs))

    def same_state(a, b):
        return all(_same_bits(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    held = an.state
    an.process_frame(tframe._frame(batch, 0, 1), gt_pose=gt_poses[0])
    assert same_state(held, tframe.init_state(cfg, device="cpu"))
    assert not an.results["success"][0]
    np.testing.assert_array_equal(
        an.state.pose.numpy(), gt_poses[0][None].astype(np.float32))
    for i in range(1, 4):
        an.process_frame(tframe._frame(batch, i, i + 1), gt_pose=gt_poses[i])
    at4 = an.state
    an.process_frame(tframe._frame(batch, 4, 5), gt_pose=gt_poses[4])
    assert not same_state(at4, an.state)
    assert an.restore_latest() and an.frame_idx == 4
    assert same_buffers() and same_state(at4, an.state)
    an.reset(initial_pose=np.array([3.0, 4.0, 0.5]))
    assert same_buffers() and an.frame_idx == 0
    assert same_state(an.state, tframe.init_state(
        cfg, np.array([3.0, 4.0, 0.5]), device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        an.state = an.state._replace(pose=torch.zeros(1, 4))


def test_cached_constants_equal_the_values_built_per_call():
    """The constants a step reads from a cache (the front end's mix vector
    and fast-time base, the solve's prior and alias bonuses, the MUSIC
    basis vector) equal the values built per call bit for bit, and a
    second call returns the same tensor."""
    from radar_slam_tpu_torch.aoa import estimators
    from radar_slam_tpu_torch.motion import velocity
    from radar_slam_tpu_torch.signal.rds import _mix_vector
    from radar_slam_tpu_torch.signal.synth import fast_time_base
    cfg = tcfg.complete_analysis_config()
    S = cfg.radar.samples_per_chirp
    for fid in ("tpu", "reference"):
        got = tframe._front_end_constants(cfg.radar, cfg.window, fid, "cpu")
        assert tframe._front_end_constants(cfg.radar, cfg.window, fid,
                                           "cpu") is got
        assert _same_bits(got[0], _mix_vector(cfg.radar, cfg.window,
                                              "baseband", S, device="cpu"))
        assert _same_bits(got[1], fast_time_base(cfg.radar, fid, "cpu"))
    for full in (False, True):
        prior = velocity._prior_matrix(cfg.velocity, full, "cpu")
        assert velocity._prior_matrix(cfg.velocity, full,
                                      torch.device("cpu")) is prior
        assert _same_bits(prior, velocity._prior_matrix_on.__wrapped__(
            cfg.velocity, full, "cpu"))
    bonus = velocity._alias_bonus("cpu")
    assert velocity._alias_bonus("cpu") is bonus
    assert _same_bits(bonus, velocity._alias_bonus.__wrapped__("cpu"))
    e0 = estimators._unit_pair(torch.complex64, "cpu")
    assert _same_bits(e0, torch.tensor([1.0, 0.0], dtype=torch.complex64))


# ---- the CUDA graph on the card ----------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _bench_cfg():
    """The benchmark's operating point: complete_analysis_config at
    S_max 128 (bench.py:364)."""
    return dataclasses.replace(tcfg.complete_analysis_config(),
                               max_scatterers=128)


def _bench_scene(seed, frames, device):
    cfg = _bench_cfg()
    return tsyn.constant_motion_scene(
        seed, frames, cfg.frame_dt, (8.0, 0.5), 0.05,
        tsyn.SceneConfig(num_points=96, max_scatterers=128), device=device)


class _StepLoop:
    """The analyzer's step written out: ``process_scatterers`` from a state
    with ``frame_seed(i)``, and the analyzer's ``gt_fallback`` rule; each
    step's row is the analyzer's results for the frame (pose, velocity,
    angular velocity, success, reliable targets, associations)."""

    def __init__(self, cfg, device):
        self.cfg, self.device = cfg, device
        self.state = tframe.init_state(cfg, device=device)

    def step(self, frame, i, gt_pose=None):
        state, out = tframe.process_scatterers(
            self.state, frame, frame_seed(i, self.device), self.cfg)
        m = out.motion
        row = torch.cat([
            out.pose.reshape(-1), m.velocity.reshape(-1),
            m.angular_velocity.reshape(-1),
            torch.stack([m.success[0].to(torch.float32),
                         out.num_reliable[0].to(torch.float32),
                         out.num_associations[0].to(torch.float32)]),
        ]).cpu().numpy().astype(np.float64)
        if not row[9] and gt_pose is not None:
            row[0:3] = gt_pose
            state = state._replace(pose=torch.as_tensor(
                gt_pose, dtype=torch.float32,
                device=self.device).reshape(1, 3))
        self.state = state
        return row


def _rows(results):
    r = results
    return np.concatenate([
        np.asarray(r["estimated_trajectory"], np.float64),
        np.asarray(r["velocity_estimates"], np.float64),
        np.stack([np.asarray(r[k], np.float64) for k in (
            "success", "num_targets", "num_associations")], axis=-1)],
        axis=-1)


def _assert_state(got, want):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert _same_bits(x, y), f"state leaf {i}"


@pytest.mark.card
def test_graph_step_equals_the_step_loop_on_the_card(card, tmp_path):
    """Two 512-frame episodes at the benchmark's operating point, with
    ``gt_fallback`` (frame 200 of the first has no valid scatterer, so
    replayed steps fail and take the ground-truth pose), a restore from
    the checkpoint at 256 after 300 frames, ``reset()`` between the
    episodes, then frames of S_max 64 and one of 128 again: every result
    and the state equal the plain loop's bit for bit; one eager step and
    one capture a shape, replays otherwise, and K1's wrapper launched on
    the host in the eager steps and the captures only (a replay launches
    the graph)."""
    from radar_slam_tpu_torch.ops import frontend
    cfg, L = _bench_cfg(), 512
    b1, gt1 = _bench_scene(1, L, card)
    b2, gt2 = _bench_scene(2, L, card)
    valid = b1.valid.clone()
    valid[200] = False
    b1 = b1._replace(valid=valid)
    narrow = tframe._map(lambda x: x[:, :64].contiguous(), b2)
    # The plain loop: the first episode, the second from a fresh state,
    # then four frames of S_max 64 and one of 128 carried on from it.
    loop = _StepLoop(cfg, card)
    want1 = np.stack([loop.step(tframe._frame(b1, i, i + 1), i,
                                gt1["poses"][i]) for i in range(L)])
    state1 = loop.state
    assert not want1[200, 9] and not want1[201, 9]
    loop = _StepLoop(cfg, card)
    want2 = np.stack([loop.step(tframe._frame(b2, i, i + 1), i,
                                gt2["poses"][i]) for i in range(L)])
    state2 = loop.state
    tail = [tframe._frame(narrow, j, j + 1) for j in range(4)] + [
        tframe._frame(b2, 0, 1)]
    want3 = np.stack([loop.step(x, L + j) for j, x in enumerate(tail)])

    k1 = frontend.frontend_kernel_split.launches
    an = StreamingAnalyzer(cfg, gt_fallback=True, device=card,
                           checkpoint_dir=str(tmp_path), checkpoint_every=128)
    for i in list(range(300)) + [None] + list(range(256, L)):
        if i is None:
            assert an.restore_latest() and an.frame_idx == 256
            continue
        an.process_frame(tframe._frame(b1, i, i + 1), gt_pose=gt1["poses"][i])
    assert an.step_paths == {"eager": 1, "capture": 1, "replay": 554}
    np.testing.assert_array_equal(_rows(an.results), want1)
    _assert_state(an.state, state1)

    an.reset()
    for i in range(L):
        an.process_frame(tframe._frame(b2, i, i + 1), gt_pose=gt2["poses"][i])
    assert an.step_paths == {"eager": 1, "capture": 1, "replay": 1066}
    np.testing.assert_array_equal(_rows(an.results), want2)
    _assert_state(an.state, state2)

    for x in tail:
        an.process_frame(x)
    assert an.step_paths == {"eager": 2, "capture": 2, "replay": 1069}
    np.testing.assert_array_equal(_rows(an.results)[L:], want3)
    _assert_state(an.state, loop.state)
    assert (frontend.frontend_kernel_split.launches - k1
            == an.step_paths["eager"] + an.step_paths["capture"])


@pytest.mark.card
def test_graph_step_in_the_real_time_worker_thread(card):
    """The real-time processor's worker thread runs the analyzer: its
    first step eager, then a capture and replays, results equal to the
    plain loop bit for bit."""
    from radar_slam_tpu_torch.pipeline.streaming import RealTimeProcessor
    cfg, F = _bench_cfg(), 64
    batch, _ = _bench_scene(3, F, card)
    loop = _StepLoop(cfg, card)
    want = np.stack([loop.step(tframe._frame(batch, i, i + 1), i)
                     for i in range(F)])
    proc = RealTimeProcessor(cfg, queue_size=F, device=card)
    proc.start_processing()
    try:
        for i in range(F):
            assert proc.add_frame_for_processing(
                tframe._frame(batch, i, i + 1))
        assert _wait(lambda: proc.frames_processed == F)
    finally:
        proc.stop_processing()
    an = proc.analyzer
    assert an.step_paths == {"eager": 1, "capture": 1, "replay": F - 2}
    np.testing.assert_array_equal(_rows(an.results), want)
    _assert_state(an.state, loop.state)


@pytest.mark.card
def test_a_failed_capture_leaves_the_analyzer_eager(card, monkeypatch,
                                                   caplog):
    """A step that reads the device from the host cannot be captured: the
    analyzer warns once, runs that step and every later one eagerly, and
    gives the plain loop's results; K1's wrapper launched once a step (the
    capture failed before it reached K1)."""
    import logging

    from radar_slam_tpu_torch.ops import frontend
    from radar_slam_tpu_torch.pipeline import streaming
    cfg, F = _bench_cfg(), 6
    batch, _ = _bench_scene(4, F, card)
    loop = _StepLoop(cfg, card)
    want = np.stack([loop.step(tframe._frame(batch, i, i + 1), i)
                     for i in range(F)])
    real = tframe.process_scatterers

    def reads_the_device(state, scatterers, seed, *args):
        float(seed.sum())
        return real(state, scatterers, seed, *args)

    monkeypatch.setattr(streaming.fr, "process_scatterers", reads_the_device)
    k1 = frontend.frontend_kernel_split.launches
    an = StreamingAnalyzer(cfg, device=card)
    with caplog.at_level(logging.WARNING, logger=streaming.__name__):
        for i in range(F):
            an.process_frame(tframe._frame(batch, i, i + 1))
    assert an.step_paths == {"eager": F - 1, "capture": 1, "replay": 0}
    assert len([r for r in caplog.records if "capture" in r.getMessage()]) == 1
    assert frontend.frontend_kernel_split.launches - k1 == F
    np.testing.assert_array_equal(_rows(an.results), want)
    _assert_state(an.state, loop.state)
