"""The port's double-buffered ingest drivers (``io/prefetch.py``) against
its one-shot drivers, as tests/test_prefetch.py holds the reference's.

From the same generator state on the CPU, the sequential, rig and cube
prefetch drivers equal their one-shot drivers bit for bit (uneven last
chunk: edge padding, seed alignment, the state carried across chunks);
the rig-batched prefetch driver is held to the one-shot batched rig as
tests/test_prefetch.py:122-127 holds it (pose 1e-5, success and
``num_reliable`` equal).  The uploader's chunk count, shapes and padding,
and ``is_host_resident``; the reference's uploader gives the same chunks.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import to_np

from radar_slam_tpu.io import prefetch as jprefetch
from radar_slam_tpu_torch.core import config as tcfg
from radar_slam_tpu_torch.io import prefetch
from radar_slam_tpu_torch.io.synthetic import (SceneConfig,
                                               constant_motion_scene,
                                               constant_motion_scene_rig)
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.pipeline import rig as trig
from radar_slam_tpu_torch.signal.synth import synthesize_frames_batch
from radar_slam_tpu_torch.utils.host import tree_leaves

# tests/test_prefetch.py:19-27.
CFG = tcfg.PipelineConfig(
    radar=tcfg.RadarConfig(noise_power=1e-6, num_chirps=16,
                           chirp_duration=12.8e-6),
    detection=tcfg.DetectionConfig(cfar_train_cells=6, guard_cells=2,
                                   cfar_offset_db=12.0, max_detections=24),
    aoa=tcfg.AoAConfig(search_resolution_deg=3.0, max_targets=24,
                       track_capacity=64),
    max_scatterers=128,
)
RIG = ((1.8, 0.9, 0.4), (1.8, -0.9, -0.4))


def _host(batch):
    return tframe._map(lambda x: x.numpy(), batch)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(to_np(x), to_np(y))


def _scene(frames=11, cfg=CFG):
    batch, _ = constant_motion_scene(
        3, num_frames=frames, dt=cfg.frame_dt, v_body=(5.0, 0.3),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=48, max_scatterers=cfg.max_scatterers),
        device="cpu")
    return batch


def test_chunk_uploader_shapes_and_count():
    """11 frames in chunks of 4: 3 chunks of 4, the tail padded with the
    last frame, None leaves kept -- the chunks the reference's uploader
    gives."""
    host = {"a": np.arange(22, dtype=np.float32).reshape(11, 2),
            "b": np.arange(11) % 3 == 0, "c": None}
    chunks = list(prefetch.chunk_uploader(host, 4, device="cpu"))
    want = list(jprefetch.chunk_uploader(
        {k: v for k, v in host.items() if v is not None}, 4))
    assert len(chunks) == len(want) == 3
    for c, w in zip(chunks, want):
        assert c["c"] is None
        for k in ("a", "b"):
            assert isinstance(c[k], torch.Tensor)
            assert c[k].shape[0] == 4
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(w[k]))
    np.testing.assert_array_equal(chunks[2]["a"].numpy()[-1],
                                  host["a"][-1])
    # The chunks are copies: writing one leaves the host arrays alone.
    chunks[0]["a"].zero_()
    assert host["a"][1, 0] == 2.0


def test_is_host_resident():
    batch = _scene(2)
    assert not prefetch.is_host_resident(batch)
    assert prefetch.is_host_resident(_host(batch))
    assert batch.elevation_rad is None
    mixed = _host(batch)._replace(vr=batch.vr)
    assert not prefetch.is_host_resident(mixed)


def test_prefetch_scatterers_bitwise_equal():
    """Chunked (uneven last chunk) == one-shot ``process_sequence``, every
    output leaf."""
    batch = _scene(11)
    want = tframe.process_sequence(batch, torch.Generator().manual_seed(3),
                                   CFG)
    got = prefetch.process_sequence_prefetch(
        _host(batch), torch.Generator().manual_seed(3), CFG, chunk=4,
        device="cpu")
    _same(got, want)


@pytest.mark.parametrize("fft_mode", ["fft", "fused"])
def test_prefetch_signals_bitwise_equal(fft_mode):
    """Host cubes through the chunked cube driver == one-shot
    ``process_signal_sequence`` (``"fused"``: the K7 path)."""
    cfg = dataclasses.replace(CFG, fft_mode=fft_mode)
    signals = synthesize_frames_batch(_scene(9), cfg.radar,
                                      torch.Generator().manual_seed(1))
    want = tframe.process_signal_sequence(signals, cfg)
    got = prefetch.process_signal_sequence_prefetch(
        signals.numpy(), cfg, chunk=4, device="cpu")
    _same(got, want)


def test_prefetch_rig_bitwise_equal():
    """Rig prefetch driver == one-shot ``process_sequence_rig``."""
    batch, _ = constant_motion_scene_rig(
        7, num_frames=11, dt=CFG.frame_dt, v_body=(5.0, 0.3), yaw_rate=0.05,
        rig=RIG, scene=SceneConfig(num_points=48,
                                   max_scatterers=CFG.max_scatterers),
        device="cpu")
    want = trig.process_sequence_rig(batch, torch.Generator().manual_seed(4),
                                     CFG, RIG)
    got = prefetch.process_sequence_rig_prefetch(
        _host(batch), torch.Generator().manual_seed(4), CFG, RIG, chunk=4,
        device="cpu")
    _same(got, want)


def test_rig_batched_prefetch_matches_one_shot():
    """Phase A per chunk of 4 (10 frames: padding and three chunks), one
    phase B: the one-shot batched rig driver."""
    cfg = dataclasses.replace(
        CFG, aoa=dataclasses.replace(CFG.aoa, track_capacity=256))
    batch, _ = constant_motion_scene_rig(
        11, num_frames=10, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.25, rig=RIG,
        scene=SceneConfig(num_points=48, max_scatterers=cfg.max_scatterers,
                          fov_rad=1.8), device="cpu")
    a = trig.process_sequence_rig_batched(
        batch, torch.Generator().manual_seed(0), cfg, RIG)
    b = prefetch.process_sequence_rig_batched_prefetch(
        _host(batch), torch.Generator().manual_seed(0), cfg, RIG, chunk=4,
        device="cpu")
    assert to_np(a.motion.success)[1:].all()
    np.testing.assert_allclose(to_np(b.pose), to_np(a.pose), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(to_np(b.motion.success),
                                  to_np(a.motion.success))
    np.testing.assert_array_equal(to_np(b.num_reliable),
                                  to_np(a.num_reliable))


def test_rig_batched_prefetch_default_chunk_covers_a_short_sequence(
        monkeypatch):
    """The default chunk (longer than these 6 frames) runs phase A once
    over the 6 frames, not over a chunk padded with repeats, and equals
    the one-shot driver."""
    batch, _ = constant_motion_scene_rig(
        11, num_frames=6, dt=CFG.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.25, rig=RIG,
        scene=SceneConfig(num_points=48, max_scatterers=CFG.max_scatterers,
                          fov_rad=1.8), device="cpu")
    seen = []
    features = trig._features_from_frame_seeds

    def spy(sc, seeds, cfg):
        seen.append(tuple(seeds.shape))
        return features(sc, seeds, cfg)

    monkeypatch.setattr(trig, "_features_from_frame_seeds", spy)
    a = trig.process_sequence_rig_batched(
        batch, torch.Generator().manual_seed(0), CFG, RIG)
    seen.clear()
    b = prefetch.process_sequence_rig_batched_prefetch(
        _host(batch), torch.Generator().manual_seed(0), CFG, RIG,
        device="cpu")
    assert seen == [(6, len(RIG))]
    np.testing.assert_allclose(to_np(b.pose), to_np(a.pose), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(to_np(b.motion.success),
                                  to_np(a.motion.success))
    np.testing.assert_array_equal(to_np(b.num_reliable),
                                  to_np(a.num_reliable))


def test_prefetch_driver_rejects_a_wrong_rig():
    batch = _scene(4)
    with pytest.raises(ValueError):
        prefetch.process_sequence_rig_batched_prefetch(
            _host(batch), torch.Generator(), CFG, RIG, device="cpu")
