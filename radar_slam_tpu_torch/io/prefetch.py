"""Double-buffered host -> device ingest: chunk i+1 uploads while chunk i
computes.

Counterpart of ``radar_slam_tpu/io/prefetch.py``.  The reference leans on
JAX's asynchronous ``device_put``; here the schedule is explicit CUDA
(:func:`chunk_uploader`):

- two pinned host staging buffers per leaf, allocated once and reused;
- each chunk is copied into its buffer on the host, then to the device with
  ``non_blocking=True`` on a side stream, and an event is recorded after
  the copy;
- before the caller computes on a chunk, the compute stream waits on that
  chunk's event, and the chunk's tensors are marked with ``record_stream``
  for the compute stream (the allocator then keeps their memory until the
  compute stream is done with it);
- before a buffer is refilled, the host waits for that buffer's previous
  copy to finish.

The last chunk is padded by repeating its last frame; the drivers cut the
outputs back to F frames.  Each driver draws its per-frame seeds once for
the whole sequence (``frame_seeds(generator, F)``; the rig ``F * B`` read
as [F, B]) and slices them per chunk, so it equals its one-shot driver:
:func:`process_sequence_prefetch` and :func:`process_sequence_rig_prefetch`
bit for bit (the same steps on the same values), and
:func:`process_sequence_rig_batched_prefetch` up to the phase-A batch size
(phase A per chunk, then one whole-sequence phase B).  On the CPU the
uploader slices and copies, without streams.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from radar_slam_tpu_torch.core.config import PipelineConfig
from radar_slam_tpu_torch.core.device import DEFAULT, resolve
from radar_slam_tpu_torch.core.types import FrameOutput, ScattererBatch
from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.ops.noise import frame_seeds
from radar_slam_tpu_torch.pipeline import frame as fr
from radar_slam_tpu_torch.pipeline import rig as rigmod
from radar_slam_tpu_torch.utils.host import (tree_leaves, tree_map,
                                           tree_unflatten)


def _num_frames(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def _fill(dst: np.ndarray, x: np.ndarray, start: int) -> None:
    """``dst`` [chunk, ...] <- frames [start, start + chunk) of ``x``, the
    tail padded by repeating the last frame."""
    n = min(dst.shape[0], x.shape[0] - start)
    dst[:n] = x[start:start + n]
    dst[n:] = x[start + n - 1]


def _slice_chunk(tree, start: int, size: int):
    """Host-side chunk [start:start+size], padded by edge-repeat to size
    (a new array per leaf)."""
    def cut(x):
        out = np.empty((size,) + x.shape[1:], x.dtype)
        _fill(out, x, start)
        return out
    return tree_map(cut, tree)


def chunk_uploader(host_tree, chunk: int, device=DEFAULT) -> Iterator:
    """Yield device-resident chunks [chunk, ...] of a tree of numpy arrays
    [F, ...] (None leaves kept), each upload enqueued one chunk ahead of
    its consumption (module docstring).  ``device`` is the card unless the
    caller names another."""
    dev = resolve(device)
    F = _num_frames(host_tree)
    n = (F + chunk - 1) // chunk
    if dev.type != "cuda":
        for i in range(n):
            yield tree_map(lambda x: torch.from_numpy(x).to(dev),
                           _slice_chunk(host_tree, i * chunk, chunk))
        return
    leaves = tree_leaves(host_tree)
    copy_stream = torch.cuda.Stream(device=dev)
    compute = torch.cuda.current_stream(dev)
    staging = [[torch.empty((chunk,) + x.shape[1:],
                            dtype=torch.from_numpy(x[:0]).dtype,
                            pin_memory=True) for x in leaves]
               for _ in range(2)]
    copied = [None, None]       # each buffer's last copy event

    def upload(i):
        slot = i % 2
        if copied[slot] is not None:
            copied[slot].synchronize()
        for buf, x in zip(staging[slot], leaves):
            _fill(buf.numpy(), x, i * chunk)
        with torch.cuda.stream(copy_stream):
            tensors = [buf.to(dev, non_blocking=True)
                       for buf in staging[slot]]
            event = torch.cuda.Event()
            event.record(copy_stream)
        copied[slot] = event
        return tensors, event

    nxt = upload(0)
    for i in range(n):
        cur, event = nxt
        if i + 1 < n:
            nxt = upload(i + 1)
        compute.wait_event(event)
        for t in cur:
            t.record_stream(compute)
        yield tree_unflatten(host_tree, cur)


def process_sequence_prefetch(host_scatterers: ScattererBatch,
                              generator: torch.Generator,
                              cfg: PipelineConfig, chunk: int = 16,
                              rotate_pose: bool = True,
                              device=DEFAULT) -> FrameOutput:
    """``pipeline.frame.process_sequence`` over host-resident scatterers
    [F, S_max] (numpy leaves), ingested through :func:`chunk_uploader`:
    the same seeds, the state carried across chunks, so the outputs are
    bit for bit the one-shot driver's."""
    fr._check_supported(cfg)
    dev = resolve(device)
    F = _num_frames(host_scatterers)
    seeds = frame_seeds(generator, F, dev)
    state = fr.init_state(cfg, device=dev)
    outs = []
    for i, sc in enumerate(chunk_uploader(host_scatterers, chunk, dev)):
        for j in range(min(chunk, F - i * chunk)):
            f = i * chunk + j
            state, out = fr.process_scatterers(
                state, fr._frame(sc, j, j + 1), seeds[f:f + 1], cfg,
                rotate_pose)
            outs.append(out)
    return fr._cat_outputs(outs)


def process_sequence_rig_prefetch(host_scatterers: ScattererBatch,
                                  generator: torch.Generator,
                                  cfg: PipelineConfig, rig: rigmod.Rig,
                                  chunk: int = 16, rotate_pose: bool = True,
                                  device=DEFAULT) -> FrameOutput:
    """``pipeline.rig.process_sequence_rig`` over host-resident per-sensor
    scatterers [F, B, S] with double-buffered chunk uploads (bit for bit:
    the same [F, B] seeds, the state carried across chunks)."""
    fr._check_supported(cfg)
    rigmod._check_rig(host_scatterers, rig, 1)
    dev = resolve(device)
    F, B = host_scatterers.range_m.shape[:2]
    seeds = frame_seeds(generator, F * B, dev).reshape(F, B)
    state = rigmod.init_rig_state(cfg, rig, device=dev)
    outs = []
    for i, sc in enumerate(chunk_uploader(host_scatterers, chunk, dev)):
        for j in range(min(chunk, F - i * chunk)):
            f = i * chunk + j
            state, out = rigmod.process_scatterers_rig(
                state, fr._map(lambda x: x[j], sc), seeds[f], cfg, rig,
                rotate_pose)
            outs.append(out)
    return fr._cat_outputs(outs)


def process_sequence_rig_batched_prefetch(
        host_scatterers: ScattererBatch, generator: torch.Generator,
        cfg: PipelineConfig, rig: rigmod.Rig, chunk: int = 512,
        rotate_pose: bool = True, device=DEFAULT) -> FrameOutput:
    """``pipeline.rig.process_sequence_rig_batched`` over host-resident
    per-sensor scatterers [F, B, S]: phase A (the front end over the
    flattened chunk x sensor axis, and the AoA tail) per uploaded chunk
    while the next chunk's copy is in flight, then one whole-sequence
    phase B on the features, so the smoothing windows see the whole
    sequence.  The production ingest path of RadarScenes rigs.

    ``chunk`` (rig frames, at most F): phase A launches ~2,500 small
    kernels a chunk, so short chunks leave the card idle.  Over 2048 rig
    frames of four sensors at 512 scatterers on an H100, chunks of 512
    ran at 95-100 % of the one-shot driver's rate with a quarter of its
    peak memory, chunks of 32 (the reference's default) at 28-40 %
    (PERF.md §6)."""
    fr._check_supported(cfg)
    rigmod._check_rig(host_scatterers, rig, 1)
    fe.use_f32_matmuls()
    dev = resolve(device)
    F, B = host_scatterers.range_m.shape[:2]
    chunk = min(chunk, F)   # no phase A over repeats of a short sequence
    seeds = frame_seeds(generator, F * B, dev).reshape(F, B)
    n_pad = -(-F // chunk) * chunk
    seeds = torch.cat([seeds, seeds[-1:].expand(n_pad - F, B)])
    feats = [rigmod._features_from_frame_seeds(
        sc, seeds[i * chunk:(i + 1) * chunk], cfg)
        for i, sc in enumerate(chunk_uploader(host_scatterers, chunk, dev))]
    full = tree_map(lambda x: x[:F],
                    tree_unflatten(feats[0], [
                        torch.cat(xs) for xs in zip(
                            *[tree_leaves(f) for f in feats])]))
    return rigmod._rig_sequence_from_features(full, cfg, rig, rotate_pose)


def is_host_resident(tree) -> bool:
    """True when every leaf is host memory (numpy): the case where the
    prefetch drivers can hide the upload behind compute."""
    return all(isinstance(leaf, np.ndarray) for leaf in tree_leaves(tree))


def process_signal_sequence_prefetch(host_signals: np.ndarray,
                                     cfg: PipelineConfig, chunk: int = 16,
                                     rotate_pose: bool = True,
                                     device=DEFAULT) -> FrameOutput:
    """``pipeline.frame.process_signal_sequence`` over host ADC cubes
    [F, A, C, S] (complex64) with double-buffered chunk uploads (the
    raw-capture replay path; bit for bit the one-shot driver's)."""
    fr._check_cube_supported(cfg)
    dev = resolve(device)
    F = host_signals.shape[0]
    state = fr.init_state(cfg, device=dev)
    outs = []
    for i, sig in enumerate(chunk_uploader(host_signals, chunk, dev)):
        for j in range(min(chunk, F - i * chunk)):
            state, out = fr.process_signals(state, sig[j:j + 1], cfg,
                                            rotate_pose)
            outs.append(out)
    return fr._cat_outputs(outs)
