"""Streaming analysis + real-time runtime.

Counterpart of ``radar_slam_tpu/pipeline/streaming.py``.  Two layers:

1. :class:`StreamingAnalyzer`: the per-frame loop over a RadarScenes (or
   synthetic) sequence with ground-truth comparison, the system's
   end-to-end entry.  Each frame is one ``pipeline.frame.
   process_scatterers`` step; ``gt_fallback=True`` reproduces the
   copy-the-ground-truth-pose-when-no-estimate quirk of the reference.
   With ``checkpoint_dir`` the state is saved every ``checkpoint_every``
   frames (``utils/checkpointing.py``), and :meth:`StreamingAnalyzer.
   restore_latest` continues mid-sequence -- from the port's checkpoints
   or from the reference's.
2. The real-time runtime: :class:`FrameBuffer` (bounded history with a
   memory budget), :class:`RealTimeProcessor` (a worker thread behind a
   bounded queue that drops frames when full, rolling metrics) and
   :class:`RealTimeVelocityEstimator`.  An exception in the worker is kept
   and raised again by :meth:`RealTimeProcessor.stop_processing`,
   :meth:`RealTimeProcessor.get_performance_metrics` and
   :meth:`RealTimeProcessor.add_frame_for_processing`.

Every frame's noise seed is its index (:func:`frame_seed`), as the
reference keys frame i with ``jax.random.key(i)``: a restored analyzer
draws the same noise with no generator state in its checkpoint.

The analyzer's step runs over static buffers -- the frame's scatterer
fields, the seed [1] and every leaf of the :class:`FrameState` -- and
ends by copying the next state into the state buffers; ``analyzer.state``
reads a copy of those buffers and its setter copies into them.  On a CUDA device
the step is one CUDA graph per input shape: a shape's first step runs
eagerly (it builds the kernels and every lazy constant), the next is
captured, and every later one replays the graph, so the host
does four things a frame: copy the frame in, fill the seed, replay, fetch
the packed result.  Where a capture raises, the analyzer stays eager and
logs one warning.  ``analyzer.step_paths`` counts the steps by path
(``eager``, ``capture``, ``replay``), as the ``step`` span's ``path``
attribute names them.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from radar_slam_tpu_torch.core.config import (PipelineConfig,
                                              complete_analysis_config)
from radar_slam_tpu_torch.core.device import DEFAULT, resolve
from radar_slam_tpu_torch.core.types import ScattererBatch
from radar_slam_tpu_torch.evaluate.pose_metrics import planar_pose_errors
from radar_slam_tpu_torch.io.prefetch import chunk_uploader, is_host_resident
from radar_slam_tpu_torch.pipeline import frame as fr
from radar_slam_tpu_torch.utils import checkpointing
from radar_slam_tpu_torch.utils.host import tree_leaves
from radar_slam_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def frame_seed(index: int, device) -> torch.Tensor:
    """The noise seed [1] int32 of frame ``index`` of a stream."""
    return torch.tensor([index], dtype=torch.int32, device=device)


def _owned(tree):
    """A copy of ``tree`` whose every leaf has storage of its own (leaves of
    a fresh state share zeros)."""
    return fr._map(lambda x: x.clone(), tree)


def _assign(dst, src) -> None:
    """Copy the leaves of ``src`` into those of ``dst`` in place (the same
    structure and shapes).  A leaf of ``src`` on the storage of a ``dst``
    leaf other than itself is cloned first, so that no copy reads what
    an earlier one wrote."""
    dsts, srcs = tree_leaves(dst), tree_leaves(src)
    if len(dsts) != len(srcs):
        raise ValueError(f"the state has {len(dsts)} leaves, the new one "
                         f"{len(srcs)}")
    held = {d.untyped_storage().data_ptr() for d in dsts}
    pairs = []
    for d, x in zip(dsts, srcs):
        if tuple(x.shape) != tuple(d.shape):
            raise ValueError(f"state leaf shape {tuple(x.shape)}, the "
                             f"state has {tuple(d.shape)}")
        if x is not d:
            aliased = x.untyped_storage().data_ptr() in held
            pairs.append((d, x.clone() if aliased else x))
    for d, x in pairs:
        d.copy_(x)


def _input_key(scatterers: ScattererBatch) -> tuple:
    """What a step's graph depends on in its input: each field's shape
    and dtype (None where absent)."""
    return tuple(None if x is None else (tuple(x.shape), x.dtype)
                 for x in scatterers)


def _leaf_paths(tree, prefix=()) -> List[tuple]:
    """The field path of every leaf of a NamedTuple tree, in leaf order."""
    out: List[tuple] = []
    for name, x in zip(tree._fields, tree):
        if x is None:
            continue
        if hasattr(x, "_fields"):
            out += _leaf_paths(x, prefix + (name,))
        else:
            out.append(prefix + (name,))
    return out


class StreamingAnalyzer:
    """Per-frame streaming ego-motion estimation with GT comparison, on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, cfg: PipelineConfig, gt_fallback: bool = False,
                 rotate_pose: bool = True,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 10, device=DEFAULT):
        self.cfg = cfg
        self.gt_fallback = gt_fallback
        self.rotate_pose = rotate_pose
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.device = resolve(device)
        self.step_paths: Dict[str, int] = dict.fromkeys(
            ("eager", "capture", "replay"), 0)
        self._state: Optional[fr.FrameState] = None
        self._seed = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._inputs: Dict[tuple, ScattererBatch] = {}
        self._graphs: Dict[tuple, tuple] = {}   # key: (graph, pack)
        self._warm: set = set()                 # keys run eagerly
        self._eager_only = self.device.type != "cuda"
        self.reset()

    @property
    def state(self) -> fr.FrameState:
        """A copy of the tracker's state: the step's static buffers, which
        every step overwrites in place, stay inside; the setter copies a
        state into them."""
        return _owned(self._state)

    @state.setter
    def state(self, state: fr.FrameState) -> None:
        _assign(self._state, state)

    def reset(self, initial_pose: Optional[np.ndarray] = None):
        state = fr.init_state(self.cfg, initial_pose, self.device)
        if self._state is None:
            self._state = _owned(state)
        else:
            self.state = state
        self.results: Dict[str, List] = collections.defaultdict(list)
        self.frame_idx = 0

    # -- checkpoint / resume --------------------------------------------

    def save_checkpoint(self) -> None:
        """Persist the FrameState and the accumulated results at the
        current frame."""
        d = Path(self.checkpoint_dir)
        checkpointing.save_pytree(d / f"state_{self.frame_idx:06d}",
                                  self._state, step=self.frame_idx)
        np.savez(d / f"results_{self.frame_idx:06d}.npz",
                 **{k: np.asarray(v) for k, v in self.results.items() if v})

    def _load_state(self, ckpt: Path):
        """The state in ``ckpt``: written by the port (its per-frame fields
        carry a leading axis of 1), or by the reference (they do not),
        which ``frame_state_from_numpy`` carries across."""
        leaves, meta = checkpointing.load_leaves(ckpt)
        like = tree_leaves(self._state)
        if len(leaves) != len(like):
            raise ValueError(f"{ckpt}: {len(leaves)} leaves, the state has "
                             f"{len(like)}")
        if all(a.shape == tuple(b.shape) for a, b in zip(leaves, like)):
            return checkpointing.load_pytree(ckpt, self._state)[0]
        fields: Dict = {}
        for path, a in zip(_leaf_paths(self._state), leaves):
            node = fields
            for name in path[:-1]:
                node = node.setdefault(name, {})
            node[path[-1]] = a
        state = fr.frame_state_from_numpy(fields, self.device)
        for a, b in zip(tree_leaves(state), like):
            if a.shape != b.shape:
                raise ValueError(f"{ckpt}: leaf shape {tuple(a.shape)}, "
                                 f"the state has {tuple(b.shape)}")
        return state

    def restore_latest(self) -> bool:
        """Resume from the newest checkpoint in ``checkpoint_dir``.

        Returns True when a checkpoint was found and loaded; the next
        :meth:`process_frame` call continues at the restored
        ``frame_idx``."""
        ckpt = checkpointing.latest_checkpoint(self.checkpoint_dir)
        if ckpt is None:
            return False
        step = int(checkpointing.load_leaves(ckpt)[1]["step"])
        self.state = self._load_state(ckpt)
        self.frame_idx = step
        rpath = Path(self.checkpoint_dir) / f"results_{step:06d}.npz"
        self.results = collections.defaultdict(list)
        if rpath.exists():
            with np.load(rpath) as z:
                for k in z.files:
                    self.results[k] = list(z[k])
        return True

    def _path(self, key: tuple) -> str:
        if key in self._graphs:
            return "replay"
        if self._eager_only or key not in self._warm:
            return "eager"
        return "capture"

    def _body(self, inputs: ScattererBatch) -> torch.Tensor:
        """The step on the static buffers: ``process_scatterers`` on the
        input and seed buffers, the next state copied into the state
        buffers; returns the [12] float32 the host fetches (pose, velocity,
        angular velocity, success, reliable targets, associations)."""
        state, out = fr.process_scatterers(self._state, inputs, self._seed,
                                           self.cfg, self.rotate_pose)
        m = out.motion
        pack = torch.cat([
            out.pose.reshape(-1), m.velocity.reshape(-1),
            m.angular_velocity.reshape(-1),
            torch.stack([m.success[0].to(torch.float32),
                         out.num_reliable[0].to(torch.float32),
                         out.num_associations[0].to(torch.float32)]),
        ])
        _assign(self._state, state)
        return pack

    def _capture(self, key: tuple, inputs: ScattererBatch) -> torch.Tensor:
        """Capture the step at ``key`` as a CUDA graph and replay it once;
        where the capture raises, warn, stay eager and run the step."""
        stream = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                pack = self._body(inputs)
        except RuntimeError:   # torch's and CUDA's capture errors
            torch.cuda.set_stream(stream)
            self._eager_only = True
            logger.warning("StreamingAnalyzer: the step's CUDA graph capture "
                           "failed; this analyzer stays eager",
                           exc_info=True)
            return self._body(inputs)
        self._graphs[key] = (graph, pack)
        with span("step.replay"):
            graph.replay()
        return pack

    def _replay(self, key: tuple) -> torch.Tensor:
        graph, pack = self._graphs[key]
        graph.replay()
        return pack

    def _load(self, inputs: ScattererBatch, scatterers: ScattererBatch,
              seed: Optional[torch.Tensor]) -> None:
        """The frame and its seed into the step's input buffers."""
        for buf, x in zip(inputs, scatterers):
            if buf is not None:
                buf.copy_(x)
        if seed is None:
            self._seed.fill_(self.frame_idx)
        else:
            self._seed.copy_(seed)

    def process_frame(self, scatterers: ScattererBatch,
                      gt_pose: Optional[np.ndarray] = None,
                      gt_velocity: Optional[np.ndarray] = None,
                      seed: Optional[torch.Tensor] = None) -> Dict:
        """One frame: scatterers [1, S_max], and the noise seed [1] of
        :func:`frame_seed` unless one is given.  Span ``step`` (request:
        the frame index; ``path``: eager, capture or replay) over the
        step, with ``step.fetch`` (the one device -> host fetch) inside;
        an eager or captured step has ``step.front_end``, ``step.aoa`` and
        ``step.tail`` inside too, a replayed one ``step.replay`` (the copy
        in, the seed and the replay), a captured one its first replay."""
        t0 = time.perf_counter()
        key = _input_key(scatterers)
        path = self._path(key)
        self.step_paths[path] += 1
        with span("step", request=self.frame_idx, path=path):
            inputs = self._inputs.get(key)
            if inputs is None:
                inputs = self._inputs[key] = fr._map(
                    lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device=self.device), scatterers)
            if path == "replay":
                with span("step.replay"):
                    self._load(inputs, scatterers, seed)
                    pack = self._replay(key)
            else:
                self._load(inputs, scatterers, seed)
                if path == "capture":
                    pack = self._capture(key, inputs)
                else:
                    pack = self._body(inputs)
                    self._warm.add(key)
            # One device -> host fetch for everything the host needs.
            with span("step.fetch"):
                host = pack.cpu().numpy()
            est_pose, vel, ang = host[0:3], host[3:6], host[6:9]
            success = bool(host[9])

            if not success and self.gt_fallback and gt_pose is not None:
                est_pose = np.asarray(gt_pose, np.float64)
                self.state = self._state._replace(pose=torch.as_tensor(
                    est_pose, dtype=torch.float32,
                    device=self.device).reshape(1, 3))

        dt_s = time.perf_counter() - t0
        r = self.results
        r["processing_times"].append(dt_s)
        r["estimated_trajectory"].append(est_pose)
        r["velocity_estimates"].append(np.concatenate([vel, ang]))
        r["success"].append(success)
        r["num_targets"].append(int(host[10]))
        r["num_associations"].append(int(host[11]))
        if gt_pose is not None:
            r["ground_truth_trajectory"].append(np.asarray(gt_pose))
        if gt_velocity is not None:
            r["ground_truth_velocities"].append(np.asarray(gt_velocity))
        self.frame_idx += 1
        if (self.checkpoint_dir is not None
                and self.frame_idx % self.checkpoint_every == 0):
            self.save_checkpoint()
        return {"success": success, "pose": est_pose,
                "velocity": r["velocity_estimates"][-1],
                "processing_time": dt_s}

    def analyze_sequence(self, batches: ScattererBatch,
                         gt_poses: Optional[np.ndarray] = None,
                         gt_velocities: Optional[np.ndarray] = None,
                         prefetch_chunk: int = 16) -> Dict:
        """Run over stacked frames [F, S_max], starting at the current
        ``frame_idx`` (0 for a fresh analyzer, mid-sequence after
        :meth:`restore_latest`).  Host-resident input (numpy leaves, as
        the RadarScenes loader gives) is ingested through the
        double-buffered ``io/prefetch.py:chunk_uploader``; the per-frame
        results and checkpoints do not depend on it."""
        F = batches.range_m.shape[0]
        start = self.frame_idx

        def gt(i):
            return dict(
                gt_pose=None if gt_poses is None else gt_poses[i],
                gt_velocity=(None if gt_velocities is None
                             else gt_velocities[i]))

        if is_host_resident(batches) and prefetch_chunk > 0 and start < F:
            rest = fr._map(lambda x: x[start:], batches)
            chunks = chunk_uploader(rest, prefetch_chunk, self.device)
            for ci, chunk in enumerate(chunks):
                base = start + ci * prefetch_chunk
                for j in range(min(prefetch_chunk, F - base)):
                    self.process_frame(fr._frame(chunk, j, j + 1),
                                       **gt(base + j))
            return self.compute_error_metrics()
        for i in range(start, F):
            self.process_frame(fr._frame(batches, i, i + 1), **gt(i))
        return self.compute_error_metrics()

    def compute_error_metrics(self) -> Dict:
        """Position / yaw / velocity RMSE against the ground truth."""
        r = self.results
        out: Dict = {
            "frames_processed": self.frame_idx,
            "successful_estimates": int(np.sum(r["success"])),
            "mean_processing_time": float(np.mean(r["processing_times"]))
            if r["processing_times"] else 0.0,
        }
        if r.get("ground_truth_trajectory"):
            est = np.asarray(r["estimated_trajectory"])
            gt = np.asarray(r["ground_truth_trajectory"])
            vel_est = vel_gt = None
            if r.get("ground_truth_velocities"):
                vel_gt = np.asarray(r["ground_truth_velocities"])
                vel_est = np.asarray(
                    r["velocity_estimates"])[:, :vel_gt.shape[1]]
            out.update(planar_pose_errors(est, gt, vel_est, vel_gt))
        return out


# ---------------------------------------------------------------------------
# Real-time runtime
# ---------------------------------------------------------------------------

def _nbytes(frame) -> int:
    return sum(x.element_size() * x.nelement() if isinstance(x, torch.Tensor)
               else getattr(x, "nbytes", 0) for x in tree_leaves(frame))


class FrameBuffer:
    """Bounded frame history with a memory budget."""

    def __init__(self, max_frames: int = 100, max_memory_mb: float = 512.0):
        self.max_frames = max_frames
        self.max_memory_mb = max_memory_mb
        self._frames: collections.deque = collections.deque(maxlen=max_frames)
        self._lock = threading.Lock()
        self.dropped = 0

    def add_frame(self, frame) -> None:
        with self._lock:
            self._frames.append(frame)
            budget = self.max_memory_mb * 1e6
            while (len(self._frames) > 1
                   and sum(_nbytes(f) for f in self._frames) > budget):
                self._frames.popleft()
                self.dropped += 1

    def latest(self):
        with self._lock:
            return self._frames[-1] if self._frames else None

    def __len__(self):
        with self._lock:
            return len(self._frames)


class RealTimeProcessor:
    """Background-thread streaming driver with backpressure; each frame is
    the analyzer's real step, on the analyzer's device."""

    def __init__(self, cfg: PipelineConfig, queue_size: int = 8,
                 buffer_frames: int = 100, metrics_window: int = 100,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 10, device=DEFAULT):
        self.cfg = cfg
        self.analyzer = StreamingAnalyzer(cfg, checkpoint_dir=checkpoint_dir,
                                          checkpoint_every=checkpoint_every,
                                          device=device)
        self.buffer = FrameBuffer(max_frames=buffer_frames)
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self.processing_times: collections.deque = collections.deque(
            maxlen=metrics_window)
        self.frames_in = 0
        self.frames_processed = 0
        self.frames_dropped = 0
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._error: Optional[BaseException] = None
        self.latest_result: Optional[Dict] = None

    def _raise_worker_error(self) -> None:
        if self._error is not None:
            raise self._error

    def start_processing(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop_processing(self, timeout: float = 5.0) -> None:
        """Stop the worker; raises the exception that ended it, if any."""
        self._running = False
        if self._thread is not None:
            try:
                self.queue.put_nowait(None)       # wake the worker
            except queue.Full:
                pass                              # it wakes on its timeout
            self._thread.join(timeout)
            self._thread = None
        self._raise_worker_error()

    def add_frame_for_processing(self, scatterers: ScattererBatch) -> bool:
        """Enqueue a frame; drops it when the queue is full."""
        self._raise_worker_error()
        self.frames_in += 1
        try:
            self.queue.put_nowait(scatterers)
            return True
        except queue.Full:
            self.frames_dropped += 1
            return False

    def _loop(self) -> None:
        dev = self.analyzer.device
        try:
            if dev.type == "cuda" and dev.index is not None:
                torch.cuda.set_device(dev)
            while self._running:
                try:
                    item = self.queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is None:
                    break
                t0 = time.perf_counter()
                self.latest_result = self.analyzer.process_frame(item)
                self.buffer.add_frame(item)
                self.processing_times.append(time.perf_counter() - t0)
                self.frames_processed += 1
        except Exception as e:  # kept for the caller; the worker ends here
            logger.exception("real-time worker failed")
            self._error = e
            self._running = False

    def get_performance_metrics(self) -> Dict:
        """Rolling metrics plus the latency percentiles a real-time layer
        is accountable for; raises the worker's exception, if any."""
        self._raise_worker_error()
        times = list(self.processing_times)
        return {
            "frames_in": self.frames_in,
            "frames_processed": self.frames_processed,
            "frames_dropped": self.frames_dropped,
            "buffer_size": len(self.buffer),
            "avg_processing_time": float(np.mean(times)) if times else 0.0,
            "max_processing_time": float(np.max(times)) if times else 0.0,
            "p50_latency_s": float(np.percentile(times, 50)) if times else 0.0,
            "p99_latency_s": float(np.percentile(times, 99)) if times else 0.0,
            "throughput_fps": (1.0 / float(np.mean(times))
                               if times and np.mean(times) > 0 else 0.0),
        }

    def get_system_status(self) -> Dict:
        """The CUDA devices' names and, where psutil is installed, a CPU,
        memory and disk snapshot."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        status: Dict = {
            "devices": [torch.cuda.get_device_name(i) for i in range(n)],
            "device": str(self.analyzer.device)}
        try:
            import psutil
            status.update({
                "cpu_percent": psutil.cpu_percent(interval=None),
                "memory_percent": psutil.virtual_memory().percent,
                "disk_percent": psutil.disk_usage("/").percent,
            })
        except ImportError:
            status["psutil"] = "unavailable"
        return status


class RealTimeVelocityEstimator:
    """High-level streaming facade."""

    def __init__(self, cfg: PipelineConfig, **kwargs):
        self.processor = RealTimeProcessor(cfg, **kwargs)

    def start_estimation(self) -> None:
        self.processor.start_processing()

    def stop_estimation(self) -> None:
        self.processor.stop_processing()

    def add_frame(self, scatterers: ScattererBatch) -> bool:
        return self.processor.add_frame_for_processing(scatterers)

    def get_latest_velocity_estimate(self) -> Optional[Dict]:
        return self.processor.latest_result

    def get_performance_metrics(self) -> Dict:
        return self.processor.get_performance_metrics()


def create_real_time_estimator(cfg: Optional[PipelineConfig] = None,
                               **kwargs) -> RealTimeVelocityEstimator:
    """A :class:`RealTimeVelocityEstimator` at ``cfg``, by default
    ``complete_analysis_config()``."""
    return RealTimeVelocityEstimator(cfg or complete_analysis_config(),
                                     **kwargs)
