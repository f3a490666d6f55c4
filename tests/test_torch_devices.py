"""Where the port allocates: its entry points run on the card unless the
caller names another device, and raise where there is no card; and the
kernel build's cache key covers the headers a source includes.

Each test decides inside itself whether a card is present (never at
import), so every worker collects the same tests."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from radar_slam_tpu_torch.aoa import estimators, smoothing
from radar_slam_tpu_torch.core import geometry
from radar_slam_tpu_torch.core.config import complete_analysis_config
from radar_slam_tpu_torch.io.synthetic import (SceneConfig,
                                               constant_motion_scene)
from radar_slam_tpu_torch.ops import _build, range_dft
from radar_slam_tpu_torch.ops.windows import get_window
from radar_slam_tpu_torch.parallel import posegraph
from radar_slam_tpu_torch.pipeline import frame
from radar_slam_tpu_torch.signal import rds, synth

CFG = complete_analysis_config()


def _scene(**kw):
    return constant_motion_scene(
        7, num_frames=2, dt=CFG.frame_dt, v_body=(8.0, 0.5), yaw_rate=0.05,
        scene=SceneConfig(num_points=16, max_scatterers=32), **kw)[0].range_m


def _graph(**kw):
    """A two-pose chain with its anchor, built from numpy arrays."""
    arrays = {"poses": np.zeros((2, 3)), "fi": np.zeros(1),
              "fj": np.ones(1), "delta": np.zeros((1, 3)),
              "info": np.ones((1, 3)), "factor_valid": np.ones(1, bool),
              "anchor": np.zeros(3), "anchor_info": np.ones(3)}
    return posegraph.posegraph_from_numpy(arrays, **kw).poses


# Each entry point with the arguments it needs, returning one tensor it
# allocated.
ENTRY_POINTS = {
    "constant_motion_scene": _scene,
    "frame.init_state": lambda **kw: frame.init_state(CFG, **kw).pose,
    "smoothing.init_state": lambda **kw: smoothing.init_state(CFG.aoa,
                                                              **kw).keys,
    "get_window": lambda **kw: get_window("hann", 16, **kw),
    "fast_time_base": lambda **kw: synth.fast_time_base(CFG.radar, **kw),
    "reference_chirp": lambda **kw: synth.reference_chirp(CFG.radar, **kw),
    "range_axis_m": lambda **kw: rds.range_axis_m(CFG.radar, **kw),
    "doppler_axis_hz": lambda **kw: rds.doppler_axis_hz(CFG.radar, **kw),
    "doppler_dft_matrix": lambda **kw: rds.doppler_dft_matrix(8, "hann",
                                                              **kw),
    "_mix_vector": lambda **kw: rds._mix_vector(CFG.radar, CFG.window,
                                                "raw", 400, **kw),
    "azimuth_grid_deg": lambda **kw: estimators.azimuth_grid_deg(CFG.aoa,
                                                                 **kw),
    "grid_steering_matrix": lambda **kw: estimators.grid_steering_matrix(
        CFG.radar, CFG.aoa, **kw),
    "antenna_positions": lambda **kw: geometry.antenna_positions(8, 0.002,
                                                                 **kw),
    "range_dft.twiddles": lambda **kw: range_dft.twiddles(400, **kw),
    "posegraph_from_numpy": _graph,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    """Without a device argument an entry point allocates on the card, or
    raises where there is none; with device="cpu" it returns CPU
    tensors."""
    fn = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert fn().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert fn(device="cpu").device.type == "cpu"


def test_init_state_is_wholly_on_the_device():
    """Every tensor of the sequential state lies where it was asked for."""
    cfg = dataclasses.replace(CFG, detection=dataclasses.replace(
        CFG.detection, clutter_map_alpha=0.05))
    state = frame.init_state(cfg, initial_pose=[1.0, 2.0, 0.1],
                             device="cpu")
    tensors = [state.pose, state.prev_valid, state.prev_motion,
               state.clutter, *state.smoother, *state.prev_targets]
    assert all(x.device.type == "cpu" for x in tensors
               if isinstance(x, torch.Tensor))


def test_library_name_covers_included_headers(tmp_path):
    """An edit to a header that a source includes renames the source's
    library (so a stale build is never loaded); a file it does not
    include leaves it alone.  Nothing is compiled."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    names = [p.name for p in _build.sources("frontend", csrc)]
    assert names[0] == "frontend.cu"
    assert {"range_fft.cuh", "tf32x3.cuh", "philox.cuh",
            "cube_onchip.cuh"} <= set(names)
    assert [p.name for p in _build.sources("cube", csrc)] == [
        "cube.cu", "cube_onchip.cuh", "philox.cuh", "range_fft.cuh",
        "tf32x3.cuh"]
    front, cube = (_build.library_path(n, csrc) for n in ("frontend", "cube"))
    assert front == _build.library_path("frontend")
    header = csrc / "range_fft.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    for name in ("frontend", "synthpower", "cube"):
        assert _build.library_path(name, csrc) != _build.library_path(name)
    cube = _build.library_path("cube", csrc)
    source = csrc / "frontend.cu"
    source.write_bytes(source.read_bytes() + b"\n// edited\n")
    assert _build.library_path("cube", csrc) == cube
