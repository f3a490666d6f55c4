"""The three-dispatch route's spans and the order statistic's counters, on
the CPU: ``call > phase_a > {k4, os_cfar, k5, aoa_features}`` with their
attributes, ``signal/detect.py:_os_noise``'s ``calls``, ``chunks`` and
``samples``, the same outputs bit for bit with the spans off and on, and
``scripts/torch_span_pass.py``'s readings of them.

The route runs at a narrow cut of the ``reference_fidelity``
configuration (16 chirps x 128 samples, S_max 32), as
``tests/test_torch_reference_fidelity_cell.py`` runs it.
"""

import copy
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from radar_slam_tpu_torch.core.config import config_from_dict
from radar_slam_tpu_torch.io.synthetic import (SceneConfig,
                                               constant_motion_scene)
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.signal import detect
from radar_slam_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
DOC = json.loads((REPO / "portbench/configs/reference_fidelity.json")
                 .read_text())


def _config(**detection):
    d = copy.deepcopy(DOC["pipeline"])
    d["radar"].update(num_chirps=16, bandwidth=250e6, chirp_duration=12.8e-6)
    d["max_scatterers"] = 32
    d["detection"].update(detection)
    if detection.get("cfar_mode") == "ca":
        d["frontend_one_pass"] = False
    return config_from_dict(d)


CFG = _config()
CASES = {"os": (CFG, "os"), "ca": (_config(cfar_mode="ca"), "ca")}


def _scene(frames, cfg=CFG):
    batch, _ = constant_motion_scene(
        3, num_frames=frames, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=24, max_scatterers=cfg.max_scatterers),
        device="cpu")
    return batch


def _call(cfg=CFG, frames=3):
    return tframe.process_sequence_batched(
        _scene(frames, cfg), torch.Generator().manual_seed(0), cfg)


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_span_pass", REPO / "scripts" / "torch_span_pass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def spans_on():
    """Spans on for the test, off and emptied after it."""
    profiling.collect()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.collect()


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_three_dispatch_call_nests_k4_os_cfar_k5_and_the_aoa(spans_on,
                                                               case):
    cfg, cfar = CASES[case]
    assert tframe._phase_a_route(cfg) == "three_dispatch"
    _call(cfg)
    spans = profiling.collect()
    (call,) = [s for s in spans if s.name == "call"]
    assert _children(spans, call) == ["phase_a", "phase_b"]
    (a,) = [s for s in spans if s.name == "phase_a"]
    assert _children(spans, a) == ["k4", "os_cfar", "k5", "aoa_features"]
    attrs = {s.name: s.attrs for s in spans
             if s.name in ("k4", "os_cfar", "k5")}
    assert attrs == {
        "k4": {"fidelity": "reference"},
        "os_cfar": {"cfar": cfar, "chunks": 1 if cfar == "os" else 0},
        "k5": {"signatures": 3 * cfg.detection.max_detections}}
    assert {s.request for s in spans} == {call.request}


@pytest.mark.parametrize("frames", [3, 130])
def test_the_order_statistic_counts_its_calls_chunks_and_samples(
        frames, monkeypatch):
    """One call a batched call, one sort a 128 frames, F * R * D * 4 train
    samples; counted with the spans off, reset by assigning 0."""
    for name in ("calls", "chunks", "samples"):
        monkeypatch.setattr(detect._os_noise, name, 0)
    p = torch.rand(frames, 128, 16) + 1e-3
    detect._os_noise(p, 8, 2, 0.75)
    train = CFG.detection.cfar_train_cells
    assert (detect._os_noise.calls, detect._os_noise.chunks,
            detect._os_noise.samples) == (
        1, -(-frames // 128), frames * 128 * 16 * 4 * train)
    assert detect.os_chunks(frames, CFG.detection) == -(-frames // 128)
    assert detect.os_chunks(frames, CASES["ca"][0].detection) == 0


def test_a_call_counts_its_order_statistic_samples(monkeypatch):
    for name in ("calls", "chunks", "samples"):
        monkeypatch.setattr(detect._os_noise, name, 0)
    _call(frames=3)
    R, D = CFG.radar.samples_per_chirp, CFG.radar.num_chirps
    assert detect._os_noise.calls == 1
    assert detect._os_noise.samples == (
        3 * R * D * 4 * CFG.detection.cfar_train_cells)


def test_spans_off_and_on_give_the_same_outputs_bit_for_bit():
    batch = _scene(3)

    def run():
        return tframe.process_sequence_batched(
            batch, torch.Generator().manual_seed(0), CFG)

    run()                                   # warm the cached constants
    profiling.disable()
    profiling.collect()
    off = run()
    assert profiling.collect() == []
    profiling.enable()
    try:
        on = run()
    finally:
        profiling.disable()
        names = {s.name for s in profiling.collect()}
    assert {"k4", "os_cfar", "k5"} <= names
    a, b = (torch.utils._pytree.tree_leaves(x) for x in (off, on))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


def test_the_span_pass_reports_the_three_dispatch_spans(spans_on):
    """The script's readers on two calls: host ms a unit of ``k4``,
    ``os_cfar`` and ``k5`` inside ``phase_a``, and the counters'
    increments a unit (the plain versions launch no kernel)."""
    script = _script()
    assert script.THREE_DISPATCH_SPANS == ("k4", "os_cfar", "k5")
    before = script.counters()
    for _ in range(2):
        _call()
    counted = script.per_unit(script.counters(), before, 2)
    spans = script.on_clock(profiling.collect(), 0)
    ms = script.span_host_ms(spans, ("phase_a",)
                             + script.THREE_DISPATCH_SPANS, 2)
    parts = [ms[k] for k in script.THREE_DISPATCH_SPANS]
    assert min(parts) > 0 and ms["phase_a"] >= sum(parts)
    R, D = CFG.radar.samples_per_chirp, CFG.radar.num_chirps
    assert counted["os_noise.calls"] == 1
    assert counted["os_noise.chunks"] == 1
    assert counted["os_noise.samples"] == 3 * R * D * 4 * 8
    assert counted["k4.launches"] == counted["k5.launches"] == 0
    assert counted["k1.launches"] == 0

