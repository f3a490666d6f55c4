"""The program's spans (``utils/profiling.py``): the recorder off and on,
its clock against the CPU profiler's, the spans the drivers open, and the
numbers ``scripts/torch_span_pass.py`` reads from them.

Off, ``span()`` is one shared no-op context and nothing is recorded; on,
spans nest per thread with their parents, self times and request ids,
every value known on the host, so the outputs and the list of aten ops of
a driver are the same either way.  The drivers run here on the CPU at a
narrow one-pass configuration (K1's plain version).  The card test
(``card``, skipped without an NVIDIA card) holds the spans to the device
trace's clock: run it on the card with

    python -m pytest tests/test_torch_spans.py -q -m card --noconftest
"""

import dataclasses
import importlib.util
import json
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
from radar_slam_tpu_torch.aoa import estimators
from radar_slam_tpu_torch.core import config as tcfg
from radar_slam_tpu_torch.io import prefetch
from radar_slam_tpu_torch.io.synthetic import (SceneConfig,
                                               constant_motion_scene,
                                               constant_motion_scene_3d,
                                               constant_motion_scene_rig)
from radar_slam_tpu_torch.ops import _build
from radar_slam_tpu_torch.pipeline import frame as tframe
from radar_slam_tpu_torch.pipeline import streaming
from radar_slam_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]

# A narrow radar on the one-pass route (K1 and its finalize tail).
CFG = tcfg.PipelineConfig(
    radar=tcfg.RadarConfig(noise_power=1e-6, num_chirps=16,
                           bandwidth=250e6, chirp_duration=12.8e-6),
    detection=tcfg.DetectionConfig(cfar_train_cells=4, guard_cells=1,
                                   cfar_offset_db=12.0, max_detections=16),
    aoa=tcfg.AoAConfig(search_resolution_deg=3.0, max_targets=16,
                       track_capacity=32),
    max_scatterers=32, fft_mode="fused", synth_in_kernel=True)
RIG = ((1.8, 0.9, 0.4), (1.8, -0.9, -0.4))


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


def _scene(frames, device="cpu"):
    batch, _ = constant_motion_scene(
        3, num_frames=frames, dt=CFG.frame_dt, v_body=(5.0, 0.3),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=24, max_scatterers=CFG.max_scatterers),
        device=device)
    return batch


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


# ---- the recorder ---------------------------------------------------------

def test_off_records_nothing_and_returns_the_shared_noop():
    profiling.disable()
    profiling.collect()
    a, b = profiling.span("step"), profiling.span("call", frames=3)
    assert a is b
    with a:
        with profiling.span("inner"):
            pass
    assert not profiling._on
    assert profiling.collect() == []


def test_nesting_parents_self_time_threads_and_requests(spans_on):
    other = {}

    def worker():
        with profiling.span("worker", request=99):
            time.sleep(0.002)
        other["thread"] = threading.get_ident()

    with profiling.span("step", request=7) as step:
        with profiling.span("step.front_end", route="one_pass"):
            time.sleep(0.003)
            with profiling.span("k1"):
                time.sleep(0.002)
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with profiling.span("step.fetch"):
            time.sleep(0.001)
    with profiling.span("call") as c1:
        pass
    with profiling.span("call") as c2:
        pass
    spans = profiling.collect()
    by = {s.name: s for s in spans if s.name not in ("call",)}
    assert [s.name for s in spans if s.name != "worker"] == [
        "k1", "step.front_end", "step.fetch", "step", "call", "call"]
    assert by["step"].parent is None and by["step"].id == step.id
    assert by["step.front_end"].parent == by["step"].id
    assert by["k1"].parent == by["step.front_end"].id
    assert by["step.fetch"].parent == by["step"].id
    assert by["step.front_end"].attrs == {"route": "one_pass"}
    # The worker thread's stack is its own: no parent, its own request.
    assert by["worker"].parent is None and by["worker"].request == 99
    assert by["worker"].thread == other["thread"] != by["step"].thread
    # Children inherit the request; roots without one take the counter.
    assert {by[n].request for n in ("step", "step.front_end", "k1",
                                    "step.fetch")} == {7}
    calls = [s for s in spans if s.name == "call"]
    assert calls[1].request == calls[0].request + 1
    assert [s.id for s in calls] == [c1.id, c2.id]
    own = profiling.self_ns(spans)
    dur = {s.name: s.end_ns - s.start_ns for s in spans}
    assert own[by["k1"].id] == dur["k1"]
    assert own[by["step.front_end"].id] == dur["step.front_end"] - dur["k1"]
    assert own[by["step"].id] == (dur["step"] - dur["step.front_end"]
                                  - dur["step.fetch"])
    assert own[by["step"].id] >= 0.0015e9      # the worker's wait


def test_collect_maps_onto_the_profiler_clock(spans_on):
    """A ``record_function`` probe opened inside a span lies inside the
    span as ``collect()`` maps it, within 1 ms, on the CPU profiler's
    absolute clock (``trace_start_ns()`` plus the event's offset); the
    nearest of three probes opens within 1 ms of its span."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with record_function("warm"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("outer"):
                with record_function("probe"):
                    torch.ones(64).sum()
                time.sleep(0.002)
    origin = prof.profiler.kineto_results.trace_start_ns()
    spans = profiling.collect()
    probes = [ev for ev in prof.events() if ev.name == "probe"]
    assert len(spans) == len(probes) == 3
    leads = []
    for s, ev in zip(spans, probes):
        start = origin + ev.time_range.start * 1e3
        end = origin + ev.time_range.end * 1e3
        assert s.start_ns - 1e6 <= start and end <= s.end_ns + 1e6
        leads.append(abs(start - s.start_ns))
    assert min(leads) < 1e6, leads


def test_trace_writes_the_spans_into_the_chrome_trace(tmp_path):
    """``trace(logdir)`` turns spans on for its body and writes them on a
    track of their own, on the trace's clock; after it spans are off and
    nothing is left to collect."""
    from torch.profiler import record_function
    profiling.disable()
    profiling.collect()
    with profiling.trace(str(tmp_path)):
        assert profiling._on
        with profiling.span("step", request=3):
            with record_function("probe"):
                torch.ones(8).sum()
    assert not profiling._on and profiling.collect() == []
    doc = json.loads((tmp_path / "trace.json").read_text())
    ev = doc["traceEvents"]
    step = [e for e in ev if e.get("cat") == "program_span"]
    probe = [e for e in ev if e.get("name") == "probe"]
    assert len(step) == 1 and len(probe) == 1
    assert step[0]["name"] == "step" and step[0]["args"]["request"] == 3
    assert step[0]["pid"] == "program spans"
    assert step[0]["ts"] - 1e3 <= probe[0]["ts"]
    assert (probe[0]["ts"] + probe[0]["dur"]
            <= step[0]["ts"] + step[0]["dur"] + 1e3)


@pytest.mark.parametrize("present", [True, False])
def test_build_span_says_whether_nvcc_ran(spans_on, tmp_path, monkeypatch,
                                          present):
    """``ops/_build.py:load`` opens ``build`` with the source's name and
    ``compiled``: False where the library was there, True where ``nvcc``
    ran (here a stand-in that writes the library)."""
    lib = tmp_path / "libfake-0.so"
    if present:
        lib.write_bytes(b"")
    ran = []

    def fake_nvcc(cmd, **kw):
        ran.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return type("P", (), {"returncode": 0, "stdout": "", "stderr": ""})

    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    assert _build.load.__wrapped__("fake") == str(lib)
    (build,) = profiling.collect()
    assert build.name == "build" and build.parent is None
    assert build.attrs == {"name": "fake", "compiled": not present}
    assert bool(ran) == (not present)


# ---- the instrumented entry points -----------------------------------------

def test_process_frame_yields_step_with_its_four_stages(spans_on):
    batch = _scene(2)
    a = streaming.StreamingAnalyzer(CFG, device="cpu")
    for j in range(2):
        a.process_frame(tframe._frame(batch, j, j + 1))
    spans = profiling.collect()
    steps = [s for s in spans if s.name == "step"]
    assert [s.request for s in steps] == [0, 1]
    for step in steps:
        assert step.parent is None
        assert _children(spans, step) == ["step.front_end", "step.aoa",
                                          "step.tail", "step.fetch"]
        (fe,) = [s for s in spans if s.parent == step.id
                 and s.name == "step.front_end"]
        assert _children(spans, fe) == ["k1", "finalize"]
        assert {s.request for s in spans if s.parent == step.id} == {
            step.request}
    m = _script().step_host_ms(spans)
    stages = sum(m[k] for k in ("front_end", "aoa", "tail", "fetch"))
    assert all(m[k] > 0 for k in ("front_end", "aoa", "tail", "fetch"))
    assert stages + m["step_self"] == pytest.approx(m["step"], rel=1e-9)


def test_process_sequence_batched_yields_call_and_both_phases(spans_on):
    tframe.process_sequence_batched(_scene(3),
                                    torch.Generator().manual_seed(0), CFG)
    spans = profiling.collect()
    (call,) = [s for s in spans if s.name == "call"]
    assert call.parent is None and call.attrs == {"frames": 3}
    assert _children(spans, call) == ["phase_a", "phase_b"]
    (a,) = [s for s in spans if s.name == "phase_a"]
    assert _children(spans, a) == ["k1", "finalize", "aoa_features"]
    assert {s.request for s in spans} == {call.request}


def test_rig_batched_prefetch_yields_the_ingest_spans(spans_on):
    """On the CPU the uploader copies each chunk out of the host arrays
    (``ingest.fill``); phase A a chunk, one phase B, all in the call.
    The pinned staging and the wait on a buffer's copy exist on the card
    only (the card test's batched calls do not run them)."""
    batch, _ = constant_motion_scene_rig(
        11, num_frames=5, dt=CFG.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.25, rig=RIG,
        scene=SceneConfig(num_points=24, max_scatterers=CFG.max_scatterers,
                          fov_rad=1.8), device="cpu")
    host = tframe._map(lambda x: x.numpy(), batch)
    prefetch.process_sequence_rig_batched_prefetch(
        host, torch.Generator().manual_seed(0), CFG, RIG, chunk=2,
        device="cpu")
    spans = profiling.collect()
    (call,) = [s for s in spans if s.name == "call"]
    assert call.attrs == {"frames": 5}
    assert _children(spans, call) == ["ingest.fill", "phase_a"] * 3 + [
        "phase_b"]


# The AoA stage's spans and counters, on a URA (the ura8x4_s512
# configuration's 181 x 61 joint grid at a 4 x 2 array) and on a ULA (the
# bench's 91-point grid at 2 deg).
URA_CFG = dataclasses.replace(
    CFG, radar=dataclasses.replace(CFG.radar, num_antennas=4,
                                   num_antennas_el=2),
    aoa=dataclasses.replace(CFG.aoa, search_resolution_deg=1.0,
                            el_min_deg=-45.0, el_max_deg=45.0,
                            el_resolution_deg=1.5))
ULA_CFG = dataclasses.replace(
    CFG, aoa=dataclasses.replace(CFG.aoa, search_resolution_deg=2.0))
AOA_CASES = {"ura": (URA_CFG, 181 * 61, 8), "ula": (ULA_CFG, 91, 8)}


def _aoa_call(cfg, frames=3):
    batch, _ = constant_motion_scene_3d(
        5, num_frames=frames, dt=cfg.frame_dt, v_body=(8.0, 0.5, 1.0),
        yaw_rate=0.05,
        scene=SceneConfig(num_points=24, max_scatterers=cfg.max_scatterers),
        z_span=5.0, device="cpu")
    return tframe.process_sequence_batched(
        batch, torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("case", sorted(AOA_CASES))
def test_aoa_grid_and_confidence_nest_under_aoa_features(spans_on, case):
    cfg, grid_points, elements = AOA_CASES[case]
    _aoa_call(cfg)
    spans = profiling.collect()
    (feat,) = [s for s in spans if s.name == "aoa_features"]
    assert _children(spans, feat) == ["aoa_grid", "aoa_confidence"]
    (grid,) = [s for s in spans if s.name == "aoa_grid"]
    assert grid.attrs == {"signatures": 3 * cfg.detection.max_detections,
                          "grid_points": grid_points, "elements": elements,
                          "route": "spectrum"}
    assert {s.request for s in spans} == {feat.request}


@pytest.mark.parametrize("case", sorted(AOA_CASES))
def test_beamforming_counters_count_signature_grid_pairs(case, monkeypatch):
    """One call, one chunk, signatures x grid points products, counted
    with the spans off as on; reset by assigning 0."""
    cfg, grid_points, _ = AOA_CASES[case]
    bf = estimators.beamforming_spectrum
    for name in ("calls", "chunks", "products"):
        monkeypatch.setattr(bf, name, 0)
    _aoa_call(cfg)
    signatures = 3 * cfg.detection.max_detections
    assert (bf.calls, bf.chunks, bf.products) == (
        1, 1, signatures * grid_points)


def test_span_pass_reads_the_aoa_spans_and_counters(spans_on):
    """The script's readers on two URA calls: host ms a unit of each AoA
    span, and the counters' increments a unit (one K1 wrapper call on the
    CPU launches no kernel, so K1's launch counts stay)."""
    script = _script()
    before = script.counters()
    for _ in range(2):
        _aoa_call(URA_CFG)
    counted = script.per_unit(script.counters(), before, 2)
    spans = script.on_clock(profiling.collect(), 0)
    ms = script.span_host_ms(spans, script.AOA_SPANS, 2)
    assert ms["aoa_features"] >= ms["aoa_grid"] + ms["aoa_confidence"] > 0
    assert counted["beamforming_spectrum.calls"] == 1
    assert counted["beamforming_spectrum.products"] == (
        3 * URA_CFG.detection.max_detections * 181 * 61)
    assert counted["k1.launches"] == 0
    assert counted["k1.branch_launches.tiled_rows"] == 0


def test_aoa_spans_off_record_nothing():
    profiling.disable()
    profiling.collect()
    _aoa_call(URA_CFG, frames=2)
    assert profiling.collect() == []


def _aten_ops(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [ev.name for ev in prof.events()
                 if ev.name.startswith("aten::")]


@pytest.mark.parametrize("driver", ["batched", "step"])
def test_on_and_off_give_the_same_outputs_and_aten_ops(driver):
    """Spans add no tensor operation: the same outputs bit for bit and the
    same list of aten ops under the CPU profiler, off and on."""
    batch = _scene(3)

    def run():
        if driver == "batched":
            return tframe.process_sequence_batched(
                batch, torch.Generator().manual_seed(0), CFG)
        a = streaming.StreamingAnalyzer(CFG, device="cpu")
        for j in range(2):
            a.process_frame(tframe._frame(batch, j, j + 1))
        return a.state

    run()                                   # warm the cached constants
    profiling.disable()
    off, ops_off = _aten_ops(run)
    profiling.enable()
    try:
        on, ops_on = _aten_ops(run)
    finally:
        profiling.disable()
        n_spans = len(profiling.collect())
    assert n_spans > 0
    assert ops_on == ops_off and len(ops_off) > 100
    a, b = torch.utils._pytree.tree_leaves(off), \
        torch.utils._pytree.tree_leaves(on)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


# ---- one clock for the processing times ------------------------------------

def test_processing_times_use_the_step_spans_clock(spans_on, monkeypatch):
    """The analyzer and the real-time worker time a step on
    ``time.perf_counter``, the spans' clock, not the wall clock: a wall
    clock stuck at 0 (in the module's view of ``time`` only) leaves them
    as they are."""
    monkeypatch.setattr(streaming, "time", types.SimpleNamespace(
        time=lambda: 0.0, perf_counter=time.perf_counter))
    batch = _scene(2)
    a = streaming.StreamingAnalyzer(CFG, device="cpu")
    r = a.process_frame(tframe._frame(batch, 0, 1))
    (step,) = [s for s in profiling.collect() if s.name == "step"]
    assert r["processing_time"] >= (step.end_ns - step.start_ns) * 1e-9 > 0
    assert a.results["processing_times"] == [r["processing_time"]]
    rt = streaming.RealTimeProcessor(CFG, device="cpu")
    rt.start_processing()
    try:
        assert rt.add_frame_for_processing(tframe._frame(batch, 1, 2))
        deadline = time.monotonic() + 60
        while rt.frames_processed < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        rt.stop_processing()
    assert rt.frames_processed == 1
    assert list(rt.processing_times)[0] > 0


# ---- the readers of scripts/torch_span_pass.py ------------------------------

def _span(name, start, end, id, parent=None):
    return profiling.Span(name, start, end, id, parent, 1, 0, {})


def test_step_host_ms_reads_each_stage_and_the_step():
    """Two steps (s): the stages' durations per step, K1 inside the front
    end counted there, the step's own time the rest."""
    spans = []
    for k, t in enumerate((0.0, 1.0)):
        b = 10 * k
        spans += [_span("step", t, t + 0.040, b + 1),
                  _span("step.front_end", t + 0.001, t + 0.021, b + 2, b + 1),
                  _span("k1", t + 0.002, t + 0.012, b + 3, b + 2),
                  _span("step.aoa", t + 0.021, t + 0.025, b + 4, b + 1),
                  _span("step.tail", t + 0.025, t + 0.035, b + 5, b + 1),
                  _span("step.fetch", t + 0.035, t + 0.0395, b + 6, b + 1)]
    m = _script().step_host_ms(spans)
    assert m == pytest.approx({"front_end": 20.0, "aoa": 4.0, "tail": 10.0,
                               "fetch": 4.5, "step_self": 1.5,
                               "step": 40.0})
    assert _script().step_host_ms([_span("call", 0, 1, 1)]) is None


def test_step_host_ms_reads_each_path_apart():
    """Steps by their ``path`` (s): the eager stages over the eager step
    only, a replayed step's ``step.replay`` and ``step.fetch`` under
    ``replay``, a captured step's under ``capture``; a row a step with
    each stage in its column."""
    def s(name, start, end, id, parent=None, **attrs):
        return profiling.Span(name, start, end, id, parent, 1, 0, attrs)

    spans = [s("step", 0.0, 0.040, 1, path="eager"),
             s("step.front_end", 0.001, 0.021, 2, 1),
             s("step.aoa", 0.021, 0.025, 3, 1),
             s("step.tail", 0.025, 0.035, 4, 1),
             s("step.fetch", 0.035, 0.0395, 5, 1),
             s("step", 3.0, 3.100, 31, path="capture"),
             s("step.front_end", 3.001, 3.021, 32, 31),
             s("step.aoa", 3.021, 3.025, 33, 31),
             s("step.tail", 3.025, 3.035, 34, 31),
             s("step.replay", 3.035, 3.095, 35, 31),
             s("step.fetch", 3.095, 3.0995, 36, 31)]
    for k, t in enumerate((1.0, 2.0)):
        b = 10 * (k + 1)
        spans += [s("step", t, t + 0.006, b + 1, path="replay"),
                  s("step.replay", t + 0.0005, t + 0.0045, b + 2, b + 1),
                  s("step.fetch", t + 0.0045, t + 0.0055, b + 3, b + 1)]
    mod = _script()
    assert mod.step_host_ms(spans) == pytest.approx(
        {"front_end": 20.0, "aoa": 4.0, "tail": 10.0, "fetch": 4.5,
         "step_self": 1.5, "step": 40.0})
    assert mod.step_host_ms(spans, "replay") == pytest.approx(
        {"replay": 4.0, "fetch": 1.0, "step_self": 1.0, "step": 6.0})
    assert mod.step_host_ms(spans, "capture") == pytest.approx(
        {"front_end": 20.0, "aoa": 4.0, "tail": 10.0, "replay": 60.0,
         "fetch": 4.5, "step_self": 1.5, "step": 100.0})
    np.testing.assert_allclose(mod.step_rows(spans), [
        [40.0, 20.0, 4.0, 10.0, 0.0, 4.5],
        [100.0, 20.0, 4.0, 10.0, 60.0, 4.5],
        [6.0, 0.0, 0.0, 0.0, 4.0, 1.0], [6.0, 0.0, 0.0, 0.0, 4.0, 1.0]],
        rtol=1e-9, atol=1e-9)


def test_idle_by_span_counts_each_gap_once():
    """A 10 s window: gaps under ``call`` alone (other), inside ``k1`` of
    ``phase_a``, in ``ingest.fill``, in ``phase_b`` and after the call
    (none); the family sums to the pass's idle share."""
    from portbench.trace import DeviceEvent, Traced, idle_share
    mod = _script()
    spans = [_span("call", 0.5, 9.5, 1), _span("phase_a", 1.0, 4.0, 2, 1),
             _span("k1", 1.0, 2.0, 3, 2), _span("ingest.fill", 4.2, 4.8, 4, 1),
             _span("phase_b", 5.0, 9.2, 5, 1)]
    events = [DeviceEvent("k", s, e, "kernel") for s, e in
              ((1.2, 1.6), (1.8, 3.0), (3.5, 4.1), (5.3, 6.0), (5.5, 5.8),
               (7.0, 8.5), (9.6, 9.8))]
    idle = mod.idle_by_span(spans, events, 0.0, 10.0)
    assert idle == pytest.approx({"phase_a": 0.2 + 0.5, "phase_b": 1.0 + 1.1,
                                  "ingest": 1.2, "other": 1.2,
                                  "none": 0.2})
    share = idle_share(Traced(events, 10.0, 1, 1, 1))
    assert sum(idle.values()) / 10.0 == pytest.approx(share, abs=1e-12)
    assert mod.idle_by_span([], events, 0.0, 10.0) is None


def test_k1_clock_check_pairs_each_k1_span_with_its_fft():
    from portbench.trace import DeviceEvent
    mod = _script()
    spans = [_span("call", 0.0, 3.0, 1), _span("k1", 0.5, 0.6, 2, 1),
             _span("k1", 1.5, 1.6, 3, 1)]
    good = [DeviceEvent("range_fft_kernel<true>", 0.7, 0.8, "kernel"),
            DeviceEvent("z_power_kernel<true>", 0.8, 0.9, "kernel"),
            DeviceEvent("range_fft_kernel<true>", 1.55, 1.7, "kernel")]
    c = mod.k1_clock_check(spans, good)
    assert c["all_after"] and c["events_before_first_span"] == 0
    assert c["lag_s_min"] == pytest.approx(0.05)
    early = good + [DeviceEvent("copy", -0.1, -0.05, "h2d")]
    early[2] = DeviceEvent("range_fft_kernel<true>", 1.4, 1.7, "kernel")
    c = mod.k1_clock_check(spans, early)
    assert not c["all_after"] and c["events_before_first_span"] == 1


# ---- the repaired stage timing ----------------------------------------------

def test_chained_time_retakes_a_difference_that_is_not_positive(
        monkeypatch):
    """``bench_torch.chained_time`` differences STAGE_ITERS calls against a
    quarter as many; where the difference comes out not positive (calls
    that ran fast while the long run was timed), it retakes both with
    twice the calls and reports a positive time."""
    monkeypatch.setattr(bench_torch, "STAGE_ITERS", 4)
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        # The long run's 16 calls (warm + 3) cost nothing, the short
        # run's 4 cost 5 ms each, every later call 1 ms.
        n = calls["n"]
        time.sleep(0 if n <= 16 else 0.005 if n <= 20 else 0.001)

    t = bench_torch.chained_time(fn, torch.device("cpu"))
    assert calls["n"] > 20
    assert t > 0.0005


# ---- on the card -------------------------------------------------------------

@pytest.mark.card
def test_spans_on_the_device_trace_clock():
    """Batched calls at the benchmark's operating point on the card, spans
    on, in a CUDA-only trace between spin kernels: every K1
    ``range_fft_kernel`` starts after the mapped start of the ``k1`` span
    that launched it, and no device event before the first span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from torch.profiler import ProfilerActivity

    from portbench import trace as tr
    mod = _script()
    cfg = dataclasses.replace(tcfg.complete_analysis_config(),
                              max_scatterers=128)
    batch, _ = constant_motion_scene(
        0, num_frames=64, dt=cfg.frame_dt, v_body=(8.0, 0.5),
        yaw_rate=0.05, scene=SceneConfig(max_scatterers=128),
        device="cuda")
    gen = torch.Generator().manual_seed(0)
    tframe.process_sequence_batched(batch, gen, cfg)
    torch.cuda.synchronize()

    def calls():
        profiling.collect()
        for _ in range(4):
            out = tframe.process_sequence_batched(batch, gen, cfg)
            np.asarray(out.pose.cpu())

    profiling.enable()
    try:
        prof, raw, _ = tr.device_trace(calls, [ProfilerActivity.CUDA],
                                       tr.Pads())
    finally:
        profiling.disable()
    spans = mod.on_clock(profiling.collect(),
                         prof.profiler.kineto_results.trace_start_ns())
    check = mod.k1_clock_check(spans, tr.device_events(raw))
    assert check["k1_spans"] == check["range_fft_kernels"] == 4, check
    assert check["all_after"], check
    assert check["events_before_first_span"] == 0, check
