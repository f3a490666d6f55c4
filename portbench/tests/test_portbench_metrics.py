"""The per-layer readers on hand-made traces: which kernels K1's
roofline counts, and what the tail counts instead."""

import importlib.util
from pathlib import Path

import pytest

from portbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
CONFIG = {"pipeline": __import__("json").loads(
    (ROOT / "portbench/configs/bench_s128.json").read_text())["pipeline"]}

# Demangled names as the profiler gives them.
K1_CFAR = ("(anonymous namespace)::cfar_kernel(float const*, float*, "
           "float const*, int, int, int, int, int, float, float, int, int, "
           "float, int)")
K1_POWER = ("void (anonymous namespace)::z_power_kernel<true, 0, false>("
            "(anonymous namespace)::Factors, float2 const*, float2 const*, "
            "float*, int)")
K10_CFAR = ("void (anonymous namespace)::cfar_kernel<true>(float2 const*, "
            "float*, unsigned char*, int, int, int, int, int, int, float, "
            "float, int, int, int, float, float, float)")
TAIL = "void at::native::vectorized_elementwise_kernel<4>(int, float*)"


def _reader(name):
    path = ROOT / "portbench/layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(full, start, end):
    return tr.DeviceEvent(tr.kernel_name(full), start, end, "kernel", full)


def _record(events):
    return tr.Traced(events, 1.0, 1, 64, 64, {"config": CONFIG})


def test_parameter_types_drop_namespaces_and_qualifiers():
    assert tr.parameter_types(K1_CFAR)[:3] == ["float*", "float*", "float*"]
    assert tr.parameter_types(K10_CFAR)[:3] == ["float2*", "float*",
                                                "unsignedchar*"]
    assert tr.parameter_types(K1_POWER)[0] == "Factors"
    assert tr.parameter_types("cfar_kernel") == []


@pytest.mark.parametrize("full, counted", [
    (K1_CFAR, True), (K1_POWER, True), (K10_CFAR, False), (TAIL, False),
    ("cfar_kernel", False)])
def test_k1_is_told_apart_by_its_signature(full, counted):
    """K10's ``cfar_kernel`` (csrc/cube.cu) shares K1's short name; only
    the signature tells them apart."""
    assert _reader("k1_roofline").is_k1(_event(full, 0.0, 1.0)) is counted


def test_a_k10_cfar_goes_to_the_tail_not_to_k1():
    k1 = _reader("k1_roofline")
    tail = _reader("tail_device_ms_per_kframe")
    only_k1 = _record([_event(K1_CFAR, 0.0, 1e-3),
                       _event(K1_POWER, 1e-3, 2e-3)])
    with_k10 = _record(only_k1.events + [_event(K10_CFAR, 2e-3, 7e-3)])
    assert k1.read(with_k10) == pytest.approx(k1.read(only_k1))
    assert tail.read(only_k1) is None
    # 5 ms of K10 over 64 frames: 78.125 ms per 1,000 frames.
    assert tail.read(with_k10) == pytest.approx(5e-3 * 1e3 / 0.064)


def test_no_k1_kernel_reads_nothing():
    assert _reader("k1_roofline").read(
        _record([_event(K10_CFAR, 0.0, 1e-3)])) is None
