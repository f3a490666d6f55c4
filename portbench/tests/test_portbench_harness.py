"""The harness: every name resolves to its file, the file is within the
benchmark's contract, each cell's set-up and window run at a tiny size on
the CPU, a new configuration / mix / metric takes only new files, and
nothing the card runs imports JAX or the JAX package."""

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import registry, run

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_name_resolves_to_its_file(name):
    cell = registry.Cell(name, BENCH)
    assert cell.config["name"] == cell.entry["config"]
    assert (ROOT / cell.config_entry["file"]).is_file()
    assert cell.config_entry["file"].startswith("portbench/configs/")
    assert hasattr(cell.driver, "Driver") and hasattr(cell.scene, "make")
    assert set(cell.limits["numbers"])
    for kind, metrics in (("end_to_end", cell.end_to_end),
                          ("layer_metrics", cell.per_layer)):
        for mod in cell.readers(kind, metrics).values():
            assert callable(mod.read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_benchmark_file_keeps_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"][1].startswith("portbench/")
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


def _check_result(res):
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checked"}
    assert list(res)[-1] == "checked"
    for m in res["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_set_up_and_window_run_on_the_cpu(name, tiny):
    res, rows, info = run.run_cell(name, 2 ** 31 + 17, 0.2, False,
                                   device="cpu", bench=BENCH)
    _check_result(res)
    assert res["correct"], rows
    assert res["failed"] == 0 and res["attempted"] > 0
    assert info["compared_frames"] > 0
    assert set(res["metrics"]) == {
        m["name"] for m in registry.Cell(name, BENCH).end_to_end}


def _digest(root: Path):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_take_only_new_files(tmp_path):
    """A throwaway configuration, mix, cell and metrics in a copy: only new
    files and entries, and the copy's harness runs the new cell."""
    copy = tmp_path / "checkout"
    shutil.copytree(HERE, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(copy / "portbench")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "bench_s128.json").read_text())
    cfg["name"] = "bench_s128_wide_fov"
    cfg["scene"]["fov_rad"] = 2.0
    (copy / "portbench/configs/bench_s128_wide_fov.json").write_text(
        json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "batch_8192.json").read_text())
    mix.update(frames=12, pool=1, check_among=1)
    (copy / "portbench/traffic/batch_12.json").write_text(json.dumps(mix))
    (copy / "portbench/limits/batch_12.bench_s128_wide_fov.json").write_text(
        (HERE / "limits" / "batch_8192.bench_s128.json").read_text())
    (copy / "portbench/end_to_end/frames_completed.py").write_text(
        "def read(win):\n    return float(win['frames'])\n")
    (copy / "portbench/layer_metrics/kernel_count.py").write_text(
        "def read(rec):\n    return float(len(rec.events)) or None\n")
    b["configs"].append({"name": "bench_s128_wide_fov", "source": "test",
                         "file": "portbench/configs/bench_s128_wide_fov.json",
                         "reduced": [], "why": "test"})
    cell = "batch_12.bench_s128_wide_fov"
    b["workloads"].append({"name": cell, "config": "bench_s128_wide_fov",
                           "traffic": "batch_12", "chips": 1, "why": "t"})
    b["end_to_end"].append({"name": "frames_completed", "unit": "frames",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock", "workloads": [cell]})
    b["per_layer"].append({"name": "kernel_count", "unit": "kernels",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "frames_completed",
                           "workloads": [cell]})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))
    after = _digest(copy / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(copy)!r}, {str(ROOT)!r}]\n"
        "from portbench import registry, run\n"
        "assert registry.HERE.parent == __import__('pathlib').Path("
        f"{str(copy)!r})\n"
        f"c = registry.Cell({cell!r}, registry.load_benchmark())\n"
        "assert [m['name'] for m in c.per_layer] == ['kernel_count']\n"
        f"res, rows, _ = run.run_cell({cell!r}, 5, 0.1, False, "
        "device='cpu')\n"
        "print(json.dumps(run._plain(res)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["frames_completed"]["value"] > 0


BLOCKER = """
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "radar_slam_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
"""


def test_nothing_the_card_runs_imports_jax():
    """In a process where jax, jaxlib, flax and radar_slam_tpu (compared
    by whole top-level name) cannot be imported, the harness, every driver,
    scene and metric, the reference and the program's modules it drives
    import, and none of those names is loaded."""
    mods = ["portbench.run", "portbench.control", "portbench.trace",
            "portbench.reference.pipeline",
            "radar_slam_tpu_torch.pipeline.frame",
            "radar_slam_tpu_torch.io.prefetch",
            "radar_slam_tpu_torch.pipeline.streaming"]
    files = [p for d in ("drivers", "scenes", "end_to_end", "layer_metrics",
                         "work") for p in sorted((HERE / d).glob("*.py"))]
    code = (BLOCKER + f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import importlib\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "from portbench import registry, run\n"
            f"for f in {[str(p) for p in files]!r}:\n"
            "    registry.module(__import__('pathlib').Path(f))\n"
            "assert run.forbidden_modules() == [], run.forbidden_modules()\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "radar_slam_tpu_torch_extra", None)
    monkeypatch.setitem(sys.modules, "jaxtyping", None)
    assert "radar_slam_tpu" not in run.forbidden_modules()
    assert "jax" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", None)
    assert "jax" in run.forbidden_modules()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    top = {m.split(".")[0] for m in _imports(path)}
    assert not top & {"radar_slam_tpu_torch", "radar_slam_tpu", "jax",
                      "jaxlib", "flax"}, top


def test_phase_b_of_the_reference_is_plain_numpy():
    """The reference's estimation shares no code with the program's: it
    imports the standard library and NumPy alone."""
    top = {m.split(".")[0] for m in _imports(HERE / "reference/estimation.py")}
    assert top <= {"__future__", "dataclasses", "math", "typing", "numpy"}, top


def test_no_card_means_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ has no program
    to run: the run stops at the program's import (``main`` exits 3)."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, pathlib\n"
            f"sys.path[:] = [{str(tmp_path)!r}] + [\n"
            "    p for p in sys.path if p and not (pathlib.Path(p)\n"
            "    / 'radar_slam_tpu_torch').exists()]\n"
            "from portbench import run\n"
            "try:\n"
            f"    run.run_cell({CELLS[0]!r}, 1, 0.1, False, device='cpu')\n"
            "except ImportError as e:\n"
            "    print('no program:', e.name)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert "no program: radar_slam_tpu_torch" in out.stdout, out.stderr
