"""On the card: at each cell's own size, the program's readings pass every
limit and the control's (the reference computed with TF32 products in the
program's place) fail one, on three seeds.

    python -m pytest portbench/tests/test_portbench_control.py -q -m card
"""

import json
from pathlib import Path

import pytest

from portbench import compare, control, registry

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell, card):
    limits = registry.Cell(cell, registry.load_benchmark()).limits["numbers"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = control.readings(cell, seed, None, True)
        ok, rows = compare.judge(r["program"], limits)
        assert ok, rows
        ok, rows = compare.judge(r["control"], limits)
        assert not ok, rows
