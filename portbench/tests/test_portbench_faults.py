"""Runs with the timed path broken underneath come out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU at a tiny size (the ``tiny`` fixture), with one fault planted in the
program's path: an answer altered where it is produced (a velocity off by
0.5 m/s), half of the batch left out (the other half's answers in its
place), a step that returns its state unchanged.  The cells run on one card, so no exchange between cards
can be left out."""

import json
from pathlib import Path

import pytest
import torch

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CALL_CELLS = ["batch_8192.bench_s128", "ingest_2048.radarscenes_s512"]


def _altered(drv):
    call = drv._call

    def wrong(*a, **k):
        out = call(*a, **k)
        m = out.motion
        return out._replace(motion=m._replace(velocity=m.velocity + 0.5))
    drv._call = wrong


def _half_left_out(drv):
    """The call computes the first half of the frames and hands the host
    its answers for the second half too."""
    call = drv._call

    def half(inputs, gen_seed):
        F = inputs.range_m.shape[0]
        first = type(inputs)(*[None if x is None else x[:F // 2]
                               for x in inputs])
        out = call(first, gen_seed)

        def fill(x):
            return torch.cat([x, x[:F - F // 2]]) if torch.is_tensor(x) else x
        return type(out)(*[type(v)(*[fill(x) for x in v])
                           if hasattr(v, "_fields") else fill(v)
                           for v in out])
    drv._call = half


@pytest.mark.parametrize("cell", CALL_CELLS)
@pytest.mark.parametrize("fault", [_altered, _half_left_out],
                         ids=["answer_altered", "half_left_out"])
def test_a_broken_call_is_not_correct(cell, fault, tiny):
    res, rows, _ = run.run_cell(cell, 21, 0.2, False, device="cpu",
                                bench=BENCH, mutate=fault)
    assert not res["correct"], rows


def _state_unchanged(drv):
    cls = drv._analyzer

    class Stuck(cls):
        def process_frame(self, *a, **k):
            state = self.state
            r = super().process_frame(*a, **k)
            self.state = state
            return r
    drv._analyzer = Stuck


def _answer_altered(drv):
    cls = drv._analyzer

    class Wrong(cls):
        def process_frame(self, *a, **k):
            r = super().process_frame(*a, **k)
            self.results["velocity_estimates"][-1] = (
                self.results["velocity_estimates"][-1] + 0.5)
            return r
    drv._analyzer = Wrong


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered],
                         ids=["state_unchanged", "answer_altered"])
def test_a_broken_step_is_not_correct(fault, tiny):
    res, rows, _ = run.run_cell("stream.bench_s128", 21, 0.2, False,
                                device="cpu", bench=BENCH, mutate=fault)
    assert not res["correct"], rows


@pytest.mark.parametrize("cell", CALL_CELLS + ["stream.bench_s128"])
def test_the_unbroken_run_is_correct(cell, tiny):
    res, rows, _ = run.run_cell(cell, 21, 0.2, False, device="cpu",
                                bench=BENCH)
    assert res["correct"], rows
