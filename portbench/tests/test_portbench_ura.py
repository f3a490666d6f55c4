"""The two cells of the 3-D deployment and of the merged recording: runs
with the timed path broken underneath come out not correct, an unbroken
tiny run comes out correct.

As ``test_portbench_faults.py``: each test skips the look for a card and
drives the rest of a run on the CPU at a tiny depth (the ``tiny_mix``
fixture), with one fault planted in the program's path: the scatterers'
elevations dropped before the call, the joint search's elevation zeroed,
a merged frame missing the returns of one of its four sensors."""

import json
from pathlib import Path

import pytest
import torch

from portbench import registry, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
URA_CELL = "batch_2048.ura8x4_s512"
MERGED_CELL = "stream_merged.radarscenes_s512"
TINY = {"batch_2048": {"frames": 6, "pool": 1, "check_among": 1},
        "stream_merged": {"episode_frames": 6, "pool": 2, "warm_steps": 2,
                          "check_steps": 5}}


@pytest.fixture()
def tiny_mix(monkeypatch):
    """The two new mixes read at a tiny depth."""
    read = registry.read_json

    def tiny_read(path):
        d = read(path)
        if path.parent.name == "traffic":
            d.update(TINY.get(path.stem, {}))
        return d

    monkeypatch.setattr(registry, "read_json", tiny_read)


def _elevation_dropped(drv):
    call = drv._call

    def flat(batch, gen_seed):
        return call(batch._replace(elevation_rad=None), gen_seed)
    drv._call = flat


def _elevation_not_estimated(drv):
    from radar_slam_tpu_torch.pipeline import frame
    call, est2d = drv._call, frame.estimators.estimate_angles_2d

    def zero_el(*a, **k):
        az, el, spec = est2d(*a, **k)
        return az, torch.zeros_like(el), spec

    def flat(batch, gen_seed):
        frame.estimators.estimate_angles_2d = zero_el
        try:
            return call(batch, gen_seed)
        finally:
            frame.estimators.estimate_angles_2d = est2d
    drv._call = flat


@pytest.mark.parametrize("fault", [_elevation_dropped,
                                   _elevation_not_estimated],
                         ids=["elevation_dropped", "elevation_zeroed"])
def test_a_ura_call_without_elevation_is_not_correct(fault, tiny_mix):
    res, rows, _ = run.run_cell(URA_CELL, 2**31 + 19, 0.2, False,
                                device="cpu", bench=BENCH, mutate=fault)
    assert not res["correct"], rows


def _sensor_missing(drv):
    """Each merged frame the program sees lacks its last sensor's returns
    (the last quarter of its valid slots, sensor 3's in the merged
    order); the reference sees the whole frame."""
    frame_of = drv._frame

    def short(cols, j):
        batch = frame_of(cols, j)
        n = int(batch.valid.sum())
        keep = torch.arange(batch.valid.shape[-1]) < n - n // 4
        return batch._replace(valid=batch.valid & keep.to(
            batch.valid.device))
    drv._frame = short


def test_a_merged_frame_missing_a_sensor_is_not_correct(tiny_mix):
    res, rows, _ = run.run_cell(MERGED_CELL, 2**31 + 19, 0.2, False,
                                device="cpu", bench=BENCH,
                                mutate=_sensor_missing)
    assert not res["correct"], rows


@pytest.mark.parametrize("cell", [URA_CELL, MERGED_CELL])
def test_the_unbroken_run_is_correct(cell, tiny_mix):
    res, rows, _ = run.run_cell(cell, 2**31 + 19, 0.2, False, device="cpu",
                                bench=BENCH)
    assert res["correct"], rows
    assert res["failed"] == 0 and res["attempted"] > 0
