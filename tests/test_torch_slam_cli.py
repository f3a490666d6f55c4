"""``analyze --slam`` of the port's CLI on the CPU (``--device cpu``): the
analyzer's frames re-run through the batched driver for their target
clouds, then loop-closure pose-graph refinement, with each solver and
proposer (the reference's block, radar_slam_tpu/pipeline/cli.py:189-212).
Each run exits 0 and reports ``slam_loop_closures``,
``slam_position_rmse`` and ``slam_yaw_rmse``; 8 synthetic frames hold no
revisit, so no loop is accepted and the refined trajectory stays within
the CLI's parity bounds (0.777 m, 0.466 rad).  A RadarScenes-layout
recording (``--dataset --merged``, host-resident batches) is uploaded to
the device before the batched call.
"""

import json

import numpy as np
import pytest

from radar_slam_tpu_torch.pipeline.cli import main as cli_main
from tests.test_torch_cli import mini_dataset  # noqa: F401  (fixture)

SLAM_KEYS = ("slam_loop_closures", "slam_position_rmse", "slam_yaw_rmse")


def metrics(out):
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


@pytest.mark.parametrize("proposer", ["pose", "scancontext"])
@pytest.mark.parametrize("solver", ["cg", "schur"])
def test_cli_analyze_slam_synthetic(solver, proposer, capsys):
    assert cli_main(["analyze", "--slam", "--max-frames", "8",
                     "--slam-solver", solver, "--slam-proposer", proposer,
                     "--device", "cpu"]) == 0
    m = metrics(capsys.readouterr().out)
    assert all(k in m for k in SLAM_KEYS), m
    assert m["frames_processed"] == 8
    assert m["slam_loop_closures"] == 0
    assert np.isfinite(m["slam_position_rmse"])
    assert m["slam_position_rmse"] <= 0.777
    assert m["slam_yaw_rmse"] <= 0.466


def test_cli_analyze_slam_dataset(mini_dataset, capsys):  # noqa: F811
    assert cli_main(["analyze", "--dataset", str(mini_dataset), "--seq",
                     "sequence_9", "--merged", "--slam", "--slam-solver",
                     "schur", "--device", "cpu"]) == 0
    m = metrics(capsys.readouterr().out)
    assert all(k in m for k in SLAM_KEYS), m
    assert np.isfinite(m["slam_position_rmse"])
