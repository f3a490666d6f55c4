"""Logging setup (parity with the reference's per-module stdlib logging +
pipeline FileHandler, ``run_ego_motion_pipeline.py:41-48``).

Counterpart of ``radar_slam_tpu/utils/logging_util.py``."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def setup_logging(level: int = logging.INFO,
                  log_file: Optional[str] = None,
                  quiet_modules: tuple = ("jax", "matplotlib")) -> None:
    handlers = [logging.StreamHandler()]
    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(level=level, format=FORMAT, handlers=handlers,
                        force=True)
    for mod in quiet_modules:
        logging.getLogger(mod).setLevel(logging.WARNING)
