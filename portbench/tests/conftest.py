"""Tests of the benchmark harness.  ``card`` marks a test that needs an
NVIDIA card; it skips (inside the ``card`` fixture, never at import) where
there is none.

    python -m pytest portbench/tests -q          # here: the CPU tests
    python -m pytest portbench/tests -q -m card  # on the card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# Tiny sizes of each mix for the CPU: the same drivers and reference.
TINY = {"batch_8192": {"frames": 16, "pool": 2, "check_among": 1},
        "ingest_2048": {"rig_frames": 8, "chunk": 4, "pool": 1,
                        "check_among": 1},
        "stream": {"episode_frames": 6, "pool": 2, "warm_steps": 2,
                   "check_steps": 5}}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.fixture()
def tiny(monkeypatch):
    """Every traffic mix read at its tiny size."""
    from portbench import registry
    read = registry.read_json

    def tiny_read(path):
        d = read(path)
        if path.parent.name == "traffic":
            d.update(TINY.get(path.stem, {}))
        return d

    monkeypatch.setattr(registry, "read_json", tiny_read)
    return TINY
