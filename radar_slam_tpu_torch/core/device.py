"""Where the port allocates when the caller names no device: on the card.

The port's entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``, as the CPU tests do).  Without a card they raise rather
than fall back to the CPU."""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device when there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available; pass "
            f"device='cpu' to run on the CPU")
    return dev
