"""Fused dechirp x window x DC removal.

Counterpart of ``radar_slam_tpu/ops/dechirp_pallas.py`` (K9): each chirp's
fast-time samples times the mix vector (conj reference chirp x window, or
the window alone for baseband input), minus the per-chirp mean.

- :func:`dechirp_window_dc` -- the kernel wrapper: a CUDA tensor launches
  ``cube_dechirp`` of ``csrc/cube.cu`` or raises; a CPU tensor runs
  :func:`dechirp_window_dc_reference`.  ``dechirp_window_dc.launches``
  counts the CUDA launches.
- :func:`dechirp_window_dc_reference` -- the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from radar_slam_tpu_torch.ops import _build


def dechirp_window_dc_reference(signals: torch.Tensor, mix: torch.Tensor,
                                dc_removal: bool = True) -> torch.Tensor:
    """signals [..., S] complex64 times mix [S], minus the mean over S."""
    x = signals * mix
    if dc_removal:
        x = x - torch.mean(x, dim=-1, keepdim=True)
    return x


def _check(signals: torch.Tensor, mix: torch.Tensor) -> None:
    if signals.dim() < 1:
        raise ValueError("signals: need [..., S]")
    _build.check_input("signals", signals, torch.complex64, signals.device)
    _build.check_input("mix", mix, torch.complex64, signals.device,
                       (signals.shape[-1],))


def dechirp_window_dc(signals: torch.Tensor, mix: torch.Tensor,
                      dc_removal: bool = True) -> torch.Tensor:
    """Same shape and type as ``signals`` [..., S] complex64.  A CUDA tensor
    launches the kernel or raises; a CPU tensor runs the plain version."""
    _check(signals, mix)
    if signals.device.type == "cuda":
        S = signals.shape[-1]
        rows = signals.numel() // S if S else 0
        out = torch.empty_like(signals)
        if rows == 0:
            return out
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = _build.bind("cube", "cube_dechirp",
                         (vp, vp, vp, ctypes.c_longlong, ci, ci, ci, vp))
        dev = signals.device
        _build.launch(fn, signals.data_ptr(), mix.data_ptr(),
                      out.data_ptr(), rows, S, int(dc_removal), dev.index,
                      torch.cuda.current_stream(dev).cuda_stream)
        dechirp_window_dc.launches += 1
        return out
    if signals.device.type == "cpu":
        return dechirp_window_dc_reference(signals, mix, dc_removal)
    raise ValueError(f"no dechirp kernel for device {signals.device}")


dechirp_window_dc.launches = 0
