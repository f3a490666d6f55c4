"""Frozen copy of the parts of ``radar_slam_tpu_torch/signal/synth.py`` at
commit d8c8661 that the reference's front end reads: ``expj_cycles``,
``fast_time_base`` and the split synthesis factors (imports renamed; the
dense factors, the reference chirp and the ADC cubes left out).

FMCW synthesis from point-cloud scatterers, batched over frames.

Counterpart of ``radar_slam_tpu/signal/synth.py``: ``expj_cycles``,
``fast_time_base``, the split and dense synthesis factors,
``reference_chirp`` and the materialized ADC cubes (``synthesize_frame``,
``synthesize_frames_batch``).  The signal model is the reference's rank-1
separable one:

    e_ac[sc, a*C + c]   = ant[sc, a] * dopp[sc, c]
    e_fast[sc, q*B + j] = coarse[sc, q] * fine[sc, j] * [t_{qB+j} >= tau_sc]

the one-pass front end recomposes both from these per-axis tables, and the
cube-input path contracts the dense factors into ADC cubes.
All phases are accumulated in CYCLES and reduced mod 1 (round half to even,
as ``jnp.round``) before any sin/cos: the carrier term alone reaches ~1.6e5
rad, where float32 trig is meaningless.
"""

from __future__ import annotations

import math
import typing

import torch

from portbench.reference.core.config import RadarConfig
from portbench.reference.core.device import DEFAULT, resolve
from portbench.reference.core.types import ScattererBatch

def expj_cycles(cycles: torch.Tensor) -> torch.Tensor:
    """exp(j 2 pi x) with range reduction to |phase| <= pi (complex64)."""
    x = (cycles - torch.round(cycles)).to(torch.float32)
    phase = (2.0 * math.pi) * x
    return torch.polar(torch.ones_like(phase), phase)


def fast_time_base(cfg: RadarConfig, fidelity: str = "tpu",
                   device=DEFAULT) -> torch.Tensor:
    """ADC fast-time sample instants [S]: ``linspace(0, T, S)``
    ("reference") or the exact ``s / fs`` base ("tpu")."""
    S = cfg.samples_per_chirp
    s = torch.arange(S, dtype=torch.float32, device=resolve(device))
    if fidelity == "reference":
        return s * (cfg.chirp_duration / max(S - 1, 1))
    if fidelity == "tpu":
        return s / cfg.sampling_rate
    raise ValueError(f"Unknown synthesis fidelity: {fidelity}")


class SplitFactors(typing.NamedTuple):
    """Factorized synthesis factors, leading frame axis [F, Sc, ...]."""
    ant: torch.Tensor     # [F, Sc, A] complex64, amplitude folded (0 invalid)
    dopp: torch.Tensor    # [F, Sc, C] complex64 slow-time factor
    coarse: torch.Tensor  # [F, Sc, Q] complex64, Q = ceil(S / B)
    fine: torch.Tensor    # [F, Sc, B] complex64
    tau: torch.Tensor     # [F, Sc] float32 round-trip delay (echo gate)


def _scatterer_terms(scatterers: ScattererBatch, cfg: RadarConfig,
                     fidelity: str):
    """Per-scatterer terms shared by the dense and split factors: (tau
    [F, Sc] round-trip delay, const_cycles [F, Sc] fast-time phase offset,
    beat [F, Sc] beat rate, e_dopp [F, Sc, C], e_ant [F, Sc, A] with the
    amplitude folded in (0 for an invalid scatterer))."""
    C = cfg.num_chirps
    lam = cfg.lambda_c
    k_rate = cfg.chirp_rate
    dev = scatterers.range_m.device

    r = scatterers.range_m.to(torch.float32)
    az = scatterers.azimuth_rad.to(torch.float32)
    rcs = scatterers.rcs_db.to(torch.float32)
    vr = scatterers.vr.to(torch.float32)
    el = (scatterers.elevation_rad.to(torch.float32)
          if scatterers.elevation_rad is not None else torch.zeros_like(az))

    ok = (scatterers.valid & (r > 0.0) & torch.isfinite(r)
          & torch.isfinite(az) & torch.isfinite(rcs) & torch.isfinite(vr))
    r_safe = torch.where(ok, r, 1.0)
    amp = (torch.sqrt(torch.pow(10.0, rcs / 10.0))
           / (4.0 * math.pi * r_safe ** 2))
    amp = torch.where(ok, amp, 0.0)
    tau = 2.0 * r_safe / cfg.c

    carrier_cycles = 2.0 * r_safe / lam
    const_cycles = (-(carrier_cycles - torch.round(carrier_cycles))
                    + 0.5 * k_rate * tau * tau)
    beat = k_rate * tau                                           # [F, Sc]

    c_idx = torch.arange(C, dtype=torch.float32, device=dev)
    if fidelity == "reference":
        cycles_dopp = (2.0 * vr / lam)[..., None].expand(*vr.shape, C)
    else:
        cycles_dopp = (-2.0 / lam) * vr[..., None] * (c_idx * cfg.pri)
    e_dopp = expj_cycles(cycles_dopp)

    # The antenna factor of a URA flattened row-major [el, az]: element
    # (m, n) sees (n d_az u_y + m d_el u_z) / lambda cycles.  For a ULA
    # pos_el is [0], and the added term is an exact zero.
    u_y = torch.cos(el) * torch.sin(az)
    u_z = torch.sin(el)
    pos_az = torch.arange(cfg.num_antennas, dtype=torch.float32,
                          device=dev) * cfg.spacing
    pos_el = torch.arange(cfg.num_antennas_el, dtype=torch.float32,
                          device=dev) * cfg.spacing_el
    cycles_ant = (1.0 / lam) * (u_y[..., None, None] * pos_az
                                + u_z[..., None, None] * pos_el[:, None])
    cycles_ant = cycles_ant.reshape(*u_y.shape, cfg.total_antennas)
    e_ant = expj_cycles(cycles_ant) * amp[..., None]              # [F, Sc, A]
    return tau, const_cycles, beat, e_dopp, e_ant


def synthesis_factors_split(scatterers: ScattererBatch, cfg: RadarConfig,
                            fidelity: str = "tpu",
                            block: int = 128) -> SplitFactors:
    """Per-axis phase tables of the synthesis factors for every frame."""
    tau, const_cycles, beat, e_dopp, e_ant = _scatterer_terms(
        scatterers, cfg, fidelity)
    t = fast_time_base(cfg, fidelity, scatterers.range_m.device)  # [S]
    coarse = expj_cycles(const_cycles[..., None]
                         - beat[..., None] * t[::block])
    fine = expj_cycles(-beat[..., None] * t[:block])
    return SplitFactors(e_ant, e_dopp, coarse, fine, tau)
