"""FMCW synthesis from point-cloud scatterers, batched over frames.

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

import numpy as np
import torch

from radar_slam_tpu_torch.core.config import RadarConfig
from radar_slam_tpu_torch.core.device import DEFAULT, resolve
from radar_slam_tpu_torch.core.types import ScattererBatch
from radar_slam_tpu_torch.ops.noise import frame_seeds, standard_normals

_CHUNK = 256          # frames per synthesis step of synthesize_frames_batch


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
    if cfg.num_antennas_el != 1:
        raise NotImplementedError(
            "num_antennas_el > 1 (URA synthesis) is not ported yet "
            "(ROADMAP: remaining estimation)")
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

    u_y = torch.cos(el) * torch.sin(az)
    pos_az = torch.arange(cfg.num_antennas, dtype=torch.float32,
                          device=dev) * cfg.spacing
    cycles_ant = (1.0 / lam) * (u_y[..., None] * pos_az)          # [F, Sc, A]
    e_ant = expj_cycles(cycles_ant) * amp[..., None]
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


def synthesis_factors(scatterers: ScattererBatch, cfg: RadarConfig,
                      fidelity: str = "tpu"):
    """The dense rank-1 factors of every frame:

        signals[f, a*C + c, s] = (e_ac[f]^T @ e_fast[f])[a*C + c, s]

    Returns (e_ac [F, Sc, A*C], e_fast [F, Sc, S]) complex64, e_fast
    echo-gated ([t_s >= tau], and [t_s - tau <= T] at reference fidelity)."""
    A, C = cfg.num_antennas, cfg.num_chirps
    tau, const_cycles, beat, e_dopp, e_ant = _scatterer_terms(
        scatterers, cfg, fidelity)
    t = fast_time_base(cfg, fidelity, scatterers.range_m.device)  # [S]
    cycles_fast = const_cycles[..., None] - beat[..., None] * t
    arrived = (t >= tau[..., None]).to(torch.float32)
    if fidelity == "reference":
        arrived = arrived * (t - tau[..., None]
                             <= cfg.chirp_duration).to(torch.float32)
    e_fast = expj_cycles(cycles_fast) * arrived
    e_ac = (e_ant[..., :, None] * e_dopp[..., None, :]).reshape(
        *e_ant.shape[:-1], A * C)
    return e_ac, e_fast


def reference_chirp(cfg: RadarConfig, device=DEFAULT) -> torch.Tensor:
    """Transmit chirp at the ADC sample instants s / fs [S] (complex64):
    exp(j 2 pi (fc_alias t + k t^2 / 2)), whole cycles of fc per sample
    dropped (they are invisible at the sample times and float32 cannot
    carry them)."""
    t = (torch.arange(cfg.samples_per_chirp, dtype=torch.float32,
                      device=resolve(device)) / cfg.sampling_rate)
    fc_alias = (cfg.fc - math.floor(cfg.fc / cfg.sampling_rate)
                * cfg.sampling_rate)
    cycles = fc_alias * t + 0.5 * cfg.chirp_rate * t * t
    return expj_cycles(cycles)


def synthesize_frame(scatterers: ScattererBatch, cfg: RadarConfig,
                     seeds: torch.Tensor, output: str = "baseband",
                     add_noise: bool = True,
                     fidelity: str = "tpu") -> torch.Tensor:
    """ADC cubes [F, A, C, S] (complex64) of scatterer sets [F, Sc], one
    frame per noise seed (``seeds`` [F] int32).

    ``output`` "baseband" is the dechirped signal; "raw" re-modulates it by
    :func:`reference_chirp` so that dechirping gives the baseband back.
    ``add_noise`` adds complex AWGN of power ``cfg.noise_power`` per
    component: the two Philox planes of ``ops/noise.py:standard_normals``
    (seed, element a*C*S + c*S + s) as real and imaginary parts, scaled by
    sqrt(noise_power).  The reference draws ``jax.random.normal``, whose
    bits cannot be replayed here: parity with it is exact at
    ``add_noise=False`` and statistical otherwise.  The same seed gives the
    same noise on the CPU and on the card."""
    A, C, S = cfg.num_antennas, cfg.num_chirps, cfg.samples_per_chirp
    e_ac, e_fast = synthesis_factors(scatterers, cfg, fidelity)
    signals = torch.matmul(e_ac.transpose(-1, -2), e_fast)       # [F, AC, S]
    if output == "raw":
        signals = signals * reference_chirp(cfg, signals.device)
    elif output != "baseband":
        raise ValueError(f"Unknown output domain: {output}")
    if add_noise:
        sn = float(np.sqrt(np.float32(cfg.noise_power)))
        gr, gi = standard_normals(seeds.to(torch.int32), A * C, S)
        signals = signals + torch.complex(sn * gr, sn * gi)
    return signals.reshape(-1, A, C, S)


def synthesize_frames_batch(scatterers: ScattererBatch, cfg: RadarConfig,
                            generator: torch.Generator,
                            output: str = "baseband", add_noise: bool = True,
                            fidelity: str = "tpu") -> torch.Tensor:
    """:func:`synthesize_frame` over a frame batch [F, Sc] -> [F, A, C, S],
    the per-frame seeds drawn from ``generator`` (as the pipeline's
    ``frame_seeds``).  Frames are synthesized ``_CHUNK`` at a time: the
    Philox draw holds several int64 tensors of _CHUNK * A * C * S elements
    (~0.2 GB each at the bench shapes)."""
    F = scatterers.range_m.shape[0]
    dev = scatterers.range_m.device
    seeds = frame_seeds(generator, F, dev)
    out = torch.empty((F, cfg.num_antennas, cfg.num_chirps,
                       cfg.samples_per_chirp), dtype=torch.complex64,
                      device=dev)
    for i in range(0, F, _CHUNK):
        part = ScattererBatch(*[None if x is None else x[i:i + _CHUNK]
                                for x in scatterers])
        out[i:i + _CHUNK] = synthesize_frame(part, cfg, seeds[i:i + _CHUNK],
                                             output, add_noise, fidelity)
    return out
