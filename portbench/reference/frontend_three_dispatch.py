"""The three-dispatch front end (K4, detection, K5's function) in plain
PyTorch, as the reference computes it.

What the configuration defines per frame on this route (the port's
``pipeline/frame.py:_three_dispatch_frontend`` documents the same
function; this file works it out again without any of the port's code):

    e_ac[sc, a*C + c] = ant[sc, a] dopp[sc, c]          (dense factors)
    e_fast[sc, s]     = e^{2j pi (const_sc - beat_sc t_s)} [t_s >= tau_sc]
                        ([t_s - tau_sc <= T] too at reference fidelity)
    X = e_ac^T e_fast + sigma (g_re + j g_im)           [A*C, S]
    Z = X diag(mix) W, column 0 zeroed                  (the range DFT)
    O[a, d, r] = sum_c W_dop[c, d] Z[a*C + c, r]        (the Doppler DFT)
    p[r, d] = mean_a |O[a, d, r]|^2                     (K4's power map)

then the detection on p + 1e-12: the 3 x 3 local maximum, the threshold
(OS-CFAR, :func:`os_noise`) plus its offset and floor, the range gate,
and the exact top-K of the masked dB map (flat index r*D + d); K5's
signatures are O[:, d_k, r_k] of the picks, scaled to unit power.
The NMS and the sub-bin refinement follow in ``estimation.detections``.

W is the exact range DFT (W[s, r] = e^{+2j pi s r / S}); W_dop the frozen
``doppler_dft_matrix``; the noise planes the frozen Philox transform
(``ops/noise.py``, element (a*C + c) * S + s); the factors come from the
frozen ``signal/synth.py`` terms, in float32 as the program draws them.

``precision`` (the one-pass front end's :data:`frontend.PRECISIONS`):

- ``"float64"``: the reference -- the products, the noise sum and the
  power in float64, the range DFT as a float64 FFT (the exact DFT to
  float64 rounding), p rounded once to float32 where K4 hands it to the
  detection, the detection in float64 on that map, the signatures
  rounded once to complex64 where K5 hands them to the tail;
- ``"tf32"``: the control -- float32 tensors, every product (the range
  DFT as the dense product too) on TF32 tensor cores.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.core.config import PipelineConfig
from portbench.reference.frontend import (PRECISIONS, FrontEnd, _log10_db,
                                          _shift2, cmm, exact_range_dft,
                                          matmul_precision, range_gate_bins,
                                          topk_exact)
from portbench.reference.ops.noise import standard_normals
from portbench.reference.signal.rds import _mix_vector, doppler_dft_matrix
from portbench.reference.signal.synth import (_scatterer_terms, expj_cycles,
                                              fast_time_base)


def _check(cfg: PipelineConfig) -> None:
    d = cfg.detection
    if not (cfg.fft_mode == "fused" and cfg.synth_in_kernel
            and cfg.chirp_subset is None and d.clutter_map_alpha == 0
            and d.cfar_mode == "os"):
        raise ValueError("the reference computes the three-dispatch front "
                         "end with OS-CFAR: fused, factors in the kernel, "
                         "no clutter map")


def dense_factors(scatterers, radar, fidelity: str):
    """(e_ac [F, Sc, A*C], e_fast [F, Sc, S]) complex64: the dense rank-1
    factors of the module docstring, from the frozen per-scatterer
    terms, each phase reduced mod 1 in float32 before the exponential."""
    A, C = radar.total_antennas, radar.num_chirps
    tau, const_cycles, beat, e_dopp, e_ant = _scatterer_terms(
        scatterers, radar, fidelity)
    t = fast_time_base(radar, fidelity, scatterers.range_m.device)
    arrived = t >= tau[..., None]
    if fidelity == "reference":
        arrived = arrived & (t - tau[..., None] <= radar.chirp_duration)
    e_fast = (expj_cycles(const_cycles[..., None] - beat[..., None] * t)
              * arrived.to(torch.float32))
    e_ac = (e_ant[..., :, None] * e_dopp[..., None, :]).reshape(
        *e_ant.shape[:-1], A * C)
    return e_ac, e_fast


def range_dft(x: torch.Tensor, mix: torch.Tensor, precision: str):
    """Z[..., r] = sum_s x[..., s] mix[s] e^{+2j pi s r / S}, column 0
    zero: a float64 FFT for the reference, the dense product (TF32 where
    the precision allows it) otherwise."""
    _, cdtype, _ = PRECISIONS[precision]
    if precision == "float64":
        z = torch.fft.ifft(x * mix.to(cdtype), dim=-1, norm="forward")
        z[..., 0] = 0
        return z
    return cmm(x, exact_range_dft(mix, cdtype))


def os_noise(p1: torch.Tensor, train: int, guard: int,
             rank: float) -> torch.Tensor:
    """The order-statistic noise [F, R, D] of power maps p1 [F, R, D].

    A cell's samples are the cross of ``train`` cells on each side beyond
    its ``guard`` band: (r +- o, d) and (r, d +- o) for o in guard+1 ..
    guard+train, 4 train of them; those outside the map read +inf.  Of the
    n_valid inside, the estimate is the k-th smallest (from 0), k =
    round-half-to-even(rank (n_valid - 1)); the frame's mean where no
    sample lies inside."""
    F, R, D = p1.shape
    dev = p1.device
    inf = torch.tensor(math.inf, dtype=p1.dtype, device=dev)
    r = torch.arange(R, device=dev)[:, None]
    d = torch.arange(D, device=dev)[None, :]
    samples, inside = [], []
    for o in range(guard + 1, guard + train + 1):
        for dr, dd in ((o, 0), (-o, 0), (0, o), (0, -o)):
            ok = ((r + dr >= 0) & (r + dr < R) & (d + dd >= 0)
                  & (d + dd < D))                               # [R, D]
            rr = torch.clamp(r + dr, 0, R - 1).expand(R, D)
            cc = torch.clamp(d + dd, 0, D - 1).expand(R, D)
            samples.append(torch.where(ok, p1[:, rr, cc], inf))
            inside.append(ok)
    n_valid = torch.stack(inside).sum(0).to(torch.float64)      # [R, D]
    k = torch.round(rank * (n_valid - 1.0)).to(torch.int64)
    ordered = torch.sort(torch.stack(samples, dim=-1), dim=-1).values
    est = torch.gather(ordered, -1, torch.clamp(k, min=0).expand(
        F, R, D)[..., None])[..., 0]
    mean = p1.mean(dim=(-2, -1), keepdim=True)
    return torch.where(n_valid > 0, est, mean)


def threshold_db(p1: torch.Tensor, det) -> torch.Tensor:
    """The detection threshold (dB) [F, R, D] of p1 [F, R, D]: the
    OS-CFAR noise plus its offset, floored at ``threshold_db``; the floor
    alone without training cells."""
    if det.cfar_train_cells <= 0:
        return torch.full_like(p1, det.threshold_db)
    noise = os_noise(p1, det.cfar_train_cells, det.guard_cells, det.os_rank)
    return torch.clamp(_log10_db(torch.clamp(noise, min=1e-12))
                       + det.cfar_offset_db, min=det.threshold_db)


def detect(p: torch.Tensor, radar, det):
    """Top-K picks of power maps p [F, R, D]: (r_bin, d_bin, values) [F, K],
    values the dB power of the picks, -inf where exhausted."""
    F, R, D = p.shape
    p1 = p + 1e-12
    pd = _log10_db(p1)
    r = det.neighborhood // 2
    is_peak = torch.ones_like(p1, dtype=torch.bool)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy or dx:
                is_peak &= p1 >= _shift2(p1, dy, dx)
    lo, hi = range_gate_bins(radar, R, det)
    r_idx = torch.arange(R, device=p.device)[:, None]
    mask = (is_peak & (pd > threshold_db(p1, det)) & (r_idx >= lo)
            & (r_idx <= hi))
    score = torch.where(mask, pd, -math.inf).to(torch.float32)
    vals, idx = topk_exact(score.reshape(F, R * D), det.max_detections)
    return idx // D, idx % D, vals


def front_end(scatterers, seeds: torch.Tensor, cfg: PipelineConfig,
              precision: str = "float64") -> FrontEnd:
    """The three-dispatch front end of frames [F, S_max] with their noise
    seeds [F]."""
    _check(cfg)
    rdtype, cdtype, tf32 = PRECISIONS[precision]
    radar, det = cfg.radar, cfg.detection
    A, C, S = radar.total_antennas, radar.num_chirps, radar.samples_per_chirp
    dev = scatterers.range_m.device
    sigma = float(radar.noise_power) ** 0.5
    e_ac, e_fast = dense_factors(scatterers, radar, cfg.synth_fidelity)
    F = e_ac.shape[0]
    mix = _mix_vector(radar, cfg.window, "baseband", S, device=dev)
    w_dop_t = doppler_dft_matrix(C, cfg.doppler_window,
                                 device=dev).transpose(0, 1).to(cdtype)
    with matmul_precision(tf32):
        x = cmm(e_ac.transpose(1, 2).to(cdtype), e_fast.to(cdtype))
        del e_ac, e_fast
        if sigma != 0.0:
            gr, gi = standard_normals(seeds.to(torch.int32), A * C, S,
                                      cfg.noise_impl)
            x = torch.complex(x.real + sigma * gr.to(rdtype),
                              x.imag + sigma * gi.to(rdtype))
            del gr, gi
        z = range_dft(x, mix, precision)
        del x
        o = cmm(w_dop_t, z.reshape(F, A, C, S))               # [F, A, D, S]
        del z
        p = (torch.sum(o.real * o.real + o.imag * o.imag, dim=1)
             * (1.0 / A)).transpose(1, 2)                       # [F, R, D]
    p32 = p.to(torch.float32)
    del p
    r_bin, d_bin, vals = detect(p32.to(rdtype), radar, det)
    K = r_bin.shape[-1]
    flat = (d_bin * S + r_bin)[:, None, :].expand(F, A, K)
    sig = torch.gather(o.reshape(F, A, C * S), 2, flat).transpose(1, 2)
    del o
    power = torch.sum(sig.real * sig.real + sig.imag * sig.imag, dim=-1,
                      keepdim=True)
    sig = torch.where(power > 0,
                      sig / torch.sqrt(torch.clamp(power, min=1e-30)), sig)
    return FrontEnd(p32, r_bin.to(torch.int32), d_bin.to(torch.int32), vals,
                    sig.to(torch.complex64))
