"""The one-pass front end (K1's function) in plain PyTorch, as the
reference computes it.

What the configuration defines per frame (``ops/frontend.py`` of the port
at commit d8c8661 documents the same function; this file works it out
again without any of the port's code):

    e_at[a*C + c, sc] = dopp[sc, c] ant[sc, a]     (split synthesis tables)
    e_fast[sc, s]     = coarse[sc, s // B] fine[sc, s % B] [t_s >= tau_sc]
    Z = e_at @ (e_fast @ W_rng) + sigma sqrt(S) (g (*) taps), column 0 zeroed
      (range-frequency noise; ``noise_domain="time"``:
       Z = (e_at @ e_fast + sigma n) @ W_rng)
    p[d, s] = mean_a |sum_c W_dop[c, d] Z[a*C + c, s]|^2
    score = 10 log10(p + 1e-12) where (3x3 local max & CA-CFAR & range
            gate), else -1e30
    top-K of the score, Z-column signatures of the picks

W_rng is the exact range DFT diag(mix) W (W[s, r] = e^{+2j pi (s r mod S) /
S}, built in float64, column 0 zero: the DC projection); W_dop the Doppler
DFT matrix of the configuration (the frozen ``doppler_dft_matrix``); the
noise planes the frozen Philox transform (``ops/noise.py``).

``precision`` selects the arithmetic of the products and the map:

- ``"float64"``: the reference -- every product, the noise sum, the power
  and the CFAR in float64, rounded once to float32 where the kernel hands
  its outputs to the tail (Z, p, score);
- ``"tf32"``: the control -- float32 tensors with TF32 tensor-core
  products allowed, the precision one step below the float32 with TF32
  off that the configuration states (``use_f32_matmuls`` in the port).

Complex products run as four real products (:func:`cmm`), so the TF32
switch reaches every one of them.  The tail (:func:`finalize`: top-K and
signatures) is float32 as in the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as tfn

from portbench.reference.core.config import PipelineConfig
from portbench.reference.ops.noise import standard_normals
from portbench.reference.ops.windows import get_window, window_freq_taps
from portbench.reference.signal.rds import _mix_vector, doppler_dft_matrix
from portbench.reference.signal.synth import (fast_time_base,
                                              synthesis_factors_split)

NEG = -1e30
_LOG10E_10 = 4.3429448190325176   # 10 / ln(10)
PRECISIONS = {"float64": (torch.float64, torch.complex128, False),
              "tf32": (torch.float32, torch.complex64, True)}


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 products on or off for the block, restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def cmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for complex tensors as four real products."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)


def exact_range_dft(mix: torch.Tensor, cdtype) -> torch.Tensor:
    """diag(mix) W [S, S], W[s, r] = e^{+2j pi (s r mod S) / S} built in
    float64, column 0 zero (the DC projection (I - J/S) W)."""
    S = mix.shape[0]
    s = torch.arange(S, dtype=torch.float64, device=mix.device)
    phase = (2.0 * math.pi / S) * torch.remainder(s[:, None] * s[None, :], S)
    w = torch.polar(torch.ones_like(phase), phase)
    w[:, 0] = 0
    return (mix.to(torch.complex128)[:, None] * w).to(cdtype)


def range_gate_bins(radar, S: int, det) -> Tuple[int, int]:
    """The inclusive bin interval [lo, hi] whose ranges r (fs / S)
    (c / (2 slope)) lie in [min_range, max_range]; (1, 0) where none do."""
    step = (radar.sampling_rate / S) * radar.c / (2.0 * radar.chirp_rate)
    ok = [r for r in range(S) if det.min_range <= r * step <= det.max_range]
    return (ok[0], ok[-1]) if ok else (1, 0)


def _log10_db(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) * _LOG10E_10


def _shift2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """result[..., c, s] = x[..., c - dy, s - dx], zero-filled."""
    r = max(abs(dy), abs(dx))
    C, S = x.shape[-2:]
    xp = tfn.pad(x, (r, r, r, r))
    return xp[..., r - dy:r - dy + C, r - dx:r - dx + S]


def _window_counts(n: int, pad: int, like: torch.Tensor) -> torch.Tensor:
    i = torch.arange(n, dtype=like.dtype, device=like.device)
    return (torch.clamp(i + pad, max=n - 1.0) - torch.clamp(i - pad, min=0.0)
            + 1.0)


def _box_sum(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    xp = tfn.pad(x, (pad, pad) if dim == -1 else (0, 0, pad, pad))
    return xp.unfold(dim, 2 * pad + 1, 1).sum(-1)


def cfar_threshold_db(p1: torch.Tensor, train: int, guard: int,
                      offset_db: float, threshold_db: float) -> torch.Tensor:
    """CA-CFAR threshold [..., C, S] in dB: clipped box means over the
    training window less the guard window, the full-window cell counts
    weighting the clipped means."""
    if train <= 0:
        return torch.full_like(p1, threshold_db)
    C, S = p1.shape[-2:]
    tpad = train + guard
    noise = _box_sum(_box_sum(p1, tpad, -2), tpad, -1) / (
        _window_counts(C, tpad, p1)[:, None]
        * _window_counts(S, tpad, p1)[None, :])
    if guard > 0:
        g = _box_sum(_box_sum(p1, guard, -2), guard, -1) / (
            _window_counts(C, guard, p1)[:, None]
            * _window_counts(S, guard, p1)[None, :])
        n_train = float((2 * tpad + 1) ** 2)
        n_guard = float((2 * guard + 1) ** 2)
        noise = (noise * n_train - g * n_guard) / (n_train - n_guard)
    noise_db = _log10_db(torch.clamp(noise, min=1e-12))
    return torch.clamp(noise_db + offset_db, min=threshold_db)


class FrontEnd(NamedTuple):
    p_lin: torch.Tensor   # [F, R, D] float32
    r_bin: torch.Tensor   # [F, K] int32
    d_bin: torch.Tensor   # [F, K] int32
    values: torch.Tensor  # [F, K] float32, -inf where exhausted
    sigs: torch.Tensor    # [F, K, A] complex64, unit power


def _check(cfg: PipelineConfig) -> None:
    d = cfg.detection
    if not (cfg.fft_mode == "fused" and cfg.synth_in_kernel
            and cfg.frontend_one_pass and d.cfar_mode == "ca"
            and cfg.chirp_subset is None and cfg.frontend_factors == "split"
            and d.clutter_map_alpha == 0):
        raise ValueError("the reference computes the one-pass front end on "
                         "split factors with CA-CFAR and no clutter map")
    if cfg.noise_domain not in ("range_freq", "time"):
        raise ValueError(f"Unknown noise_domain: {cfg.noise_domain}")


def body(scatterers, seeds: torch.Tensor, cfg: PipelineConfig,
         precision: str = "float64"):
    """Z^T (real, imaginary) [F, S, A*C], p and score [F, C, S] of frames
    [F, S_max] with their noise seeds [F], rounded to float32."""
    _check(cfg)
    rdtype, cdtype, tf32 = PRECISIONS[precision]
    radar, d = cfg.radar, cfg.detection
    A, C, S = radar.total_antennas, radar.num_chirps, radar.samples_per_chirp
    dev = scatterers.range_m.device
    sigma = float(radar.noise_power) ** 0.5
    split = synthesis_factors_split(scatterers, radar, cfg.synth_fidelity)
    t = fast_time_base(radar, cfg.synth_fidelity, device=dev)
    F, Sc = split.tau.shape
    B, Q = split.fine.shape[-1], split.coarse.shape[-1]
    e_at = (split.dopp.transpose(1, 2)[:, None, :, :]
            * split.ant.transpose(1, 2)[:, :, None, :]).reshape(F, A * C, Sc)
    e_fast = (split.coarse[..., :, None] * split.fine[..., None, :]).reshape(
        F, Sc, Q * B)[..., :S]
    arrived = t[None, None, :] >= split.tau[..., None]
    if cfg.synth_fidelity == "reference":
        arrived = arrived & (t[None, None, :] - split.tau[..., None]
                             <= radar.chirp_duration)
    e_fast = e_fast * arrived.to(torch.float32)
    e_at, e_fast = e_at.to(cdtype), e_fast.to(cdtype)
    mix = _mix_vector(radar, cfg.window, "baseband", S, device=dev)
    w_rng = exact_range_dft(mix, cdtype)
    w_dop_t = doppler_dft_matrix(C, cfg.doppler_window,
                                 device=dev).transpose(0, 1).to(cdtype)
    with matmul_precision(tf32):
        if sigma == 0.0:
            gr = gi = None
        else:
            gr, gi = standard_normals(seeds.to(torch.int32), A * C, S,
                                      cfg.noise_impl)
            gr, gi = gr.to(rdtype), gi.to(rdtype)
        if cfg.noise_domain == "time":
            x = cmm(e_at, e_fast)
            if gr is not None:
                x = torch.complex(x.real + sigma * gr, x.imag + sigma * gi)
            z = cmm(x, w_rng)
        else:
            z = cmm(e_at, cmm(e_fast, w_rng))
            if gr is not None:
                sn = float(sigma * float(S) ** 0.5)
                taps = window_freq_taps(cfg.window)

                def conv(g):
                    acc = None
                    for off, cc in taps:
                        term = cc * (g if off == 0 else torch.roll(g, off,
                                                                   dims=-1))
                        acc = term if acc is None else acc + term
                    return acc

                z = torch.complex(z.real + sn * conv(gr),
                                  z.imag + sn * conv(gi))
            z[..., 0] = 0.0
        del gr, gi
        o = cmm(w_dop_t, z.reshape(F, A, C, S))               # [F, A, D, S]
        p = torch.sum(o.real * o.real + o.imag * o.imag, dim=1) * (1.0 / A)
        del o
    p1 = p + 1e-12
    pd = _log10_db(p1)
    thresh = cfar_threshold_db(p1, d.cfar_train_cells, d.guard_cells,
                               d.cfar_offset_db, d.threshold_db)
    r = d.neighborhood // 2
    is_peak = torch.ones_like(p1, dtype=torch.bool)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy or dx:
                is_peak &= p1 >= _shift2(p1, dy, dx)
    lo, hi = range_gate_bins(radar, S, d)
    s_idx = torch.arange(S, device=dev)
    mask = is_peak & (pd > thresh) & (s_idx >= lo) & (s_idx <= hi)
    score = torch.where(mask, pd, NEG)
    zt = z.transpose(1, 2)
    return (zt.real.to(torch.float32).contiguous(),
            zt.imag.to(torch.float32).contiguous(),
            p.to(torch.float32), score.to(torch.float32))


def topk_exact(score: torch.Tensor, K: int):
    """Exact top-K over the last axis, ties to the smaller index (a stable
    descending sort)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def finalize(zr, zi, p_ds, score_ds, K: int, A: int, C: int,
             doppler_window) -> FrontEnd:
    """Top-K on the masked score map (flat index r*C + d) and the picks'
    signatures as exact Z-column contractions, in float32."""
    F, S = zr.shape[:2]
    p_lin = p_ds.transpose(-1, -2)                            # [F, R, D]
    score = score_ds.transpose(-1, -2).reshape(F, S * C)
    vals, idx = topk_exact(score, K)
    rb = idx // C
    db = idx % C
    valid = vals > NEG * 0.1
    vals = torch.where(valid, vals, -math.inf)
    g = rb[:, :, None].expand(F, K, zr.shape[-1])
    zcols = torch.complex(torch.gather(zr, 1, g), torch.gather(zi, 1, g))
    zcols = zcols.reshape(F, K, A, C)
    c_idx = torch.arange(C, dtype=torch.float32, device=zr.device)
    f_shift = torch.remainder(db - C // 2, C).to(torch.float32)
    phase = -((2.0 * math.pi / C) * c_idx[None, :, None]
              * f_shift[:, None, :])                            # [F, C, K]
    w_dop = torch.polar(torch.ones_like(phase), phase)
    if doppler_window is not None:
        wd = get_window(doppler_window, C, device=zr.device)
        w_dop = wd[None, :, None] * w_dop
    sig = torch.einsum("fkac,fck->fka", zcols, w_dop)          # [F, K, A]
    power = torch.sum(sig.abs() ** 2, dim=-1, keepdim=True)
    sig = torch.where(power > 0,
                      sig / torch.sqrt(torch.clamp(power, min=1e-30)), sig)
    return FrontEnd(p_lin, rb.to(torch.int32), db.to(torch.int32), vals, sig)


def front_end(scatterers, seeds: torch.Tensor, cfg: PipelineConfig,
              precision: str = "float64",
              clutter: Optional[torch.Tensor] = None) -> FrontEnd:
    """The whole one-pass front end of frames [F, S_max]."""
    if clutter is not None:
        raise ValueError("the reference has no clutter map")
    zr, zi, p, score = body(scatterers, seeds, cfg, precision)
    with matmul_precision(PRECISIONS[precision][2]):
        return finalize(zr, zi, p, score, cfg.detection.max_detections,
                        cfg.radar.total_antennas, cfg.radar.num_chirps,
                        cfg.doppler_window)
