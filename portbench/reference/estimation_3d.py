"""What a planar array (URA) adds to the reference's phase B, written from
what the configuration defines: joint azimuth-elevation estimation and
targets with height.  Everything else of phase B (detections, MDL order,
temporal smoothing, association, the 6-DoF solve, the planar pose) is
:mod:`portbench.reference.estimation`'s, which already carries a target's
height through the association and the solve.

A URA of ``num_antennas_el`` rows of ``num_antennas`` elements is
flattened row-major [el, az]: element (m, n) sees the phase 2 pi (n d_az
cos(el) sin(az) + m d_el sin(el)) / lambda.

1. **Joint beamformer** (:func:`joint_beamforming`): the power
   |a(az, el)^H s|^2 over the el-major grid [G_el * G_az] (azimuth
   fastest), in plain torch on the signatures' device in blocks of
   signatures; its first maximum, refined by a parabola along each axis
   through the peak's neighbours on that axis (interior peaks only).
2. **Confidence** (:func:`confidence`): the reference's score against the
   URA steering vector at (azimuth, elevation).
3. **Targets** (:func:`targets`): at (r cos el cos az, r cos el sin az,
   r sin el) with the smoothed azimuth and the raw elevation (the
   smoothing follows a detection's azimuth only), lines of sight the unit
   directions.

Departures from the port's formulation (``aoa/estimators.py``,
``aoa/confidence.py``, ``core/types.py``): the grids and the steering
vectors are float64 (the port rounds the grids to float32 and builds
complex64 steering); the spectrum is one complex product per block, in
float64, where the port takes complex64 products in chunks of 1 GiB; the
confidence's 20th percentile is ``torch.quantile``'s linear rank; the
lines of sight are computed once from (az, el).  ``precision`` is
``estimation.Precision``: the control ("tf32") rounds every product's
operands to TF32 and multiplies in float32 with TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference import estimation as est
from portbench.reference.frontend import matmul_precision

SIG_BLOCK = 4096      # signatures per block of the joint spectrum


def grids_deg(aoa):
    """(azimuth grid [G_az], elevation grid [G_el]) in degrees, float64."""
    return (np.linspace(aoa.search_min_deg, aoa.search_max_deg,
                        aoa.num_grid_points),
            np.linspace(aoa.el_min_deg, aoa.el_max_deg,
                        aoa.num_el_grid_points))


def steering(az_rad, el_rad, radar) -> np.ndarray:
    """URA steering vectors [..., A], row-major [el, az], complex128."""
    az = np.asarray(az_rad, np.float64)[..., None, None]
    el = np.asarray(el_rad, np.float64)[..., None, None]
    n = np.arange(radar.num_antennas)[None, :] * radar.spacing
    m = np.arange(radar.num_antennas_el)[:, None] * radar.spacing_el
    ph = (2.0 * math.pi / radar.lambda_c) * (
        np.cos(el) * np.sin(az) * n + np.sin(el) * m)
    return np.exp(1j * ph).reshape(*ph.shape[:-2], radar.total_antennas)


def grid_steering(cfg) -> np.ndarray:
    """Steering over the el-major joint grid [G_el * G_az, A]."""
    az, el = grids_deg(cfg.aoa)
    return steering(np.deg2rad(np.tile(az, len(el))),
                    np.deg2rad(np.repeat(el, len(az))), cfg.radar)


def _tdtype(prec: est.Precision):
    return torch.complex128 if prec.complex == np.complex128 \
        else torch.complex64


def _parabola(ym, y0, yp, interior):
    den = ym - 2.0 * y0 + yp
    safe = den.abs() > 1e-12
    off = torch.where(safe, 0.5 * (ym - yp) / torch.where(safe, den, 1.0),
                      0.0)
    return torch.where(interior, off.clamp(-0.5, 0.5), 0.0)


def _refine(spec: torch.Tensor, g_el: int, g_az: int):
    """(grid steps off the el-major grid's first maximum along elevation
    and azimuth, float64 [n, 2]; the peak's (ie, ia) [n, 2]) of spectra
    [n, G_el * G_az]."""
    idx = torch.argmax(spec, dim=-1, keepdim=True)
    ie, ia = idx // g_az, idx % g_az

    def tap(e, a):
        return torch.gather(spec, -1, e * g_az + a)[:, 0].double()

    y0 = tap(ie, ia)
    da = _parabola(tap(ie, (ia - 1).clamp(0, g_az - 1)), y0,
                   tap(ie, (ia + 1).clamp(0, g_az - 1)),
                   (ia[:, 0] > 0) & (ia[:, 0] < g_az - 1))
    de = _parabola(tap((ie - 1).clamp(0, g_el - 1), ia), y0,
                   tap((ie + 1).clamp(0, g_el - 1), ia),
                   (ie[:, 0] > 0) & (ie[:, 0] < g_el - 1))
    return (torch.stack([de, da], -1),
            torch.cat([ie, ia], -1))


def joint_beamforming(sigs: np.ndarray, cfg, prec: est.Precision,
                      device) -> np.ndarray:
    """Refined (az_deg, el_deg) [F, K, 2] of signatures [F, K, A]: the
    joint spectrum on ``device`` in blocks of :data:`SIG_BLOCK`
    signatures."""
    az_g, el_g = grids_deg(cfg.aoa)
    cdt = _tdtype(prec)
    a_h = torch.from_numpy(prec.r(grid_steering(cfg))).to(device).conj().T
    F, K, A = sigs.shape
    flat = sigs.reshape(F * K, A)
    out = np.empty((F * K, 2), np.float64)
    with torch.no_grad(), matmul_precision(False):
        for i in range(0, F * K, SIG_BLOCK):
            s = torch.from_numpy(prec.r(flat[i:i + SIG_BLOCK])).to(device)
            resp = s.to(cdt) @ a_h
            spec = resp.real ** 2 + resp.imag ** 2
            off, peak = _refine(spec, len(el_g), len(az_g))
            peak, off = peak.cpu().numpy(), off.cpu().numpy()
            out[i:i + SIG_BLOCK, 0] = (az_g[peak[:, 1]]
                                       + off[:, 1] * (az_g[1] - az_g[0]))
            out[i:i + SIG_BLOCK, 1] = (el_g[peak[:, 0]]
                                       + off[:, 0] * (el_g[1] - el_g[0]))
    return out.reshape(F, K, 2).astype(prec.real)


def confidence(sigs: np.ndarray, az_deg: np.ndarray, el_deg: np.ndarray,
               cfg, prec: est.Precision) -> np.ndarray:
    """``estimation.confidence`` against the URA steering vector at
    (azimuth, elevation): 0.4 |a^H s| / ||s|| + 0.3 exp(-mean |wrapped
    phase error|) + 0.3 SNR term, clipped to [0, 1]."""
    rdt = torch.float64 if prec.real == np.float64 else torch.float32
    s = torch.from_numpy(sigs.astype(prec.complex))
    a = torch.from_numpy(steering(np.deg2rad(az_deg.astype(np.float64)),
                                  np.deg2rad(el_deg.astype(np.float64)),
                                  cfg.radar).astype(prec.complex))
    p = (s.real ** 2 + s.imag ** 2).to(rdt)
    power = p.sum(-1)
    corr = torch.sum(a.conj() * s, -1).abs()
    corr = torch.where(power > 0,
                       corr / torch.sqrt(power.clamp(min=1e-30)), 0.0)
    err = torch.angle(s) - torch.angle(a)
    phase_err = torch.atan2(torch.sin(err), torch.cos(err)).abs().mean(-1)
    floor = torch.quantile(p, 0.2, dim=-1)
    snr = torch.where(floor > 0, p.mean(-1) / floor.clamp(min=1e-30), 0.0)
    snr_term = torch.where(
        floor > 0, (torch.log10(snr.clamp(min=1e-12)) / 3.0).clamp(0, 1),
        0.0)
    conf = (0.4 * corr + 0.3 * torch.exp(-phase_err)
            + 0.3 * snr_term).clamp(0.0, 1.0)
    return conf.numpy().astype(prec.real)


def aoa_features(det: Dict, sigs: np.ndarray, cfg, prec: est.Precision,
                 device) -> Dict:
    """Kept detections, their raw azimuths and elevations, confidences and
    MDL order (``estimation.aoa_features`` on a URA)."""
    aoa = cfg.aoa
    K = det["valid"].shape[-1]
    kept = (det["valid"] & (det["power_db"] > aoa.power_filter_db)
            & (np.arange(K) < aoa.max_targets))
    ang = joint_beamforming(sigs, cfg, prec, device)
    az, el = ang[..., 0], ang[..., 1]
    _, multi = est.mdl_order(sigs)
    return {**det, "kept": kept, "az_deg": az, "el_deg": el,
            "conf": confidence(sigs, az, el, cfg, prec), "multi": multi,
            "sig0": sigs[..., 0].astype(prec.complex),
            "key": det["range_bin"] * cfg.radar.num_chirps
            + det["doppler_bin"]}


def targets(feat: Dict, az_s: np.ndarray, conf_s: np.ndarray, cfg,
            prec: est.Precision) -> Dict:
    """Targets [F, N] with height: positions (r cos el cos az, r cos el
    sin az, r sin el) from the smoothed azimuth and the raw elevation,
    lines of sight their unit directions."""
    ft = prec.real
    reliable = (feat["kept"] & (conf_s >= cfg.aoa.confidence_threshold)
                & ~feat["multi"])
    az = np.deg2rad(az_s.astype(np.float64))
    el = np.deg2rad(feat["el_deg"].astype(np.float64))
    r = feat["range_m"].astype(np.float64)
    los = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                    np.sin(el)], axis=-1)
    return {"pos": (r[..., None] * los).astype(ft), "los": los.astype(ft),
            "vr": feat["vr"].astype(ft), "conf": conf_s.astype(ft),
            "sig0": feat["sig0"], "kept": feat["kept"],
            "ok": feat["kept"] & reliable, "reliable": reliable}
