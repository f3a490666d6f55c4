"""Phase B of the reference in plain NumPy: from the front end's picks to
motion and pose, written from what the configuration defines, in float64.

Each function states the quantity it computes; none follows the program's
batched formulation.  Per frame:

1. **Detections** (:func:`detections`): a top-K pick is valid where its
   score is finite and no valid stronger pick (a lower slot) lies within
   the Chebyshev NMS radius of its (range, Doppler) cell; its range and
   Doppler are refined by a parabola through the dB power of the cell and
   its neighbours on each axis (interior cells), then converted to metres,
   hertz and radial velocity (vr = -f_d lambda / 2).
2. **AoA** (:func:`beamforming_azimuth`): the conventional beamformer's
   power |a(theta)^H s|^2 over the search grid, its first maximum refined
   by a parabola through the neighbours (interior peaks).  The MDL order of
   the single-snapshot covariance s s^H (:func:`mdl_order`) marks
   multipath, and :func:`confidence` scores each angle.
3. **Temporal smoothing**: a detection's track is the chain of earlier
   detections of the same cell, each within ``track_max_age + 1`` frames of
   the next; the smoothed angle blends the confidence-weighted circular
   mean of the track's last ``temporal_window`` raw angles with the
   previous raw angle (:func:`smooth_sequence`; the streaming analyzer's
   bounded table of tracks: :class:`SlotTable`).
4. **Targets**: kept detections (valid, above the power filter, among the
   first ``max_targets`` slots); reliable where the smoothed confidence
   reaches the threshold and no multipath.
5. **Association** (:func:`associate`): a current and a previous reliable
   target match where each is the other's nearest neighbour in (x, y)
   (within one sensor on a rig) and the distance is inside the gate.
6. **Solve** (:func:`solve`): Doppler de-aliasing by consensus, a Huber
   IRLS ridge solve of the Doppler and apparent-velocity rows (velocity
   first, then all six), then Gauss-Newton on the wrapped phase residual
   of the translational block.
7. **Pose**: planar dead reckoning, each step's body velocity turned by
   the yaw before it.

``Precision`` selects the arithmetic: ``"float64"`` for the reference,
``"tf32"`` for the control (float32 with every product's operands rounded
to TF32's 10-bit mantissa).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

BIG = 1e9                 # the distance of a pair that may not match
FRAME_CHUNK = 512         # frames per block of the [F, K, K] / [F, K, G] work


@dataclasses.dataclass(frozen=True)
class Precision:
    real: type
    complex: type
    tf32: bool

    def r(self, x):
        """``x`` in this precision's arithmetic (operands of products)."""
        x = np.asarray(x)
        x = x.astype(self.complex if np.iscomplexobj(x) else self.real)
        if not self.tf32:
            return x
        if np.iscomplexobj(x):
            return (_tf32(x.real) + 1j * _tf32(x.imag)).astype(self.complex)
        return _tf32(x)


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest even)."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0xFFF) + ((b >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return b.view(np.float32)


PRECISIONS = {"float64": Precision(np.float64, np.complex128, False),
              "tf32": Precision(np.float32, np.complex64, True)}


def wrap(theta):
    """Angles wrapped to (-pi, pi]."""
    return np.arctan2(np.sin(theta), np.cos(theta))


def _parabola_offset(ym, y0, yp, interior, eps):
    """Vertex offset, in bins, of the parabola through (-1, ym), (0, y0),
    (1, yp), clipped to [-0.5, 0.5]; 0 where flat or not interior."""
    den = ym - 2.0 * y0 + yp
    safe = np.abs(den) > eps
    off = np.where(safe, 0.5 * (ym - yp) / np.where(safe, den, 1.0), 0.0)
    return np.where(interior, np.clip(off, -0.5, 0.5), 0.0)


# ---- 1. detections ------------------------------------------------------

def range_step_m(radar, R: int) -> float:
    """Metres per range bin: (fs / R) (c / (2 slope))."""
    return (radar.sampling_rate / R) * radar.c / (2.0 * radar.chirp_rate)


def detections(p_lin: np.ndarray, r_bin: np.ndarray, d_bin: np.ndarray,
               values: np.ndarray, cfg, prec: Precision) -> Dict:
    """The detections of top-K picks [F, K] on power maps [F, R, D]."""
    radar, det = cfg.radar, cfg.detection
    F, K = r_bin.shape
    R, D = p_lin.shape[-2:]
    ft = prec.real
    r = r_bin.astype(np.int64)
    d = d_bin.astype(np.int64)
    picked = np.isfinite(values)
    valid = picked.copy()
    if det.nms_radius > 0:
        near = ((np.abs(r[:, :, None] - r[:, None, :]) <= det.nms_radius)
                & (np.abs(d[:, :, None] - d[:, None, :]) <= det.nms_radius))
        earlier = np.tri(K, K, -1, dtype=bool)       # [i, j]: j < i
        valid &= ~np.any(near & earlier & picked[:, None, :], axis=-1)
    pdb = (10.0 * np.log10(p_lin.astype(ft) + 1e-12)).reshape(F, R * D)

    def db(dr, dd):
        rr = np.clip(r + dr, 0, R - 1)
        cc = np.clip(d + dd, 0, D - 1)
        return np.take_along_axis(pdb, rr * D + cc, axis=1)

    y0 = db(0, 0)
    r_off = _parabola_offset(db(-1, 0), y0, db(1, 0),
                             (r > 0) & (r < R - 1), 1e-9)
    d_off = _parabola_offset(db(0, -1), y0, db(0, 1),
                             (d > 0) & (d < D - 1), 1e-9)
    range_m = (r + r_off) * range_step_m(radar, R)
    doppler_hz = (d - D // 2 + d_off) / (D * radar.pri)
    vr = -doppler_hz * radar.lambda_c / 2.0
    z = np.zeros((F, K), ft)
    return {"valid": valid,
            "range_bin": np.where(valid, r, 0),
            "doppler_bin": np.where(valid, d, 0),
            "range_m": np.where(valid, range_m, z).astype(ft),
            "vr": np.where(valid, vr, z).astype(ft),
            "power_db": np.where(valid, values.astype(ft), -np.inf)}


# ---- 2. angle of arrival -------------------------------------------------

def azimuth_grid_deg(aoa) -> np.ndarray:
    return np.linspace(aoa.search_min_deg, aoa.search_max_deg,
                       aoa.num_grid_points)


def steering(az_rad, radar, prec: Precision) -> np.ndarray:
    """ULA steering vectors [..., A]: element n at n d sees the phase
    2 pi n d sin(az) / lambda."""
    n = np.arange(radar.num_antennas)
    ph = (2.0 * math.pi * radar.spacing / radar.lambda_c) \
        * np.sin(np.asarray(az_rad, np.float64))[..., None] * n
    return np.exp(1j * ph).astype(prec.complex)


def beamforming_azimuth(sigs: np.ndarray, cfg,
                        prec: Precision) -> np.ndarray:
    """The refined beamforming azimuth (deg) of signatures [F, K, A]."""
    aoa = cfg.aoa
    grid = azimuth_grid_deg(aoa)
    a = prec.r(steering(np.deg2rad(grid), cfg.radar, prec))      # [G, A]
    F, K, A = sigs.shape
    out = np.empty((F, K), np.float64)
    G = grid.shape[0]
    for i in range(0, F, FRAME_CHUNK):
        s = prec.r(sigs[i:i + FRAME_CHUNK])
        resp = np.einsum("fka,ga->fkg", s, a.conj())
        spec = (resp.real ** 2 + resp.imag ** 2).astype(prec.real)
        g = np.argmax(spec, axis=-1)
        taps = [np.take_along_axis(spec, np.clip(g + o, 0, G - 1)[..., None],
                                   axis=-1)[..., 0] for o in (-1, 0, 1)]
        off = _parabola_offset(*taps, (g > 0) & (g < G - 1), 1e-12)
        out[i:i + FRAME_CHUNK] = grid[g] + off * (grid[1] - grid[0])
    return out.astype(prec.real)


def mdl_order(sigs: np.ndarray, max_sources: int = 4):
    """(sources, multipath) by the MDL criterion over the eigenvalues of the
    single-snapshot covariance s s^H: (||s||^2, 0, ..., 0) descending,
    since it has rank one.  With A elements and k sources the noise
    eigenvalues are the last L = A - k; MDL(k) = -A L log(geometric /
    arithmetic mean of them) + k (2A - k) log(L) / 2, infinite where their
    mean is 0; the order is 1 where the second eigenvalue is under 1e-6 of
    the first."""
    A = sigs.shape[-1]
    ev = np.zeros(sigs.shape, np.float64)
    ev[..., 0] = np.sum(np.abs(sigs.astype(np.complex128)) ** 2, axis=-1)
    best, order = np.full(ev.shape[:-1], np.inf), np.ones(ev.shape[:-1], int)
    for k in range(1, min(max_sources, A - 1) + 1):
        L = A - k
        noise = ev[..., k:]
        arith = noise.mean(axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            geo = np.exp(np.mean(np.log(np.maximum(noise, 1e-20)), axis=-1))
            ratio = np.where(arith > 0, geo / arith, 1.0)
            mdl = np.where(arith > 0,
                           -A * L * np.log(np.maximum(ratio, 1e-30))
                           + 0.5 * k * (2 * A - k) * math.log(L), np.inf)
        better = mdl < best
        best = np.where(better, mdl, best)
        order = np.where(better, k, order)
    order = np.where(ev[..., 1] < 1e-6 * np.maximum(ev[..., 0], 1e-30), 1,
                     order)
    return order, order > 1


def confidence(sigs: np.ndarray, az_deg: np.ndarray, cfg,
               prec: Precision) -> np.ndarray:
    """0.4 |a^H s| / ||s|| + 0.3 exp(-mean |wrapped phase error|) + 0.3 SNR
    term, clipped to [0, 1]; the SNR term is log10(mean |s_n|^2 / its 20th
    percentile) / 3 in [0, 1], 0 where that percentile is 0."""
    s = sigs.astype(prec.complex)
    a = steering(np.deg2rad(az_deg.astype(np.float64)), cfg.radar, prec)
    p = (s.real ** 2 + s.imag ** 2).astype(prec.real)
    power = p.sum(axis=-1)
    corr = np.abs(np.sum(a.conj() * s, axis=-1))
    corr = np.where(power > 0, corr / np.sqrt(np.maximum(power, 1e-30)), 0.0)
    phase_err = np.mean(np.abs(wrap(np.angle(s) - np.angle(a))), axis=-1)
    floor = np.percentile(p, 20.0, axis=-1).astype(prec.real)
    with np.errstate(divide="ignore", invalid="ignore"):
        snr = np.where(floor > 0, p.mean(axis=-1) / floor, 0.0)
    snr_term = np.where(floor > 0, np.clip(
        np.log10(np.maximum(snr, 1e-12)) / 3.0, 0.0, 1.0), 0.0)
    return np.clip(0.4 * corr + 0.3 * np.exp(-phase_err) + 0.3 * snr_term,
                   0.0, 1.0).astype(prec.real)


# ---- 3. temporal smoothing -----------------------------------------------

def _smoothed(entries: List, aoa):
    """(angle deg, confidence) of a track's raw entries (angle, conf),
    newest last, at most ``temporal_window`` of them."""
    if len(entries) <= 1:
        return entries[-1]
    ang = np.deg2rad(np.array([e[0] for e in entries], np.float64))
    cnf = np.array([e[1] for e in entries], np.float64)
    total = cnf.sum()
    w = cnf / total if total > 0 else np.full(len(entries), 1 / len(entries))
    circ = math.degrees(math.atan2(float(np.sum(w * np.sin(ang))),
                                   float(np.sum(w * np.cos(ang)))))
    sf = aoa.smoothing_factor
    return (sf * circ + (1.0 - sf) * float(entries[-2][0]),
            float(cnf.mean()))


def smooth_sequence(keys: np.ndarray, angles: np.ndarray, confs: np.ndarray,
                    kept: np.ndarray, aoa):
    """Smoothed (angles, confidences) [F, K] of a sequence; unkept
    detections keep their raw values.  A track is keyed by its cell; a
    kept detection continues its key's track when that track's last
    detection is at most ``track_max_age + 1`` frames back, else starts
    one."""
    gap = aoa.track_max_age + 1
    W = aoa.temporal_window
    out_a = np.array(angles, np.float64)
    out_c = np.array(confs, np.float64)
    tracks: Dict[int, tuple] = {}            # key -> (last frame, entries)
    for f in range(keys.shape[0]):
        for k in np.flatnonzero(kept[f]).tolist():
            key = int(keys[f, k])
            e = (float(angles[f, k]), float(confs[f, k]))
            last = tracks.get(key)
            entries = ((last[1] + [e])[-W:]
                       if last is not None and f - last[0] <= gap else [e])
            tracks[key] = (f, entries)
            out_a[f, k], out_c[f, k] = _smoothed(entries, aoa)
    return out_a, out_c


class SlotTable:
    """The streaming analyzer's bounded table of tracks: ``track_capacity``
    slots, each a key, its last ``temporal_window`` raw entries, and the
    frames since its last update.  A kept detection continues the first
    slot of its key updated within ``track_max_age`` frames before this
    one's; otherwise it takes a slot: free slots first, then the stalest
    (the lower slot first among equals), never one continued this frame."""

    def __init__(self, aoa):
        self.aoa = aoa
        n = aoa.track_capacity
        self.key: List[Optional[int]] = [None] * n
        self.entries: List[List] = [[] for _ in range(n)]
        self.age = [0] * n

    def step(self, keys, angles, confs, kept):
        aoa = self.aoa
        n = len(self.key)
        dets = np.flatnonzero(kept).tolist()
        slot_of = {}
        for k in dets:
            key = int(keys[k])
            for s in range(n):
                if self.key[s] == key and self.age[s] <= aoa.track_max_age:
                    slot_of[k] = s
                    break
        continued = set(slot_of.values())
        order = sorted(range(n), key=lambda s: (
            -(2 ** 40 if self.key[s] is None
              else -1 if s in continued else self.age[s]), s))
        fresh = iter(order)
        out_a = np.array(angles, np.float64)
        out_c = np.array(confs, np.float64)
        written = set()
        for k in dets:
            e = (float(angles[k]), float(confs[k]))
            if k in slot_of:
                s = slot_of[k]
                self.entries[s] = (self.entries[s]
                                   + [e])[-aoa.temporal_window:]
            else:
                s = next(fresh)
                self.key[s] = int(keys[k])
                self.entries[s] = [e]
            written.add(s)
            out_a[k], out_c[k] = _smoothed(self.entries[s], aoa)
        self.age = [0 if s in written else a + 1
                    for s, a in enumerate(self.age)]
        return out_a, out_c


# ---- 4. targets ----------------------------------------------------------

def aoa_features(det: Dict, sigs: np.ndarray, cfg, prec: Precision) -> Dict:
    """Kept detections, their raw azimuths, confidences and MDL order."""
    aoa = cfg.aoa
    K = det["valid"].shape[-1]
    kept = (det["valid"] & (det["power_db"] > aoa.power_filter_db)
            & (np.arange(K) < aoa.max_targets))
    az = beamforming_azimuth(sigs, cfg, prec)
    _, multi = mdl_order(sigs)
    return {**det, "kept": kept, "az_deg": az,
            "conf": confidence(sigs, az, cfg, prec), "multi": multi,
            "sig0": sigs[..., 0].astype(prec.complex),
            "key": det["range_bin"] * cfg.radar.num_chirps
            + det["doppler_bin"]}


def targets(feat: Dict, az_s: np.ndarray, conf_s: np.ndarray, cfg,
            prec: Precision, mount=None) -> Dict:
    """Targets [F, N]: positions (x, y, 0) and lines of sight in the vehicle
    frame, through the sensor's mount (x, y, yaw) on a rig."""
    ft = prec.real
    reliable = (feat["kept"] & (conf_s >= cfg.aoa.confidence_threshold)
                & ~feat["multi"])
    az = np.deg2rad(az_s.astype(np.float64))
    r = feat["range_m"].astype(np.float64)
    if mount is None:
        ox = oy = 0.0
        x, y = r * np.cos(az), r * np.sin(az)
    else:
        ox, oy, yaw = mount
        x, y = ox + r * np.cos(az + yaw), oy + r * np.sin(az + yaw)
    pos = np.stack([x, y, np.zeros_like(x)], axis=-1)
    rel = pos - np.array([ox, oy, 0.0])
    los = rel / np.maximum(np.linalg.norm(rel, axis=-1, keepdims=True), 1e-6)
    return {"pos": pos.astype(ft), "los": los.astype(ft),
            "vr": feat["vr"].astype(ft), "conf": conf_s.astype(ft),
            "sig0": feat["sig0"], "kept": feat["kept"],
            "ok": feat["kept"] & reliable, "reliable": reliable}


# ---- 5. association --------------------------------------------------------

def associate(cur: Dict, prev: Dict, has_prev: np.ndarray, cfg,
              prec: Precision, group: Optional[np.ndarray] = None) -> Dict:
    """Mutual nearest neighbours between targets [F, N] and their previous
    frame's [F, N], and what the solve needs of each match."""
    vc = cfg.velocity
    F, N = cur["ok"].shape
    hit = np.zeros((F, N), bool)
    j_of = np.zeros((F, N), np.int64)
    for i in range(0, F, FRAME_CHUNK):
        sl = slice(i, i + FRAME_CHUNK)
        pc, pp = cur["pos"][sl, :, None, :2], prev["pos"][sl, None, :, :2]
        dist = np.sqrt(np.sum((pc - pp) ** 2, axis=-1) + 1e-12)
        allowed = cur["ok"][sl, :, None] & prev["ok"][sl, None, :]
        if group is not None:
            allowed &= group[:, None] == group[None, :]
        dist = np.where(allowed, dist, BIG)
        j = np.argmin(dist, axis=2)
        i_of_j = np.argmin(dist, axis=1)
        best = np.take_along_axis(dist, j[..., None], axis=2)[..., 0]
        mutual = np.take_along_axis(i_of_j, j, axis=1) == np.arange(N)
        hit[sl] = (cur["ok"][sl] & mutual & (best < vc.association_gate)
                   & has_prev[sl, None])
        j_of[sl] = j

    def at_j(x):
        return np.take_along_axis(
            x, j_of.reshape(F, N, *([1] * (x.ndim - 2))), axis=1)
    dt = max(cfg.frame_dt, 1e-6)
    phase = np.angle(cur["sig0"] * np.conj(at_j(prev["sig0"])))
    app_v = (cur["pos"] - at_j(prev["pos"])) / dt
    weight = cur["conf"] * at_j(prev["conf"])
    ft = prec.real
    return {"valid": hit, "pos": cur["pos"], "los": cur["los"],
            "vr": cur["vr"],
            "phase": np.where(hit, phase, 0.0).astype(ft),
            "app_v": np.where(hit[..., None], app_v, 0.0).astype(ft),
            "weight": np.where(hit, weight, 0.0).astype(ft)}


# ---- 6. the solve ----------------------------------------------------------

def _huber(res, delta):
    a = np.abs(res)
    return np.where(a <= delta, 1.0, delta / np.maximum(a, 1e-12))


def _normal(prec, A, w, b):
    """(A^T W A, A^T W b) per frame of rows A [F, N, n], b, w [F, N]."""
    A = prec.r(A)
    Awt = prec.r(A * w[..., None]).transpose(0, 2, 1)
    return Awt @ A, (Awt @ prec.r(b)[..., None])[..., 0]


def _median_guess(assoc, cfg) -> np.ndarray:
    """-(median apparent velocity of the matches) in x and y, 0 without
    matches, clipped to the speed limit; z and rotation 0."""
    F = assoc["valid"].shape[0]
    x0 = np.zeros((F, 6))
    for f in np.flatnonzero(assoc["valid"].any(axis=1)).tolist():
        m = assoc["valid"][f]
        x0[f, :2] = -np.median(assoc["app_v"][f, m, :2].astype(np.float64),
                               axis=0)
    vmax = cfg.velocity.max_velocity
    x0[:, :3] = np.clip(x0[:, :3], -vmax, vmax)
    return x0


def solve(assoc: Dict, cfg, prec: Precision,
          prev_motion: Optional[np.ndarray] = None):
    """(x [F, 6] = velocity and angular velocity, success [F], matches
    [F]) of associations [F, N]."""
    vc, radar = cfg.velocity, cfg.radar
    ft = prec.real
    valid = assoc["valid"]
    F, N = valid.shape
    n = valid.sum(axis=1)
    pos = assoc["pos"].astype(ft)
    los = assoc["los"].astype(ft)
    rows = np.concatenate([los, np.cross(pos, los)], axis=-1)   # [F, N, 6]
    vr = assoc["vr"].astype(ft)
    zero6 = np.zeros((F, 6), ft)
    prior_x = zero6 if prev_motion is None else prev_motion.astype(ft)
    if vc.dealias_doppler:
        span = 2.0 * radar.max_unambiguous_velocity
        cands = np.stack([prior_x, zero6,
                          _median_guess(assoc, cfg).astype(ft)], axis=1)
        pred = -np.einsum("fni,fci->fcn", prec.r(rows), prec.r(cands))
        res = vr[:, None, :] - pred
        folded = res - span * np.round(res / span)
        support = (np.sum((np.abs(folded) < 1.5) & valid[:, None, :], -1)
                   / np.maximum(n, 1)[:, None])
        best = np.argmax(support + np.array([2e-3, 1e-3, 0.0]), axis=1)
        ref = cands[np.arange(F), best]
        vr_ref = -np.einsum("fni,fi->fn", prec.r(rows), prec.r(ref))
        vr = (vr + np.round((vr_ref - vr) / span) * span).astype(ft)

    lam = vc.regularization_weight
    t = vc.temporal_weight * lam if prev_motion is not None else 0.0
    w_base = np.where(valid, np.maximum(assoc["weight"], 1e-3), 0.0)

    # Doppler rows vr = -[d, r x d] . x; apparent-velocity rows
    # -app_v = v + w x r in x and y.
    A, b = -rows, vr
    w0 = w_base if vc.use_doppler_vr else np.zeros_like(w_base)
    if vc.use_apparent_velocity:
        r = pos
        o, z = np.ones_like(r[..., 0]), np.zeros_like(r[..., 0])
        ax = np.stack([o, z, z, z, r[..., 2], -r[..., 1]], axis=-1)
        ay = np.stack([z, o, z, -r[..., 2], z, r[..., 0]], axis=-1)
        A = np.concatenate([A, ax, ay], axis=1)
        b = np.concatenate([b, -assoc["app_v"][..., 0],
                            -assoc["app_v"][..., 1]], axis=1)
        wa = vc.apparent_velocity_weight * w_base
        w0 = np.concatenate([w0, wa, wa], axis=1)
    diag = np.array([lam, lam, lam * vc.z_velocity_weight, lam, lam, lam])
    stages = []
    if vc.two_step:
        stages.append(np.concatenate([diag[:3], [1e6] * 3]))
    stages.append(diag)
    x = np.zeros((F, 6), ft)
    for d in stages:
        reg = np.diag(d + t + 1e-9)
        for _ in range(3):
            res = b - (prec.r(A) @ prec.r(x)[..., None])[..., 0]
            w = w0 * _huber(res, vc.doppler_huber_mps)
            H, g = _normal(prec, A, w, b)
            x = np.linalg.solve(H + reg, (g + t * prior_x)[..., None])[..., 0]
            x = x.astype(ft)

    # Gauss-Newton on the wrapped phase residual, velocity only; rotation
    # fixed at the IRLS value, its phase subtracted.
    scale = 4.0 * math.pi * cfg.frame_dt / radar.lambda_c
    s2 = scale * scale
    A3 = scale * los
    phi = assoc["phase"] - scale * np.einsum(
        "fni,fi->fn", prec.r(np.cross(pos, los)), prec.r(x[:, 3:]))
    v_prior = prior_x[:, :3]
    reg3 = s2 * np.diag(diag[:3] + t + 1e-6)
    v = x[:, :3].copy()
    for _ in range(vc.gn_iterations):
        res = wrap(phi - (prec.r(A3) @ prec.r(v)[..., None])[..., 0])
        w = w_base * _huber(res, vc.huber_delta)
        H, g = _normal(prec, A3, w, res)
        dv = np.linalg.solve(H + reg3,
                             (g + s2 * t * (v_prior - v))[..., None])[..., 0]
        v = (v + dv).astype(ft)
    x = np.concatenate([np.clip(v, -vc.max_velocity, vc.max_velocity),
                        np.clip(x[:, 3:], -vc.max_angular_velocity,
                                vc.max_angular_velocity)], axis=-1)
    success = n >= vc.min_targets
    x = np.where(success[:, None], x, prior_x)
    return x.astype(ft), success, n


# ---- 7. pose ---------------------------------------------------------------

def pose_sequence(x: np.ndarray, success: np.ndarray, dt: float):
    """Poses (x, y, yaw) [F, 3] after each frame of a sequence started at
    the origin; a failed frame moves nothing."""
    v = np.where(success[:, None], x[:, :2], 0.0).astype(np.float64)
    wz = np.where(success, x[:, 5], 0.0).astype(np.float64)
    yaw_after = np.cumsum(wz * dt)
    yaw = yaw_after - wz * dt
    c, s = np.cos(yaw), np.sin(yaw)
    step = np.stack([c * v[:, 0] - s * v[:, 1],
                     s * v[:, 0] + c * v[:, 1]], axis=-1) * dt
    return np.concatenate([np.cumsum(step, axis=0), yaw_after[:, None]], -1)


def pose_step(pose: np.ndarray, x: np.ndarray, dt: float) -> np.ndarray:
    """One planar step of pose (x, y, yaw) by body motion x [6]."""
    c, s = math.cos(pose[2]), math.sin(pose[2])
    return np.array([pose[0] + (c * x[0] - s * x[1]) * dt,
                     pose[1] + (s * x[0] + c * x[1]) * dt,
                     pose[2] + x[5] * dt])
