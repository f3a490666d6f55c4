"""Closed-form 6-DoF radar ego-motion velocity solver, batched over frames.

Counterpart of ``radar_slam_tpu/motion/velocity.py``: the phase model
phi_i = (4 pi dt / lambda) [d_i, r_i x d_i] . x is linear in x = (v, w), so
the solve is regularized least squares -- Huber IRLS on the Doppler
(+ apparent-velocity) rows, then Gauss-Newton on the wrapped phase
residual ("fused"), with Doppler de-aliasing by consensus.  The reference
vmaps one frame's solve; here the frame axis [F] is written out and every
small system is solved by the same unrolled Cholesky.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from radar_slam_tpu_torch.core.config import VelocityConfig
from radar_slam_tpu_torch.core.geometry import wrap_angle
from radar_slam_tpu_torch.core.types import Associations, MotionEstimate


def _f32(x: float) -> float:
    """x rounded to float32, kept as a Python scalar (the reference's
    ``jnp.float32`` constants, without a host tensor on the device path)."""
    return float(np.float32(x))


def design_matrix(assoc: Associations) -> torch.Tensor:
    """Rows [F, K, 6] = [d_i, r_i x d_i] (the radial-rate Jacobian)."""
    r, d = assoc.position, assoc.direction
    return torch.cat([d, torch.linalg.cross(r, d, dim=-1)], dim=-1)


def _masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of x over its valid entries, per row [F]: NaN when
    a row has none, the mean of the two middle values for an even count
    (the reference's weights low (1 - w) + high w, w = 0.5)."""
    n = valid.sum(dim=-1)                                         # [F]
    xs = torch.sort(torch.where(valid, x, math.inf), dim=-1).values
    q = 0.5 * (n.to(torch.float32) - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    hw = q - lo
    lw = 1.0 - hw
    cap = torch.clamp(n - 1, min=0)
    i_lo = torch.minimum(torch.clamp(lo, min=0).to(torch.int64), cap)
    i_hi = torch.minimum(torch.clamp(hi, min=0).to(torch.int64), cap)
    v_lo = torch.gather(xs, -1, i_lo[:, None])[:, 0]
    v_hi = torch.gather(xs, -1, i_hi[:, None])[:, 0]
    med = v_lo * lw + v_hi * hw
    return torch.where(n > 0, med, math.nan)


def smart_initial_guess(assoc: Associations,
                        cfg: VelocityConfig) -> torch.Tensor:
    """x0 [F, 6] = -(median apparent target velocity), z and omega zero."""
    vx = _masked_median(assoc.apparent_velocity[..., 0], assoc.valid)
    vy = _masked_median(assoc.apparent_velocity[..., 1], assoc.valid)
    v = torch.stack([-vx, -vy, torch.zeros_like(vx)], dim=-1)
    v = torch.where(torch.isnan(v), 0.0, v)
    v = torch.clamp(v, -cfg.max_velocity, cfg.max_velocity)
    return torch.cat([v, torch.zeros_like(v)], dim=-1)


def _prior_matrix(cfg: VelocityConfig, full: bool, device) -> torch.Tensor:
    """Diagonal Tikhonov prior [6, 6] (reference regularizers as ridge),
    read-only: one per (configuration, ``full``, device), built on first
    use (:func:`_prior_matrix_on`)."""
    return _prior_matrix_on(cfg, full, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _prior_matrix_on(cfg: VelocityConfig, full: bool,
                     device: str) -> torch.Tensor:
    lam = cfg.regularization_weight
    diag = torch.full((6,), lam, dtype=torch.float32, device=device)
    diag[2] = lam * cfg.z_velocity_weight
    if not full:
        diag[3:] = 1e6      # v-only step: pin omega hard
    return torch.diag(diag)


@functools.lru_cache(maxsize=None)
def _alias_bonus(device: str) -> torch.Tensor:
    """The alias candidates' tie-break bonuses [3] (previous motion, zero,
    guess), read-only, built once per device."""
    bonus = torch.zeros(3, dtype=torch.float32, device=device)
    bonus[0], bonus[1] = 2e-3, 1e-3
    return bonus


def _chol_solve_unrolled(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve SPD H x = g (H [..., n, n], g [..., n]) by a fully unrolled
    Cholesky: batched scalar operations only."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _ridge_solve(A, b, w, prior, x_prior, t_weight: float) -> torch.Tensor:
    """Solve (A^T W A + prior + t I) x = A^T W b + t x_prior per frame.
    A [F, N, 6], b / w [F, N], x_prior [F, 6]."""
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    Aw = A * w[..., None]
    H = A.transpose(-1, -2) @ Aw + prior + t_weight * eye
    g = (Aw.transpose(-1, -2) @ b[..., None])[..., 0] + t_weight * x_prior
    return _chol_solve_unrolled(H + 1e-9 * eye, g)


def _huber_weights(res: torch.Tensor, delta: float) -> torch.Tensor:
    a = res.abs()
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-12))


def _apparent_velocity_rows(assoc: Associations):
    """Rows for the transverse apparent-velocity observable
    apparent_v = -(v + w x r): A [F, 2K, 6], b [F, 2K]."""
    r = assoc.position
    zero = torch.zeros_like(r[..., 0])
    one = torch.ones_like(zero)
    row_x = torch.stack([one, zero, zero, zero, r[..., 2], -r[..., 1]], -1)
    row_y = torch.stack([zero, one, zero, -r[..., 2], zero, r[..., 0]], -1)
    A = torch.cat([row_x, row_y], dim=-2)
    b = torch.cat([-assoc.apparent_velocity[..., 0],
                   -assoc.apparent_velocity[..., 1]], dim=-1)
    return A, b


def solve_doppler(assoc: Associations, cfg: VelocityConfig,
                  prev_motion: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ridge IRLS on vr_i = -[d_i, r_i x d_i] . x (+ apparent-velocity
    rows).  Returns x [F, 6]."""
    F = assoc.valid.shape[0]
    dev = assoc.vr_mps.device
    A = -design_matrix(assoc)
    b = assoc.vr_mps
    w_base = torch.where(assoc.valid, torch.clamp(assoc.weight, min=1e-3),
                         0.0)
    w0 = w_base if cfg.use_doppler_vr else torch.zeros_like(w_base)
    if cfg.use_apparent_velocity:
        A2, b2 = _apparent_velocity_rows(assoc)
        A = torch.cat([A, A2], dim=-2)
        b = torch.cat([b, b2], dim=-1)
        w_app = cfg.apparent_velocity_weight * torch.cat([w_base, w_base],
                                                         dim=-1)
        w0 = torch.cat([w0, w_app], dim=-1)
    t_w = _f32(cfg.temporal_weight * cfg.regularization_weight
               if prev_motion is not None else 0.0)
    x_prior = (prev_motion if prev_motion is not None
               else torch.zeros((F, 6), dtype=torch.float32, device=dev))

    def irls(x, full):
        prior = _prior_matrix(cfg, full, dev)
        for _ in range(3):
            res = b - (A @ x[..., None])[..., 0]
            w = w0 * _huber_weights(res, cfg.doppler_huber_mps)
            x = _ridge_solve(A, b, w, prior, x_prior, t_w)
        return x

    x = torch.zeros((F, 6), dtype=torch.float32, device=dev)
    if cfg.two_step:
        x = irls(x, full=False)
    return irls(x, full=True)


def refine_phase(assoc: Associations, x0: torch.Tensor, dt: float,
                 lambda_c: float, cfg: VelocityConfig,
                 prev_motion: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gauss-Newton on the wrapped phase residual from x0 [F, 6], refining
    the translational block only (omega keeps x0's value and its phase
    contribution is subtracted as a fixed offset)."""
    dev = x0.device
    scale = _f32(np.float32(4.0 * math.pi) * np.float32(dt)
                 / np.float32(lambda_c))
    A = scale * assoc.direction                                   # [F, K, 3]
    lever = torch.linalg.cross(assoc.position, assoc.direction, dim=-1)
    phi = assoc.temporal_phase_diff - scale * (lever @ x0[:, 3:, None])[..., 0]
    w0 = torch.where(assoc.valid, torch.clamp(assoc.weight, min=1e-3), 0.0)
    t_w = _f32(cfg.temporal_weight * cfg.regularization_weight
               if prev_motion is not None else 0.0)
    v_prior = (prev_motion[:, :3] if prev_motion is not None
               else torch.zeros_like(x0[:, :3]))
    prior3 = _prior_matrix(cfg, True, dev)[:3, :3]
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    s2 = _f32(np.float32(scale) * np.float32(scale))

    v = x0[:, :3]
    for _ in range(cfg.gn_iterations):
        res = wrap_angle(phi - (A @ v[..., None])[..., 0])
        w = w0 * _huber_weights(res, cfg.huber_delta)
        Aw = A * w[..., None]
        H = A.transpose(-1, -2) @ Aw + s2 * (prior3 + t_w * eye3)
        g = ((Aw.transpose(-1, -2) @ res[..., None])[..., 0]
             + s2 * t_w * (v_prior - v))
        dv = _chol_solve_unrolled(H + 1e-6 * s2 * eye3, g)
        v = v + dv
    return torch.cat([v, x0[:, 3:]], dim=-1)


def dealias_doppler(assoc: Associations, x_ref: torch.Tensor,
                    v_unambiguous: float) -> Associations:
    """Unwrap each target's vr by the integer number of spans 2 v_unamb
    that brings it nearest the prediction -[d, r x d] . x_ref."""
    span = _f32(2.0 * v_unambiguous)
    vr_pred = -(design_matrix(assoc) @ x_ref[..., None])[..., 0]
    k = torch.round((vr_pred - assoc.vr_mps) / span)
    return assoc._replace(vr_mps=assoc.vr_mps + k * span)


def solve_velocity(assoc: Associations, dt: float, lambda_c: float,
                   cfg: VelocityConfig,
                   prev_motion: Optional[torch.Tensor] = None,
                   mode: Optional[str] = None,
                   v_unambiguous: Optional[float] = None) -> MotionEstimate:
    """Full two-step 6-DoF solve per frame; a :class:`MotionEstimate` [F]."""
    mode = mode or cfg.mode
    F = assoc.valid.shape[0]
    dev = assoc.vr_mps.device
    n = assoc.num_valid

    if cfg.dealias_doppler and v_unambiguous is not None:
        # Alias reference by consensus among {previous motion, zero,
        # apparent-velocity guess}; small bonuses break ties toward
        # prev > zero > guess.
        span = _f32(2.0 * v_unambiguous)
        zeros6 = torch.zeros((F, 6), dtype=torch.float32, device=dev)
        prev = prev_motion if prev_motion is not None else zeros6
        cands = torch.stack([prev, zeros6,
                             smart_initial_guess(assoc, cfg)], dim=1)
        pred = -(cands @ design_matrix(assoc).transpose(-1, -2))  # [F, 3, K]
        res = assoc.vr_mps[:, None, :] - pred
        folded = res - span * torch.round(res / span)
        w = torch.where(assoc.valid, 1.0, 0.0)[:, None, :]
        support = (torch.sum((folded.abs() < 1.5) * w, dim=-1)
                   / torch.clamp(torch.sum(w, dim=-1), min=1.0))
        bonus = _alias_bonus(str(dev))
        best = torch.argmax(support + bonus, dim=-1)              # [F]
        x_ref = torch.gather(cands, 1, best[:, None, None].expand(F, 1, 6))
        assoc = dealias_doppler(assoc, x_ref[:, 0], v_unambiguous)

    if mode == "doppler":
        x = solve_doppler(assoc, cfg, prev_motion)
    elif mode == "phase":
        x = refine_phase(assoc, smart_initial_guess(assoc, cfg), dt,
                         lambda_c, cfg, prev_motion)
    elif mode == "fused":
        x0 = solve_doppler(assoc, cfg, prev_motion)
        x = refine_phase(assoc, x0, dt, lambda_c, cfg, prev_motion)
    else:
        raise ValueError(f"Unknown solver mode: {mode}")

    v = torch.clamp(x[:, :3], -cfg.max_velocity, cfg.max_velocity)
    w = torch.clamp(x[:, 3:], -cfg.max_angular_velocity,
                    cfg.max_angular_velocity)
    x = torch.cat([v, w], dim=-1)

    scale = _f32(np.float32(4.0 * math.pi) * np.float32(dt)
                 / np.float32(lambda_c))
    res = wrap_angle(assoc.temporal_phase_diff
                     - scale * (design_matrix(assoc) @ x[..., None])[..., 0])
    res = torch.where(assoc.valid, res, 0.0)
    denom = torch.clamp(n, min=1).to(torch.float32)
    rmse = torch.sqrt(torch.sum(res * res, dim=-1) / denom)
    max_res = torch.amax(res.abs(), dim=-1)
    cost = torch.sum(res * res, dim=-1)

    success = n >= cfg.min_targets
    fallback = (prev_motion if prev_motion is not None
                else torch.zeros((F, 6), dtype=torch.float32, device=dev))
    x = torch.where(success[:, None], x, fallback)
    return MotionEstimate(
        velocity=x[:, :3],
        angular_velocity=x[:, 3:],
        rmse=torch.where(success, rmse, math.inf),
        max_residual=torch.where(success, max_res, math.inf),
        num_targets=n.to(torch.int32),
        success=success,
        cost=torch.where(success, cost, math.inf),
    )
