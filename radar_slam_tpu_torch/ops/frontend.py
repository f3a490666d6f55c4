"""One-pass front end: split synthesis factors -> Z + power + CFAR score map
-> exact top-K + Z-column signatures.

Counterpart of ``radar_slam_tpu/ops/frontend_pallas.py`` at its production
knobs (split factors, range-frequency noise, "fast" Gaussians, CA-CFAR,
exact top-K).  Per frame the kernel body computes

    T = e_fast @ W_rng                      [Sc, S]   (range DFT, mix/DC folded)
    Z = e_at @ T + sigma sqrt(S) (g (*) taps), column 0 zeroed    [A*C, S]
    p[d, s] = mean_a |sum_c W_dop[c, d] Z[a*C + c, s]|^2          [C, S]
    score = 10 log10(p + 1e-12) where (3x3 local max & CA-CFAR & range
            gate), else -1e30

with e_at[a*C + c, sc] = dopp[sc, c] * ant[sc, a] and e_fast recomposed
from the coarse / fine tables and the echo gate.  The noise is shaped by
the PERIODIC window's taps while the signal keeps the symmetric window --
the reference's documented deviation, reproduced on purpose.

Three layers:

- :func:`frontend_kernel_split` -- the kernel wrapper.  On a CUDA tensor it
  launches the hand-written kernel of ``csrc/frontend.cu`` (or raises); on
  a CPU tensor it runs :func:`scatterer_frontend_split_reference`.
  ``frontend_kernel_split.launches`` counts the CUDA launches.
- :func:`scatterer_frontend_split_reference` -- the kernel body in plain
  PyTorch, the oracle the kernel is held against on the card.
- :func:`scatterer_frontend_split` -- the public entry point, mirroring the
  reference wrapper: constants, kernel, then :func:`_finalize`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as tfn

from radar_slam_tpu_torch.ops import _build
from radar_slam_tpu_torch.ops.noise import standard_normals
from radar_slam_tpu_torch.ops.windows import get_window

_NEG = -1e30          # score sentinel; power_db >= -120 so -1e29 separates
_LOG10E_10 = 4.3429448190325176   # 10 / ln(10)
_MAX_TAPS = 5         # csrc/frontend.cu: MAX_TAPS (a 3-term cosine window)
_MAX_SMEM = 232448    # shared memory one block may use on Hopper (bytes)


def use_f32_matmuls() -> None:
    """The precision contract is float32: TF32 (about three decimal
    digits) would move the power map far beyond its 1e-5 tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class FrontendParams:
    """Scalar knobs of the kernel body (all frame-independent)."""
    sigma: float                 # AWGN standard deviation per plane
    noise_taps: tuple            # ((offset, coeff), ...) periodic-window taps
    echo_upper: Optional[float]  # reference-fidelity upper echo gate [s]
    dc_removal: bool
    train: int                   # CA-CFAR training cells (0 = fixed threshold)
    guard: int
    neighborhood: int            # local-max window (odd)
    offset_db: float
    threshold_db: float
    min_range_bin: int           # inclusive range gate [lo, hi]
    max_range_bin: int


def _log10_db(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) * _LOG10E_10


def _shift2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """result[..., c, s] = x[..., c - dy, s - dx], zero-filled."""
    r = max(abs(dy), abs(dx))
    C, S = x.shape[-2:]
    xp = tfn.pad(x, (r, r, r, r))
    return xp[..., r - dy:r - dy + C, r - dx:r - dx + S]


def _window_counts(n: int, pad: int, device) -> torch.Tensor:
    """Per-index valid sample count of a centered width-(2 pad + 1) window
    clipped to [0, n)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return (torch.clamp(i + pad, max=n - 1.0) - torch.clamp(i - pad, min=0.0)
            + 1.0)


def _box_sum(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """Clipped (zero-extended) box sum of width 2 pad + 1 along ``dim``
    (-1 or -2) of a [..., C, S] map."""
    xp = tfn.pad(x, (pad, pad) if dim == -1 else (0, 0, pad, pad))
    return xp.unfold(dim, 2 * pad + 1, 1).sum(-1)


def _cfar_threshold(p1: torch.Tensor, prm: FrontendParams) -> torch.Tensor:
    """CA-CFAR threshold map [..., C, S] in dB: clipped box means over the
    training window minus the guard window (the full-window cell counts
    weight the clipped means, as the reference does)."""
    if prm.train <= 0:
        return torch.full_like(p1, prm.threshold_db)
    C, S = p1.shape[-2:]
    dev = p1.device
    tpad = prm.train + prm.guard
    noise = _box_sum(_box_sum(p1, tpad, -2), tpad, -1) / (
        _window_counts(C, tpad, dev)[:, None]
        * _window_counts(S, tpad, dev)[None, :])
    if prm.guard > 0:
        gpad = prm.guard
        g = _box_sum(_box_sum(p1, gpad, -2), gpad, -1) / (
            _window_counts(C, gpad, dev)[:, None]
            * _window_counts(S, gpad, dev)[None, :])
        n_train = float((2 * tpad + 1) ** 2)
        n_guard = float((2 * gpad + 1) ** 2)
        noise = (noise * n_train - g * n_guard) / (n_train - n_guard)
    noise_db = _log10_db(torch.clamp(noise, min=1e-12))
    return torch.clamp(noise_db + prm.offset_db, min=prm.threshold_db)


def scatterer_frontend_split_reference(
        ant: torch.Tensor, dopp: torch.Tensor, coarse: torch.Tensor,
        fine: torch.Tensor, tau: torch.Tensor, t: torch.Tensor,
        seeds: torch.Tensor, w_rng: torch.Tensor, w_dop_t: torch.Tensor,
        prm: FrontendParams
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel body in plain PyTorch.

    Args:
        ant / dopp / coarse / fine: [F, Sc, A|C|Q|B] complex64 split factors.
        tau: [F, Sc] float32 round-trip delays; t: [S] fast-time base.
        seeds: [F] int32 per-frame noise seeds.
        w_rng: [S, S] complex64 folded range DFT; w_dop_t: [C, C] complex64
            transposed Doppler DFT (fftshift in its row order).

    Returns:
        (zr, zi [F, S, A*C] float32 -- Z transposed, row a*C + c;
         p [F, C, S] float32 Doppler power; score [F, C, S] float32).
    """
    F, Sc, A = ant.shape
    C = dopp.shape[-1]
    B = fine.shape[-1]
    Q = coarse.shape[-1]
    S = t.shape[0]
    AC = A * C

    e_at = (dopp.transpose(1, 2)[:, None, :, :]
            * ant.transpose(1, 2)[:, :, None, :]).reshape(F, AC, Sc)
    e_fast = (coarse[..., :, None] * fine[..., None, :]).reshape(
        F, Sc, Q * B)[..., :S]
    arrived = t[None, None, :] >= tau[..., None]
    if prm.echo_upper is not None:
        arrived = arrived & (t[None, None, :] - tau[..., None]
                             <= prm.echo_upper)
    e_fast = e_fast * arrived.to(torch.float32)

    z = e_at @ (e_fast @ w_rng)                              # [F, AC, S]
    if prm.sigma != 0.0:
        # sigma = 0 adds exactly zero; the draw is skipped (so is it in
        # the kernel).
        sn = float(prm.sigma * float(S) ** 0.5)
        gr, gi = standard_normals(seeds, AC, S)

        def conv(g):
            acc = None
            for off, cc in prm.noise_taps:
                term = cc * (g if off == 0 else torch.roll(g, off, dims=-1))
                acc = term if acc is None else acc + term
            return acc

        z = torch.complex(z.real + sn * conv(gr), z.imag + sn * conv(gi))
    if prm.dc_removal:
        z[..., 0] = 0.0
    zt = z.transpose(1, 2)
    zr = zt.real.contiguous()
    zi = zt.imag.contiguous()

    o = w_dop_t @ z.reshape(F, A, C, S)                      # [F, A, D, S]
    p = torch.sum(o.real * o.real + o.imag * o.imag, dim=1) * (1.0 / A)

    p1 = p + 1e-12
    pd = _log10_db(p1)
    thresh = _cfar_threshold(p1, prm)
    r = prm.neighborhood // 2
    is_peak = torch.ones_like(p1, dtype=torch.bool)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy or dx:
                is_peak &= p1 >= _shift2(p1, dy, dx)
    s_idx = torch.arange(S, device=p.device)
    gate = (s_idx >= prm.min_range_bin) & (s_idx <= prm.max_range_bin)
    mask = is_peak & (pd > thresh) & gate
    score = torch.where(mask, pd, _NEG)
    return zr, zi, p, score


def _check_inputs(ant, dopp, coarse, fine, tau, t, seeds, w_rng, w_dop_t,
                  prm: FrontendParams):
    F, Sc, A = ant.shape
    C = dopp.shape[-1]
    B = fine.shape[-1]
    Q = coarse.shape[-1]
    S = t.shape[0]
    shapes = {"ant": (ant, (F, Sc, A)), "dopp": (dopp, (F, Sc, C)),
              "coarse": (coarse, (F, Sc, Q)), "fine": (fine, (F, Sc, B)),
              "tau": (tau, (F, Sc)), "t": (t, (S,)), "seeds": (seeds, (F,)),
              "w_rng": (w_rng, (S, S)), "w_dop_t": (w_dop_t, (C, C))}
    dtypes = {"tau": torch.float32, "t": torch.float32,
              "seeds": torch.int32}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
        want = dtypes.get(name, torch.complex64)
        if x.dtype != want:
            raise TypeError(f"{name}: dtype {x.dtype} != {want}")
        if x.device != ant.device:
            raise ValueError(f"{name} is on {x.device}, ant on {ant.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if Q * B < S:
        raise ValueError(f"coarse/fine tables cover {Q * B} < S={S} samples")
    if len(prm.noise_taps) > _MAX_TAPS:
        raise ValueError(f"at most {_MAX_TAPS} noise taps")
    if prm.neighborhood % 2 != 1:
        raise ValueError("neighborhood must be odd")
    return F, Sc, A, C, B, Q, S


@functools.lru_cache(maxsize=None)
def _frontend_fn():
    lib = _build.load("frontend")
    fn = lib.radar_frontend_split
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([vp] * 14 + [ci] * 8 + [ci, cf, cf, ci, vp, vp, ci]
                   + [ci, ci, ci, cf, cf, ci, ci, vp])
    fn.restype = ci
    return fn


def _launch_cuda(ant, dopp, coarse, fine, tau, t, seeds, w_rng, w_dop_t,
                 prm: FrontendParams):
    F, Sc, A, C, B, Q, S = _check_inputs(ant, dopp, coarse, fine, tau, t,
                                         seeds, w_rng, w_dop_t, prm)
    if F > 65535:
        raise ValueError(f"F={F} frames exceeds the grid's z limit 65535")
    # csrc/frontend.cu: doppler_power_kernel stages 16 rows of Z and W_dop^T,
    # cfar_kernel the [C, S] map and its Doppler box sums.
    smem = max(4 * (2 * 16 * (A * C + 1) + 2 * C * C), 4 * 2 * C * S)
    if smem > _MAX_SMEM:
        raise ValueError(f"A={A}, C={C}, S={S} needs {smem} bytes of shared "
                         f"memory per block; the kernel has {_MAX_SMEM}")
    dev = ant.device
    ins = (ant, dopp, coarse, fine, tau, t, seeds, w_rng, w_dop_t)
    tbuf = torch.empty((F, Sc, S), dtype=torch.complex64, device=dev)
    zr = torch.empty((F, S, A * C), dtype=torch.float32, device=dev)
    zi = torch.empty_like(zr)
    p = torch.empty((F, C, S), dtype=torch.float32, device=dev)
    score = torch.empty_like(p)
    n_taps = len(prm.noise_taps)
    tap_off = (ctypes.c_int * _MAX_TAPS)(*[o for o, _ in prm.noise_taps])
    tap_coef = (ctypes.c_float * _MAX_TAPS)(*[c for _, c in prm.noise_taps])
    sn = (float(prm.sigma * float(S) ** 0.5)
          if prm.sigma != 0.0 else 0.0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _frontend_fn()(
        *[x.data_ptr() for x in ins],
        tbuf.data_ptr(), zr.data_ptr(), zi.data_ptr(), p.data_ptr(),
        score.data_ptr(),
        F, A, C, S, Sc, B, Q, dev.index,
        int(prm.echo_upper is not None),
        float(prm.echo_upper if prm.echo_upper is not None else 0.0),
        sn, n_taps, ctypes.cast(tap_off, ctypes.c_void_p),
        ctypes.cast(tap_coef, ctypes.c_void_p), int(prm.dc_removal),
        prm.train, prm.guard, prm.neighborhood, prm.offset_db,
        prm.threshold_db, prm.min_range_bin, prm.max_range_bin, stream)
    if err != 0:
        raise RuntimeError(f"frontend kernel failed: cudaError_t {err}")
    frontend_kernel_split.launches += 1
    return zr, zi, p, score


def frontend_kernel_split(ant, dopp, coarse, fine, tau, t, seeds, w_rng,
                          w_dop_t, prm: FrontendParams):
    """The one-pass kernel: same arguments and outputs as
    :func:`scatterer_frontend_split_reference`.  A CUDA tensor launches the
    hand-written kernel (``csrc/frontend.cu``) or raises; a CPU tensor runs
    the plain version, because there is no card to run the kernel on."""
    if ant.device.type == "cuda":
        return _launch_cuda(ant, dopp, coarse, fine, tau, t, seeds, w_rng,
                            w_dop_t, prm)
    if ant.device.type == "cpu":
        _check_inputs(ant, dopp, coarse, fine, tau, t, seeds, w_rng,
                      w_dop_t, prm)
        return scatterer_frontend_split_reference(
            ant, dopp, coarse, fine, tau, t, seeds, w_rng, w_dop_t, prm)
    raise ValueError(f"no front-end kernel for device {ant.device}")


frontend_kernel_split.launches = 0


def topk_exact(score: torch.Tensor, K: int):
    """Exact top-K over the last axis with ``lax.top_k``'s tie order (the
    smaller index first): a stable descending sort.  ``torch.topk``
    promises no tie order, and NMS downstream suppresses by slot order.
    Returns (values [..., K], int64 indices [..., K])."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def _finalize(zr, zi, p_ds, score_ds, K: int, A: int, C: int,
              doppler_window):
    """Tail on the kernel's outputs: exact top-K on the masked score map
    (flat index r*C + d) + signatures as exact Z-column contractions."""
    F, S = zr.shape[:2]
    p_lin = p_ds.transpose(-1, -2)                            # [F, R, D]
    score = score_ds.transpose(-1, -2).reshape(F, S * C)
    vals, idx = topk_exact(score, K)
    rb = idx // C
    db = idx % C
    valid = vals > _NEG * 0.1
    vals = torch.where(valid, vals, -math.inf)

    # signature[f, k, a] = sum_c w_dop[c, f(d_k)] * Z[f, r_k, a*C + c],
    # f(d) = (d - C//2) mod C: detection_signatures' math on gathered rows.
    g = rb[:, :, None].expand(F, K, zr.shape[-1])
    zcols = torch.complex(torch.gather(zr, 1, g), torch.gather(zi, 1, g))
    zcols = zcols.reshape(F, K, A, C)
    c_idx = torch.arange(C, dtype=torch.float32, device=zr.device)
    f_shift = torch.remainder(db - C // 2, C).to(torch.float32)  # [F, K]
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
    return (p_lin, rb.to(torch.int32), db.to(torch.int32), vals, sig)


def frontend_constants(C: int, S: int, mix: torch.Tensor, dc_removal: bool,
                       doppler_window):
    """Frame-independent kernel inputs: the mix-and-DC-folded range DFT
    [S, S] and the transposed Doppler DFT [C, C] (complex64)."""
    from radar_slam_tpu_torch.signal.rds import (doppler_dft_matrix,
                                                 range_dft_matrix)
    w_rng = range_dft_matrix(S, mix, dc_removal)
    w_dop_t = doppler_dft_matrix(C, doppler_window,
                                 device=mix.device).transpose(0, 1)
    return w_rng.contiguous(), w_dop_t.contiguous()


def scatterer_frontend_split(
        ant: torch.Tensor, dopp: torch.Tensor, coarse: torch.Tensor,
        fine: torch.Tensor, tau: torch.Tensor, t: torch.Tensor,
        seeds: torch.Tensor, mix: torch.Tensor, C: int, sigma: float,
        K: int, *, train: int, guard: int, neighborhood: int,
        offset_db: float, threshold_db: float, min_range_bin: int,
        max_range_bin: int, clutter: Optional[torch.Tensor] = None,
        dc_removal: bool = True, doppler_window: Optional[str] = None,
        noise_impl: str = "fast", topk_mode: str = "two_stage",
        noise_domain: str = "range_freq", noise_taps: tuple = (),
        echo_upper: Optional[float] = None, cfar_impl: str = "matmul"):
    """The one-pass front end over a frame batch (the reference wrapper's
    split-factor entry point, production knobs only).

    ``topk_mode`` "two_stage" and "sort" both select exactly (they are two
    TPU lowerings of the same answer).  The non-default branches of the
    reference kernel -- time-domain noise, Box-Muller, the prefix-sum CFAR
    and the clutter input -- are not ported yet and raise.

    Returns:
        (p_lin [F, R, D] f32, r_bin [F, K] i32, d_bin [F, K] i32,
         top_vals_db [F, K] f32 with -inf for exhausted slots,
         signatures [F, K, A] complex64 unit-power).
    """
    if noise_domain != "range_freq":
        raise NotImplementedError(
            f"noise_domain={noise_domain!r}: only 'range_freq' is ported "
            "(ROADMAP: K1' time-domain noise)")
    if not noise_taps:
        raise ValueError("noise_domain='range_freq' needs the window's "
                         "noise_taps (ops/windows.py:window_freq_taps)")
    if noise_impl != "fast":
        raise NotImplementedError(
            f"noise_impl={noise_impl!r}: only 'fast' is ported "
            "(ROADMAP: K1' box_muller)")
    if cfar_impl != "matmul":
        raise NotImplementedError(
            f"cfar_impl={cfar_impl!r}: only the box-sum CA-CFAR "
            "('matmul') is ported (ROADMAP: K1' cumsum)")
    if clutter is not None:
        raise NotImplementedError(
            "the clutter-map input is not ported (ROADMAP: K1' clutter)")
    if topk_mode not in ("two_stage", "sort"):
        raise ValueError(f"Unknown topk_mode: {topk_mode}")
    use_f32_matmuls()
    S = t.shape[0]
    A = ant.shape[-1]
    w_rng, w_dop_t = frontend_constants(C, S, mix, dc_removal,
                                        doppler_window)
    prm = FrontendParams(
        sigma=float(sigma), noise_taps=tuple(noise_taps),
        echo_upper=echo_upper, dc_removal=dc_removal, train=train,
        guard=guard, neighborhood=neighborhood, offset_db=offset_db,
        threshold_db=threshold_db, min_range_bin=min_range_bin,
        max_range_bin=max_range_bin)
    zr, zi, p_ds, score_ds = frontend_kernel_split(
        ant, dopp, coarse, fine, tau.to(torch.float32),
        t.to(torch.float32), seeds.to(torch.int32), w_rng, w_dop_t, prm)
    return _finalize(zr, zi, p_ds, score_ds, K, A, C, doppler_window)
