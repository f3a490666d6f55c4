"""One-pass front end: synthesis factors -> Z + power + CFAR score map ->
exact top-K + Z-column signatures.

Counterpart of ``radar_slam_tpu/ops/frontend_pallas.py`` for its two
kernels, K1 on split factors and K3 on dense factor planes, in every
branch of their shared body ``_frontend_body``.  Per frame the kernel body
computes Z [A*C, S] in one of two noise domains:

- ``noise_domain="range_freq"``:
      T = e_fast @ W_rng                      [Sc, S]   (range DFT, mix/DC folded)
      Z = e_at @ T + sigma sqrt(S) (g (*) taps), column 0 zeroed
  the noise drawn in the range-frequency domain and shaped by the PERIODIC
  window's taps while the signal keeps the symmetric window -- the
  reference's documented deviation, reproduced on purpose;
- ``noise_domain="time"`` (the reference wrappers' default):
      X = e_at @ e_fast + sigma n             [A*C, S]  (the ADC cube)
      Z = X @ W_rng
  with n drawn at element (a*C + c) * S + s, the index the three-dispatch
  kernels and ``synthesize_frame`` use, so one seed gives one cube;

then, in both,

    p[d, s] = mean_a |sum_c W_dop[c, d] Z[a*C + c, s]|^2          [C, S]
    score = 10 log10(p + 1e-12) where (3x3 local max & CA-CFAR & range
            gate & clutter gate), else -1e30

with, for K1, e_at[a*C + c, sc] = dopp[sc, c] * ant[sc, a] and e_fast
recomposed from the coarse / fine tables and the echo gate, and for K3
e_at = e_ac^T and e_fast as given.  The noise transform is "fast" or
"box_muller" (``ops/noise.py``); the CA-CFAR box sums run as clipped box
sums (``cfar_impl="matmul"``, the banded products' sums) or from log-shift
prefix sums (``"cumsum"``, the reference's add order); the optional clutter
map [F, R, D] gates cells at ``ln(max(c, 1e-12)) * 10 / ln 10 +
clutter_offset_db`` -- the kernel's form, not detect.py's ``10 log10``.

The kernels run the range DFT (W_rng = diag(mix) W, column 0 zeroed with
``dc_removal``) as the factored FFT of ``ops/range_dft.py``, so they take
the mix vector [S] where the plain versions take the dense matrix; the
plain versions keep ``signal/rds.py:range_dft_matrix``, the reference's
constant.

Three layers per kernel:

- :func:`frontend_kernel_split` (K1) / :func:`frontend_kernel_dense` (K3)
  -- the kernel wrappers.  On a CUDA tensor each launches its hand-written
  kernel of ``csrc/frontend.cu`` (or raises); on a CPU tensor it runs its
  plain version on ``range_dft_matrix(S, mix, dc_removal)``.  ``.launches``
  counts the CUDA launches and ``.branch_launches`` those that ran each
  non-default branch ("dense_range": an S with a prime factor above 5,
  whose range DFT has no factored plan; "cluster_rows": the time domain at
  C > 32, a cluster of blocks per antenna; "tiled_rows": the range
  frequency with more Z rows than a block holds, A*C > ~540).
- :func:`scatterer_frontend_split_reference` /
  :func:`scatterer_frontend_reference` -- the plain versions: the factor
  planes, then one shared body (:func:`_frontend_body_reference`), the
  oracle the kernels are held against on the card.
- :func:`scatterer_frontend_split` / :func:`scatterer_frontend` -- the
  public entry points, with the reference wrappers' signatures and
  defaults: constants, kernel, then :func:`_finalize`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as tfn

from radar_slam_tpu_torch.ops import _build, range_dft
from radar_slam_tpu_torch.ops.noise import standard_normals
from radar_slam_tpu_torch.ops.windows import get_window

_NEG = -1e30          # score sentinel; power_db >= -120 so -1e29 separates
_LOG10E_10 = 4.3429448190325176   # 10 / ln(10)
_MAX_TAPS = 5         # csrc/frontend.cu: MAX_TAPS (a 3-term cosine window)
_MAX_SMEM = 232448    # shared memory one block may use on Hopper (bytes)
# csrc/cube_onchip.cuh: the cube rows a block holds, the blocks of a
# cluster (one antenna of one frame), its ring (float2: two stages of
# OC_KC x (OC_LDA + 1 + OC_LDB)).
_OC_ROWS, _OC_MAX_CLUSTER, _OC_RING = 32, 8, 2 * 32 * (36 + 1 + 132)


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
    noise_domain: str            # "range_freq" or "time"
    noise_impl: str              # "fast" or "box_muller"
    cfar_impl: str               # "matmul" (box sums) or "cumsum"
    clutter_offset_db: float     # clutter-map gate margin [dB]


_DOMAINS = {"range_freq": 0, "time": 1}    # csrc/frontend.cu: DOMAIN_*
_IMPLS = {"fast": 0, "box_muller": 1}      # csrc/frontend.cu: IMPL_*
_CFARS = {"matmul": 0, "cumsum": 1}        # csrc/frontend.cu: CFAR_*
_BRANCHES = ("time", "box_muller", "cumsum", "clutter", "dense_range",
             "cluster_rows", "tiled_rows")


def _branches(prm: FrontendParams, clutter, S: Optional[int] = None,
              route: Optional[str] = None) -> Tuple[str, ...]:
    """The non-default branches a launch with ``prm`` (and, where given,
    S samples per chirp and the shape route of :func:`_check_launch`)
    runs (K1')."""
    on = {"time": prm.noise_domain == "time",
          "box_muller": prm.noise_impl == "box_muller",
          "cumsum": prm.cfar_impl == "cumsum",
          "clutter": clutter is not None,
          "dense_range": S is not None and range_dft.plan(S) is None,
          "cluster_rows": route == "cluster_rows",
          "tiled_rows": route == "tiled_rows"}
    return tuple(b for b in _BRANCHES if on[b])


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


def _cumsum_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim`` (-2 or -1) of a [..., C, S] map
    by log-shift adds of zero-filled shifts: the reference's add order
    (frontend_pallas.py:93-101), so the sums round as its do."""
    n = x.shape[dim]
    sh = 1
    while sh < n:
        x = x + (_shift2(x, sh, 0) if dim == -2 else _shift2(x, 0, sh))
        sh *= 2
    return x


def _box_from_cumsum(cs: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    """Clipped width-(2 pad + 1) box sum from an inclusive prefix sum:
    cs[min(i + pad, n - 1)] - cs[i - pad - 1] (0 before the start)."""
    n = cs.shape[dim]
    i = torch.arange(n, device=cs.device)
    if dim == -2:
        hi, last, lo = (_shift2(cs, -pad, 0), cs[..., n - 1:n, :],
                        _shift2(cs, pad + 1, 0))
        i = i[:, None]
    else:
        hi, last, lo = (_shift2(cs, 0, -pad), cs[..., n - 1:n],
                        _shift2(cs, 0, pad + 1))
    hi = torch.where(i + pad > n - 1, last, hi)
    return hi - lo


def _cfar_threshold_cumsum(p1: torch.Tensor,
                           prm: FrontendParams) -> torch.Tensor:
    """CA-CFAR threshold map [..., C, S] in dB from separable prefix-sum
    differences (frontend_pallas.py:118-149): the same clipped box means as
    :func:`_cfar_threshold`, summed in the reference's order."""
    if prm.train <= 0:
        return torch.full_like(p1, prm.threshold_db)
    C, S = p1.shape[-2:]
    dev = p1.device
    tpad = prm.train + prm.guard
    cs_d = _cumsum_axis(p1, -2)
    sum_d = _box_from_cumsum(cs_d, -2, tpad)
    sum_t = _box_from_cumsum(_cumsum_axis(sum_d, -1), -1, tpad)
    noise = sum_t / (_window_counts(C, tpad, dev)[:, None]
                     * _window_counts(S, tpad, dev)[None, :])
    if prm.guard > 0:
        gpad = prm.guard
        sum_dg = _box_from_cumsum(cs_d, -2, gpad)
        g = (_box_from_cumsum(_cumsum_axis(sum_dg, -1), -1, gpad)
             / (_window_counts(C, gpad, dev)[:, None]
                * _window_counts(S, gpad, dev)[None, :]))
        n_train = float((2 * tpad + 1) ** 2)
        n_guard = float((2 * gpad + 1) ** 2)
        noise = (noise * n_train - g * n_guard) / (n_train - n_guard)
    noise_db = _log10_db(torch.clamp(noise, min=1e-12))
    return torch.clamp(noise_db + prm.offset_db, min=prm.threshold_db)


def _frontend_body_reference(e_at: torch.Tensor, e_fast: torch.Tensor,
                             seeds: torch.Tensor, w_rng: torch.Tensor,
                             w_dop_t: torch.Tensor, prm: FrontendParams,
                             A: int, clutter: Optional[torch.Tensor] = None):
    """The kernel body shared by K1 and K3 in plain PyTorch, from the factor
    planes e_at [F, A*C, Sc] and e_fast [F, Sc, S] on; ``clutter`` is the
    optional background map in the kernel's layout [F, C, S].  Returns
    (zr, zi, p, score) as the kernels do."""
    F, AC, _ = e_at.shape
    S = e_fast.shape[-1]
    C = AC // A
    if prm.noise_domain == "time":
        x = e_at @ e_fast                                    # [F, AC, S]
        if prm.sigma != 0.0:
            # sigma = 0 adds exactly zero; the draw is skipped (so is it
            # in the kernel).
            gr, gi = standard_normals(seeds, AC, S, prm.noise_impl)
            x = torch.complex(x.real + prm.sigma * gr,
                              x.imag + prm.sigma * gi)
        z = x @ w_rng
    else:
        z = e_at @ (e_fast @ w_rng)                          # [F, AC, S]
        if prm.sigma != 0.0:
            sn = float(prm.sigma * float(S) ** 0.5)
            gr, gi = standard_normals(seeds, AC, S, prm.noise_impl)

            def conv(g):
                acc = None
                for off, cc in prm.noise_taps:
                    term = cc * (g if off == 0 else torch.roll(g, off,
                                                               dims=-1))
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
    thresh = (_cfar_threshold_cumsum(p1, prm) if prm.cfar_impl == "cumsum"
              else _cfar_threshold(p1, prm))
    r = prm.neighborhood // 2
    is_peak = torch.ones_like(p1, dtype=torch.bool)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy or dx:
                is_peak &= p1 >= _shift2(p1, dy, dx)
    s_idx = torch.arange(S, device=p.device)
    gate = (s_idx >= prm.min_range_bin) & (s_idx <= prm.max_range_bin)
    mask = is_peak & (pd > thresh) & gate
    if clutter is not None:
        cd = _log10_db(torch.clamp(clutter, min=1e-12))
        mask = mask & (pd > cd + prm.clutter_offset_db)
    score = torch.where(mask, pd, _NEG)
    return zr, zi, p, score


def scatterer_frontend_split_reference(
        ant: torch.Tensor, dopp: torch.Tensor, coarse: torch.Tensor,
        fine: torch.Tensor, tau: torch.Tensor, t: torch.Tensor,
        seeds: torch.Tensor, w_rng: torch.Tensor, w_dop_t: torch.Tensor,
        prm: FrontendParams, clutter: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 in plain PyTorch: the split tables recomposed into the factor
    planes, then the shared body.

    Args:
        ant / dopp / coarse / fine: [F, Sc, A|C|Q|B] complex64 split factors.
        tau: [F, Sc] float32 round-trip delays; t: [S] fast-time base.
        seeds: [F] int32 per-frame noise seeds.
        w_rng: [S, S] complex64 folded range DFT; w_dop_t: [C, C] complex64
            transposed Doppler DFT (fftshift in its row order).
        clutter: optional [F, C, S] float32 background power map (the
            kernel's layout: Doppler rows, range columns).

    Returns:
        (zr, zi [F, S, A*C] float32 -- Z transposed, row a*C + c;
         p [F, C, S] float32 Doppler power; score [F, C, S] float32).
    """
    F, Sc, A = ant.shape
    C = dopp.shape[-1]
    B = fine.shape[-1]
    Q = coarse.shape[-1]
    S = t.shape[0]

    e_at = (dopp.transpose(1, 2)[:, None, :, :]
            * ant.transpose(1, 2)[:, :, None, :]).reshape(F, A * C, Sc)
    e_fast = (coarse[..., :, None] * fine[..., None, :]).reshape(
        F, Sc, Q * B)[..., :S]
    arrived = t[None, None, :] >= tau[..., None]
    if prm.echo_upper is not None:
        arrived = arrived & (t[None, None, :] - tau[..., None]
                             <= prm.echo_upper)
    e_fast = e_fast * arrived.to(torch.float32)
    return _frontend_body_reference(e_at, e_fast, seeds, w_rng, w_dop_t,
                                    prm, A, clutter)


def scatterer_frontend_reference(
        e_ac: torch.Tensor, e_fast: torch.Tensor, seeds: torch.Tensor,
        w_rng: torch.Tensor, w_dop_t: torch.Tensor, prm: FrontendParams,
        C: int, clutter: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 in plain PyTorch: the dense planes e_ac [F, Sc, A*C] (row
    a*C + c) and e_fast [F, Sc, S] (echo-gated) into the shared body.
    Returns what :func:`scatterer_frontend_split_reference` returns."""
    return _frontend_body_reference(e_ac.transpose(1, 2), e_fast, seeds,
                                    w_rng, w_dop_t, prm,
                                    e_ac.shape[-1] // C, clutter)


def _check_clutter(clutter, F: int, C: int, S: int, dev) -> None:
    if clutter is not None:
        _build.check_input("clutter", clutter, torch.float32, dev, (F, C, S))


def _check_inputs(ant, dopp, coarse, fine, tau, t, seeds, mix, w_dop_t,
                  prm: FrontendParams, clutter=None):
    F, Sc, A = ant.shape
    C = dopp.shape[-1]
    B = fine.shape[-1]
    Q = coarse.shape[-1]
    S = t.shape[0]
    shapes = {"ant": (ant, (F, Sc, A)), "dopp": (dopp, (F, Sc, C)),
              "coarse": (coarse, (F, Sc, Q)), "fine": (fine, (F, Sc, B)),
              "tau": (tau, (F, Sc)), "t": (t, (S,)), "seeds": (seeds, (F,)),
              "mix": (mix, (S,)), "w_dop_t": (w_dop_t, (C, C))}
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
    _check_clutter(clutter, F, C, S, ant.device)
    _check_params(prm)
    return F, Sc, A, C, B, Q, S


def _scratch(F: int, A: int, C: int, S: int, Sc: int, prm: FrontendParams,
             dev):
    """The kernel's scratch: T [F, Sc, S] complex in the range-frequency
    domain; the per-antenna power planes [F, A, C, S] in the time domain,
    where the cube and Z never leave the chip."""
    if prm.noise_domain == "time":
        return torch.empty((F, A, C, S), dtype=torch.float32, device=dev)
    return torch.empty((F, Sc, S), dtype=torch.complex64, device=dev)


def _outputs(F: int, A: int, C: int, S: int, dev):
    """zr, zi [F, S, A*C] and p, score [F, C, S]."""
    zr = torch.empty((F, S, A * C), dtype=torch.float32, device=dev)
    zi = torch.empty_like(zr)
    p = torch.empty((F, C, S), dtype=torch.float32, device=dev)
    return zr, zi, p, torch.empty_like(p)


def _count(wrapper, prm: FrontendParams, clutter, S: int,
           route: str) -> None:
    wrapper.launches += 1
    for b in _branches(prm, clutter, S, route):
        wrapper.branch_launches[b] += 1


def range_fft_args(S: int, dev):
    """(twiddle table, input positions, number of stages, radices) of the
    range DFT for the C launchers (``ops/range_dft.py``)."""
    nst, radices = range_dft.stage_args(S)
    radix = (ctypes.c_int * range_dft.MAX_STAGES)(*radices)
    return (range_dft.twiddles(S, dev), range_dft.input_positions(S, dev),
            nst, ctypes.cast(radix, ctypes.c_void_p))


def _launch_cuda(ant, dopp, coarse, fine, tau, t, seeds, mix, w_dop_t,
                 prm: FrontendParams, clutter):
    F, Sc, A, C, B, Q, S = _check_inputs(ant, dopp, coarse, fine, tau, t,
                                         seeds, mix, w_dop_t, prm, clutter)
    route = _check_launch(F, A, C, S, prm)
    dev = ant.device
    tw, pos, nst, radix = range_fft_args(S, dev)
    ins = (ant, dopp, coarse, fine, tau, t, seeds, mix, tw, pos)
    scratch = _scratch(F, A, C, S, Sc, prm, dev)
    # The time domain composes e_fast [F, Sc, S] once per frame.
    efast = (torch.empty((F, Sc, S), dtype=torch.complex64, device=dev)
             if prm.noise_domain == "time" else None)
    outs = _outputs(F, A, C, S, dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind("frontend", "radar_frontend_split",
                     (vp,) * 10 + (ci, vp) + (vp,) * 8 + (ci,) * 8
                     + (ci, cf, cf, ci, vp, vp) + (ci,) * 4
                     + (cf, cf, ci, ci) + (ci,) * 3 + (cf, vp))
    _build.launch(fn, *[x.data_ptr() for x in ins], nst, radix,
                  w_dop_t.data_ptr(), scratch.data_ptr(),
                  efast.data_ptr() if efast is not None else None,
                  *[x.data_ptr() for x in outs],
                  clutter.data_ptr() if clutter is not None else None,
                  F, A, C, S, Sc, B, Q, dev.index,
                  int(prm.echo_upper is not None),
                  float(prm.echo_upper if prm.echo_upper is not None
                        else 0.0),
                  *_noise_args(prm, S), *_cfar_args(prm),
                  *_branch_args(prm),
                  torch.cuda.current_stream(dev).cuda_stream)
    _count(frontend_kernel_split, prm, clutter, S, route)
    return outs


def frontend_kernel_split(ant, dopp, coarse, fine, tau, t, seeds, mix,
                          w_dop_t, prm: FrontendParams, clutter=None):
    """The one-pass kernel: the arguments of
    :func:`scatterer_frontend_split_reference` with the mix vector [S] in
    place of the dense range DFT, and its outputs.  A CUDA tensor launches
    the hand-written kernel (``csrc/frontend.cu``) or raises; a CPU tensor
    runs the plain version on ``range_dft_matrix(S, mix, dc_removal)``,
    because there is no card to run the kernel on."""
    if ant.device.type == "cuda":
        return _launch_cuda(ant, dopp, coarse, fine, tau, t, seeds, mix,
                            w_dop_t, prm, clutter)
    if ant.device.type == "cpu":
        _check_inputs(ant, dopp, coarse, fine, tau, t, seeds, mix, w_dop_t,
                      prm, clutter)
        return scatterer_frontend_split_reference(
            ant, dopp, coarse, fine, tau, t, seeds,
            _range_matrix(t.shape[0], mix, prm), w_dop_t, prm, clutter)
    raise ValueError(f"no front-end kernel for device {ant.device}")


frontend_kernel_split.launches = 0
frontend_kernel_split.branch_launches = dict.fromkeys(_BRANCHES, 0)


def _range_matrix(S: int, mix: torch.Tensor, prm: FrontendParams):
    from radar_slam_tpu_torch.signal.rds import range_dft_matrix
    return range_dft_matrix(S, mix, prm.dc_removal).contiguous()


def _check_params(prm: FrontendParams) -> None:
    """Every knob value the reference's kernel takes is ported; an unknown
    name raises ``ValueError``."""
    for name, table in (("noise_domain", _DOMAINS),
                        ("noise_impl", _IMPLS), ("cfar_impl", _CFARS)):
        if getattr(prm, name) not in table:
            raise ValueError(f"Unknown {name}: {getattr(prm, name)}")
    if prm.noise_domain == "range_freq" and not prm.noise_taps:
        raise ValueError("noise_domain='range_freq' needs the window's "
                         "noise_taps (ops/windows.py:window_freq_taps)")
    if len(prm.noise_taps) > _MAX_TAPS:
        raise ValueError(f"at most {_MAX_TAPS} noise taps")
    if prm.neighborhood % 2 != 1:
        raise ValueError("neighborhood must be odd")


def frag_pitch(n: int) -> int:
    """csrc/tf32x3.cuh: the smallest pitch >= n that is 4 mod 16."""
    return n + (20 - n % 16) % 16


def _z_r0(split: bool, A: int, C: int) -> int:
    """csrc/frontend.cu: zk_r0 (float2), the ring / noise / W_dop^T
    region."""
    stage = (32 * (frag_pitch(C) + frag_pitch(A) + 36) if split
             else 16 * (260 + 36))
    return max(2 * stage, 256 * 36,
               -(-C // 16) * 16 * frag_pitch(-(-C // 8) * 8))


def _z_power_smem(split: bool, A: int, C: int,
                  ag: Optional[int] = None) -> int:
    """csrc/frontend.cu: zk_smem_bytes, the Z rows of ``ag`` antennas
    (all A by default)."""
    ag = A if ag is None else ag
    return 8 * (_z_r0(split, A, C) + (ag * C + 8) * 36)


def z_power_groups(split: bool, A: int, C: int) -> int:
    """csrc/frontend.cu: zk_group_antennas -- the antennas whose Z rows
    ``z_power_kernel`` holds at once: A, or the most that fit (the tiled
    route); 0 where not even one antenna's rows fit."""
    if _z_power_smem(split, A, C) <= _MAX_SMEM:
        return A
    room = _MAX_SMEM // 8 - _z_r0(split, A, C)
    return max(0, min(A, (room // 36 - 8) // C))


def _check_launch(F: int, A: int, C: int, S: int, prm: FrontendParams,
                  split: bool = True) -> str:
    """Raise, with the reason, for shapes the kernel does not take; else
    return the shape route it takes: in the time domain that of
    :func:`cube_onchip_limits`, in the range-frequency domain "all_rows"
    (one block holds all A*C rows of Z for its 32 range bins) or
    "tiled_rows" (groups of antennas, the power carried across them in
    antenna order)."""
    if not 0 < F <= 65535:
        raise ValueError(f"F={F} frames: the kernel takes 1..65535")
    # The CFAR holds the [C, S] map and its Doppler box sums (two planes)
    # or two scan planes (three).
    planes = 3 if prm.cfar_impl == "cumsum" else 2
    need = {"the CFAR": 4 * planes * C * S}
    if prm.noise_domain == "time":
        route = cube_onchip_limits(C, S)
    else:
        dense = range_dft.plan(S) is None
        need["range_fft_kernel"] = 8 * (8 * S + S + (8 * S if dense else 0)) \
            + 4 * S
        ag = z_power_groups(split, A, C)
        if ag == 0:
            need["z_power_kernel"] = _z_power_smem(split, A, C, 1)
        route = "all_rows" if ag == A else "tiled_rows"
    for what, smem in need.items():
        if smem > _MAX_SMEM:
            raise ValueError(f"A={A}, C={C}, S={S}: {what} needs {smem} "
                             f"bytes of shared memory per block; a block "
                             f"has {_MAX_SMEM}")
    return route


def cube_onchip_limits(C: int, S: int) -> str:
    """Raise, with the reason, where the on-chip cube kernel of
    ``csrc/cube_onchip.cuh`` (K1' and K3 in the time domain, K4, K5, K7)
    cannot hold one antenna's cube rows on chip; else return its route:
    "one_block" (C <= 32: one block per antenna and frame) or
    "cluster_rows" (a cluster of ceil(C / 32) blocks, 32 chirp rows each,
    the Doppler stage reading the others' rows through distributed shared
    memory)."""
    if not 0 < C <= _OC_ROWS * _OC_MAX_CLUSTER:
        raise ValueError(f"C={C} chirps: the on-chip kernel holds an "
                         f"antenna's rows in a cluster of at most "
                         f"{_OC_MAX_CLUSTER} blocks of {_OC_ROWS} chirps, "
                         f"C <= {_OC_ROWS * _OC_MAX_CLUSTER}")
    ldx = frag_pitch(-(-S // 8) * 8)
    smem = 8 * (_OC_ROWS * ldx + _OC_RING + S) + 4 * S
    if smem > _MAX_SMEM:
        raise ValueError(f"S={S}: the on-chip kernel needs {smem} bytes "
                         f"of shared memory per block; a block has "
                         f"{_MAX_SMEM}")
    return "one_block" if C <= _OC_ROWS else "cluster_rows"


def count_onchip(wrapper, S: int, route: str) -> None:
    """Count one launch of the on-chip cube kernel by K4, K5 or K7's
    wrapper, and its non-default routes ("dense_range": S has no factored
    plan; "cluster_rows": C > 32)."""
    wrapper.launches += 1
    if range_dft.plan(S) is None:
        wrapper.branch_launches["dense_range"] += 1
    if route == "cluster_rows":
        wrapper.branch_launches["cluster_rows"] += 1


def _check_dense_inputs(e_ac, e_fast, seeds, mix, w_dop_t, C: int,
                        prm: FrontendParams, clutter=None):
    if e_ac.dim() != 3 or e_fast.dim() != 3:
        raise ValueError(f"e_ac / e_fast: need [F, Sc, A*C] / [F, Sc, S], "
                         f"got {tuple(e_ac.shape)} / {tuple(e_fast.shape)}")
    F, Sc, AC = e_ac.shape
    S = e_fast.shape[-1]
    if AC % C:
        raise ValueError(f"e_ac: A*C = {AC} is not a multiple of C = {C}")
    dev = e_ac.device
    for name, x, dtype, shape in (
            ("e_ac", e_ac, torch.complex64, (F, Sc, AC)),
            ("e_fast", e_fast, torch.complex64, (F, Sc, S)),
            ("seeds", seeds, torch.int32, (F,)),
            ("mix", mix, torch.complex64, (S,)),
            ("w_dop_t", w_dop_t, torch.complex64, (C, C))):
        _build.check_input(name, x, dtype, dev, shape)
    _check_clutter(clutter, F, C, S, dev)
    _check_params(prm)
    return F, Sc, AC // C, S


def _noise_args(prm: FrontendParams, S: int):
    """(noise scale, n_taps, tap offsets, tap coefficients) for the C
    launchers: sigma sqrt(S) on the range-frequency taps, sigma itself in
    the time domain."""
    taps = prm.noise_taps if prm.noise_domain == "range_freq" else ()
    tap_off = (ctypes.c_int * _MAX_TAPS)(*[o for o, _ in taps])
    tap_coef = (ctypes.c_float * _MAX_TAPS)(*[c for _, c in taps])
    if prm.sigma == 0.0:
        sn = 0.0
    elif prm.noise_domain == "time":
        sn = float(prm.sigma)
    else:
        sn = float(prm.sigma * float(S) ** 0.5)
    return (sn, len(taps), ctypes.cast(tap_off, ctypes.c_void_p),
            ctypes.cast(tap_coef, ctypes.c_void_p))


def _cfar_args(prm: FrontendParams):
    return (int(prm.dc_removal), prm.train, prm.guard, prm.neighborhood,
            prm.offset_db, prm.threshold_db, prm.min_range_bin,
            prm.max_range_bin)


def _branch_args(prm: FrontendParams):
    return (_DOMAINS[prm.noise_domain], _IMPLS[prm.noise_impl],
            _CFARS[prm.cfar_impl], float(prm.clutter_offset_db))


def frontend_kernel_dense(e_ac, e_fast, seeds, mix, w_dop_t,
                          prm: FrontendParams, C: int, clutter=None):
    """K3, the one-pass kernel on dense factor planes: the arguments of
    :func:`scatterer_frontend_reference` with the mix vector [S] in place
    of the dense range DFT, and its outputs.  A CUDA tensor launches the
    hand-written kernel (``csrc/frontend.cu``, ``radar_frontend_dense``)
    or raises; a CPU tensor runs the plain version, because there is no
    card to run the kernel on."""
    F, Sc, A, S = _check_dense_inputs(e_ac, e_fast, seeds, mix, w_dop_t,
                                      C, prm, clutter)
    dev = e_ac.device
    if dev.type == "cpu":
        return scatterer_frontend_reference(e_ac, e_fast, seeds,
                                            _range_matrix(S, mix, prm),
                                            w_dop_t, prm, C, clutter)
    if dev.type != "cuda":
        raise ValueError(f"no front-end kernel for device {dev}")
    route = _check_launch(F, A, C, S, prm, split=False)
    tw, pos, nst, radix = range_fft_args(S, dev)
    outs = (_scratch(F, A, C, S, Sc, prm, dev), *_outputs(F, A, C, S, dev))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind("frontend", "radar_frontend_dense",
                     (vp,) * 6 + (ci, vp) + (vp,) * 7 + (ci,) * 6
                     + (cf, ci, vp, vp) + (ci,) * 4 + (cf, cf, ci, ci)
                     + (ci,) * 3 + (cf, vp))
    _build.launch(fn, e_ac.data_ptr(), e_fast.data_ptr(), seeds.data_ptr(),
                  mix.data_ptr(), tw.data_ptr(), pos.data_ptr(), nst, radix,
                  w_dop_t.data_ptr(), *[x.data_ptr() for x in outs],
                  clutter.data_ptr() if clutter is not None else None,
                  F, A, C, S, Sc, dev.index,
                  *_noise_args(prm, S), *_cfar_args(prm),
                  *_branch_args(prm),
                  torch.cuda.current_stream(dev).cuda_stream)
    _count(frontend_kernel_dense, prm, clutter, S, route)
    return outs[1:]


frontend_kernel_dense.launches = 0
frontend_kernel_dense.branch_launches = dict.fromkeys(_BRANCHES, 0)


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


def doppler_constant(C: int, doppler_window, device) -> torch.Tensor:
    """The transposed Doppler DFT [C, C] complex64 the kernels take (the
    range DFT is theirs: they take the mix vector); built once per (C,
    window, device) and shared, read-only, by every call."""
    return _doppler_constant(C, doppler_window, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _doppler_constant(C: int, doppler_window, device: str) -> torch.Tensor:
    from radar_slam_tpu_torch.signal.rds import doppler_dft_matrix
    return doppler_dft_matrix(C, doppler_window,
                              device=device).transpose(0, 1).contiguous()


def _check_topk(topk_mode: str) -> None:
    if topk_mode not in ("two_stage", "sort"):
        raise ValueError(f"Unknown topk_mode: {topk_mode}")


def _params(sigma, noise_taps, echo_upper, dc_removal, train, guard,
            neighborhood, offset_db, threshold_db, min_range_bin,
            max_range_bin, noise_domain, noise_impl, cfar_impl,
            clutter_offset_db) -> FrontendParams:
    return FrontendParams(
        sigma=float(sigma), noise_taps=tuple(noise_taps),
        echo_upper=echo_upper, dc_removal=dc_removal, train=train,
        guard=guard, neighborhood=neighborhood, offset_db=offset_db,
        threshold_db=threshold_db, min_range_bin=min_range_bin,
        max_range_bin=max_range_bin, noise_domain=noise_domain,
        noise_impl=noise_impl, cfar_impl=cfar_impl,
        clutter_offset_db=float(clutter_offset_db))


def _clutter_ds(clutter: Optional[torch.Tensor], F: int, S: int, C: int):
    """The clutter map [F, R, D] in the kernel's layout [F, D, R]."""
    if clutter is None:
        return None
    if tuple(clutter.shape) != (F, S, C):
        raise ValueError(f"clutter: need [F, R, D] = {(F, S, C)}, got "
                         f"{tuple(clutter.shape)}")
    return clutter.to(torch.float32).transpose(1, 2).contiguous()


def scatterer_frontend_split(
        ant: torch.Tensor, dopp: torch.Tensor, coarse: torch.Tensor,
        fine: torch.Tensor, tau: torch.Tensor, t: torch.Tensor,
        seeds: torch.Tensor, mix: torch.Tensor, C: int, sigma: float,
        K: int, *, train: int, guard: int, neighborhood: int,
        offset_db: float, threshold_db: float, min_range_bin: int,
        max_range_bin: int, clutter: Optional[torch.Tensor] = None,
        clutter_offset_db: float = 6.0, dc_removal: bool = True,
        doppler_window: Optional[str] = None, synth_precision: str = "high",
        doppler_precision: str = "high", doppler_layout: str = "loop",
        sig_precision: str = "high", noise_impl: str = "box_muller",
        topk_mode: str = "sort", noise_domain: str = "time",
        noise_taps: tuple = (), echo_upper: Optional[float] = None,
        cfar_impl: str = "matmul"):
    """The one-pass front end over a frame batch on split synthesis factors
    (the reference wrapper's signature and defaults; kernel K1).

    ``clutter`` is the optional background power map [F, R, D]: a cell
    must exceed it by ``clutter_offset_db``.  ``topk_mode`` "two_stage" and
    "sort" both select exactly (two TPU lowerings of the same answer); the
    precision and layout names are accepted and select nothing (float32
    throughout).

    Returns:
        (p_lin [F, R, D] f32, r_bin [F, K] i32, d_bin [F, K] i32,
         top_vals_db [F, K] f32 with -inf for exhausted slots,
         signatures [F, K, A] complex64 unit-power).
    """
    from radar_slam_tpu_torch.signal.rds import _check_precision
    _check_topk(topk_mode)
    _check_precision(synth_precision, doppler_precision, sig_precision)
    if doppler_layout not in ("loop", "wide"):
        raise ValueError(f"Unknown doppler_layout: {doppler_layout}")
    use_f32_matmuls()
    F, _, A = ant.shape
    S = t.shape[0]
    w_dop_t = doppler_constant(C, doppler_window, mix.device)
    prm = _params(sigma, noise_taps, echo_upper, dc_removal, train, guard,
                  neighborhood, offset_db, threshold_db, min_range_bin,
                  max_range_bin, noise_domain, noise_impl, cfar_impl,
                  clutter_offset_db)
    zr, zi, p_ds, score_ds = frontend_kernel_split(
        ant, dopp, coarse, fine, tau.to(torch.float32),
        t.to(torch.float32), seeds.to(torch.int32),
        mix.to(torch.complex64).contiguous(), w_dop_t, prm,
        _clutter_ds(clutter, F, S, C))
    return _finalize(zr, zi, p_ds, score_ds, K, A, C, doppler_window)


def scatterer_frontend(
        e_ac: torch.Tensor, e_fast: torch.Tensor, seeds: torch.Tensor,
        mix: torch.Tensor, C: int, sigma: float, K: int, *, train: int,
        guard: int, neighborhood: int, offset_db: float, threshold_db: float,
        min_range_bin: int, max_range_bin: int,
        clutter: Optional[torch.Tensor] = None,
        clutter_offset_db: float = 6.0, dc_removal: bool = True,
        doppler_window: Optional[str] = None, synth_precision: str = "high",
        precision_name: str = "default", doppler_precision: str = "high",
        doppler_layout: str = "loop", sig_precision: str = "high",
        noise_impl: str = "box_muller", topk_mode: str = "sort",
        noise_domain: str = "time", noise_taps: tuple = (),
        cfar_impl: str = "matmul"):
    """The one-pass front end on dense factor planes (the reference's
    ``scatterer_frontend``; kernel K3): e_ac [F, Sc, A*C] / e_fast
    [F, Sc, S] complex64 (``signal/synth.py:synthesis_factors``).  Same
    knobs, defaults and returns as :func:`scatterer_frontend_split`."""
    from radar_slam_tpu_torch.signal.rds import _check_precision
    _check_topk(topk_mode)
    _check_precision(synth_precision, precision_name, doppler_precision,
                     sig_precision)
    if doppler_layout not in ("loop", "wide"):
        raise ValueError(f"Unknown doppler_layout: {doppler_layout}")
    use_f32_matmuls()
    F = e_ac.shape[0]
    S = e_fast.shape[-1]
    A = e_ac.shape[-1] // C
    w_dop_t = doppler_constant(C, doppler_window, mix.device)
    prm = _params(sigma, noise_taps, None, dc_removal, train, guard,
                  neighborhood, offset_db, threshold_db, min_range_bin,
                  max_range_bin, noise_domain, noise_impl, cfar_impl,
                  clutter_offset_db)
    zr, zi, p_ds, score_ds = frontend_kernel_dense(
        e_ac, e_fast, seeds.to(torch.int32),
        mix.to(torch.complex64).contiguous(), w_dop_t, prm, C,
        _clutter_ds(clutter, F, S, C))
    return _finalize(zr, zi, p_ds, score_ds, K, A, C, doppler_window)
