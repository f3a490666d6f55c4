"""Scatterers -> power map / signatures, and the noise planes: the
three-dispatch front end.

Counterpart of ``radar_slam_tpu/ops/synthpower_pallas.py`` (K4, K5, K6).
The signal model is the rank-1 separable one of
``signal/synth.py:synthesis_factors``:

    X = e_ac^T @ e_fast + sigma (n_re + j n_im)      [F, A*C, S]

with e_ac [F, Sc, A*C] (row a*C + c), e_fast [F, Sc, S] and the two
standard-normal planes of ``ops/noise.py:standard_normals`` for the frame
seeds (element (a*C + c) * S + s, as ``synthesize_frame`` draws it), so one
generator state gives the three-dispatch path and the materialized path
the same noisy cube.

- :func:`noise_cube` (K6) -- the noise planes [F, rows, cols] complex64.
- :func:`scatterer_power` (K4) -- X, then the range product, Doppler DFT,
  |.|^2 and antenna mean -> power map [F, R, D] (detection layout).
- :func:`scatterer_signatures` (K5) -- the same X contracted with the
  detected cells' DFT columns -> unit-power signatures [F, K, A].

Each wrapper launches its hand-written kernel of ``csrc/synthpower.cu`` on
a CUDA tensor (or raises) and runs its plain version
(``*_reference``: the cube materialized, then K7's plain power form or
``detection_signatures``' column math) on a CPU tensor; ``.launches``
counts the CUDA launches.  The precision and layout names of the reference
(``synth_precision``, ``precision_name``, ``doppler_precision``,
``doppler_layout``, ``sig_precision``) are accepted and select nothing:
the port computes in float32 (ROADMAP, Port conventions).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from radar_slam_tpu_torch.ops import _build
from radar_slam_tpu_torch.ops.frontend import frontend_constants
from radar_slam_tpu_torch.ops.noise import standard_normals
from radar_slam_tpu_torch.ops.power import rds_power_reference
from radar_slam_tpu_torch.signal.rds import (_check_precision,
                                             signature_columns,
                                             signatures_from_columns,
                                             unit_power)

_IMPLS = {"fast": 0, "box_muller": 1}    # csrc/synthpower.cu: IMPL_*
_LAYOUTS = ("loop", "wide")
_MAX_SMEM = 232448    # shared memory one block may use on Hopper (bytes)
_PS = 32              # csrc/synthpower.cu: range bins per Doppler block


def _check_names(noise_impl: str, *precisions: str,
                 doppler_layout: str = "loop") -> None:
    if noise_impl not in _IMPLS:
        raise ValueError(f"Unknown noise impl: {noise_impl}")
    if doppler_layout not in _LAYOUTS:
        raise ValueError(f"Unknown doppler_layout: {doppler_layout}")
    _check_precision(*precisions)


def noise_cube_reference(seeds: torch.Tensor, rows: int, cols: int,
                         noise_impl: str = "box_muller") -> torch.Tensor:
    """The noise planes [F, rows, cols] complex64 in plain PyTorch."""
    gr, gi = standard_normals(seeds, rows, cols, noise_impl)
    return torch.complex(gr, gi)


def noise_cube(seeds: torch.Tensor, rows: int, cols: int,
               noise_impl: str = "box_muller") -> torch.Tensor:
    """The exact noise realization [F, rows, cols] (complex64: n_re + j
    n_im) that :func:`scatterer_power` and :func:`scatterer_signatures`
    draw for these seeds [F] int32 -- the validation surface of both.  A
    CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
    version."""
    _check_names(noise_impl)
    seeds = seeds.to(torch.int32)
    if seeds.dim() != 1:
        raise ValueError(f"seeds: need [F], got {tuple(seeds.shape)}")
    if not 0 < rows * cols < 2 ** 32:
        raise ValueError(f"rows * cols = {rows * cols}: the element index "
                         "is one 32-bit Philox counter word")
    if seeds.device.type == "cuda":
        F = seeds.shape[0]
        if not 0 < F <= 65535:
            raise ValueError(f"F={F} frames: the kernel takes 1..65535")
        _build.check_input("seeds", seeds, torch.int32, seeds.device)
        out = torch.empty((F, rows, cols), dtype=torch.complex64,
                          device=seeds.device)
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = _build.bind("synthpower", "synth_noise",
                         (vp, vp, ci, cl, ci, ci, vp))
        _build.launch(fn, seeds.data_ptr(), out.data_ptr(), F, rows * cols,
                      _IMPLS[noise_impl], seeds.device.index,
                      torch.cuda.current_stream(seeds.device).cuda_stream)
        noise_cube.launches += 1
        return out
    if seeds.device.type == "cpu":
        return noise_cube_reference(seeds, rows, cols, noise_impl)
    raise ValueError(f"no noise kernel for device {seeds.device}")


noise_cube.launches = 0


def synthesize_cube(e_ac: torch.Tensor, e_fast: torch.Tensor,
                    seeds: torch.Tensor, sigma: float,
                    noise_impl: str) -> torch.Tensor:
    """The cube X [F, A*C, S] both kernels build, in plain PyTorch:
    ``e_ac^T @ e_fast + sigma (n_re + j n_im)``; sigma = 0 adds exactly
    zero and skips the draw (so do the kernels)."""
    x = torch.matmul(e_ac.transpose(-1, -2), e_fast)
    if sigma != 0.0:
        gr, gi = standard_normals(seeds, x.shape[-2], x.shape[-1],
                                  noise_impl)
        x = x + torch.complex(sigma * gr, sigma * gi)
    return x


def _check_factors(e_ac, e_fast, seeds, mix, C: int):
    """Shape, type and placement checks shared by K4's and K5's wrappers.
    Returns (F, Sc, A, S)."""
    if e_ac.dim() != 3:
        raise ValueError(f"e_ac: need [F, Sc, A*C], got {tuple(e_ac.shape)}")
    F, Sc, AC = e_ac.shape
    if AC % C:
        raise ValueError(f"e_ac: A*C = {AC} is not a multiple of C = {C}")
    if e_fast.dim() != 3:
        raise ValueError(f"e_fast: need [F, Sc, S], got "
                         f"{tuple(e_fast.shape)}")
    S = e_fast.shape[-1]
    dev = e_ac.device
    _build.check_input("e_ac", e_ac, torch.complex64, dev)
    _build.check_input("e_fast", e_fast, torch.complex64, dev, (F, Sc, S))
    _build.check_input("seeds", seeds, torch.int32, dev, (F,))
    _build.check_input("mix", mix, torch.complex64, dev, (S,))
    if dev.type == "cuda" and not 0 < F <= 65535:
        raise ValueError(f"F={F} frames: the kernels take 1..65535")
    return F, Sc, AC // C, S


def scatterer_power_reference(e_ac: torch.Tensor, e_fast: torch.Tensor,
                              seeds: torch.Tensor, mix: torch.Tensor,
                              C: int, sigma: float, dc_removal: bool = True,
                              doppler_window: Optional[str] = None,
                              noise_impl: str = "box_muller"
                              ) -> torch.Tensor:
    """K4 in plain PyTorch: the materialized cube, then K7's plain power
    form.  Returns the power map [F, S, C] float32."""
    x = synthesize_cube(e_ac, e_fast, seeds, sigma, noise_impl)
    F, AC, S = x.shape
    return rds_power_reference(x.reshape(F, AC // C, C, S), mix, dc_removal,
                               doppler_window)


def scatterer_power(e_ac: torch.Tensor, e_fast: torch.Tensor,
                    seeds: torch.Tensor, mix: torch.Tensor, C: int,
                    sigma: float, dc_removal: bool = True,
                    doppler_window: Optional[str] = None,
                    synth_precision: str = "high",
                    precision_name: str = "default",
                    doppler_precision: str = "high",
                    doppler_layout: str = "loop",
                    noise_impl: str = "box_muller") -> torch.Tensor:
    """Power map [F, S, C] float32 (detection layout [range, Doppler])
    straight from the synthesis factors e_ac [F, Sc, A*C] / e_fast
    [F, Sc, S] complex64, per-frame seeds [F] int32 (shared with
    :func:`scatterer_signatures` for one realization), the baseband mix
    [S] and sigma = sqrt(noise_power) per plane."""
    _check_names(noise_impl, synth_precision, precision_name,
                 doppler_precision, doppler_layout=doppler_layout)
    seeds = seeds.to(torch.int32)
    F, Sc, A, S = _check_factors(e_ac, e_fast, seeds, mix, C)
    dev = e_ac.device
    if dev.type == "cpu":
        return scatterer_power_reference(e_ac, e_fast, seeds, mix, C, sigma,
                                         dc_removal, doppler_window,
                                         noise_impl)
    if dev.type != "cuda":
        raise ValueError(f"no power kernel for device {dev}")
    smem = 4 * (2 * A * C * _PS + 2 * C * (C + 1))
    if smem > _MAX_SMEM:
        raise ValueError(f"A={A}, C={C} needs {smem} bytes of shared memory "
                         f"per block; the kernel has {_MAX_SMEM}")
    w_rng, w_dop_t = frontend_constants(C, S, mix, dc_removal,
                                        doppler_window)
    x = torch.empty((F, A * C, S), dtype=torch.complex64, device=dev)
    z = torch.empty_like(x)
    p = torch.empty((F, S, C), dtype=torch.float32, device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind("synthpower", "synth_power",
                     (vp,) * 8 + (ci,) * 5 + (cf, ci, cf, ci, vp))
    _build.launch(fn, e_ac.data_ptr(), e_fast.data_ptr(), seeds.data_ptr(),
                  w_rng.data_ptr(), w_dop_t.data_ptr(), x.data_ptr(),
                  z.data_ptr(), p.data_ptr(), F, A, C, S, Sc, float(sigma),
                  _IMPLS[noise_impl], float(1.0 / A), dev.index,
                  torch.cuda.current_stream(dev).cuda_stream)
    scatterer_power.launches += 1
    return p


scatterer_power.launches = 0


def scatterer_signatures_reference(
        e_ac: torch.Tensor, e_fast: torch.Tensor, seeds: torch.Tensor,
        range_bin: torch.Tensor, doppler_bin: torch.Tensor,
        mix: torch.Tensor, C: int, sigma: float, dc_removal: bool = True,
        doppler_window: Optional[str] = None,
        noise_impl: str = "box_muller") -> torch.Tensor:
    """K5 in plain PyTorch: the materialized cube, then
    ``detection_signatures``' column math.  Returns [F, K, A] complex64
    unit-power."""
    x = synthesize_cube(e_ac, e_fast, seeds, sigma, noise_impl)
    S = x.shape[-1]
    w_rng, w_dop = signature_columns(S, C, range_bin, doppler_bin, mix,
                                     dc_removal, doppler_window)
    return signatures_from_columns(x, w_rng, w_dop, x.shape[-2] // C)


def scatterer_signatures(e_ac: torch.Tensor, e_fast: torch.Tensor,
                         seeds: torch.Tensor, range_bin: torch.Tensor,
                         doppler_bin: torch.Tensor, mix: torch.Tensor,
                         C: int, sigma: float, dc_removal: bool = True,
                         doppler_window: Optional[str] = None,
                         synth_precision: str = "high",
                         sig_precision: str = "high",
                         noise_impl: str = "box_muller") -> torch.Tensor:
    """Unit-power spatial signatures [F, K, A] complex64 of the detected
    cells (``range_bin`` / ``doppler_bin`` [F, K]) straight from the
    synthesis factors, with the SAME noise realization as
    :func:`scatterer_power` for the same seeds.  The cells' range columns
    [F, S, K] (DC projector on r = 0 before the mix) and Doppler columns
    [F, C, K] are built in torch, as the reference builds them in XLA."""
    _check_names(noise_impl, synth_precision, sig_precision)
    seeds = seeds.to(torch.int32)
    F, Sc, A, S = _check_factors(e_ac, e_fast, seeds, mix, C)
    if range_bin.shape != doppler_bin.shape or range_bin.dim() != 2 \
            or range_bin.shape[0] != F:
        raise ValueError(f"range_bin / doppler_bin: need [F={F}, K], got "
                         f"{tuple(range_bin.shape)} / "
                         f"{tuple(doppler_bin.shape)}")
    dev = e_ac.device
    if dev.type == "cpu":
        return scatterer_signatures_reference(
            e_ac, e_fast, seeds, range_bin, doppler_bin, mix, C, sigma,
            dc_removal, doppler_window, noise_impl)
    if dev.type != "cuda":
        raise ValueError(f"no signature kernel for device {dev}")
    K = range_bin.shape[-1]
    w_rng, w_dop = signature_columns(S, C, range_bin.to(dev),
                                     doppler_bin.to(dev), mix, dc_removal,
                                     doppler_window)
    w_rng = w_rng.to(torch.complex64).contiguous()
    w_dop = w_dop.to(torch.complex64).contiguous()
    x = torch.empty((F, A * C, S), dtype=torch.complex64, device=dev)
    g = torch.empty((F, A * C, K), dtype=torch.complex64, device=dev)
    sig = torch.empty((F, A, K), dtype=torch.complex64, device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind("synthpower", "synth_signatures",
                     (vp,) * 8 + (ci,) * 6 + (cf, ci, ci, vp))
    _build.launch(fn, e_ac.data_ptr(), e_fast.data_ptr(), seeds.data_ptr(),
                  w_rng.data_ptr(), w_dop.data_ptr(), x.data_ptr(),
                  g.data_ptr(), sig.data_ptr(), F, A, C, S, Sc, K,
                  float(sigma), _IMPLS[noise_impl], dev.index,
                  torch.cuda.current_stream(dev).cuda_stream)
    scatterer_signatures.launches += 1
    return unit_power(sig.transpose(1, 2))


scatterer_signatures.launches = 0
