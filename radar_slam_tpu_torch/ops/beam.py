"""The beamforming grid search's peak without a spectrum: for each
signature, the first maximum of |s a(g)^H|^2 over the (el-major) search
grid and the five powers the sub-grid refinement taps.

Replaces no TPU kernel: the reference leaves this search to XLA (the
product, |.|^2, argmax and gathers of ``radar_slam_tpu/aoa/estimators.py``).
The kernel (``csrc/beam.cu:beam_peak_kernel``) is bounded by its products;
it takes the planar array's steering in factored form (A_az complex MACs
a grid point instead of A), keeps every power in registers with a running
argmax a signature, and recomputes the taps as direct FP32 dot products
against the steering rows (the source's note has the design).

- :func:`peak_taps` -- the kernel wrapper: a CUDA tensor launches
  ``beam_peak`` or raises; a CPU tensor runs :func:`peak_taps_reference`.
  ``peak_taps.launches`` counts the launches, ``peak_taps.products`` their
  signature x grid-point pairs, on the host at each launch (a replayed
  CUDA graph adds none); a caller resets them by assigning 0.
- :func:`spectrum_peak_taps` -- the same outputs from spectra: the argmax
  (first maximum) and the gathers at :data:`TAP_STEPS`.  The plain
  search's refinement (``aoa/estimators.py:_refine_peak_2d``,
  ``_refine_peak``) takes its taps from here.
- :func:`peak_taps_reference` -- the plain version:
  ``aoa/estimators.py:beamforming_spectrum``, then
  :func:`spectrum_peak_taps`.
- :func:`grid_constants` -- the grid's steering and its factored phasor
  tables, built once per configuration by the caller.
- :func:`fits` -- whether the kernel's shared memory holds an array: up to
  64 elements on a line (any grid).

Taps, in order (:data:`TAP_STEPS`): y0 (the peak), az - 1, az + 1,
el - 1, el + 1, each index clamped to the grid; on a ULA (G_el = 1) the
last two are y0.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from radar_slam_tpu_torch.core.geometry import antenna_positions
from radar_slam_tpu_torch.ops import _build

# The taps as (el, az) steps from the peak; csrc/beam.cu takes them in
# this order.
TAP_STEPS = ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0))
TAPS = len(TAP_STEPS)
CHUNK = 8                 # csrc/beam.cu: azimuth elements a chunk
_P_WORDS = 1920           # csrc/beam.cu: BM_P_WORDS
_SIGS = 128               # csrc/beam.cu: BM_SIGS
_SMEM_MAX = 232448        # csrc/beam.cu: BM_SMEM_MAX


class BeamConstants(NamedTuple):
    """The fused search's inputs besides the signatures, complex64 on one
    device: the steering [G_el * G_az, A] as the plain search takes it, the
    elevation phasors E [G_el, A_el] = exp(-j k m d_el sin el) and the
    azimuth phasors P [G_el, G_az, padded_width(A_az)] = exp(-j k n d_az
    cos el sin az), zero for n >= A_az."""
    steering: torch.Tensor
    el_phasors: torch.Tensor
    az_phasors: torch.Tensor
    g_el: int
    g_az: int
    a_el: int
    a_az: int


def padded_width(a_az: int) -> int:
    """A_az rounded up to whole chunks: the phasor table's last axis."""
    return -(-a_az // CHUNK) * CHUNK


def smem_bytes(a_az: int, a_el: int) -> int:
    """Shared memory a block of the kernel takes (``csrc/beam.cu``'s
    ``bm_smem_bytes``): two phasor tiles, two padded t buffers, the
    signature tile."""
    azp = padded_width(a_az)
    return 8 * (2 * _P_WORDS + 2 * _SIGS * (azp + 2) + _SIGS * a_az * a_el)


def fits(a_az: int, a_el: int) -> bool:
    """Whether the kernel takes an array of A_el x A_az elements."""
    return smem_bytes(a_az, a_el) <= _SMEM_MAX


def grid_constants(steering: torch.Tensor, az_rad: torch.Tensor,
                   el_rad: torch.Tensor, a_az: int, a_el: int,
                   spacing_az: float, spacing_el: float,
                   lambda_c: float) -> BeamConstants:
    """The factored phasor tables over the grid az_rad [G_az] x el_rad
    [G_el] (float32; one zero elevation on a ULA) beside ``steering``, on
    its device.  u_y = cos el sin az and u_z = sin el are taken in float32
    as ``core/geometry.py:ura_steering_vector`` takes them, the phases and
    phasors in float64, rounded once to complex64."""
    az = az_rad.to("cpu", torch.float32)
    el = el_rad.to("cpu", torch.float32)
    u_y = (torch.cos(el)[:, None] * torch.sin(az)[None, :]).double()
    u_z = torch.sin(el).double()
    k = 2.0 * math.pi / lambda_c
    pos_az = antenna_positions(a_az, spacing_az, "cpu").double()
    pos_el = antenna_positions(a_el, spacing_el, "cpu").double()
    ph_az = -k * u_y[..., None] * pos_az
    p = torch.zeros(*ph_az.shape[:-1], padded_width(a_az),
                    dtype=torch.complex128)
    p[..., :a_az] = torch.polar(torch.ones_like(ph_az), ph_az)
    ph_el = -k * u_z[:, None] * pos_el
    e = torch.polar(torch.ones_like(ph_el), ph_el)
    dev = steering.device
    return BeamConstants(steering.contiguous(),
                         e.to(torch.complex64).to(dev),
                         p.to(torch.complex64).to(dev), el.shape[0],
                         az.shape[0], a_el, a_az)


def tap_indices(idx: torch.Tensor, g_el: int, g_az: int) -> torch.Tensor:
    """Flat indices [..., 5] of the taps of peaks ``idx`` [...] on the
    el-major G_el x G_az grid, each step of :data:`TAP_STEPS` clamped to
    the grid."""
    ie, ia = idx // g_az, idx % g_az
    cols = []
    for de, da in TAP_STEPS:
        e = ie if de == 0 else (ie + de).clamp(0, g_el - 1)
        a = ia if da == 0 else (ia + da).clamp(0, g_az - 1)
        cols.append(e * g_az + a)
    return torch.stack(cols, dim=-1)


def spectrum_peak_taps(flat: torch.Tensor, g_el: int, g_az: int):
    """(idx [...] int64, taps [..., 5]) of spectra ``flat`` [..., G_el *
    G_az] (el-major): the first maximum, as ``torch.argmax`` gives it, and
    the spectra at :func:`tap_indices`."""
    idx = torch.argmax(flat, dim=-1)
    return idx, torch.gather(flat, -1, tap_indices(idx, g_el, g_az))


def peak_taps_reference(signatures: torch.Tensor, steering: torch.Tensor,
                        g_el: int, g_az: int):
    """(idx [N] int64, taps [N, 5] float32) of signatures [N, A] in plain
    PyTorch: :func:`spectrum_peak_taps` of ``beamforming_spectrum``."""
    from radar_slam_tpu_torch.aoa.estimators import beamforming_spectrum
    return spectrum_peak_taps(beamforming_spectrum(signatures, steering),
                              g_el, g_az)


def peak_taps(signatures: torch.Tensor, consts: BeamConstants):
    """(idx [N] int64, taps [N, 5] float32) of signatures [N, A] complex64
    over the grid of ``consts``: the flattened index of the first maximum
    of |s a^H|^2 and the powers at the peak and its clamped neighbours.  A
    CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
    version."""
    N, A = signatures.shape
    if A != consts.a_el * consts.a_az:
        raise ValueError(f"signatures have {A} elements, the grid's "
                         f"steering {consts.a_el} x {consts.a_az}")
    if signatures.device.type == "cpu":
        return peak_taps_reference(signatures, consts.steering, consts.g_el,
                                   consts.g_az)
    if signatures.device.type != "cuda":
        raise ValueError(f"no beam kernel for device {signatures.device}")
    dev = signatures.device
    G = consts.g_el * consts.g_az
    _build.check_input("signatures", signatures, torch.complex64, dev)
    _build.check_input("steering", consts.steering, torch.complex64, dev,
                       (G, A))
    _build.check_input("el_phasors", consts.el_phasors, torch.complex64, dev,
                       (consts.g_el, consts.a_el))
    if not fits(consts.a_az, consts.a_el):
        raise ValueError(f"beam_peak takes no {consts.a_el} x "
                         f"{consts.a_az} array: it needs "
                         f"{smem_bytes(consts.a_az, consts.a_el)} B of "
                         f"shared memory, more than {_SMEM_MAX}")
    width = padded_width(consts.a_az)
    _build.check_input("az_phasors", consts.az_phasors, torch.complex64, dev,
                       (consts.g_el, consts.g_az, width))
    idx = torch.empty(N, dtype=torch.int64, device=dev)
    taps = torch.empty(N, TAPS, dtype=torch.float32, device=dev)
    if N == 0:
        return idx, taps
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.bind("beam", "beam_peak",
                     (vp,) + (ci,) * 6 + (vp,) * 5 + (ci, vp))
    _build.launch(fn, signatures.data_ptr(), N, consts.a_az, consts.a_el,
                  consts.g_az, consts.g_el, width,
                  consts.el_phasors.data_ptr(), consts.az_phasors.data_ptr(),
                  consts.steering.data_ptr(), idx.data_ptr(), taps.data_ptr(),
                  dev.index, torch.cuda.current_stream(dev).cuda_stream)
    peak_taps.launches += 1
    peak_taps.products += N * G
    return idx, taps


peak_taps.launches = 0
peak_taps.products = 0
