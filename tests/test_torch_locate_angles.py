"""``aoa/estimators.py:locate_angles_2d`` and the fused beamforming search
of ``ops/beam.py`` (``csrc/beam.cu``).

On the CPU:
- ``locate_angles_2d`` gives ``estimate_angles_2d``'s first two outputs
  bit for bit, on a ULA and a URA, for beamforming, MUSIC (forward-backward
  on and off) and ESPRIT;
- ``peak_taps_reference`` (the plain version, the refinement's own taps)
  gives the spectrum's argmax and its values at the clamped steps of
  ``TAP_STEPS``, with planted sources at the grid's corners and edges and
  on flat (zero) spectra, and the refinement's angles from them;
- the kernel's factored arithmetic (``grid_constants``' phasor tables,
  evaluated here in plain PyTorch) gives the spectrum within float32
  rounding, at 8 and 32 azimuth elements;
- the shared-memory plan is the kernel source's, and holds lines of up to
  64 elements.

On the card (``card``; skipped without an NVIDIA card; run there with
``python -m pytest tests/test_torch_locate_angles.py -q -m card
--noconftest``), the kernel against the plain version at the URA's shape
(A = 32, 181 x 61), the ULA's (A = 8, G = 91), lines of 32 and 64
elements (several chunks of 8), a 16 x 4 URA, and 0.1 degree grids (ULA
G = 1,801; URA 1,801 x 61, several tiles a row): ragged N, planted
sources at the corners and edges, zero and constant rows, near-ties, two
runs bit for bit, a CUDA graph's replay, one launch a call.
"""

import dataclasses

import pytest
import torch

from radar_slam_tpu_torch.aoa import estimators as te
from radar_slam_tpu_torch.core.config import AoAConfig, RadarConfig
from radar_slam_tpu_torch.ops import beam

URA = (RadarConfig(num_antennas=8, num_antennas_el=4),
       AoAConfig(search_resolution_deg=1.0, el_min_deg=-45.0,
                 el_max_deg=45.0, el_resolution_deg=1.5))
ULA = (RadarConfig(num_antennas=8), AoAConfig(search_resolution_deg=2.0))
ARRAYS = {"ura": URA, "ula": ULA}
ULA32 = (RadarConfig(num_antennas=32), AoAConfig(search_resolution_deg=1.0))
# The kernel on the card besides: lines of several chunks of 8 elements,
# and grids whose rows take several tiles of phasors.
CARD_ARRAYS = dict(
    ARRAYS, ula32=ULA32,
    ula64=(RadarConfig(num_antennas=64),
           AoAConfig(search_resolution_deg=0.5)),
    ura16x4=(RadarConfig(num_antennas=16, num_antennas_el=4), URA[1]),
    ula_fine=(RadarConfig(num_antennas=8),
              AoAConfig(search_resolution_deg=0.1)),
    ura_fine=(URA[0], dataclasses.replace(URA[1],
                                          search_resolution_deg=0.1)))
# Random rows whose index the plain argmax gives: on the 0.1 degree grids
# neighbouring points differ by less than float32 rounding near more
# peaks, and there the values at the two indices decide.
SAME_SHARE = {"ula_fine": 0.99, "ura_fine": 0.99}
METHODS = {"beamforming": ("beamforming", True),
           "music_fb": ("music", True), "music": ("music", False),
           "esprit": ("esprit", True)}


def _signatures(n: int, A: int, seed: int, device="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    s = torch.complex(torch.randn(n, A, generator=g),
                      torch.randn(n, A, generator=g))
    return s.to(device)


def _grid(radar, aoa):
    g_el = aoa.num_el_grid_points if radar.num_antennas_el > 1 else 1
    return g_el, aoa.num_grid_points


def _planted(radar, aoa, device="cpu"):
    """Signatures equal to the steering of the grid's corners and edge
    midpoints (flat indices), each a source exactly on a grid point."""
    g_el, g_az = _grid(radar, aoa)
    rows = sorted({e * g_az + a for e in (0, g_el // 2, g_el - 1)
                   for a in (0, 1, g_az // 2, g_az - 2, g_az - 1)})
    steering = te.grid_steering_matrix(radar, aoa, device)
    return steering[rows], torch.tensor(rows, device=device)


# ---- on the CPU ------------------------------------------------------------

@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("array", sorted(ARRAYS))
def test_locate_angles_2d_is_estimate_angles_2d_on_the_cpu(array, method):
    radar, aoa = ARRAYS[array]
    name, fb = METHODS[method]
    aoa = dataclasses.replace(aoa, music_fb=fb, esprit_weighted=fb)
    s = _signatures(2 * 7, radar.total_antennas, 3).reshape(2, 7, -1)
    num_sources = torch.tensor([[1, 2, 1, 1, 2, 1, 1]] * 2)
    want_az, want_el, _ = te.estimate_angles_2d(s, radar, aoa, name,
                                                num_sources)
    before = beam.peak_taps.launches
    az, el = te.locate_angles_2d(s, radar, aoa, name, num_sources)
    assert te.grid_route(s, radar, name) == "spectrum"
    assert beam.peak_taps.launches == before
    assert torch.equal(az, want_az) and torch.equal(el, want_el)


@pytest.mark.parametrize("array", sorted(ARRAYS))
def test_plain_peak_taps_hold_the_refinement_taps(array):
    radar, aoa = ARRAYS[array]
    g_el, g_az = _grid(radar, aoa)
    A = radar.total_antennas
    planted, rows = _planted(radar, aoa)
    s = torch.cat([_signatures(40, A, 5), planted,
                   torch.zeros(3, A, dtype=torch.complex64)])
    steering = te.grid_steering_matrix(radar, aoa, "cpu")
    spec = te.beamforming_spectrum(s, steering)
    idx, taps = beam.peak_taps_reference(s, steering, g_el, g_az)
    assert torch.equal(idx, torch.argmax(spec, dim=-1))
    # A planted source peaks at its point, or at a point of equal power:
    # on the ULA (d = lambda / 2) az = +90 deg aliases -90 deg.
    got = idx[40:40 + rows.shape[0]]
    v = spec[40:40 + rows.shape[0]]
    v_got, v_row = v.gather(-1, got[:, None]), v.gather(-1, rows[:, None])
    assert ((got == rows) | ((v_got - v_row).abs() <= 1e-6 * v_row)[:, 0]
            ).all()
    assert (got == rows).sum() >= rows.shape[0] - 1
    assert torch.equal(idx[-3:], torch.zeros(3, dtype=torch.int64))
    assert torch.equal(taps[-3:], torch.zeros(3, beam.TAPS))
    grid = spec.reshape(-1, g_el, g_az)
    rows_n = torch.arange(s.shape[0])
    for k, (de, da) in enumerate(beam.TAP_STEPS):
        e = (idx // g_az + de).clamp(0, g_el - 1)
        a = (idx % g_az + da).clamp(0, g_az - 1)
        assert torch.equal(taps[:, k], grid[rows_n, e, a]), k
    az_grid = te.azimuth_grid_deg(aoa, "cpu")
    el_grid = te.elevation_grid_deg(aoa, "cpu") if g_el > 1 else None
    az, el = te._angles_from_taps(idx, taps, az_grid, el_grid)
    if g_el > 1:
        want_az, want_el = te._refine_peak_2d(spec.reshape(-1, g_el, g_az),
                                              az_grid, el_grid)
    else:
        want_az = te._refine_peak(spec, az_grid)
        want_el = torch.zeros_like(want_az)
    assert torch.equal(az, want_az) and torch.equal(el, want_el)


@pytest.mark.parametrize("array", sorted(ARRAYS) + ["ula32"])
def test_factored_phasors_give_the_spectrum(array):
    """The kernel's order in plain PyTorch: t_n(e) = sum_m s_mn E_m(e),
    then sum_n t_n(e) P_n(e, a); float32 rounding off the spectrum, and the
    same argmax but for near-ties.  The tables' phases are taken in
    float64 and the plain steering's in float32, whose phase error grows
    with the element's distance: the bound grows with A_az."""
    radar, aoa = ARRAYS.get(array, ULA32)
    consts = te._fused_search_constants(radar, aoa, "cpu")[0]
    assert consts.az_phasors.shape[-1] == beam.padded_width(consts.a_az)
    assert not consts.az_phasors[..., consts.a_az:].any()
    s = _signatures(256, radar.total_antennas, 11)
    t = torch.einsum("nma,em->nea",
                     s.reshape(-1, consts.a_el, consts.a_az),
                     consts.el_phasors)
    resp = torch.einsum("nea,eza->nez", t,
                        consts.az_phasors[..., :consts.a_az])
    fact = (resp.real ** 2 + resp.imag ** 2).reshape(s.shape[0], -1)
    spec = te.beamforming_spectrum(s, consts.steering)
    scale = spec.amax(dim=-1, keepdim=True)
    assert ((fact - spec).abs() <= 2e-6 * consts.a_az / 8 * scale).all()
    agree = torch.argmax(fact, -1) == torch.argmax(spec, -1)
    assert agree.float().mean() >= 0.99


def test_peak_taps_shapes_and_widths():
    radar, aoa = URA
    consts = te._fused_search_constants(radar, aoa, "cpu")[0]
    with pytest.raises(ValueError):
        beam.peak_taps(_signatures(4, 8, 0), consts)
    assert [beam.padded_width(a) for a in (2, 8, 9, 16, 17, 32)] == [
        8, 8, 16, 16, 24, 32]
    s = _signatures(5, 32, 1)
    before = (beam.peak_taps.launches, beam.peak_taps.products)
    idx, taps = beam.peak_taps(s, consts)
    assert idx.dtype == torch.int64 and idx.shape == (5,)
    assert taps.dtype == torch.float32 and taps.shape == (5, beam.TAPS)
    assert (beam.peak_taps.launches, beam.peak_taps.products) == before


def test_smem_plan_is_the_kernel_sources():
    """``ops/beam.py``'s shared-memory sum uses ``csrc/beam.cu``'s
    constants, and the kernel holds every grid and lines up to 64
    elements: the cells' arrays, 32 and 64 elements, a 16 x 4 URA."""
    import pathlib
    import re
    src = (pathlib.Path(beam.__file__).parents[1] / "csrc" / "beam.cu"
           ).read_text()

    def const(name):
        return int(re.search(rf"constexpr [\w ]+ {name} = (\d+);", src)[1])

    assert const("BM_P_WORDS") == beam._P_WORDS
    assert const("BM_R") * 32 == beam._SIGS
    assert const("BM_CHUNK") == beam.CHUNK
    assert const("BM_SMEM_MAX") == beam._SMEM_MAX
    assert const("BM_TAPS") == beam.TAPS
    fit = {(a_az, a_el): beam.fits(a_az, a_el)
           for a_az, a_el in ((8, 1), (8, 4), (16, 4), (32, 1), (64, 1),
                              (65, 1), (32, 8))}
    assert fit == {(8, 1): True, (8, 4): True, (16, 4): True,
                   (32, 1): True, (64, 1): True, (65, 1): False,
                   (32, 8): False}
    assert beam.smem_bytes(8, 4) == 8 * (2 * 1920 + 2 * 128 * 10 + 128 * 32)


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _check_against_plain(s, consts, exact_share):
    """Kernel against the plain version: indices equal on at least
    ``exact_share`` of the rows; where they differ the plain spectrum's
    values at the two indices within 1e-5 of each other; every tap within
    1e-5 of a float64 evaluation at the kernel's index (relative to the
    row's peak power)."""
    g_el, g_az = consts.g_el, consts.g_az
    idx, taps = beam.peak_taps(s, consts)
    want_idx, _ = beam.peak_taps_reference(s, consts.steering, g_el, g_az)
    spec = te.beamforming_spectrum(s, consts.steering)
    torch.cuda.synchronize()
    same = idx == want_idx
    assert same.float().mean().item() >= exact_share, same.float().mean()
    v_k = torch.gather(spec, -1, idx[:, None])[:, 0]
    v_p = torch.gather(spec, -1, want_idx[:, None])[:, 0]
    assert ((v_k - v_p).abs() <= 1e-5 * v_p).all()
    st = consts.steering.to(torch.complex128)
    rows = st[beam.tap_indices(idx, g_el, g_az)]           # [N, 5, A]
    exact = (s.to(torch.complex128)[:, None, :] * rows.conj()).sum(-1)
    exact = exact.real ** 2 + exact.imag ** 2
    scale = exact[:, :1].clamp(min=1e-30)
    assert ((taps.double() - exact).abs() <= 1e-5 * scale).all()
    return idx, taps


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 63, 65, 12157])
@pytest.mark.parametrize("array", sorted(CARD_ARRAYS))
def test_beam_kernel_on_the_card(array, n):
    dev = _card()
    radar, aoa = CARD_ARRAYS[array]
    consts = te._fused_search_constants(radar, aoa, str(dev))[0]
    s = _signatures(n, radar.total_antennas, 100 + n, dev)
    _check_against_plain(s, consts, SAME_SHARE.get(array, 0.999))


@pytest.mark.card
@pytest.mark.parametrize("array", sorted(CARD_ARRAYS))
def test_beam_kernel_edges_flat_rows_and_near_ties(array):
    dev = _card()
    radar, aoa = CARD_ARRAYS[array]
    A = radar.total_antennas
    consts = te._fused_search_constants(radar, aoa, str(dev))[0]
    planted, rows = _planted(radar, aoa, dev)
    idx, _ = _check_against_plain(planted, consts, 0.0)
    # A planted source peaks at its point, or at a point of equal power
    # within float32 rounding: az = +-90 deg on a line, where the two
    # steering vectors coincide, and, on the 0.1 deg grids, the points
    # near +-90 deg, whose spacing in sin az is ~1e-6.
    spec = te.beamforming_spectrum(planted, consts.steering)
    v_k = spec.gather(-1, idx[:, None])[:, 0]
    v_row = spec.gather(-1, rows[:, None])[:, 0]
    assert (v_k >= v_row * (1 - 1e-5)).all()
    if array not in SAME_SHARE:
        assert (idx == rows).float().mean().item() >= 0.8
    flat = torch.zeros(5, A, dtype=torch.complex64, device=dev)
    idx, taps = beam.peak_taps(flat, consts)
    assert torch.equal(idx, torch.zeros_like(idx))
    assert torch.equal(taps, torch.zeros_like(taps))
    const = torch.full((3, A), 0.5 - 0.25j, dtype=torch.complex64, device=dev)
    _check_against_plain(const, consts, 1.0)
    # Two equal sources: two peaks whose order rounding decides.
    g = torch.Generator().manual_seed(7)
    G = consts.g_el * consts.g_az
    pairs = torch.randint(0, G, (256, 2), generator=g).to(dev)
    ties = consts.steering[pairs[:, 0]] + consts.steering[pairs[:, 1]]
    _check_against_plain(ties, consts, 0.0)


@pytest.mark.card
@pytest.mark.parametrize("array", sorted(ARRAYS))
def test_beam_kernel_repeats_replays_and_counts(array):
    dev = _card()
    radar, aoa = ARRAYS[array]
    consts = te._fused_search_constants(radar, aoa, str(dev))[0]
    s = _signatures(4099, radar.total_antennas, 21, dev)
    before = beam.peak_taps.launches
    first = beam.peak_taps(s, consts)
    again = beam.peak_taps(s, consts)
    assert beam.peak_taps.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        beam.peak_taps(s, consts)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = beam.peak_taps(s, consts)
    for out in captured:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, captured))
