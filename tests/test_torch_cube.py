"""The port's cube-input modules and the plain versions of its four cube
kernels (K7 power, K8 RDS, K9 dechirp, K10 CFAR mask) against the JAX
reference on the CPU.

Inputs are made with numpy or by the reference and handed to the port
through ``signals_from_numpy``.  Pallas kernels run in interpret mode, as
the reference's own tests run them.  Tolerances, with their reasons:

- synthesis 1e-6 of the maximum: float32 factors (~1e-7 per element)
  contracted over 128 scatterers.  The reference runs eagerly here
  (``jax.disable_jit``): under ``jit`` XLA reassociates the ~1,300-cycle
  float32 beat phase and its own cube moves by ~3e-3 of the maximum.
- power maps 1e-5 of the maximum and RDS 1e-5 of max |rds| against the
  same formulation; 2e-5 against the FFT path, from which the reference's
  own matmul form differs by 1.1e-5 (float32 DFT constants with range
  phases to ~2.5e3 rad).
- K9 rtol = atol = 1e-5 and K10 power_db 1e-4 dB, masks > 99.9 % equal,
  planted peaks found: the reference's tests (test_ops_pallas.py); K10
  also at D = 128.
- detections: identical valid sets and bins, ``range_m`` to 1e-5 (the
  reference's test_fused_power.py), valid signatures to 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import bench_config, scene_fields, to_np
from jax.experimental.pallas import tpu as pltpu

from radar_slam_tpu.ops import (cfar_pallas, dechirp_pallas, power_pallas,
                                rds_pallas)
from radar_slam_tpu.signal import detect as jdet
from radar_slam_tpu.signal import rds as jrds
from radar_slam_tpu.signal import synth as jsynth
from radar_slam_tpu_torch.core.types import (scatterer_batch_from_numpy,
                                             signals_from_numpy)
from radar_slam_tpu_torch.ops import cfar, dechirp, power
from radar_slam_tpu_torch.ops import rds as trds_op
from radar_slam_tpu_torch.signal import detect as tdet
from radar_slam_tpu_torch.signal import rds as trds
from radar_slam_tpu_torch.signal import synth as tsynth

F = 2


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def cube():
    """Two noisy bench-scene cubes from the reference's synthesis."""
    cfg = bench_config()
    jbatch, _, _ = scene_fields(F)
    sig = np.asarray(jsynth.synthesize_frames_batch(jbatch, cfg.radar,
                                                    jax.random.key(1)))
    return cfg, sig


def rand_complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---- (a) synthesis ----------------------------------------------------------

@pytest.mark.parametrize("fidelity", ["tpu", "reference"])
def test_reference_chirp_and_dense_factors_match(fidelity):
    cfg = bench_config()
    jbatch, fields, _ = scene_fields(F)
    np.testing.assert_array_equal(to_np(tsynth.reference_chirp(
        cfg.radar, device="cpu")),
                                  np.asarray(jsynth.reference_chirp(cfg.radar)))
    e_ac_j, e_fast_j = jax.vmap(
        lambda s: jsynth.synthesis_factors(s, cfg.radar, fidelity))(jbatch)
    e_ac, e_fast = tsynth.synthesis_factors(
        scatterer_batch_from_numpy(fields, "cpu"), cfg.radar, fidelity)
    assert e_ac.shape == (F, 128, 8 * 32) and e_fast.shape == (F, 128, 400)
    assert rel(to_np(e_ac), e_ac_j) < 1e-6
    assert rel(to_np(e_fast), e_fast_j) < 1e-6


@pytest.mark.parametrize("output,fidelity", [
    ("baseband", "tpu"), ("raw", "tpu"), ("baseband", "reference")])
def test_noiseless_cubes_match(output, fidelity):
    cfg = bench_config()
    jbatch, fields, _ = scene_fields(F)
    with jax.disable_jit():
        want = np.asarray(jsynth.synthesize_frames_batch(
            jbatch, cfg.radar, jax.random.key(0), output=output,
            add_noise=False, fidelity=fidelity))
    got = to_np(tsynth.synthesize_frames_batch(
        scatterer_batch_from_numpy(fields, "cpu"), cfg.radar,
        torch.Generator(), output=output, add_noise=False,
        fidelity=fidelity))
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert rel(got, want) < 1e-6


def test_cube_noise_statistics():
    """A scene with no valid scatterer is pure noise: zero mean, variance
    noise_power per component, no correlation between the real and
    imaginary parts nor between neighbouring samples (five standard errors
    over 2 x 102,400 samples); the same generator seed repeats it."""
    cfg = bench_config(noise_power=0.25)
    _, fields, _ = scene_fields(F)
    fields = dict(fields, valid=np.zeros_like(fields["valid"]))
    batch = scatterer_batch_from_numpy(fields, "cpu")
    x = tsynth.synthesize_frames_batch(batch, cfg.radar,
                                       torch.Generator().manual_seed(5))
    again = tsynth.synthesize_frames_batch(batch, cfg.radar,
                                           torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(to_np(x), to_np(again))
    z = to_np(x).reshape(F, -1).astype(np.complex128)
    n = z.size
    se = 5.0 / np.sqrt(n)
    for part in (z.real, z.imag):
        assert abs(part.mean()) / 0.5 < se
        assert abs(part.var() / 0.25 - 1.0) < 5.0 * np.sqrt(2.0 / n)
    assert abs(np.mean(z.real * z.imag)) / 0.25 < se
    for part in (z.real, z.imag):
        assert abs(np.mean(part[:, 1:] * part[:, :-1])) / 0.25 < se
    assert not np.allclose(z[0], z[1])


# ---- (b) K7, (c) K8 -----------------------------------------------------------

def test_plain_power_matches_reference_oracles(cube):
    cfg, sig = cube
    S = sig.shape[-1]
    mix = trds._mix_vector(cfg.radar, cfg.window, "baseband", S,
                             device="cpu")
    got = to_np(power.rds_power_fused(signals_from_numpy(sig, "cpu"), mix,
                                      True, cfg.doppler_window))
    want = np.asarray(power_pallas.rds_power_reference(
        jnp.asarray(sig), jrds._mix_vector(cfg.radar, cfg.window,
                                           "baseband", S),
        True, cfg.doppler_window))
    assert got.shape == (F, 400, 32)
    assert rel(got, want) < 1e-5
    xla = np.asarray(jax.vmap(lambda s: jrds.rds_power(
        s, cfg.radar, window=cfg.window,
        doppler_window=cfg.doppler_window, mode="xla"))(sig))
    assert rel(got, xla) < 2e-5
    # rds_power on a CPU tensor: "auto" takes the FFT path, as the
    # reference does off a TPU; "pallas" the kernel's plain version.
    x = signals_from_numpy(sig, "cpu")
    for mode in ("auto", "pallas"):
        p = to_np(trds.rds_power(x, cfg.radar, window=cfg.window,
                                 doppler_window=cfg.doppler_window,
                                 mode=mode))
        assert rel(p, xla) < 2e-5, mode


def _small_cube(seed, shape=(2, 8, 64)):
    rng = np.random.default_rng(seed)
    sig = rand_complex(rng, shape)
    mix = rand_complex(rng, shape[-1:])
    return sig, mix


def test_plain_power_matches_interpret_kernel():
    sig, mix = _small_cube(0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(power_pallas.rds_power_fused(
            jnp.asarray(sig), jnp.asarray(mix), True, "hann",
            precision_name="highest", doppler_precision="highest"))
    got = to_np(power.rds_power_fused(torch.tensor(sig), torch.tensor(mix),
                                      True, "hann"))
    assert got.shape == want.shape == (64, 8)
    assert rel(got, want) < 1e-5


def test_plain_rds_matches_reference(cube):
    cfg, sig = cube
    S = sig.shape[-1]
    x = signals_from_numpy(sig, "cpu")
    got = to_np(trds_op.rds_fused(
        x, trds._mix_vector(cfg.radar, cfg.window, "baseband", S,
                             device="cpu"), True,
        cfg.doppler_window))
    assert got.shape == (F, 8, 400, 32) and got.dtype == np.complex64
    jmix = jrds._mix_vector(cfg.radar, cfg.window, "baseband", S)
    same_form = np.asarray(jrds._rds_matmul(
        jnp.asarray(sig), jmix, True, cfg.doppler_window,
        jax.lax.Precision.HIGHEST))
    assert rel(got, same_form) < 1e-5
    fft = np.asarray(jrds.range_doppler_spectrum(
        jnp.asarray(sig), cfg.radar, window=cfg.window,
        doppler_window=cfg.doppler_window, fft_mode="fft"))
    assert rel(got, fft) < 2e-5
    # The port's three modes agree with each other.
    modes = {m: to_np(trds.range_doppler_spectrum(
        x, cfg.radar, window=cfg.window, doppler_window=cfg.doppler_window,
        fft_mode=m, use_pallas=up))
        for m, up in (("fft", False), ("matmul", False), ("pallas", True))}
    assert rel(modes["fft"], fft) < 1e-6
    assert rel(modes["matmul"], modes["fft"]) < 2e-5
    np.testing.assert_array_equal(modes["pallas"], got)


def test_plain_rds_matches_interpret_kernel():
    sig, mix = _small_cube(1, (2, 3, 8, 64))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(rds_pallas.rds_fused(
            jnp.asarray(sig), jnp.asarray(mix), True, "hann"))
    got = to_np(trds_op.rds_fused(torch.tensor(sig), torch.tensor(mix),
                                  True, "hann"))
    assert got.shape == want.shape == (2, 3, 64, 8)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("input_domain", ["baseband", "raw"])
def test_rds_fft_path_matches_reference(cube, input_domain):
    """The FFT path, the raw input domain (conj reference chirp in the mix)
    and a chirp subset with odd C (the explicit fftshift branch).  The
    reference runs eagerly: under ``jit`` XLA rounds the chirp's
    ~2e4-cycle quadratic phase in another order (~1e-3 of the maximum)."""
    cfg, sig = cube
    x = signals_from_numpy(sig, "cpu")
    for subset in (None, (3, 28)):
        with jax.disable_jit():
            want = np.asarray(jrds.range_doppler_spectrum(
                jnp.asarray(sig), cfg.radar, window=cfg.window,
                input_domain=input_domain, chirp_subset=subset,
                doppler_window=cfg.doppler_window))
        got = to_np(trds.range_doppler_spectrum(
            x, cfg.radar, window=cfg.window, input_domain=input_domain,
            chirp_subset=subset, doppler_window=cfg.doppler_window))
        assert rel(got, want) < 1e-5, subset


# ---- (d) K9 -------------------------------------------------------------------

@pytest.mark.parametrize("shape,dc", [((8, 32, 400), True),
                                      ((8, 32, 400), False),
                                      ((3, 5, 173), True)])
def test_plain_dechirp_matches_interpret_kernel(shape, dc):
    rng = np.random.default_rng(sum(shape) + dc)
    sig = rand_complex(rng, shape)
    mix = rand_complex(rng, shape[-1:])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(dechirp_pallas.dechirp_window_dc(
            jnp.asarray(sig), jnp.asarray(mix), dc))
    got = to_np(dechirp.dechirp_window_dc(torch.tensor(sig),
                                          torch.tensor(mix), dc))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---- (e) K10 ------------------------------------------------------------------

PEAKS = [(50, 10, 30.0), (200, 32, 100.0), (333, 50, 60.0)]


def rds_with_peaks(seed):
    """Noise plus planted peaks with shoulders (test_ops_pallas.py:48)."""
    rds = 0.01 * rand_complex(np.random.default_rng(seed), (8, 400, 64))
    for r, d, a in PEAKS:
        rds[:, r, d] += a
        rds[:, r + 1, d] += 0.4 * a
    return rds


@pytest.mark.parametrize("train,guard", [(0, 0), (8, 2)])
def test_plain_cfar_matches_interpret_kernel(train, guard):
    rds = rds_with_peaks(4)
    kw = dict(threshold_db=-25.0, neighborhood=3, train=train, guard=guard,
              offset_db=12.0)
    with pltpu.force_tpu_interpret_mode():
        want_pdb, want_mask = map(np.asarray, cfar_pallas.cfar_mask(
            jnp.asarray(rds), **kw))
    pdb, mask = map(to_np, cfar.cfar_mask(torch.tensor(rds)[None], **kw))
    assert pdb.shape == mask.shape == (1, 400, 64) and mask.dtype == bool
    np.testing.assert_allclose(pdb[0], want_pdb, rtol=1e-4, atol=1e-4)
    assert np.mean(mask[0] == want_mask) > 0.999
    for r, d, _ in PEAKS:
        assert mask[0, r, d] and want_mask[r, d]


PEAKS_128 = [(50, 10, 30.0), (200, 96, 100.0), (333, 127, 60.0)]


@pytest.mark.parametrize("train,guard", [(0, 0), (8, 2)])
def test_plain_cfar_matches_interpret_kernel_d128(train, guard):
    """A map with 128 Doppler bins (a 128-chirp configuration), which one
    block per frame could not hold on the card."""
    rds = 0.01 * rand_complex(np.random.default_rng(9), (4, 400, 128))
    for r, d, a in PEAKS_128:
        rds[:, r, d] += a
        rds[:, r + 1, d] += 0.4 * a
    kw = dict(threshold_db=-25.0, neighborhood=3, train=train, guard=guard,
              offset_db=12.0)
    with pltpu.force_tpu_interpret_mode():
        want_pdb, want_mask = map(np.asarray, cfar_pallas.cfar_mask(
            jnp.asarray(rds), **kw))
    pdb, mask = map(to_np, cfar.cfar_mask(torch.tensor(rds)[None], **kw))
    assert pdb.shape == mask.shape == (1, 400, 128)
    np.testing.assert_allclose(pdb[0], want_pdb, rtol=1e-4, atol=1e-4)
    assert np.mean(mask[0] == want_mask) > 0.999
    for r, d, _ in PEAKS_128:
        assert mask[0, r, d] and want_mask[r, d]


# ---- (f) detection and signatures --------------------------------------------

def _det_equal(got, want):
    v = np.asarray(want.valid)
    assert v.any(), "no detections"
    np.testing.assert_array_equal(to_np(got.valid), v)
    for name in ("range_bin", "doppler_bin"):
        np.testing.assert_array_equal(to_np(getattr(got, name))[v],
                                      np.asarray(getattr(want, name))[v])
    np.testing.assert_allclose(to_np(got.range_m)[v],
                               np.asarray(want.range_m)[v], rtol=1e-5)
    return v


def test_detect_peaks_from_power_and_signatures_match(cube):
    cfg, sig = cube
    p = np.asarray(jax.vmap(lambda s: jrds.rds_power(
        s, cfg.radar, window=cfg.window,
        doppler_window=cfg.doppler_window, mode="xla"))(sig))
    want = jax.vmap(lambda q: jdet.detect_peaks_from_power(
        q, cfg.radar, cfg.detection))(jnp.asarray(p))
    got = tdet.detect_peaks_from_power(torch.tensor(p), cfg.radar,
                                       cfg.detection)
    v = _det_equal(got, want)
    want_sig = np.asarray(jax.vmap(lambda s, r, d: jrds.detection_signatures(
        s, r, d, cfg.radar, window=cfg.window,
        doppler_window=cfg.doppler_window))(sig, want.range_bin,
                                            want.doppler_bin))
    got_sig = to_np(trds.detection_signatures(
        signals_from_numpy(sig, "cpu"), got.range_bin, got.doppler_bin,
        cfg.radar, window=cfg.window, doppler_window=cfg.doppler_window))
    assert got_sig.shape == (F, 64, 8)
    np.testing.assert_allclose(got_sig[v], want_sig[v], rtol=0, atol=2e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_detect_peaks_and_cube_signatures_match(cube, use_pallas):
    """detect_peaks on the same RDS (``use_pallas``: the reference's CFAR
    kernel in interpret mode, the port's K10 plain version) and the
    signatures gathered from it."""
    cfg, sig = cube
    rds = np.asarray(jax.vmap(lambda s: jrds.range_doppler_spectrum(
        s, cfg.radar, window=cfg.window,
        doppler_window=cfg.doppler_window))(sig))
    with pltpu.force_tpu_interpret_mode():
        want = jax.vmap(lambda r: jdet.detect_peaks(
            r, cfg.radar, cfg.detection, use_pallas=use_pallas))(
                jnp.asarray(rds))
    want_sig = np.asarray(jax.vmap(jdet.extract_spatial_signatures)(
        jnp.asarray(rds), want))
    got = tdet.detect_peaks(torch.tensor(rds), cfg.radar, cfg.detection,
                            use_pallas=use_pallas)
    v = _det_equal(got, want)
    np.testing.assert_allclose(
        to_np(tdet.power_spectrum_db(torch.tensor(rds))),
        np.asarray(jax.vmap(jdet.power_spectrum_db)(jnp.asarray(rds))),
        rtol=0, atol=1e-4)
    got_sig = to_np(tdet.extract_spatial_signatures(torch.tensor(rds), got))
    np.testing.assert_allclose(got_sig[v], want_sig[v], rtol=0, atol=2e-4)


# ---- the wrappers -------------------------------------------------------------

def test_cpu_tensors_run_the_plain_versions(cube):
    """On the CPU no wrapper launches anything: the counts move only on the
    card, and each wrapper returns its plain version's result."""
    cfg, sig = cube
    x = signals_from_numpy(sig, "cpu")
    mix = trds._mix_vector(cfg.radar, cfg.window, "baseband", 400,
                           device="cpu")
    wrappers = (power.rds_power_fused, trds_op.rds_fused,
                dechirp.dechirp_window_dc, cfar.cfar_mask)
    before = [w.launches for w in wrappers]
    np.testing.assert_array_equal(
        to_np(power.rds_power_fused(x, mix)),
        to_np(power.rds_power_reference(x, mix)))
    rds = trds_op.rds_fused(x, mix)
    np.testing.assert_array_equal(
        to_np(rds), to_np(trds_op.rds_fused_reference(x, mix)))
    np.testing.assert_array_equal(
        to_np(dechirp.dechirp_window_dc(x, mix)),
        to_np(dechirp.dechirp_window_dc_reference(x, mix)))
    for a, b in zip(cfar.cfar_mask(rds, train=8, guard=2),
                    cfar.cfar_mask_reference(rds, train=8, guard=2)):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    assert [w.launches for w in wrappers] == before


def test_wrappers_check_their_inputs(cube):
    cfg, sig = cube
    x = signals_from_numpy(sig, "cpu")
    mix = trds._mix_vector(cfg.radar, cfg.window, "baseband", 400,
                           device="cpu")
    for fn in (power.rds_power_fused, trds_op.rds_fused,
               dechirp.dechirp_window_dc):
        with pytest.raises(TypeError):
            fn(x.to(torch.complex128), mix)
        with pytest.raises(ValueError):
            fn(x, mix[:-1])
        with pytest.raises(ValueError):
            fn(x.transpose(-1, -2), mix[:32])
    with pytest.raises(ValueError):
        cfar.cfar_mask(x, neighborhood=4)
    with pytest.raises(TypeError):
        cfar.cfar_mask(x.real)
    with pytest.raises(TypeError):
        signals_from_numpy(sig.astype(np.complex128), "cpu")
    with pytest.raises(ValueError):
        signals_from_numpy(sig[0], "cpu")
    with pytest.raises(ValueError):
        tdet.detect_peaks_from_power(torch.ones(1, 400, 32), cfg.radar,
                                     cfg.detection,
                                     clutter_lin=torch.ones(1, 32, 400))
