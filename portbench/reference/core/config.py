"""Frozen copy of ``radar_slam_tpu_torch/core/config.py`` at commit d8c8661
(the named operating points left out; otherwise unchanged).

Typed configuration of the port: frozen dataclasses of Python scalars.

The port's own copy of the reference's ``radar_slam_tpu/core/config.py``
(the same classes, fields, defaults, derived properties and factories), so
the port imports nothing of the JAX package.  :func:`config_from_dict`
rebuilds a port :class:`PipelineConfig` from ``dataclasses.asdict`` of any
pipeline configuration: it carries a configuration across, as a weights
converter carries weights, and the parity tests hand the reference's
configuration to the port through it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

C_LIGHT = 299792458.0
# The reference keeps c = 3e8 (range resolution 0.15 m, wavelength
# 3.896 mm at 77 GHz).
C_REF = 3.0e8


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    """FMCW waveform and array: 77 GHz carrier, 1 GHz bandwidth, 40 us
    chirp, 100 us PRI, 64 chirps, 8-element half-wavelength ULA, 10 MHz
    ADC by default."""

    fc: float = 77.0e9                 # carrier frequency [Hz]
    bandwidth: float = 1.0e9           # chirp bandwidth [Hz]
    chirp_duration: float = 40.0e-6    # chirp duration [s]
    pri: float = 100.0e-6              # pulse repetition interval [s]
    num_chirps: int = 64               # chirps per frame (slow time)
    num_antennas: int = 8              # azimuth (ULA) elements
    sampling_rate: float = 10.0e6      # ADC rate [Hz]
    noise_power: float = 0.01          # AWGN power added during synthesis
    antenna_spacing: Optional[float] = None  # None -> lambda/2
    c: float = C_REF                   # propagation speed [m/s]
    # Planar (URA) array: rows of elevation elements, flattened row-major
    # [el, az] along the antenna axis.
    num_antennas_el: int = 1
    antenna_spacing_el: Optional[float] = None  # None -> lambda/2

    @property
    def lambda_c(self) -> float:
        """Carrier wavelength [m]."""
        return self.c / self.fc

    @property
    def spacing(self) -> float:
        """Element spacing [m]; half a wavelength by default."""
        return (self.antenna_spacing if self.antenna_spacing is not None
                else self.lambda_c / 2.0)

    @property
    def spacing_el(self) -> float:
        """Elevation-row spacing [m]; half a wavelength by default."""
        return (self.antenna_spacing_el if self.antenna_spacing_el is not None
                else self.lambda_c / 2.0)

    @property
    def total_antennas(self) -> int:
        return self.num_antennas * self.num_antennas_el

    @property
    def samples_per_chirp(self) -> int:
        return int(self.chirp_duration * self.sampling_rate)

    @property
    def chirp_rate(self) -> float:
        """Chirp slope B / T [Hz/s]."""
        return self.bandwidth / self.chirp_duration

    @property
    def range_resolution(self) -> float:
        return self.c / (2.0 * self.bandwidth)

    @property
    def velocity_resolution(self) -> float:
        return self.lambda_c / (2.0 * self.num_chirps * self.pri)

    @property
    def prf(self) -> float:
        """Pulse repetition frequency 1 / PRI [Hz]."""
        return 1.0 / self.pri

    @property
    def max_unambiguous_range(self) -> float:
        return self.range_resolution * self.samples_per_chirp

    @property
    def max_unambiguous_velocity(self) -> float:
        """lambda / (4 PRI) [m/s]."""
        return self.lambda_c / (4.0 * self.pri)

    def validate(self) -> "RadarConfig":
        assert self.fc > 0 and self.bandwidth > 0
        assert self.samples_per_chirp > 0, \
            "chirp_duration * sampling_rate must be >= 1"
        assert self.num_chirps >= 1 and self.num_antennas >= 2
        assert self.pri >= self.chirp_duration, "PRI must cover the chirp"
        return self


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Range-Doppler peak detection: local max, fixed or CFAR threshold,
    range gate, static top-K with a validity mask."""

    threshold_db: float = -25.0
    min_range: float = 1.0
    max_range: float = 200.0
    max_detections: int = 64           # static K
    neighborhood: int = 3              # local-max window (odd)
    nms_radius: int = 2                # Chebyshev radius of cross-detection NMS
    guard_cells: int = 0
    cfar_train_cells: int = 0          # > 0 enables the CFAR threshold
    cfar_offset_db: float = 12.0
    cfar_mode: str = "ca"              # "ca" cell-averaging, "os" order-stat
    os_rank: float = 0.75
    # > 0 carries an EMA background power map across frames (sequential
    # drivers): a cell must exceed it by clutter_offset_db.
    clutter_map_alpha: float = 0.0
    clutter_offset_db: float = 6.0


@dataclasses.dataclass(frozen=True)
class AoAConfig:
    """Angle-of-arrival estimation and the robust estimator's smoothing."""

    search_min_deg: float = -90.0
    search_max_deg: float = 90.0
    search_resolution_deg: float = 2.0
    method: str = "beamforming"          # beamforming | music | esprit
    el_min_deg: float = -20.0
    el_max_deg: float = 20.0
    el_resolution_deg: float = 2.0
    num_sources: int = 1
    music_fb: bool = True                # forward-backward averaging (MUSIC)
    esprit_weighted: bool = True         # multi-lag ESPRIT
    temporal_window: int = 3
    confidence_threshold: float = 0.6
    smoothing_factor: float = 0.7
    max_targets: int = 50
    power_filter_db: float = -25.0
    track_capacity: int = 256            # slots of the temporal smoother
    track_max_age: int = 2               # frames before a track goes stale

    @property
    def num_grid_points(self) -> int:
        return int(round((self.search_max_deg - self.search_min_deg)
                         / self.search_resolution_deg)) + 1

    @property
    def num_el_grid_points(self) -> int:
        return int(round((self.el_max_deg - self.el_min_deg)
                         / self.el_resolution_deg)) + 1


@dataclasses.dataclass(frozen=True)
class VelocityConfig:
    """6-DoF velocity solve: "doppler", "phase" or "fused" observables."""

    mode: str = "fused"
    max_velocity: float = 30.0
    max_angular_velocity: float = 5.0
    regularization_weight: float = 0.01
    z_velocity_weight: float = 10.0
    temporal_weight: float = 0.1         # weight of the previous motion prior
    huber_delta: float = 1.0             # phase IRLS scale [rad]
    gn_iterations: int = 8
    two_step: bool = True
    association_gate: float = 5.0        # cartesian gate [m]
    min_targets: int = 3
    doppler_huber_mps: float = 0.5       # Doppler IRLS scale [m/s]
    use_doppler_vr: bool = True
    use_apparent_velocity: bool = True
    apparent_velocity_weight: float = 0.1
    association_method: str = "mutual"   # "mutual" or "greedy"
    dealias_doppler: bool = True


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    """Pose integration."""

    integration_method: str = "trapezoidal"  # trapezoidal | euler
    smoothing: bool = False
    smoothing_window: int = 5
    planar: bool = False
    coast_on_failure: bool = True            # dead-reckon through failed solves


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline composition."""

    radar: RadarConfig = dataclasses.field(default_factory=RadarConfig)
    detection: DetectionConfig = dataclasses.field(
        default_factory=DetectionConfig)
    aoa: AoAConfig = dataclasses.field(default_factory=AoAConfig)
    velocity: VelocityConfig = dataclasses.field(
        default_factory=VelocityConfig)
    pose: PoseConfig = dataclasses.field(default_factory=PoseConfig)
    frame_duration_ms: float = 100.0
    max_scatterers: int = 512
    chirp_subset: Optional[Tuple[int, int]] = None
    window: str = "hann"                     # fast-time window
    doppler_window: Optional[str] = "hann"   # slow-time window
    use_pallas: bool = False                 # dechirp / CFAR through kernels
    fft_mode: str = "fft"                    # fft | matmul | pallas | fused
    dft_precision: str = "highest"
    power_precision: str = "default"
    doppler_precision: str = "highest"
    synth_doppler_precision: str = "high"
    doppler_layout: str = "loop"
    synth_doppler_layout: str = "wide"
    synth_in_kernel: bool = False            # cube-free scatterer front end
    noise_impl: str = "fast"                 # "fast" or "box_muller"
    noise_domain: str = "range_freq"         # one-pass noise: or "time"
    frontend_topk: str = "two_stage"         # "two_stage" or "sort"
    frontend_factors: str = "split"          # "split" (K1) or "dense" (K3)
    frontend_one_pass: bool = True
    synth_fidelity: str = "tpu"              # "tpu" or "reference"

    @property
    def frame_dt(self) -> float:
        return self.frame_duration_ms * 1e-3


_SECTIONS = {"radar": RadarConfig, "detection": DetectionConfig,
             "aoa": AoAConfig, "velocity": VelocityConfig,
             "pose": PoseConfig}


def config_from_dict(d: Mapping[str, Any]) -> PipelineConfig:
    """A port :class:`PipelineConfig` from ``dataclasses.asdict`` of a
    pipeline configuration (the port's or the reference's).

    Nested sections become their dataclasses again and ``chirp_subset``
    becomes a tuple (``asdict`` keeps tuples, a JSON round trip makes them
    lists).  An unknown field raises ``TypeError``, as the constructor
    does."""
    kw = dict(d)
    for name, cls in _SECTIONS.items():
        if name in kw and not isinstance(kw[name], cls):
            kw[name] = cls(**kw[name])
    if kw.get("chirp_subset") is not None:
        kw["chirp_subset"] = tuple(kw["chirp_subset"])
    return PipelineConfig(**kw)


__all__ = [
    "AoAConfig", "DetectionConfig", "PipelineConfig", "PoseConfig",
    "RadarConfig", "VelocityConfig", "config_from_dict",
]
