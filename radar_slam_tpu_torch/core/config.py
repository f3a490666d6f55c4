"""The pipeline configuration, shared with the reference.

The frozen dataclasses of ``radar_slam_tpu/core/config.py`` are re-exported
here, not copied: reference and port run from one config object.  That
module imports no JAX (nor does ``radar_slam_tpu/__init__.py``), so the
port stays free of it; the port's modules and ``chip_smoke.py`` import the
configuration from here only.
"""

from radar_slam_tpu.core.config import (AoAConfig, DetectionConfig,
                                        PipelineConfig, PoseConfig,
                                        RadarConfig, VelocityConfig,
                                        complete_analysis_config,
                                        default_config,
                                        reference_fidelity_config)

__all__ = [
    "AoAConfig", "DetectionConfig", "PipelineConfig", "PoseConfig",
    "RadarConfig", "VelocityConfig", "complete_analysis_config",
    "default_config", "reference_fidelity_config",
]
