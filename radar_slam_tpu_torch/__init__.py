"""radar_slam_tpu_torch: the PyTorch / CUDA port of ``radar_slam_tpu``.

The JAX package beside it is the reference; every module here mirrors a
module of the same name there and is held against it by the CPU parity
tests (``tests/test_torch_*.py``).  This package imports ``torch`` and
nothing of ``jax`` or of the JAX package: it keeps its own copy of the
frozen configuration dataclasses (``core.config``, with
``config_from_dict`` to carry a configuration across).

Ported so far: the batched drivers (scatterers and ADC cubes), the
sequential drivers (``pipeline.frame.process_sequence``,
``process_sequence_chunked``, ``process_signal_sequence`` and their
one-frame steps) with the clutter map and the slot-table smoother, the
rig drivers, every TPU kernel, hand-written in CUDA for the H100
(``csrc/``), and the entry points: the CLI (``python -m
radar_slam_tpu_torch``), the streaming analyzer with checkpoint resume, the
real-time runtime, the RadarScenes loader and the prefetch ingest.

- ``core``      config, static-shape tensor types, geometry
- ``signal``    synthesis, DFT constants, detection (CFAR, clutter map)
- ``ops``       kernel wrappers + their plain PyTorch versions, the
                counter-based Gaussian generator, window taps
- ``aoa``       beamforming AoA, confidence + MDL, temporal smoothing,
                the robust per-frame AoA stage
- ``motion``    mutual-NN association, 6-DoF velocity solve, planar pose
- ``pipeline``  the batched, sequential and rig drivers, streaming, CLI
- ``io``        synthetic known-truth scenes, the RadarScenes loader,
                double-buffered host ingest
- ``evaluate``  planar pose errors
- ``utils``     checkpointing, host transfers of tensor trees, logging
"""

__version__ = "0.1.0"
