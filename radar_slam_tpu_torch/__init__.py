"""radar_slam_tpu_torch: the PyTorch / CUDA port of ``radar_slam_tpu``.

The JAX package beside it is the reference; every module here mirrors a
module of the same name there and is held against it by the CPU parity
tests (``tests/test_torch_*.py``).  This package imports ``torch`` and never
``jax``: the frozen configuration dataclasses are shared with the reference
through ``radar_slam_tpu.core.config``, which imports no jax.

Slice ported so far: the batched scatterers-to-pose path
(``pipeline.frame.process_sequence_batched``), with the one-pass front-end
kernel hand-written in CUDA for the H100 (``csrc/frontend.cu``).

- ``core``      shared config re-export, static-shape tensor types, geometry
- ``signal``    synthesis factors, DFT constants, detection tail
- ``ops``       the front-end kernel wrapper + its plain PyTorch version,
                the counter-based Gaussian generator, window taps
- ``aoa``       beamforming AoA, confidence + MDL, windowed smoothing
- ``motion``    mutual-NN association, fused 6-DoF velocity solve
- ``pipeline``  the batched sequence pipeline
- ``io``        synthetic known-truth scenes
- ``evaluate``  planar pose errors
"""

__version__ = "0.1.0"
