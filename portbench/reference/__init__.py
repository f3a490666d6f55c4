"""The plain reference the benchmark holds the program's outputs to.

Phase A, the one-pass front end (K1's function), is worked out again in
PyTorch on the card in float64 (``frontend.py``), on frozen copies of the
port's signal model at commit d8c8661 whose bits or tables the kernels
must match: the Philox noise (``ops/noise.py``), the windows, the Doppler
DFT matrix and the synthesis factors (``ops/``, ``signal/``), and the
configuration's dataclasses (``core/``).  Phase B, from the picks to motion
and pose, is written anew in NumPy from what the configuration defines
(``estimation.py``), and ``pipeline.py`` drives both as the program's
batched, rig and streaming drivers do.  Nothing here imports the program or
JAX.
"""
