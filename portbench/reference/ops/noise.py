"""Frozen copy of ``radar_slam_tpu_torch/ops/noise.py`` at commit d8c8661
(imports renamed to ``portbench.reference``; otherwise unchanged).

The front end's counter-based Gaussian generator, in plain PyTorch.

The reference kernels draw their noise from the TPU's seeded in-kernel
PRNG (``ops/synthpower_pallas.py:_standard_normals``).  Those bits cannot
be replayed off the TPU, so the port keeps the *transforms* and replaces
the bit source with Philox-4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011), which the CUDA kernels in
``csrc/frontend.cu`` and ``csrc/synthpower.cu`` evaluate bit-identically:

- key   = (frame seed as uint32, 0);
- counter = (element index, block, 0, 0), element index = row * S + col
  over the [A*C, S] noise plane (row a*C + c), block 0 and 1;
- impl "fast" (the front end's default): words w0..w3 from block 0 and w4
  from block 1 feed the transform: an exact Rayleigh radius
  sqrt(-2 log u1), u1 = (w0 >> 8) 2^-24 + 2^-25, times a direction from
  two Irwin-Hall(4) byte sums (w1, w2) plus a pair (w3, w4) rotated 45
  degrees, whose square-lattice anisotropies cancel;
- impl "box_muller" (the default of the reference's ``noise_cube`` and
  ``scatterer_power``): words w0 and w1 of block 0 give
  u1 = (w0 >> 8) 2^-24 + 2^-25 and u2 = (w1 >> 8) 2^-24, and the planes
  are r cos(2 pi u2) and r sin(2 pi u2) with r = sqrt(-2 ln u1).

Every shift is logical: an arithmetic ``>> 8`` on signed words made half
of the reference's uniforms negative and NaN'd its noise on chip.  The
32-bit products of Philox are split into 16-bit halves so that no int64
intermediate overflows.
"""

from __future__ import annotations

import torch

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK = 0xFFFFFFFF
_ROUNDS = 10
_TWO_PI = 6.283185307179586


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * x for a constant
    uint32 ``m`` and int64 ``x`` holding uint32 values."""
    p_lo = m * (x & 0xFFFF)                 # < 2^48
    p_hi = m * (x >> 16)                    # < 2^48
    t = ((p_hi & 0xFFFF) << 16) + p_lo      # < 2^49
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32(ctr, key):
    """Philox-4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1).

    Each word is an int64 tensor (or int) holding a uint32 value; tensors
    broadcast.  Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(_ROUNDS):
        if r > 0:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _byte_sum(w: torch.Tensor) -> torch.Tensor:
    """Sum of the four bytes of each uint32 word: Irwin-Hall(4) over
    discrete uniforms (mean 510, var 4 (256^2 - 1) / 12)."""
    return ((w & 255) + ((w >> 8) & 255) + ((w >> 16) & 255)
            + (w >> 24))


def standard_normals(seeds: torch.Tensor, rows: int, cols: int,
                     impl: str = "fast") -> tuple[torch.Tensor, torch.Tensor]:
    """Two standard-normal planes [F, rows, cols] per frame seed.

    ``seeds`` [F] int32.  Element (f, i, j) is the ``impl`` transform
    ("fast" or "box_muller") of the Philox words at counter i * cols + j
    under key seeds[f]; the CUDA kernels draw the same words for the same
    (seed, index)."""
    if impl not in ("fast", "box_muller"):
        raise ValueError(f"Unknown noise impl: {impl}")
    dev = seeds.device
    key0 = (seeds.to(torch.int64) & _MASK)[:, None]               # [F, 1]
    idx = torch.arange(rows * cols, dtype=torch.int64, device=dev)[None, :]
    w0, w1, w2, w3 = philox4x32((idx, 0, 0, 0), (key0, 0))
    u1 = ((w0 >> 8).to(torch.float32) * (1.0 / (1 << 24))
          + (0.5 / (1 << 24)))
    r = torch.sqrt(-2.0 * torch.log(u1))
    shape = (seeds.shape[0], rows, cols)
    if impl == "box_muller":
        u2 = (w1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
        ang = _TWO_PI * u2
        return ((r * torch.cos(ang)).reshape(shape),
                (r * torch.sin(ang)).reshape(shape))
    w4 = philox4x32((idx, 1, 0, 0), (key0, 0))[0]
    g1 = _byte_sum(w1).to(torch.float32) - 510.0
    g2 = _byte_sum(w2).to(torch.float32) - 510.0
    h1 = _byte_sum(w3).to(torch.float32) - 510.0
    h2 = _byte_sum(w4).to(torch.float32) - 510.0
    v1 = g1 + 0.7071067811865476 * (h1 - h2)
    v2 = g2 + 0.7071067811865476 * (h1 + h2)
    inv = 1.0 / torch.sqrt(v1 * v1 + v2 * v2 + 1e-6)
    return (r * v1 * inv).reshape(shape), (r * v2 * inv).reshape(shape)


def frame_seeds(generator: torch.Generator, num_frames: int,
                device) -> torch.Tensor:
    """Per-frame noise seeds [F] int32 drawn from ``generator`` (a
    non-blocking copy: the host does not wait for the device)."""
    seeds = torch.randint(-2 ** 31, 2 ** 31, (num_frames,),
                          generator=generator, dtype=torch.int64,
                          device=generator.device)
    return seeds.to(torch.int32).to(device, non_blocking=True)
