"""``z_power_kernel``'s product on warpgroup MMA (``csrc/frontend.cu``,
``csrc/wgmma.cuh``): the shared-memory plan and the ``"wgmma"`` counter on
the CPU; on the card, the kernel against its float64 plain version.

- The plan: ``ops/frontend.py:_z_ring`` / ``_z_r0`` / ``_z_power_smem`` /
  ``z_power_groups`` mirror ``zk_ring`` / ``zk_r0`` / ``zk_smem_bytes`` /
  ``zk_group_antennas``, recomputed here from the kernel source's own
  constants, at the benchmark cells' shapes (the bench and ingest ULA,
  A = 8 and C = 32; the URA, A = 32 on "tiled_rows") and at A = 16, C = 64.
- The counter: ``branch_launches["wgmma"]`` exists on both wrappers and
  stays 0 for CPU tensors, which run the plain version; the ``k1`` span
  names the product.
- On the card (``card``, skipped without an NVIDIA card; run there with
  ``python -m pytest tests/test_torch_z_power_wgmma.py -q -m card
  --noconftest``): K1 and K3 at the bench's, the ingest's (Sc = 512) and
  the URA's shapes, at A = 16 / C = 64, at F = 1, at a ragged F, at a
  ragged Sc and at an odd S, against the float64 plain version on the exact DFT at
  ``chip_smoke.py``'s tolerances (``FRONTEND_TOL``), two runs bit for bit,
  one "wgmma" count a launch.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from radar_slam_tpu_torch.ops import frontend as fe
from radar_slam_tpu_torch.utils import profiling

_SRC = (Path(fe.__file__).resolve().parent.parent / "csrc"
        / "frontend.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


def _kernel_ring(split: bool, A: int, C: int) -> int:
    """zk_ring from the source's constants: two stages each of B' (KC / 4
    k-steps of two 8 x 64 word tiles: 256 words, 128 float2 per complex
    k), of the T tile (ZK_NT per complex k) and of the A factors."""
    kc = _const("ZK_KCS") if split else _const("ZK_KC")
    d = fe.frag_pitch(C) + fe.frag_pitch(A) if split else _const("ZK_LDA")
    nt = _const("ZK_NT")
    return kc * 2 * (4 * nt + nt + d)


_SHAPES = {"bench": (8, 32), "ingest": (8, 32), "ura": (32, 32),
           "a16_c64": (16, 64)}


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_z_power_plan_matches_the_kernel_at_the_cells_shapes(shape, split):
    A, C = _SHAPES[shape]
    ring = _kernel_ring(split, A, C)
    assert fe._z_ring(split, A, C) == ring
    noise = _const("ZK_MC") * (_const("ZK_NT") + 2 * 2)
    r0 = max(ring, noise, -(-C // 16) * 16 * fe.frag_pitch(-(-C // 8) * 8))
    assert fe._z_r0(split, A, C) == r0
    ldz = _const("ZK_LDZ")
    ag = fe.z_power_groups(split, A, C)
    assert fe._z_power_smem(split, A, C, ag) == 8 * (r0 + (ag * C + 8) * ldz)
    assert fe._z_power_smem(split, A, C, ag) <= fe._MAX_SMEM
    assert ag == A or fe._z_power_smem(split, A, C, ag + 1) > fe._MAX_SMEM
    # The cells keep their routes: all rows at A = 8, 16 antennas a pass
    # on the URA (two passes of two 256-row chunks), 8 at A = 16, C = 64.
    assert ag == {"bench": 8, "ingest": 8, "ura": 16, "a16_c64": 8}[shape]
    # The ring, the noise tile and W_dop^T share the first region; the B'
    # stages at its start are whole 8 x 64 tiles (2 KB, 16-byte aligned).
    assert ring <= r0 and (8 * ring) % 16 == 0


def _cpu_inputs(F=2, A=2, C=8, S=16, Sc=5, seed=3):
    g = torch.Generator().manual_seed(seed)

    def cplx(*shape):
        return torch.complex(torch.randn(*shape, generator=g),
                             torch.randn(*shape, generator=g))
    B, Q = 8, 2
    args = (cplx(F, Sc, A), cplx(F, Sc, C), cplx(F, Sc, Q), cplx(F, Sc, B),
            torch.rand(F, Sc, generator=g) * 1e-7,
            torch.arange(S, dtype=torch.float32) * 1e-8,
            torch.arange(F, dtype=torch.int32), cplx(S),
            fe.doppler_constant(C, None, "cpu"))
    prm = fe.FrontendParams(
        sigma=0.1, noise_taps=((0, 0.5), (1, -0.25), (-1, -0.25)),
        echo_upper=None, dc_removal=True, train=2, guard=1, neighborhood=3,
        offset_db=6.0, threshold_db=-40.0, min_range_bin=1,
        max_range_bin=S - 2, noise_domain="range_freq", noise_impl="fast",
        cfar_impl="matmul", clutter_offset_db=6.0)
    return args, prm


def test_wgmma_count_exists_and_stays_zero_on_the_cpu():
    args, prm = _cpu_inputs()
    A, C = args[0].shape[-1], args[1].shape[-1]
    e_ac = (args[1][..., None, :] * args[0][..., :, None]).reshape(
        *args[0].shape[:2], A * C).contiguous()
    e_fast = torch.ones(*args[0].shape[:2], args[5].shape[0],
                        dtype=torch.complex64)
    for w, call in (
            (fe.frontend_kernel_split,
             lambda: fe.frontend_kernel_split(*args, prm)),
            (fe.frontend_kernel_dense,
             lambda: fe.frontend_kernel_dense(e_ac, e_fast, args[6], args[7],
                                              args[8], prm, C))):
        assert "wgmma" in w.branch_launches
        before = (w.launches, dict(w.branch_launches))
        out = call()
        assert all(bool(torch.isfinite(x).all()) for x in out)
        assert (w.launches, w.branch_launches) == before
    # A CUDA launch on either range-frequency route counts it; the time
    # domain's on-chip cube kernel does not.
    assert "wgmma" in fe._branches(prm, None, 16, "all_rows")
    assert "wgmma" not in fe._branches(
        dataclasses.replace(prm, noise_domain="time"), None, 16,
        "one_block")


def test_k1_span_names_the_product():
    args, prm = _cpu_inputs()
    assert fe._product("range_freq", "cuda") == "wgmma"
    assert fe._product("time", "cuda") == "mma_sync"
    profiling.enable()
    try:
        fe.scatterer_frontend_split(
            *args[:7], args[7], args[1].shape[-1], 0.1, 4, train=2, guard=1,
            neighborhood=3, offset_db=6.0, threshold_db=-40.0,
            min_range_bin=1, max_range_bin=14, noise_domain="range_freq",
            noise_taps=prm.noise_taps, noise_impl="fast")
    finally:
        spans = profiling.collect()
        profiling.disable()
    k1 = [s for s in spans if s.name == "k1"]
    assert len(k1) == 1 and k1[0].attrs == {"product": "plain"}


# ---- on the card -------------------------------------------------------------

# (configuration, scene, frames): the cells' shapes, A = 16 / C = 64, one
# frame (a streaming step), a ragged frame count, a ragged capacity (100
# scatterers: no multiple of either route's 16 or 8 complex k a stage) and
# an odd S (401: T's rows no longer 16-byte aligned, so the copies move 8
# bytes).
_CARD = {"bench": ("bench", {}, 8), "ingest": ("bench", {"cap": 512}, 8),
         "ura": ("ura", {}, 8), "a16_c64": ("a16", {}, 8),
         "f1": ("bench", {"cap": 512}, 1), "ragged_f": ("bench", {}, 5),
         "ragged_sc": ("bench", {"cap": 100}, 8),
         "odd_s": ("bench", {"samples": 401}, 8)}


@pytest.mark.card
@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("shape", sorted(_CARD))
def test_z_power_kernel_on_the_card(shape, split):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import chip_smoke as cs
    from radar_slam_tpu_torch.core import config as cfg_mod
    dev = torch.device("cuda", 0)
    fe.use_f32_matmuls()
    kind, knobs, F = _CARD[shape]
    if kind == "ura":
        cfg = cs.ura_config(cfg_mod)
        batch, _ = cs.ura_scene(F, cfg, dev)
    else:
        cfg = (cs.route_cfg(cfg_mod, 16) if kind == "a16" else
               cs.bench_config(cfg_mod, max_scatterers=knobs.get("cap", 128),
                               samples_per_chirp=knobs.get("samples")))
        batch, _ = cs.scene(F, cfg, dev)
    seeds = torch.arange(F, dtype=torch.int32, device=dev) * 7919 - 3
    args, prm = cs.kernel_inputs(batch, cfg, seeds)
    exact = cs.plain_args(args, prm)
    C = cfg.radar.num_chirps
    if split:
        wrapper = fe.frontend_kernel_split
        run = lambda: wrapper(*args, prm)
        plain = cs.as_f32(fe.scatterer_frontend_split_reference(*exact, prm))
    else:
        e_ac, e_fast, mix = cs.synth_inputs(batch, cfg)
        wrapper = fe.frontend_kernel_dense
        run = lambda: wrapper(e_ac, e_fast, seeds, mix, args[8], prm, C)
        plain = cs.as_f32(fe.scatterer_frontend_reference(
            e_ac.to(torch.complex128), e_fast.to(torch.complex128), seeds,
            exact[7], exact[8], prm, C))
    before = (wrapper.launches, wrapper.branch_launches["wgmma"])
    kern = run()
    again = run()
    torch.cuda.synchronize()
    assert (wrapper.launches - before[0],
            wrapper.branch_launches["wgmma"] - before[1]) == (2, 2)
    assert cs.digest(kern) == cs.digest(again)
    label = f"{shape} {'K1' if split else 'K3'}"
    r = cs.frontend_errors(torch, fe, cfg, kern, plain, label, prm)
    cs.check_frontend(label, r)
