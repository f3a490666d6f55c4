#!/usr/bin/env python3
"""K10's device time at each tile height T the tile plan may choose.

    python3 scripts/torch_cfar_tiles.py

Calls K10 (``ops/cfar.py:_launch``, the launch ``cfar_mask`` makes) on
the maps of 64 frames of bench-scene cubes (A=8, R=400, D=32) and of
128-chirp cubes (D=128), at the bench detector (CA-CFAR, train 8, guard 2,
neighborhood 3: a halo of 10 rows), once per T in 8, 16, 32, 64: each
run's outputs against ``cfar_mask_reference`` (bit for bit), its device
time per call from a profile of 20 calls, its CUDA-event time per call,
the read amplification (T + 2 halo) / T, and the T that
``ops/cfar.py:cfar_tile_plan`` picks.  Prints one JSON line per case and
the card's name and power limit.  Needs a CUDA device.
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main():
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print("torch_cfar_tiles: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from radar_slam_tpu_torch.core import config as cfg_mod
    from radar_slam_tpu_torch.ops import cfar
    from radar_slam_tpu_torch.ops import rds as rds_op
    from radar_slam_tpu_torch.ops.frontend import use_f32_matmuls
    from radar_slam_tpu_torch.signal.rds import _mix_vector

    use_f32_matmuls()
    dev = torch.device("cuda", 0)
    for chirps in (32, 128):
        cfg = cs.bench_config(cfg_mod, num_chirps=chirps)
        sig, _ = cs.cube_signals(64, cfg, dev, 0)
        mix = _mix_vector(cfg.radar, cfg.window, "baseband", sig.shape[-1],
                          device=dev)
        rds = rds_op.rds_fused_reference(sig, mix, True, cfg.doppler_window)
        del sig
        d = cfg.detection
        kw = dict(threshold_db=d.threshold_db, neighborhood=d.neighborhood,
                  train=d.cfar_train_cells, guard=d.guard_cells,
                  offset_db=d.cfar_offset_db)
        want_pdb, want_mask = cfar.cfar_mask_reference(rds, **kw)
        F, A, R, D = rds.shape
        plan_T, halo, _ = cfar.cfar_tile_plan(R, D, d.cfar_train_cells,
                                              d.guard_cells, d.neighborhood)
        pdb = torch.empty((F, R, D), dtype=torch.float32, device=dev)
        mask = torch.empty((F, R, D), dtype=torch.bool, device=dev)
        for T in (8, 16, 32, 64):
            smem = cfar._smem_bytes(T, D, halo, d.cfar_train_cells,
                                    d.guard_cells, d.neighborhood)

            def call():
                cfar._launch(rds, pdb, mask, T, halo, smem, **kw)

            call()
            torch.cuda.synchronize()
            equal = (bool(torch.equal(pdb, want_pdb))
                     and bool(torch.equal(mask, want_mask)))
            per = cs.kernel_profile(torch, lambda: [call() for _ in range(20)])
            event = min(cs.cuda_time_ms(torch, call, 50) for _ in range(3))
            print(json.dumps({
                "D": D, "T": T, "halo": halo, "plan_T": plan_T,
                "read_amplification": (T + 2 * halo) / T,
                "bit_equal": equal, "blocks": F * -(-R // T),
                "device_ms_per_64f": sum(per.values()) / 20,
                "event_ms_per_64f": event}), flush=True)
            if not equal:
                return 1
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
