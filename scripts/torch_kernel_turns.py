#!/usr/bin/env python3
"""Time the port's K1, K4, K5, K7, K8 and K10 in one source tree, so that
two commits can be compared on one card in turns.

    python3 scripts/torch_kernel_turns.py <tree>

<tree> is a checkout of the repository: this one ("."), or another commit
unpacked with ``git archive <commit> | tar -x -C <dir>`` into a
git-ignored directory.  Its ``radar_slam_tpu_torch`` kernels are built (in
its own ``_build/``) and each wrapper is timed per 64-frame call on the
bench cell (A=8, C=32, S=400, Sc=128, K=64): CUDA events, best of 3 x 20
calls, and each kernel's device time by name from a profile of 10 calls
(the wrapper's host cost left out).  The inputs are made by this checkout's ``chip_smoke.py`` helpers
through the tree's package.  Prints one JSON line.  Run the two trees in
turns in one call on one card (parent, change, change, parent) and compare
within that call.  Needs a CUDA device.
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main():
    tree = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    from radar_slam_tpu_torch.core import config as cfg_mod
    from radar_slam_tpu_torch.ops import _build, cfar, power
    from radar_slam_tpu_torch.ops import frontend as fe
    from radar_slam_tpu_torch.ops import rds as rds_op
    from radar_slam_tpu_torch.ops import synthpower as sp
    from radar_slam_tpu_torch.signal.detect import detect_peaks_from_power
    # The helpers only; every radar_slam_tpu_torch module they import
    # resolves to the tree's package, imported above.
    sys.path.insert(1, str(REPO))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    for name in ("frontend", "cube", "synthpower"):
        _build.load(name)
    dev = torch.device("cuda")
    fe.use_f32_matmuls()
    cfg = cs.bench_config(cfg_mod)
    b64, _ = cs.scene(64, cfg, dev)
    seeds = torch.arange(64, dtype=torch.int32, device=dev)
    e_ac, e_fast, mix = cs.synth_inputs(b64, cfg)
    C = cfg.radar.num_chirps
    sigma = float(cfg.radar.noise_power) ** 0.5
    dw, impl = cfg.doppler_window, cfg.noise_impl
    det = detect_peaks_from_power(
        sp.scatterer_power(e_ac, e_fast, seeds, mix, C, sigma,
                           doppler_window=dw, noise_impl=impl),
        cfg.radar, cfg.detection)
    sig, _ = cs.cube_signals(64, cfg, dev, 0)
    rds = rds_op.rds_fused_reference(sig, mix, True, dw)
    d = cfg.detection
    kw = dict(threshold_db=d.threshold_db, neighborhood=d.neighborhood,
              train=d.cfar_train_cells, guard=d.guard_cells,
              offset_db=d.cfar_offset_db)
    args, prm = cs.kernel_inputs(b64, cfg, seeds)
    fns = {
        "K1": lambda: fe.frontend_kernel_split(*args, prm),
        "K4": lambda: sp.scatterer_power(e_ac, e_fast, seeds, mix, C, sigma,
                                         doppler_window=dw, noise_impl=impl),
        "K5": lambda: sp.scatterer_signatures(
            e_ac, e_fast, seeds, det.range_bin, det.doppler_bin, mix, C,
            sigma, doppler_window=dw, noise_impl=impl),
        "K7": lambda: power.rds_power_fused(sig, mix, True, dw),
        "K8": lambda: rds_op.rds_fused(sig, mix, True, dw),
        "K10": lambda: cfar.cfar_mask(rds, **kw),
    }
    out, dev_ms = {}, {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        out[name] = min(cs.cuda_time_ms(torch, fn, 20) for _ in range(3))
        per = cs.kernel_profile(torch, lambda: [fn() for _ in range(10)])
        dev_ms[name] = {k: v / 10 for k, v in per.items()}
    print(json.dumps({"tree": sys.argv[1], "ms_per_64f": out,
                      "device_ms_per_64f": dev_ms,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
