#!/usr/bin/env python3
"""Some phases of chip_smoke.py on the card, without the rest of the script:

    python3 tools/torch_smoke_phases.py 8b 18 19

``8b``: the textured frame with normal maps and material fBm against the
CPU path (``run_tbn_fbm_check``). ``18``: env-axis sharding
(``run_sharding_phase``) from phase 5's world after its driven run (64
envs × 256², 11 frames of ``step_and_render``); on a machine with several
cards the phase also runs over every card. ``19``: bench_torch.py through
its harness (``run_bench_phase``: kernel_parity, then a run the budget
cuts to the headline and the cheapest configs). Builds the kernels first
and prints the card's name and power limit; exits non-zero on a failed
check.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402

PHASES = ("8b", "18", "19")


def main(argv) -> int:
    import torch

    phases = argv or list(PHASES)
    unknown = set(phases) - set(PHASES)
    if unknown or not torch.cuda.is_available():
        print(f"usage: torch_smoke_phases.py [{' '.join(PHASES)}] (on a "
              f"CUDA card); unknown {sorted(unknown)}", file=sys.stderr)
        return 2
    from clap_tpu_torch import cuda_build

    dev, smi = CS.setup_card()
    CS.log(f"{smi}; {torch.cuda.device_count()} card(s), torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    cuda_build.build_all()
    sync = torch.cuda.synchronize
    checks = CS.parity_checks(sync)
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "8b":
            CS.run_tbn_fbm_check(dev, smi, CS.require, *checks)
        elif phase == "19":
            CS.run_bench_phase(smi)
        else:
            w = CS.build_slice(dev)
            d = CS.drive_frames(w, sync, CS.require)
            flag = dict(w=w, gs=CS.to_device(d["gs"], "cpu"),
                        static=CS.to_device(d["static"], "cpu"), frame=11)
            del d
            CS.run_sharding_phase(dev, smi, CS.require, *checks, flag)
        CS.log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    CS.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
