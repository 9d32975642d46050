#!/usr/bin/env python3
"""chip_smoke.py's LM phases alone, on one GPU.

    python3 tools/lm_phase.py [--seed 0] [--phase 16 | 17 | 18 | 19 | 16,17]

Narrows its own process to the first GPU the machine gives it, as the smoke
does, prints the card's name and power limit, then runs phase 16
(gemma3-12b: (a) one full-width pattern group in float32, the card against
the CPU; (b) the full model in bf16 serving 4 requests of 1,100-token
prompts) and/or phase 17 (the same for deepseek-v2-lite-16b, mamba2-2.7b,
hymba-1.5b, whisper-large-v3 and llama-3.2-vision-90b) and/or phase 18
(training: (a) one full-width pattern group of minitron-4b, deepseek-v2-
lite-16b and mamba2-2.7b, gradients on the card against the CPU; (b)
minitron-4b at full width and depth taking 5 AdamW steps, twice) and/or
phase 19 (the train step on a (2, 4) mesh of gloo ranks sharing the card,
against this process's: minitron-4b, then one group each of
deepseek-v2-lite-16b, mamba2-2.7b and whisper-large-v3; and NCCL x1 at
(1, 1)). Needs no kernel build.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", default="16",
                    help="16, 17, 18, 19 or a list such as 16,17 "
                    "(default 16)")
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    import chip_smoke as cs

    gpus = cs.machine_gpus()
    if not gpus:
        print("lm_phase: no GPU on this machine", file=sys.stderr)
        return 1
    os.environ["CUDA_VISIBLE_DEVICES"] = gpus[0]
    import torch

    if not torch.cuda.is_available():
        print("lm_phase: no CUDA device", file=sys.stderr)
        return 1
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(power)
    for phase in args.phase.split(","):
        t0 = time.perf_counter()
        if phase == "16":
            cs.phase_lm(args.seed, power)
        elif phase == "17":
            cs.phase_lm_kinds(args.seed, power)
        elif phase == "18":
            cs.phase_lm_train(args.seed, power)
        elif phase == "19":
            cs.phase_lm_mesh(args.seed, power)
        else:
            ap.error(f"--phase: {phase!r} is not 16, 17, 18 or 19")
        print(f"phase {phase} {time.perf_counter() - t0:.1f} s; card {power}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
