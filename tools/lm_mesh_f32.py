#!/usr/bin/env python3
"""Where a full-width MoE group's float32 gradients part, on one GPU.

    python3 tools/lm_mesh_f32.py [--arch deepseek-v2-lite-16b] [--seed 0]

One pattern group (``with_groups(1)``) at full width in float32, B 2 x S
1,024: the gradient pass in this process on the card, the same on this
process's CPU (the weights drawn on the card from ``--seed`` and copied),
and on gloo meshes sharing the card at (2, 4), (2, 1) and (1, 4). Prints,
for each pair, the six leaves farthest apart (each over its largest |g|
of the second), the losses and each MoE layer's dropped copies. It tells
a mesh's own error from the one-process run's. Needs no kernel build.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = ((2, 4), (2, 1), (1, 4))


def gaps(got: dict, want: dict, top: int = 6) -> list:
    out = []
    for k, w in want.items():
        a, b = got[k].float().cpu(), w.float().cpu()
        out.append((float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30), k))
    return sorted(out, reverse=True)[:top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    import chip_smoke as cs

    gpus = cs.machine_gpus()
    if not gpus:
        print("lm_mesh_f32: no GPU on this machine", file=sys.stderr)
        return 1
    os.environ["CUDA_VISIBLE_DEVICES"] = gpus[0]
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch.lm_mesh import TrainCase, run_lm_mesh_cases

    if not torch.cuda.is_available():
        print("lm_mesh_f32: no CUDA device", file=sys.stderr)
        return 1
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(power)
    full = get_config(args.arch)
    cfg = dataclasses.replace(full.with_groups(1), dtype=torch.float32)
    batch = synthetic_batch(full, 0, 1024, 2, device="cpu")
    card = cs._one_process(cfg, args.seed, batch, grads=True)
    cpu = cs._cpu_grads(cfg, args.seed, batch)
    print(f"{cfg.name} float32: card pass loss {card['loss']!r} dropped "
          f"{card['dropped']}; CPU pass loss {cpu['loss']!r} dropped "
          f"{cpu['dropped']} ({cpu['seconds']:.1f} s)")
    print(f"card pass against the CPU pass: {gaps(card['grads'], cpu['grads'])}")
    for shape in SHAPES:
        t0 = time.perf_counter()
        res = run_lm_mesh_cases(
            [TrainCase(cfg, args.seed, batch, steps=0, keep=("grads",))],
            shape, device="cuda", backend="gloo", timeout=300).results[0]
        m = res.grads_metrics
        print(f"{shape} gloo: loss {m['loss']!r} dropped {m.get('dropped')} "
              f"({time.perf_counter() - t0:.1f} s)")
        print(f"{shape} against the card pass: "
              f"{gaps(res.grads, card['grads'])}")
        print(f"{shape} against the CPU pass: {gaps(res.grads, cpu['grads'])}")
    print(f"card {power}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
