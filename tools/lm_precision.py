#!/usr/bin/env python3
"""How far bf16 arithmetic moves gemma3-12b's serving logits, on one GPU:
the bf16 decode and the bf16 ``forward`` each against the float32 forward
of the same weights (the bf16 ones, upcast), and the float32 decode against
it (the ring at full width and depth, 1,100-token prompts past the 1,024
window), step by step; then one bf16 decode step under ``torch.profiler``.

    python3 tools/lm_precision.py [--seed 0] [--prompt 1100] [--gen 32]
"""

from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--prompt", type=int, default=1100)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    import chip_smoke as cs

    gpus = cs.machine_gpus()
    if not gpus:
        print("lm_precision: no GPU on this machine", file=sys.stderr)
        return 1
    os.environ["CUDA_VISIBLE_DEVICES"] = gpus[0]
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.serving.engine import greedy_generate
    from repro_torch.serving.cache import make_caches

    if not torch.cuda.is_available():
        print("lm_precision: no CUDA device", file=sys.stderr)
        return 1
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(power)
    B, S, G = args.batch, args.prompt, args.gen
    cfg = get_config("gemma3-12b")
    model = init_params(cfg, args.seed, "cuda")
    prompt = synthetic_batch(cfg, 0, S, B, device="cuda")["tokens"]
    tokens = greedy_generate(model, prompt, make_caches(cfg, B, S + G, "cuda"), G)
    full = torch.cat([prompt, tokens], 1)
    t0 = time.perf_counter()

    def run(m):
        """Per-step logits of prefill + decode (fed the greedy tokens) and
        forward's at the same positions, on the CPU."""
        dec = torch.stack(cs.lm_logits(m, full, S, G - 1, "cuda"), 1).cpu()
        fwd = m(full[:, :S + G - 1])[:, S - 1:].cpu()
        return dec, fwd

    bf_dec, bf_fwd = run(model)
    prof = cs.profile_decode_step(
        model, make_caches(cfg, B, S + G, "cuda"), tokens[:, :1], 0)
    host = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = Transformer(cfg32, {k: v.to("cuda", torch.float32)
                                  for k, v in host.items()})
    del host
    f_dec, f_fwd = run(model32)

    def gaps(a, b):
        return [round(float((a[:, i] - b[:, i]).abs().max()), 6)
                for i in range(a.shape[1])]

    top = float(f_fwd.abs().max())
    out = {
        "max_logit_f32": top,
        "bf16_decode_vs_bf16_forward": gaps(bf_dec, bf_fwd),
        "bf16_decode_vs_f32_forward": gaps(bf_dec, f_fwd),
        "bf16_forward_vs_f32_forward": gaps(bf_fwd, f_fwd),
        "f32_decode_vs_f32_forward": gaps(f_dec, f_fwd),
        "argmax_agree_bf16_decode_f32": float(
            (bf_dec.argmax(-1) == f_fwd.argmax(-1)).float().mean()),
        "argmax_agree_bf16_forward_f32": float(
            (bf_fwd.argmax(-1) == f_fwd.argmax(-1)).float().mean()),
        "profile_decode_step": prof,
        "seconds": time.perf_counter() - t0,
    }
    print("lm_precision " + json.dumps(out))
    for k, v in out.items():
        if isinstance(v, list):
            print(f"{k}: max {max(v):.6g} first {v[0]:.6g} median "
                  f"{sorted(v)[len(v) // 2]:.6g}")
    print(f"card {power}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
