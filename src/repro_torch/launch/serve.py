"""Serving launcher: batched prefill + greedy decode, on the card unless
``--device`` says otherwise, for any of the ten archs.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu] [--seed 0]

The archs that read media (llama-3.2-vision-90b's image patches,
whisper-large-v3's audio frames) get ``synthetic_batch``'s. Whisper's
decoder caches hold 448 positions, its context, so its prompt and generated
tokens must fit in them.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params, uses_media
from repro_torch.serving.cache import cache_bytes, make_caches
from repro_torch.serving.engine import greedy_generate

#: Whisper's decoder context: the length of its self-attention caches
DECODER_MAX_LEN = 448


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    max_len = args.prompt_len + args.gen
    if cfg.n_enc_layers:
        if max_len > DECODER_MAX_LEN:
            ap.error(f"{cfg.name}: --prompt-len + --gen = {max_len} passes "
                     f"the decoder's {DECODER_MAX_LEN} positions")
        max_len = DECODER_MAX_LEN
    model = init_params(cfg, args.seed, device)
    caches = make_caches(cfg, args.batch, max_len=max_len, device=device)
    print(f"[serve] {cfg.name}: cache {cache_bytes(caches)/2**20:.1f} MiB "
          f"for B={args.batch} L={max_len}")
    batch = synthetic_batch(cfg, 0, args.prompt_len, args.batch, device=device)
    if uses_media(cfg):
        print(f"[serve] media {tuple(batch['media'].shape)}")
    t0 = time.perf_counter()
    out = greedy_generate(model, batch["tokens"], caches, args.gen,
                          media=batch.get("media"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"[serve] generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s on {device}, no compile)")
    print("[serve] sample tokens:", out[0, :12].tolist())


if __name__ == "__main__":
    main()
