"""The reference's §Perf variants (``repro/launch/perf.py``), priced by
``launch/dryrun.py``:

* A: command-r-plus-104b × ``train_4k`` (the most collective-bound): A1
  flat-head attention, A2 A1 without ``seq_shard``, A3 A1 with
  ``grad_compress``, A4 A1 without remat;
* B: qwen3-moe-235b-a22b × ``decode_32k`` (the worst roofline fraction):
  B1 the weight-stationary ``serve`` specs, B2 B1 with flat heads, B3 B1
  with ``capacity_factor`` 1.0;
* C: the GraphD superstep: C1 the compact wire (``recoded_compact``: a
  bf16 value and an int8 flag a slot, one all_to_all hop), C2 4x larger
  edge blocks (16384), C3 both.

    PYTHONPATH=src python -m repro_torch.launch.perf A1 [A2 ... B3 C1 ...]
        [--link-bytes-per-s RATE] [--out perf_results.json]

Each record goes to ``--out``, replacing one of the same variant.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.launch.dryrun import run_cell, run_graphd_cell


def variant_A(tag: str, *, link_bytes_per_s: float | None = None):
    """command-r-plus-104b x train_4k (most collective-bound)."""
    from repro_torch.configs import get_config

    if tag not in ("A1", "A2", "A3", "A4"):
        raise KeyError(tag)
    cfg = get_config("command-r-plus-104b")
    if tag == "A2":  # A1 + no sequence sharding of the residual stream
        cfg = dataclasses.replace(cfg, seq_shard=False)
    elif tag == "A3":  # A1 + int8 error-feedback gradient compression
        cfg = dataclasses.replace(cfg, grad_compress=True)
    elif tag == "A4":  # A1 + no remat (operations down, activations up)
        cfg = dataclasses.replace(cfg, remat=False)
    # A1: flat heads, the O(S^2) logits sharded 16-way
    return run_cell("command-r-plus-104b", "train_4k", multi_pod=False,
                    cfg=cfg, variant=tag, link_bytes_per_s=link_bytes_per_s,
                    flat_heads=True)


def variant_B(tag: str, *, link_bytes_per_s: float | None = None):
    """qwen3-moe-235b-a22b x decode_32k (worst roofline fraction); every B
    variant takes the weight-stationary ``serve`` specs."""
    from repro_torch.configs import get_config

    if tag not in ("B1", "B2", "B3"):
        raise KeyError(tag)
    cfg = get_config("qwen3-moe-235b-a22b")
    if tag == "B3":  # B1 + tighter expert capacity (decode batch routing)
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    return run_cell("qwen3-moe-235b-a22b", "decode_32k", multi_pod=False,
                    cfg=cfg, param_mode="serve", variant=tag,
                    link_bytes_per_s=link_bytes_per_s,
                    flat_heads=tag == "B2")  # B1 + flat heads


def variant_C(tag: str, *, link_bytes_per_s: float | None = None):
    """graphd-pagerank superstep (the paper's own technique)."""
    kw = dict(link_bytes_per_s=link_bytes_per_s, variant=tag)
    if tag == "C1":  # compact wire: bf16 msgs + int8 flags, one-hop a2a
        return run_graphd_cell(False, mode="recoded_compact", **kw)
    if tag == "C2":  # 4x larger edge blocks (streaming granularity B, §3.2)
        return run_graphd_cell(False, edge_block=16384, **kw)
    if tag == "C3":  # compact wire + big blocks
        return run_graphd_cell(False, mode="recoded_compact",
                               edge_block=16384, **kw)
    raise KeyError(tag)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.perf")
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--link-bytes-per-s", type=float, default=None)
    ap.add_argument("--out", default="perf_results.json")
    args = ap.parse_args(argv)
    fns = {"A": variant_A, "B": variant_B, "C": variant_C}

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for tag in args.cells:
        print(f"[perf] running variant {tag} ...", flush=True)
        rec = fns[tag[0]](tag, link_bytes_per_s=args.link_bytes_per_s)
        results = [r for r in results if r.get("variant") != tag]
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(json.dumps(
            {k: rec[k] for k in (
                "variant", "flops_per_chip", "bytes_per_chip",
                "collective_bytes_per_chip", "t_compute_s", "t_memory_s",
                "t_collective_s", "dominant", "roofline_fraction",
            ) if k in rec},
            indent=1,
        ), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
