"""The reference's §Perf variants of the GraphD dry-run cell
(``repro/launch/perf.py::variant_C``), priced by ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.perf C1 [C2 C3]

C1 is the compact wire (``recoded_compact``: a bf16 value and an int8 flag
a slot, one all_to_all hop), C2 4x larger edge blocks (16384), C3 both.
Each record goes to ``perf_results.json`` (``--out``), replacing one of the
same variant. The A and B variants are language-model cells and wait for
ROADMAP item 12.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import run_graphd_cell


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
    for tag in args.cells:
        if tag[:1] in ("A", "B"):
            raise NotImplementedError(
                f"variant {tag}: the language-model variants wait for "
                "ROADMAP item 12; the port runs the C variants only")

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for tag in args.cells:
        print(f"[perf] running variant {tag} ...", flush=True)
        rec = variant_C(tag, link_bytes_per_s=args.link_bytes_per_s)
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
