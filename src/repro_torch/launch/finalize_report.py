"""Render the dry-run records as the reference's report sections
(``repro/launch/finalize_report.py``): the dry-run tables of one pod, of
two pods and of the GraphD cell, then the roofline tables.

    PYTHONPATH=src python -m repro_torch.launch.finalize_report
        [--results dryrun_results.json] [--doc PATH]

With ``--doc`` the sections replace the ``<!-- DRYRUN_TABLES -->`` and
``<!-- ROOFLINE_TABLES -->`` markers of that document; without it they
are printed.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.launch.report import dryrun_table, roofline_table

DRYRUN_MARK = "<!-- DRYRUN_TABLES -->"
ROOFLINE_MARK = "<!-- ROOFLINE_TABLES -->"


def sections(results: list) -> tuple[str, str]:
    """The dry-run and roofline sections of the records: the LM cells by
    mesh, the GraphD cells (``arch`` ``graphd-...``) apart."""
    results = sorted(results, key=lambda r: (r["mesh"], r["arch"],
                                             r["shape"]))
    gd = [r for r in results if r["arch"].startswith("graphd-")]
    single = [r for r in results if r["mesh"] == "singlepod"]
    multi = [r for r in results if r["mesh"] == "multipod"]
    lm = single + multi
    ok = [r for r in lm if r.get("ok")]
    skipped = [r for r in lm if r.get("skipped")]
    failed = len(lm) - len(ok) - len(skipped)
    big = [f"{r['arch']} × {r['shape']} ({r['mesh']})" for r in ok
           if not r.get("fits")]
    dr = (
        "### Dry-run (single pod, 16×16 = 256 GPUs)\n\n"
        + dryrun_table(single)
        + "\n\n### Dry-run (multi-pod, 2×16×16 = 512 GPUs)\n\n"
        + dryrun_table(multi)
        + "\n\n### Dry-run — GraphD (the paper's system, flat machine ring)\n\n"
        + dryrun_table(gd)
        + f"\n\n{len(ok)} LM cells priced, {len(skipped)} declared skips "
        "(long_500k × pure full attention), "
        f"{failed} failed. Nothing is compiled (compile: –): the counts "
        "are the port's, from the shapes. Per-GPU arguments are exact "
        "(sharded parameters, optimizer state, caches and inputs); "
        "`peak_bytes_model` adds the reference's activation model. "
        + (f"Past the H100's 80 GB: {', '.join(big)}.\n" if big
           else "Every cell fits the H100's 80 GB.\n")
    )
    rf = (
        "### Roofline (single pod; seconds a step a GPU)\n\n"
        + roofline_table(single)
        + "\n\n### Roofline (multi-pod)\n\n"
        + roofline_table(multi)
        + "\n\n### Roofline — GraphD\n\n"
        + roofline_table(gd)
        + "\n\nAt the H100 SXM data sheet's rates (989 TFLOP/s dense bf16, "
        "67 TFLOP/s float32, 3.35 TB/s HBM3); the collective term (–) "
        "needs a measured link rate (`--link-bytes-per-s`).\n"
    )
    return dr, rf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.finalize_report")
    ap.add_argument("--results", default="dryrun_results.json")
    ap.add_argument("--doc", default=None,
                    help="a document whose markers the tables replace; "
                         "none: print them")
    args = ap.parse_args(argv)
    with open(args.results) as f:
        results = json.load(f)
    dr, rf = sections(results)
    if args.doc is None:
        print(dr + "\n" + rf)
        return 0
    with open(args.doc) as f:
        txt = f.read()
    missing = [m for m in (DRYRUN_MARK, ROOFLINE_MARK) if m not in txt]
    if missing:
        raise SystemExit(f"{args.doc}: no {' or '.join(missing)}")
    txt = txt.replace(DRYRUN_MARK, dr).replace(ROOFLINE_MARK, rf)
    with open(args.doc, "w") as f:
        f.write(txt)
    print(f"{args.doc} updated: {len(results)} records")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
