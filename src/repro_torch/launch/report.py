"""Render dry-run results (``launch/dryrun.py``'s JSON) as the dry-run and
roofline tables: the reference's formatting (``repro/launch/report.py``).
The port's records have no compile time (nothing is compiled; the column
shows "–") and may have no collective term (no link rate: "–").

    PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.json
"""

from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    if b >= 2**30:
        return f"{b/2**30:.2f} GiB"
    if b >= 2**20:
        return f"{b/2**20:.1f} MiB"
    return f"{b/2**10:.0f} KiB"


def fmt_t(s):
    if s is None:
        return "–"
    if s == 0:
        return "0"
    if s < 1e-3:
        return f"{s*1e6:.0f} µs"
    if s < 1:
        return f"{s*1e3:.1f} ms"
    return f"{s:.2f} s"


def dryrun_table(results):
    lines = [
        "| arch | shape | mesh | compile | per-chip args | HLO FLOPs/chip | "
        "HLO bytes/chip | collective B/chip |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if r.get("skipped"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"SKIP ({r['reason'].split(' — ')[0]}) | – | – | – | – |"
            )
            continue
        if not r.get("ok"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"**FAIL** | – | – | – | – |"
            )
            continue
        compile_s = f"{r['compile_s']}s" if "compile_s" in r else "–"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{compile_s} | {fmt_bytes(r['argument_bytes'])} | "
            f"{r['flops_per_chip']:.3g} | {r['bytes_per_chip']:.3g} | "
            f"{r['collective_bytes_per_chip']:.3g} |"
        )
    return "\n".join(lines)


def roofline_table(results):
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | dominant | "
        "useful/HLO FLOPs | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if not r.get("ok"):
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_t(r['t_compute_s'])} | "
            f"{fmt_t(r['t_memory_s'])} | {fmt_t(r['t_collective_s'])} | "
            f"**{r['dominant']}** | {r['useful_flops_ratio']:.3f} | "
            f"{r['roofline_fraction']:.4f} |"
        )
    return "\n".join(lines)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    with open(path) as f:
        results = json.load(f)
    results.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    for mesh in sorted({r["mesh"] for r in results}):
        print(f"### Dry-run ({mesh})\n")
        print(dryrun_table([r for r in results if r["mesh"] == mesh]))
        print(f"\n### Roofline ({mesh})\n")
        print(roofline_table([r for r in results if r["mesh"] == mesh]))
        print()


if __name__ == "__main__":
    main()
