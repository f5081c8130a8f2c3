"""Roofline table of the dry-run records, on the card's constants.

The port of the reference's ``benchmarks/roofline.py``.  The primary
terms come from the analytic cost model (``runtime/cost_model.py``), as
there; the dry-run records add the fit check and the collective op
census (kinds and counts of the collectives one rank launches).

Run:  python -m repro_torch.workloads.roofline [--dir build/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs.base import SHAPES, cell_is_applicable, load_config
from ..runtime.cost_model import cost_for_cell
from ..runtime.sharding import PEAK_FLOPS_BF16


def load_records(dirpath: str = "build/dryrun",
                 include_variants: bool = False) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if r.get("variant") and not include_variants:
            continue  # §Perf variants are reported on their own
        recs.append(r)
    return recs


def fmt_seconds(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-6:
        return f"{x * 1e9:.1f}ns"
    if x < 1e-3:
        return f"{x * 1e6:.1f}us"
    if x < 1:
        return f"{x * 1e3:.2f}ms"
    return f"{x:.2f}s"


def analytic_row(arch: str, shape_name: str, n_pods: int = 1) -> dict:
    cfg = load_config(arch)
    shape = SHAPES[shape_name]
    if not cell_is_applicable(cfg, shape):
        return {"status": "skip"}
    c = cost_for_cell(cfg, shape, n_pods=n_pods)
    r = c.roofline()
    # MFU-style fraction: useful model flops against the time bound
    mult = 6 if shape.kind == "train" else 2
    N = (cfg.active_param_count() if cfg.moe is not None
         else cfg.param_count())
    toks = shape.global_batch * (1 if shape.kind == "decode"
                                 else shape.seq_len)
    chips = 256 * n_pods
    model_flops_chip = mult * N * toks / chips
    mfu_bound = model_flops_chip / PEAK_FLOPS_BF16 / r["bound_s"]
    return {"status": "ok", "cost": c, "roofline": r,
            "mfu_at_bound": mfu_bound}


def table(recs: list[dict], mesh: str = "16x16") -> str:
    n_pods = 2 if mesh == "2x16x16" else 1
    lines = [
        "| arch | shape | t_compute | t_memory | t_coll | dominant | "
        "roofline frac | coll ops | fits HBM |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skip":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"SKIP (full-attention @500k) | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"ERROR | — | — | — |")
            continue
        a = analytic_row(r["arch"], r["shape"], n_pods)
        rf = a["roofline"]
        coll_counts = r.get("coll", {}).get("count", {})
        coll_str = ",".join(f"{k.split('-')[0][:2]}{v}"
                            for k, v in coll_counts.items() if v)
        fit = r.get("fit", {})
        fits = fit.get("fits_hbm", "?")
        pods = fit.get("pods_needed")
        fitstr = ("yes" if fits else (f"needs {pods} pods" if pods
                                      else "no"))
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_seconds(rf['t_compute_s'])} "
            f"| {fmt_seconds(rf['t_memory_s'])} "
            f"| {fmt_seconds(rf['t_collective_s'])} "
            f"| {rf['dominant']} "
            f"| {a['mfu_at_bound']:.2f} "
            f"| {coll_str or '—'} "
            f"| {fitstr} |")
    return "\n".join(lines)


def summarize(recs: list[dict]) -> dict:
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == "16x16"]
    rows = {}
    for r in ok:
        rows[(r["arch"], r["shape"])] = analytic_row(r["arch"], r["shape"],
                                                     1)
    by_dom: dict[str, int] = {}
    for a in rows.values():
        d = a["roofline"]["dominant"]
        by_dom[d] = by_dom.get(d, 0) + 1
    worst = sorted(rows.items(), key=lambda kv: kv[1]["mfu_at_bound"])[:5]
    most_coll = sorted(
        rows.items(),
        key=lambda kv: -(kv[1]["roofline"]["t_collective_s"]
                         / (kv[1]["roofline"]["bound_s"] + 1e-12)))[:5]
    return {
        "cells_ok": len(ok),
        "dominant_histogram": by_dom,
        "worst_roofline_fraction": [
            (a, s, round(v["mfu_at_bound"], 3)) for (a, s), v in worst],
        "most_collective_bound": [(a, s) for (a, s), _ in most_coll],
    }


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m repro_torch.workloads.roofline",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", default="build/dryrun")
    args = p.parse_args(argv)
    recs = load_records(args.dir)
    if not recs:
        print("no dry-run records found — run repro_torch.launch.dryrun "
              "first")
        return {}
    print(table(recs, "16x16"))
    s = summarize(recs)
    print("\nsummary:", json.dumps(s, indent=1))
    return {"summary": s}


if __name__ == "__main__":
    main()
