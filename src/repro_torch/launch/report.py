"""Regenerate the dry-run + roofline tables from a directory of dry-run
results.

    PYTHONPATH=src python -m repro_torch.launch.report RESULTS_DIR \
        [--md EXPERIMENTS.md]

Port of `repro.launch.report`: the same tables from the same file names
(`dryrun_singlepod.json`, `dryrun_multipod*.json`, `fit_recheck*.json`,
as `launch.dryrun --out` writes them), read from RESULTS_DIR.  With
`--md` the tables replace what follows the `<!-- DRYRUN_TABLE -->` and
`<!-- ROOFLINE_TABLE -->` markers of that file, as the reference does in
EXPERIMENTS.md; without it they are printed.  One difference: a fit peak
is flagged against the card's memory (`hw.H100_SXM.hbm_capacity`, 80 GB),
where the reference flags 16 GiB, a v5e chip's.
"""

from __future__ import annotations

import argparse
import json
import os

from .. import hw


def _load(results: str, path: str):
    p = os.path.join(results, path)
    if not os.path.exists(p):
        return []
    with open(p) as f:
        return json.load(f)


def _gib(b):
    return f"{b / 2**30:.2f}"


def _fit_overrides(results: str) -> dict:
    """Latest re-measured fit peaks from the §Perf iterations."""
    out = {}
    for path in ("fit_recheck.json", "fit_recheck3.json",
                 "fit_recheck4.json"):
        for r in _load(results, path):
            for k in ("fit2_peak_gib", "fit3_peak_gib"):
                if k in r:
                    out[(r["arch"], r["shape"])] = r[k] * 2**30
    return out


def dryrun_table(results: str) -> str:
    single = _load(results, "dryrun_singlepod.json")
    fit_fix = _fit_overrides(results)
    multi = _load(results, "dryrun_multipod.json") \
        + _load(results, "dryrun_multipod_fix1.json") \
        + _load(results, "dryrun_multipod_fix2.json")
    multi_ok = {}
    for r in multi:
        key = (r["arch"], r["shape"])
        status = "✓" if "roofline" in r or "memory" in r else (
            "skip" if "skipped" in r else "FAIL")
        # later entries (fix reruns) override earlier failures
        if multi_ok.get(key) in (None, "FAIL") or status == "✓":
            multi_ok[key] = status

    lines = ["| arch | shape | 16×16 compile | fit peak/chip (GiB) | "
             "fit mb | 2×16×16 |",
             "|---|---|---|---|---|---|"]
    for r in single:
        key = (r["arch"], r["shape"])
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | skip (full attn @500k) "
                         f"| – | – | {multi_ok.get(key, 'skip')} |")
            continue
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | **FAIL** | – | – | "
                         f"{multi_ok.get(key, '?')} |")
            continue
        fm = r.get("fit_memory", r.get("memory", {}))
        peak_b = fit_fix.get(key, fm.get("peak_bytes", 0))
        peak = _gib(peak_b) if fm or key in fit_fix else "–"
        if peak_b > hw.H100_SXM.hbm_capacity:
            peak += " ⚠"
        mb = str(r.get("fit_microbatches", "–"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | ✓ {r.get('compile_s', 0):.0f}s "
            f"| {peak} | {mb} | {multi_ok.get(key, '?')} |")
    return "\n".join(lines)


def roofline_table(results: str) -> str:
    single = _load(results, "dryrun_singlepod.json")
    lines = ["| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
             "bound | useful | rf |",
             "|---|---|---|---|---|---|---|---|"]
    for r in single:
        if "roofline" not in r:
            continue
        rl = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {rl['t_compute_s'] * 1e3:.1f} | {rl['t_memory_s'] * 1e3:.1f} "
            f"| {rl['t_collective_s'] * 1e3:.2f} | {rl['bottleneck']} "
            f"| {rl['useful_ratio']:.3f} | {rl['roofline_fraction']:.4f} |")
    return "\n".join(lines)


def inject(md_path: str, marker: str, content: str):
    with open(md_path) as f:
        text = f.read()
    tag = f"<!-- {marker} -->"
    start = text.index(tag)
    end = text.find("\n## ", start)
    if end == -1:
        end = len(text)
    text = text[:start] + tag + "\n\n" + content + "\n\n" + text[end:]
    with open(md_path, "w") as f:
        f.write(text)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("results", help="directory of the dry-run's JSON files")
    ap.add_argument("--md", default=None,
                    help="markdown file whose marked tables to replace")
    args = ap.parse_args(argv)
    tables = {"DRYRUN_TABLE": dryrun_table(args.results),
              "ROOFLINE_TABLE": roofline_table(args.results)}
    if args.md is None:
        print("\n\n".join(tables.values()))
        return
    for marker, content in tables.items():
        inject(args.md, marker, content)
    print(f"{args.md} tables regenerated")


if __name__ == "__main__":
    main()
