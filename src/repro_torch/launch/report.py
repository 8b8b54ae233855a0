"""§Dry-run and §Roofline tables from ``results/`` (the port's
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report

Reads the port's records (``results/torch/{dryrun,roofline}``) by
default; a record of either package renders (the reference's
``flops_per_device_hlo`` and ``compile_s`` where the port's
``flops_per_device_trace`` and ``trace_s`` are missing).
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import ARCHS, SKIPPED_CELLS, get_config, shapes_for

ROOT = Path(__file__).resolve().parents[3]
DRY = ROOT / "results" / "torch" / "dryrun"
ROOF = ROOT / "results" / "torch" / "roofline"


def _load(path):
    return json.loads(path.read_text()) if path.exists() else None


def _either(d: dict, *keys):
    return next((d[k] for k in keys if k in d), None)


def dryrun_table(tag="baseline") -> str:
    rows = ["| arch | shape | mesh | peak GiB/dev | GFLOPs/dev "
            "| collective MB/dev | trace (compile) s |",
            "|---|---|---|---|---|---|---|"]
    for arch in ARCHS:
        for shape in shapes_for(get_config(arch)):
            for mesh in ("16x16", "2x16x16"):
                r = _load(DRY / arch / shape.name / f"{mesh}.{tag}.json")
                if r is None:
                    rows.append(f"| {arch} | {shape.name} | {mesh} | "
                                "MISSING | | | |")
                    continue
                m = r["memory"]["peak_estimate_per_device"] / 2**30
                fl = _either(r["cost"], "flops_per_device_trace",
                             "flops_per_device_hlo") / 1e9
                cb = r["collectives"]["total_bytes"] / 2**20
                t = _either(r["times"], "trace_s", "compile_s")
                rows.append(f"| {arch} | {shape.name} | {mesh} | {m:.2f} | "
                            f"{fl:.1f} | {cb:.1f} | {t} |")
        for (a, s), why in SKIPPED_CELLS.items():
            if a == arch:
                rows.append(f"| {arch} | {s} | — | {why} | | | |")
    return "\n".join(rows)


def roofline_table(tag="baseline") -> str:
    hdr = ("| arch | shape | compute ms | memory ms | collective ms | "
           "dominant | MODEL_GFLOPs/dev | useful ratio | bound ms |")
    rows = [hdr, "|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCHS:
        for shape in shapes_for(get_config(arch)):
            r = _load(ROOF / arch / shape.name / f"16x16.{tag}.json")
            if r is None:
                rows.append(f"| {arch} | {shape.name} | MISSING | | | | | | |")
                continue
            t = r["terms"]
            rows.append(
                f"| {arch} | {shape.name} | {t['compute_s']*1e3:.3f} | "
                f"{t['memory_s']*1e3:.3f} | {t['collective_s']*1e3:.3f} | "
                f"{t['dominant']} | "
                f"{r['model_flops_per_device']/1e9:.1f} | "
                f"{r['useful_flops_ratio']:.2f} | "
                f"{t['step_lower_bound_s']*1e3:.3f} |")
    return "\n".join(rows)


if __name__ == "__main__":
    print("## §Dry-run\n")
    print(dryrun_table())
    print("\n## §Roofline\n")
    print(roofline_table())
