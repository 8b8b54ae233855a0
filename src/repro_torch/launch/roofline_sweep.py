"""Roofline sweep over every (arch × shape) cell on the single-pod mesh
(16 × 16), through the probes (the port's ``repro.launch.roofline_sweep``).

    PYTHONPATH=src python -m repro_torch.launch.roofline_sweep [--arch A]

Records go to ``results/torch/roofline``; a cell already there is skipped.
"""
from __future__ import annotations

import argparse
import traceback

from repro_torch.configs import ARCHS, get_config, shapes_for
from repro_torch.launch.roofline import RESULTS, analyze_cell


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="roofline probe sweep (single-pod mesh)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu on a host without "
                         "CUDA)")
    args = ap.parse_args(argv)

    archs = (args.arch,) if args.arch else ARCHS
    failures = []
    for arch in archs:
        for shape in shapes_for(get_config(arch)):
            out = RESULTS / arch / shape.name / f"16x16.{args.tag}.json"
            if out.exists():
                print(f"[skip-cached] {arch} × {shape.name}")
                continue
            print(f"[roofline] {arch} × {shape.name} ...", flush=True)
            try:
                rec = analyze_cell(arch, shape.name, multi_pod=False,
                                   tag=args.tag, probes=True,
                                   device=args.device)
                t = rec["terms"]
                print(f"  compute={t['compute_s']*1e3:.2f}ms "
                      f"memory={t['memory_s']*1e3:.2f}ms "
                      f"coll={t['collective_s']*1e3:.2f}ms "
                      f"dom={t['dominant']} "
                      f"useful={rec['useful_flops_ratio']:.2f}", flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, shape.name, repr(e)))
                print(f"  FAIL: {e}\n{traceback.format_exc()}", flush=True)
    if failures:
        print(f"{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("roofline sweep complete")


if __name__ == "__main__":
    main()
