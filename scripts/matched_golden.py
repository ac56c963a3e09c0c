"""Matched-golden histogram parity: this engine vs the reference script
at one identical reduced configuration.

A patched copy of the reference's Temperature_Pore_MC.py (geometry
lengths scaled by ``--scale`` exactly as PoreGeometry.scaled, loop cut to
``--steps``, matplotlib headless; physics, dt, seeds and cell grid
untouched) was run on CPU; its outputs are committed under
``runs/matched_golden/reference_run/``.  This script runs the SAME
configuration through this engine and compares on equal footing:

    python scripts/matched_golden.py <ref_run_dir> <out_dir> \
        [--scale 0.35] [--steps 2500] [--ref-log <ref_run_dir>/run.log]

It writes <out_dir>/report.json plus this engine's 8 histogram files and
momentum CSV, and copies the reference-run files next to them.  The
comparison and its pass rules live in ``argon_monte_carlo_tpu.golden``
(per-axis histogram correlation >= 0.97, measured-MFP ratio within 3%).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ref_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--scale", type=float, default=0.35)
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--stage", default="temperature_pore",
                    choices=["temperature_pore", "pore"],
                    help="pore = Open_Air_Pore_MC (v1: all-specular "
                         "walls, no ledger CSV to compare)")
    ap.add_argument("--ref-log", default=None,
                    help="reference run log (for its printed MFP)")
    ap.add_argument("--reuse-ours", action="store_true",
                    help="skip the simulation if <out>/ours already "
                         "holds artifacts (compare-only rerun)")
    args = ap.parse_args()

    from argon_monte_carlo_tpu import golden
    from argon_monte_carlo_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(args.out_dir, exist_ok=True)
    ours_dir = os.path.join(args.out_dir, "ours")
    ref_copy = os.path.join(args.out_dir, "reference_run")
    os.makedirs(ours_dir, exist_ok=True)
    os.makedirs(ref_copy, exist_ok=True)

    energized = args.stage == "temperature_pore"
    summary_path = os.path.join(ours_dir, "summary.json")
    if args.reuse_ours and os.path.exists(summary_path):
        with open(summary_path) as f:
            summary = json.load(f)
    else:
        summary = golden.run_matched_config(
            ours_dir, scale=args.scale, steps=args.steps,
            dtype="float64", energized=energized)
        with open(summary_path, "w") as f:
            json.dump(summary, f, indent=2)
    n = golden.matched_config(args.scale, energized=energized).num_molecules
    print(f"matched golden[{args.stage}]: scale={args.scale} N={n} "
          f"steps={args.steps}", file=sys.stderr)

    for name in os.listdir(args.ref_dir):
        if name.startswith("hist_") or name == "momentum_energy.csv":
            shutil.copy(os.path.join(args.ref_dir, name), ref_copy)

    ref_mfp = None
    if args.ref_log and os.path.exists(args.ref_log):
        ref_mfp = golden.reference_mfp_from_log(args.ref_log)
    # The v1 pore reference keeps no ledger and writes no CSV
    # (Open_Air_Pore_MC.py:564-636), so only the temperature pore has
    # one to compare.
    report = {
        "config": {"scale": args.scale, "steps": args.steps,
                   "n": n, "dtype": "float64"},
        "ours": summary,
    }
    report.update(golden.compare_runs(ref_copy, ours_dir,
                                      summary["mfp_total"], ref_mfp,
                                      ledger=energized))
    with open(os.path.join(args.out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
