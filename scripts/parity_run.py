"""Golden parity run: Temperature_Pore at full reference scale vs the
committed reference artifact.

Runs the default temperature-pore workload (557,649 molecules, reference
constants, seed 17) for the same number of steps as the committed
reference momentum_energy.csv (250), writes our CSV, and compares the
per-step momentum / energy-transfer statistics.  Bitwise parity is
impossible (different RNG streams; BASELINE.json asks for statistical
tolerance under fixed seeds), so the comparison is on the distributional
statistics of the 250-step ledgers.

Usage (GPU host):  python scripts/parity_run.py [--steps 250] [--out PARITY.md]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--out", type=str, default="PARITY.md")
    ap.add_argument("--reference-csv", type=str,
                    default=os.path.join(
                        "runs", "matched_golden", "reference_run",
                        "momentum_energy.csv"))
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args()

    import jax

    import argon_monte_carlo_tpu as amc
    from argon_monte_carlo_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    from argon_monte_carlo_tpu.io import writers

    cfg = amc.temperature_pore_config(
        engine=amc.EngineConfig(dtype=args.dtype, broadphase="cells",
                                steps_per_epoch=50),
    )
    n = cfg.num_molecules
    print(f"parity run: N={n} steps={args.steps} "
          f"device={jax.devices()[0].device_kind}", file=sys.stderr)
    sim = amc.Simulation(amc.make_workload(cfg))
    t0 = time.time()
    state, measure, metrics = sim.run(num_steps=args.steps)
    jax.block_until_ready(state.pos)
    elapsed = time.time() - t0
    print(f"ran in {elapsed:.1f}s", file=sys.stderr)

    ours = {
        "Momentum": np.asarray(metrics.momentum_z, np.float64),
        "EnergyCold": np.asarray(metrics.energy_cold, np.float64),
        "EnergyHot": np.asarray(metrics.energy_hot, np.float64),
    }
    writers.write_momentum_energy_csv(
        ours["Momentum"], ours["EnergyCold"], ours["EnergyHot"],
        "parity_momentum_energy.csv",
    )

    import pandas as pd

    ref = pd.read_csv(args.reference_csv, index_col=0)
    rows = []
    verdicts = []
    for col in ("Momentum", "EnergyCold", "EnergyHot"):
        r = ref[col].to_numpy()[: args.steps]
        o = ours[col][: len(r)]
        mean_r, mean_o = r.mean(), o.mean()
        std_r, std_o = r.std(), o.std()
        # Standard error of each mean; agreement within ~4 combined SE.
        se = np.sqrt(std_r**2 / len(r) + std_o**2 / len(o))
        z = abs(mean_o - mean_r) / se if se > 0 else np.inf
        ok = z < 4.0 and 0.5 < (std_o / std_r) < 2.0
        verdicts.append(ok)
        rows.append((col, mean_r, mean_o, std_r, std_o, z, ok))

    with open(args.out, "w") as f:
        f.write("# PARITY — Temperature_Pore vs reference "
                "momentum_energy.csv\n\n")
        f.write(f"- reference artifact: `{args.reference_csv}` "
                f"(250 committed steps)\n")
        f.write(f"- our run: N={n}, steps={args.steps}, seed={cfg.seed}, "
                f"dtype={args.dtype}, device="
                f"{jax.devices()[0].device_kind}, {elapsed:.1f}s\n")
        f.write("- comparison: per-step ledger statistics; z = "
                "|mean difference| / combined standard error "
                "(runs use independent RNG streams, so agreement is "
                "statistical, per BASELINE.json)\n\n")
        f.write("| series | ref mean | ours mean | ref std | ours std "
                "| z | verdict |\n|---|---|---|---|---|---|---|\n")
        for col, mr, mo, sr, so, z, ok in rows:
            f.write(f"| {col} | {mr:.4e} | {mo:.4e} | {sr:.4e} "
                    f"| {so:.4e} | {z:.2f} | "
                    f"{'PASS' if ok else 'FAIL'} |\n")
        f.write(f"\nOur per-step CSV: `parity_momentum_energy.csv`.\n")
    print(json.dumps({
        "all_pass": bool(all(verdicts)),
        "z_scores": {r[0]: float(r[5]) for r in rows},
    }))
    print(open(args.out).read(), file=sys.stderr)
    return 0 if all(verdicts) else 1


if __name__ == "__main__":
    sys.exit(main())
