"""Interleaved same-session A/B bench: decide sub-5% engine levers.

Two separate runs of the same program differ by more than a small
lever's effect (another card, another power limit, other neighbours on
the host), so a lever decided across runs is confounded.  This harness
removes the confound structurally:

* ONE process, ONE device session, both configs compiled up front;
* timed epochs interleaved in ABBA blocks (A B B A), so any drift
  that is linear within a block cancels exactly in the paired
  differences and slower drift cancels to first order;
* the statistic is the PAIRED per-block difference, reported with a
  t-based 95% confidence interval and an explicit decision rule:
  "B wins/loses" only when the CI excludes zero.

Usage (one process on the card; nothing else running there):

    AB_OVERRIDES_B='{"rebuild_occupancy_skip": true}' \
        python scripts/ab_bench.py chiprun_out/ab_occskip.json

Env:
    AB_PARTICLES   workload scale (default 1_000_000)
    AB_SPE         steps per timed epoch (default 48 = 6 K=8 windows)
    AB_BLOCKS      ABBA blocks (default 3 -> 6 pairs, 12 timed epochs)
    AB_OVERRIDES_A / AB_OVERRIDES_B
                   JSON dicts of EngineConfig field overrides; A
                   defaults to the shipping config.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Two-sided 97.5% Student-t quantiles, df 1..30 (then normal 1.96).
_T975 = [12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306,
         2.262, 2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120,
         2.110, 2.101, 2.093, 2.086, 2.080, 2.074, 2.069, 2.064,
         2.060, 2.056, 2.052, 2.048, 2.045, 2.042]


def t975(df: int) -> float:
    return _T975[df - 1] if 1 <= df <= 30 else 1.96


def main() -> int:
    out_path = sys.argv[1] if len(sys.argv) > 1 else "chiprun_out/ab.json"
    n_target = int(os.environ.get("AB_PARTICLES", 1_000_000))
    spe = int(os.environ.get("AB_SPE", 48))
    n_blocks = int(os.environ.get("AB_BLOCKS", 3))
    ov_a = json.loads(os.environ.get("AB_OVERRIDES_A", "{}"))
    ov_b = json.loads(os.environ.get("AB_OVERRIDES_B", "{}"))
    if ov_a == ov_b:
        print("ab_bench: AB_OVERRIDES_A == AB_OVERRIDES_B; nothing to "
              "compare", file=sys.stderr)
        return 2

    import jax

    import argon_monte_carlo_tpu as amc
    from argon_monte_carlo_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    t_start = time.time()

    def mark(msg):
        print(f"ab_bench: {msg} at +{time.time() - t_start:.1f}s",
              file=sys.stderr, flush=True)

    base = amc.EngineConfig(
        dtype="float32", broadphase="cells", steps_per_epoch=spe,
        hist_flush_interval=1, narrowphase="pairs", rebuild_interval=8,
    )
    arms = {}
    for name, ov in (("A", ov_a), ("B", ov_b)):
        eng = dataclasses.replace(base, **ov)
        cfg = amc.temperature_pore_config(engine=eng).scaled_to(n_target)
        sim = amc.Simulation(amc.make_workload(cfg))
        arms[name] = {"sim": sim, "cfg": cfg, "epochs": [], "step0": 0}
    n = arms["A"]["cfg"].num_molecules
    mark(f"N={n} spe={spe} blocks={n_blocks} "
         f"A={ov_a or 'shipping'} B={ov_b}")

    # Init both arms from the SAME key/state distribution, then warm
    # both programs (all compiles land before any timed epoch).
    for name in ("A", "B"):
        arm = arms[name]
        sim = arm["sim"]
        state, measure, key = sim.init()
        _ = float(state.pos[0, 0])
        mark(f"{name}: init done")
        t0 = time.time()
        state, measure, _ = sim.run(num_steps=spe, state=state,
                                    measure=measure, run_key=key)
        _ = float(state.pos[0, 0])
        mark(f"{name}: warmup (incl. compile) {time.time() - t0:.1f}s")
        arm.update(state=state, measure=measure, key=key, step0=spe)

    def timed_epoch(name: str) -> float:
        arm = arms[name]
        t0 = time.time()
        state, measure, _ = arm["sim"].run(
            num_steps=spe, state=arm["state"], measure=arm["measure"],
            run_key=arm["key"], start_step=arm["step0"],
        )
        _ = float(state.pos[:, 2].sum())  # device->host sync
        dt = time.time() - t0
        arm.update(state=state, measure=measure)
        arm["step0"] += spe
        arm["epochs"].append(dt)
        print(f"ab_bench: {name} epoch: {dt:.3f}s "
              f"({n * spe / dt:.4g} ps/s)", file=sys.stderr, flush=True)
        return dt

    # ABBA blocks -> 2 paired differences per block.
    pairs = []  # (tA, tB)
    for blk in range(n_blocks):
        a1 = timed_epoch("A")
        b1 = timed_epoch("B")
        b2 = timed_epoch("B")
        a2 = timed_epoch("A")
        pairs.append((a1, b1))
        pairs.append((a2, b2))

    diffs = [tb - ta for ta, tb in pairs]          # B slower => positive
    m = len(diffs)
    mean_d = sum(diffs) / m
    var_d = sum((d - mean_d) ** 2 for d in diffs) / (m - 1)
    se = math.sqrt(var_d / m)
    half = t975(m - 1) * se
    med_a = sorted(arms["A"]["epochs"])[len(arms["A"]["epochs"]) // 2]
    med_b = sorted(arms["B"]["epochs"])[len(arms["B"]["epochs"]) // 2]
    ps_a, ps_b = n * spe / med_a, n * spe / med_b
    rel = mean_d / med_a
    rel_half = half / med_a
    if mean_d + half < 0:
        verdict = "B_FASTER"
    elif mean_d - half > 0:
        verdict = "B_SLOWER"
    else:
        verdict = "UNDECIDED"

    result = {
        "metric": "interleaved A/B paired epoch difference "
                  f"(Temperature_Pore, {n_target} particles)",
        "particles": n,
        "steps_per_epoch": spe,
        "pairs": m,
        "overrides_A": ov_a,
        "overrides_B": ov_b,
        "epochs_A_sec": [round(t, 4) for t in arms["A"]["epochs"]],
        "epochs_B_sec": [round(t, 4) for t in arms["B"]["epochs"]],
        "median_A_sec": round(med_a, 4),
        "median_B_sec": round(med_b, 4),
        "ps_per_sec_A": ps_a,
        "ps_per_sec_B": ps_b,
        "paired_mean_diff_sec": mean_d,
        "paired_ci95_halfwidth_sec": half,
        "relative_B_minus_A": rel,
        "relative_ci95": [rel - rel_half, rel + rel_half],
        "verdict": verdict,
        "device": jax.devices()[0].device_kind,
        "elapsed_sec": round(time.time() - t_start, 1),
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in (
        "verdict", "relative_B_minus_A", "relative_ci95",
        "ps_per_sec_A", "ps_per_sec_B", "pairs")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
