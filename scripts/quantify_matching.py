"""Quantify mutual-match vs the reference's sequential in-cell resolution.

The engine resolves a pair (a,b) iff each is the
other's lowest-index overlapping candidate (ops/collide.py); the
reference resolves pairs sequentially inside each cell with in-loop
writeback (Open_Air_Pore_MC.py:221-232), so a particle overlapping two
others resolves against the first and may immediately re-collide with
the second in the same sweep.  The engine defers the unmatched overlap
to the next step instead.  This script measures, per step at reference
density:

  * overlap_pairs:   particles within collision_range of >=1 candidate
  * multi_candidate: particles with >=2 overlapping candidates (the only
                     case where the two semantics can differ)
  * deferred:        particles overlapping but not mutually matched this
                     step (resolved 1+ steps later)
  * deferred_persist: deferred particles still overlapping the SAME
                     candidate next step (i.e. the deferral actually
                     delayed a resolution rather than the pair separating
                     on its own)

Run: python scripts/quantify_matching.py [N] [steps]
Writes a summary table to stdout (markdown-ready).
"""
import sys

sys.path.insert(0, ".")

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_enable_x64", True)
assert jax.devices()[0].platform == "cpu"

import jax.numpy as jnp
import numpy as np

import argon_monte_carlo_tpu as amc
from argon_monte_carlo_tpu.engine import Simulation, build_grids
from argon_monte_carlo_tpu.ops import collide

N = int(sys.argv[1]) if len(sys.argv) > 1 else 60_000
STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 60

eng = amc.EngineConfig(dtype="float64", broadphase="cells",
                       steps_per_epoch=1)
cfg = amc.temperature_pore_config(engine=eng).scaled_to(N)
wl = amc.make_workload(cfg)
sim = Simulation(wl)
_, dgrid = build_grids(wl)
cr = cfg.physics.collision_range

state, measure, key = sim.init()

probe = jax.jit(lambda pos: collide.cell_candidate_search(
    pos, dgrid, cr, top_k=2)[0])

rows = []
prev_deferred = None
tot = dict(overlap=0, multi=0, deferred=0, persist=0, resolved=0)
for s in range(STEPS):
    cands = np.asarray(probe(state.pos))
    partner = cands[:, 0]
    overlap = partner >= 0
    multi = cands[:, 1] >= 0
    mutual = overlap & (partner[np.clip(partner, 0, None)] ==
                        np.arange(len(partner)))
    deferred = overlap & ~mutual
    if prev_deferred is not None:
        persist = int((prev_deferred & deferred).sum())
    else:
        persist = 0
    tot["overlap"] += int(overlap.sum())
    tot["multi"] += int(multi.sum())
    tot["deferred"] += int(deferred.sum())
    tot["persist"] += persist
    tot["resolved"] += int(mutual.sum()) // 2
    prev_deferred = deferred
    state, measure, _ = sim.run(num_steps=1, state=state, measure=measure,
                                run_key=key, start_step=s)

n_steps = STEPS
print(f"# Mutual-match deferral statistics")
print(f"N={cfg.num_molecules} steps={STEPS} "
      f"(Temperature_Pore at reference density)\n")
print("| metric | per step | fraction of overlapping |")
print("|---|---|---|")
ov = max(tot["overlap"], 1)
print(f"| overlapping particles | {tot['overlap']/n_steps:.2f} | 1.0 |")
print(f"| resolved pairs | {tot['resolved']/n_steps:.2f} | "
      f"{2*tot['resolved']/ov:.4f} |")
print(f"| multi-candidate particles | {tot['multi']/n_steps:.3f} | "
      f"{tot['multi']/ov:.5f} |")
print(f"| deferred (unmatched overlap) | {tot['deferred']/n_steps:.3f} | "
      f"{tot['deferred']/ov:.5f} |")
print(f"| deferred persisting next step | {tot['persist']/n_steps:.3f} | "
      f"{tot['persist']/ov:.5f} |")
print()
print("Interpretation: the two semantics can only differ for "
      "multi-candidate particles; a deferred overlap that does not "
      "persist separated ballistically (no resolution was lost), and "
      "one that persists resolves 1 step (= dt, 1/1000 of a mean free "
      "time) later than the reference's same-sweep handling.")
