"""fp32 vs fp64 error study (SURVEY.md section 7 "fp precision").

The engine runs fp32 by default (positions O(1e-7 m), collision range 3.4e-10 m:
~2e-3 relative -> f32 keeps ~1e-10 absolute resolution near the pore,
comfortably below the collision range); CPU validation runs fp64.  This
study quantifies what fp32 costs physically on the north-star workload:

  * per-step collision counts and wall-hit counts (identical events?)
  * momentum/energy ledger series divergence (z-scores)
  * mean free path and histogram divergence
  * total kinetic energy drift (conservation between thermal exchanges)

Run: python scripts/precision_study.py [N] [steps]  (CPU)
"""
import sys

sys.path.insert(0, ".")

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np

import argon_monte_carlo_tpu as amc
from argon_monte_carlo_tpu.analysis import path_statistics

N = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 250


def run(dtype):
    eng = amc.EngineConfig(dtype=dtype, broadphase="cells",
                           steps_per_epoch=50)
    cfg = amc.temperature_pore_config(engine=eng).scaled_to(N)
    sim = amc.Simulation(amc.make_workload(cfg))
    state, measure, metrics = sim.run(num_steps=STEPS)
    stats = path_statistics(measure, cfg.engine.num_bins,
                            cfg.engine.hist_range)
    ke = 0.5 * cfg.physics.mass * float(
        np.sum(np.asarray(state.vel, np.float64) ** 2))
    return cfg, measure, metrics, stats, ke


cfg32, m32, met32, s32, ke32 = run("float32")
cfg64, m64, met64, s64, ke64 = run("float64")

mz32 = np.asarray(met32.momentum_z, np.float64)
mz64 = np.asarray(met64.momentum_z, np.float64)
col32 = np.asarray(met32.collisions)
col64 = np.asarray(met64.collisions)


def zdiff(a, b):
    s = np.std(np.concatenate([a, b]))
    return abs(a.mean() - b.mean()) / max(s / np.sqrt(len(a)), 1e-300)


print(f"# fp32 vs fp64 (Temperature_Pore, N={cfg32.num_molecules}, "
      f"{STEPS} steps, same seed)\n")
print("| quantity | fp32 | fp64 | relative |")
print("|---|---|---|---|")
print(f"| total collisions | {col32.sum()} | {col64.sum()} | "
      f"{abs(int(col32.sum())-int(col64.sum()))/max(col64.sum(),1):.2%} |")
print(f"| mean momentum_z/step | {mz32.mean():.4e} | {mz64.mean():.4e} | "
      f"z = {zdiff(mz32, mz64):.2f} |")
print(f"| mean free path | {s32.mean_free_path:.5e} | "
      f"{s64.mean_free_path:.5e} | "
      f"{abs(s32.mean_free_path-s64.mean_free_path)/s64.mean_free_path:.2%} |")
print(f"| completed paths | {s32.num_completed_paths} | "
      f"{s64.num_completed_paths} | "
      f"{abs(s32.num_completed_paths-s64.num_completed_paths)/max(s64.num_completed_paths,1):.2%} |")
print(f"| final kinetic energy (J) | {ke32:.6e} | {ke64:.6e} | "
      f"{abs(ke32-ke64)/ke64:.2e} |")
h32 = np.asarray(m32.hist, np.float64)
h64 = np.asarray(m64.hist, np.float64)
l1 = np.abs(h32 - h64).sum() / max(h64.sum(), 1.0)
print(f"| histogram L1 / total mass | | | {l1:.3%} |")
print(f"| errs (f32/f64) | {int(m32.err_count)} | {int(m64.err_count)} | |")
print("\nInterpretation: identical RNG keys; divergence reflects fp32")
print("rounding in the collision geometry compounding chaotically --")
print("individual trajectories decorrelate, so the comparison is")
print("statistical (means/ledgers/histograms), matching BASELINE.json's")
print("statistical-parity criterion.")
