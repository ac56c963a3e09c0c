"""Statistical comparison of a run against the reference script's outputs.

The matched-golden check (``scripts/matched_golden.py``) runs this engine
and the reference script at one identical reduced configuration and
compares what both wrote: the 8 histogram files, the measured mean free
path, and the momentum/energy ledger CSV.  The two use different RNG
streams (and this engine may run float32 where the reference ran NumPy
float64), so agreement is statistical, never bitwise.

Pass rules: per-axis histogram correlation >= ``HIST_CORR_MIN`` and a
measured-MFP ratio within ``MFP_REL_TOL`` of 1.  At ~1e5 completed paths
the per-bin noise sits far below both limits.  The ledger |z| scores are
reported, not judged.
"""

from __future__ import annotations

import os

import numpy as np

from .io.writers import AXIS_NAMES, read_reference_histogram

HIST_CORR_MIN = 0.97
MFP_REL_TOL = 0.03
LEDGER_COLUMNS = ("Momentum", "EnergyCold", "EnergyHot")


def read_histograms(run_dir: str) -> dict:
    """{axis: (left edges, densities)} from the 8 histogram files."""
    out = {}
    for ax in AXIS_NAMES:
        x = read_reference_histogram(
            os.path.join(run_dir, f"hist_x_axis_{ax}_data.txt"))
        y = read_reference_histogram(
            os.path.join(run_dir, f"hist_y_axis_{ax}_data.txt"))
        out[ax] = (x, y)
    return out


def read_ledger_csv(path: str) -> dict:
    """{column: values} from a ``momentum_energy.csv``."""
    with open(path) as f:
        header = f.readline().strip().split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return {name: data[:, i] for i, name in enumerate(header) if name}


def correlation(a, b) -> float:
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    if a.std() == 0 or b.std() == 0:
        return float("nan")
    return float(np.corrcoef(a, b)[0, 1])


def reference_mfp_from_log(path: str) -> float | None:
    """The reference's printed "Simulation mean free path: <value>"."""
    mfp = None
    with open(path) as f:
        for line in f:
            if line.strip().startswith("Simulation mean free path:"):
                mfp = float(line.split(":")[1])
    return mfp


def compare_histograms(ref: dict, ours: dict):
    """(correlation per axis, relative L1 distance per axis)."""
    corrs, l1s = {}, {}
    for ax in AXIS_NAMES:
        ry, oy = ref[ax][1], ours[ax][1]
        m = min(len(ry), len(oy))
        corrs[ax] = correlation(ry[:m], oy[:m])
        denom = np.abs(ry[:m]).sum()
        l1s[ax] = (float(np.abs(ry[:m] - oy[:m]).sum() / denom)
                   if denom else float("nan"))
    return corrs, l1s


def ledger_z_scores(ref_csv: str, ours_csv: str) -> dict:
    """Per-column means and the z-score of their difference over the
    common step range (per-step values are close to independent after
    the initial transient)."""
    ref = read_ledger_csv(ref_csv)
    ours = read_ledger_csv(ours_csv)
    out = {}
    for col in LEDGER_COLUMNS:
        m = min(len(ref[col]), len(ours[col]))
        r, o = ref[col][:m], ours[col][:m]
        se = np.sqrt(r.var() / m + o.var() / m)
        out[col] = {
            "ref_mean": float(r.mean()), "ours_mean": float(o.mean()),
            "z": float((r.mean() - o.mean()) / se) if se else None,
        }
    return out


def compare_runs(ref_dir: str, ours_dir: str, our_mfp: float,
                 ref_mfp: float | None, ledger: bool = True) -> dict:
    """The matched-golden report with its ``pass_hist``/``pass_mfp``."""
    corrs, l1s = compare_histograms(read_histograms(ref_dir),
                                    read_histograms(ours_dir))
    report = {"hist_correlation": corrs, "hist_l1_rel": l1s,
              "ours_mfp_total": our_mfp, "ref_mfp_total": ref_mfp}
    if ref_mfp:
        report["mfp_ratio"] = our_mfp / ref_mfp
    if ledger:
        report["ledger"] = ledger_z_scores(
            os.path.join(ref_dir, "momentum_energy.csv"),
            os.path.join(ours_dir, "momentum_energy.csv"))
    report["pass_hist"] = all(c == c and c >= HIST_CORR_MIN
                              for c in corrs.values())
    report["pass_mfp"] = (ref_mfp is not None
                          and abs(report["mfp_ratio"] - 1.0) <= MFP_REL_TOL)
    return report


def matched_config(scale: float = 0.35, dtype: str = "float64",
                   energized: bool = True):
    """The matched-golden configuration: the pore geometry scaled by
    ``scale`` (0.35 gives 23,909 molecules), pairs engine, K=8."""
    from . import EngineConfig, PoreConfig
    from .geometry import PoreGeometry

    eng = EngineConfig(dtype=dtype, broadphase="cells", steps_per_epoch=48,
                       narrowphase="pairs", rebuild_interval=8,
                       check_finite=True)
    return PoreConfig(geometry=PoreGeometry().scaled(scale), engine=eng,
                      energized=energized)


def run_matched_config(out_dir: str, scale: float = 0.35,
                       steps: int = 2500, dtype: str = "float64",
                       energized: bool = True) -> dict:
    """Run ``matched_config`` for ``steps`` steps from the workload's
    seed.  Writes the 8 histogram files (and, energized, the ledger CSV)
    into ``out_dir``; returns a summary with the measured MFP and
    counters."""
    import jax

    from . import Simulation, make_workload
    from .analysis import path_statistics
    from .io import writers

    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    cfg = matched_config(scale, dtype, energized)
    eng = cfg.engine
    sim = Simulation(make_workload(cfg))
    _, measure, metrics = sim.run(num_steps=steps)
    measure = sim.finalize_measure(measure)
    writers.write_histograms(measure, eng.num_bins, eng.hist_range, out_dir)
    if energized:
        writers.write_momentum_energy_csv(
            np.asarray(metrics.momentum_z), np.asarray(metrics.energy_cold),
            np.asarray(metrics.energy_hot),
            os.path.join(out_dir, "momentum_energy.csv"))
    stats = path_statistics(measure, eng.num_bins, eng.hist_range)
    return {
        "n": int(cfg.num_molecules),
        "collisions": int(measure.collision_count),
        "mfp_total": stats.mean_free_path,
        "path_count": int(measure.path_count),
        "err": int(measure.err_count),
        "overflow": int(measure.overflow_count),
        "hist_drop": int(measure.hist_drop_count),
        "nonfinite": int(np.asarray(metrics.nonfinite).sum()),
    }
