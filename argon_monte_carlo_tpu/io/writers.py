"""Reference-format output artifacts.

The reference writes, at the end of a run (Open_Air_Cube_MC.py:394-418,
Temperature_Pore_MC.py:902-933):

* 8 histogram text files ``hist_{x,y}_axis_{total,x,y,z}_data.txt`` --
  the 200 left bin edges and the density-normalized counts, each written
  as ``str(ndarray)`` (numpy repr with unlimited threshold).
* ``momentum_energy.csv`` -- pandas DataFrame of per-step Momentum,
  EnergyCold, EnergyHot with the row index = timestep (``df.to_csv``:
  header ``,Momentum,EnergyCold,EnergyHot``, floats as Python reprs).
  Written here with the plain csv format, no pandas needed.

We reproduce both formats exactly so downstream consumers of the
reference's artifacts (e.g. graph_sim_data.py-style replotters) can read
ours unchanged.  Densities are computed from the on-device histogram
accumulators: density = counts / (in_range_total * bin_width), matching
numpy.histogram(density=True) semantics used by ax.hist.
"""

from __future__ import annotations

import os

import numpy as np

from ..state import Measurements

AXIS_NAMES = ("total", "x", "y", "z")


def histogram_densities(measure: Measurements, num_bins: int,
                        hist_range: tuple[float, float]):
    """(edges (num_bins,), densities (4, num_bins)) from the accumulators."""
    lo, hi = hist_range
    width = (hi - lo) / num_bins
    counts = np.asarray(measure.hist, dtype=np.float64)[:, :num_bins]
    totals = counts.sum(axis=1, keepdims=True)
    totals = np.where(totals == 0.0, 1.0, totals)
    densities = counts / (totals * width)
    edges = lo + width * np.arange(num_bins)
    return edges, densities


def _ndarray_repr(arr: np.ndarray) -> str:
    """The reference's file format: str(ndarray) with no truncation
    (np.set_printoptions(threshold=sys.maxsize), Open_Air_Cube_MC.py:13)."""
    with np.printoptions(threshold=np.iinfo(np.int64).max):
        return str(arr)


def write_histograms(measure: Measurements, num_bins: int,
                     hist_range: tuple[float, float],
                     out_dir: str = ".") -> list[str]:
    """Write the 8 reference histogram text files; returns the paths."""
    edges, densities = histogram_densities(measure, num_bins, hist_range)
    paths = []
    for i, name in enumerate(AXIS_NAMES):
        px = os.path.join(out_dir, f"hist_x_axis_{name}_data.txt")
        py = os.path.join(out_dir, f"hist_y_axis_{name}_data.txt")
        with open(px, "w") as f:
            f.write(_ndarray_repr(edges))
        with open(py, "w") as f:
            f.write(_ndarray_repr(densities[i]))
        paths += [px, py]
    return paths


def write_momentum_energy_csv(momentum_z, energy_cold, energy_hot,
                              path: str = "momentum_energy.csv") -> str:
    """Per-step ledger CSV (Temperature_Pore_MC.py:928-933).

    Column order and the unnamed index column match the reference
    artifact (runs/matched_golden/reference_run/momentum_energy.csv,
    header ",Momentum,EnergyCold,EnergyHot").
    """
    m = np.asarray(momentum_z, dtype=np.float64).tolist()
    c = np.asarray(energy_cold, dtype=np.float64).tolist()
    h = np.asarray(energy_hot, dtype=np.float64).tolist()
    with open(path, "w") as f:
        f.write(",Momentum,EnergyCold,EnergyHot\n")
        for i, row in enumerate(zip(m, c, h)):
            f.write(f"{i},{row[0]!r},{row[1]!r},{row[2]!r}\n")
    return path


def read_reference_histogram(path: str) -> np.ndarray:
    """Parse a ``str(ndarray)``-format histogram file (for golden tests)."""
    with open(path) as f:
        text = f.read()
    text = text.strip().lstrip("[").rstrip("]")
    return np.fromiter((float(t) for t in text.split()), dtype=np.float64)
