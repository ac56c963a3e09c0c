"""Post-run analysis: distribution fits and mean-free-path statistics.

Reference analogues:
* exponential decay fit of the total-free-path histogram, p0=[1.4e7,-1.1e7]
  (Open_Air_Cube_MC.py:119-121, 344-348) -- hard-sphere free paths must be
  exponential with rate 1/lambda;
* inverse power fit of the per-axis histograms (Open_Air_Cube_MC.py:123-125,
  357-381);
* mean-free-path report (Open_Air_Cube_MC.py:386-392).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.optimize import curve_fit

from .state import Measurements


def fit_exp_function(x, coeff_1, coeff_2):
    """a * exp(b x) (Open_Air_Cube_MC.py:120-121)."""
    return coeff_1 * np.exp(coeff_2 * np.asarray(x))


def fit_inv_function(x, coeff_1, coeff_2, coeff_3):
    """a * (x - b)^c (Open_Air_Cube_MC.py:124-125)."""
    return coeff_1 * (np.asarray(x) - coeff_2) ** coeff_3


def fit_exponential(bin_edges: np.ndarray, densities: np.ndarray,
                    p0=(1.4e7, -1.1e7), maxfev: int = 25000):
    """Least-squares exponential fit with scipy.optimize.curve_fit (the
    reference's tool); returns (a, b)."""
    x = np.asarray(bin_edges, dtype=np.float64)
    y = np.asarray(densities, dtype=np.float64)
    popt, _ = curve_fit(fit_exp_function, x, y, p0=list(p0), maxfev=maxfev)
    return float(popt[0]), float(popt[1])


def fit_inverse(bin_edges: np.ndarray, densities: np.ndarray,
                p0=(1.0, 0.0, -3.0), maxfev: int = 25000):
    """Inverse-power fit a(x-b)^c; returns (a, b, c), or NaNs when the
    fit does not converge."""
    try:
        popt, _ = curve_fit(fit_inv_function, np.asarray(bin_edges),
                            np.asarray(densities), p0=list(p0),
                            maxfev=maxfev)
    except RuntimeError:
        return (float("nan"),) * 3
    return tuple(float(v) for v in popt)


@dataclasses.dataclass(frozen=True)
class PathStatistics:
    """Mean free paths + fit parameters, the reference's end-of-run report."""

    mean_free_path: float
    mean_x_free_path: float
    mean_y_free_path: float
    mean_z_free_path: float
    num_completed_paths: int
    exp_fit_a: float
    exp_fit_b: float

    @property
    def fitted_mfp(self) -> float:
        """-1/b of the exponential fit: the distribution-level MFP."""
        return -1.0 / self.exp_fit_b if self.exp_fit_b else float("nan")


def path_statistics(measure: Measurements, num_bins: int,
                    hist_range: tuple[float, float]) -> PathStatistics:
    from .io.writers import histogram_densities

    count = max(int(measure.path_count), 1)
    sums = np.asarray(measure.path_sum, dtype=np.float64)
    edges, dens = histogram_densities(measure, num_bins, hist_range)
    a, b = fit_exponential(edges, dens[0])
    return PathStatistics(
        mean_free_path=float(sums[0] / count),
        mean_x_free_path=float(sums[1] / count),
        mean_y_free_path=float(sums[2] / count),
        mean_z_free_path=float(sums[3] / count),
        num_completed_paths=int(measure.path_count),
        exp_fit_a=a,
        exp_fit_b=b,
    )
