"""argon_monte_carlo_tpu: a JAX hard-sphere argon Monte Carlo engine.

A from-scratch JAX/XLA re-design of the capabilities of the
reference CPU implementation (Lightbrite88/Argon_Monte_Carlo): time-driven
1:1 hard-sphere collision Monte Carlo over cube and thruster-pore
geometries with specular and Debye-energized walls, free-path histograms,
and per-step momentum/energy ledgers.

See ARCHITECTURE.md for the layer map and the design decisions.
"""

__version__ = "0.1.0"

from . import config, engine, geometry, init, physics, rng, state  # noqa: F401
from .config import CubeConfig, EngineConfig, PoreConfig, temperature_pore_config  # noqa: F401
from .engine import Simulation, Workload  # noqa: F401
from .geometry import CubeGeometry, PoreGeometry  # noqa: F401
from .physics import GasPhysics  # noqa: F401
from .models import (  # noqa: F401
    make_cube_workload,
    make_pore_workload,
    make_temperature_pore_workload,
)


def make_workload(cfg):
    """Build the right Workload for a config."""
    if isinstance(cfg, CubeConfig):
        return make_cube_workload(cfg)
    if isinstance(cfg, PoreConfig):
        if cfg.energized:
            return make_temperature_pore_workload(cfg)
        return make_pore_workload(cfg)
    raise TypeError(f"unknown config type {type(cfg)!r}")
