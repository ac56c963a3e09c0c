"""Workload and engine configuration.

The reference has no config system: every parameter is a module-level
constant edited in-file (SURVEY.md section 5).  Here each reference script
becomes a frozen dataclass mirroring its constant block, plus an
``EngineConfig`` for the device execution strategy (dtype, collision
grid, histogram binning, epoch length) that has no reference analogue.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .geometry import CubeGeometry, PoreGeometry
from .physics import (
    CUBE_PHYSICS,
    GasPhysics,
    PORE_PHYSICS,
    TEMPERATURE_PORE_PHYSICS,
)
from .utils import debye


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution-strategy knobs for the engine (no reference analogue)."""

    # "float32" (default) or "float64" (CPU parity tests; the reference
    # computes in NumPy float64).
    dtype: str = "float32"
    # Pair-collision broad phase: "allpairs" (exact, O(N^2), small N) or
    # "cells" (compact region-aware cell list, scales to millions).
    broadphase: str = "cells"
    # Target mean particles per occupied cell (sets the cell size).
    # 11 (with the auto capacity formula landing on 32 slots) halves the
    # cell count vs 6: fewer, fatter cells trade per-row neighbour
    # gathers for wider rows.  Chosen on another chip's cost model; not
    # yet re-decided on the GPU.
    cell_occupancy: float = 11.0
    # Max particles stored per cell; None = auto from the occupancy
    # Poisson tail (occ + 5*sqrt(occ) + 4, rounded up to 8).  Overflow is
    # counted in metrics either way.
    cell_capacity: Optional[int] = None
    # Tile size for the all-pairs broad phase.
    allpairs_tile: int = 2048
    # Steps per lax.scan epoch (no host round-trips within an epoch).
    steps_per_epoch: int = 100
    # Free-path histograms (reference: 200 bins over (0, 1e-6);
    # Open_Air_Cube_MC.py:81,344).
    num_bins: int = 200
    hist_range: tuple[float, float] = (0.0, 1e-6)
    # Narrow-phase strategy.  "sweep": full 27-neighbourhood sweep every
    # step (reference-shaped; Open_Air_Pore_MC.py:160-255).  "pairs":
    # Verlet reach-pair list (ops/pairs.py) -- the sweep runs only every
    # ``rebuild_interval`` steps with per-particle reach radii, and each
    # step tests the listed pairs exactly; identical collision semantics
    # (tests/test_pairs.py asserts bitwise-equal trajectories).
    narrowphase: str = "sweep"
    # Steps between pair-list rebuilds in narrowphase="pairs" (the
    # Verlet-list amortization window K; reach = cr/2 + |v| K dt).
    # narrowphase="sweep" requires 1 (it re-sweeps every step).
    rebuild_interval: int = 1
    # Max N for the FUSED whole-window program in narrowphase="pairs"
    # (rebuild + K steps jitted as one program).  Fusing amortizes
    # per-dispatch host overhead across the window, but the combined
    # program is roughly twice the size to compile; above this N the
    # engine interleaves the two separately-jitted programs (rebuild,
    # K-step block) instead.  Trajectories are bitwise identical either
    # way (tests/test_pairs.py::test_fused_epoch_matches_split_blocks_bitwise).
    fused_epoch_max_particles: int = 2_000_000
    # Re-evaluate every wall-case predicate after the wall phase and
    # report residual counts per step (the reference's "missed case"
    # audit, Open_Air_Pore_MC.py:488-511).  Costs one extra pass.
    debug_audits: bool = False
    # Count non-finite state elements per step (NaN/inf sanitizer; the
    # reference uses np.seterr(all='raise'), Open_Air_Pore_MC.py:11).
    check_finite: bool = False
    # Flush staged histogram events every N steps.  1 is exact per the
    # one-pending-slot-per-particle semantics; larger values trade a tiny
    # sample loss (a particle colliding twice within the window only bins
    # its last event; the exact sums/means are unaffected) for one fewer
    # scatter per step.  Benchmarks use 8.
    hist_flush_interval: int = 1
    # Extra neighbour-search radius (metres) beyond collision_range when
    # rebuild_interval > 1, so pairs entering range between rebuilds are
    # still candidates (Verlet-list skin).
    skin: float = 0.0
    # Bin particles through ONE packed (nz, 4) layer-table row gather
    # instead of three separate per-layer gathers (nx, half_extent,
    # layer_base) in ops/collide.assign_cells: one row read per
    # particle instead of three.  Cell ids are bitwise-identical
    # (integer layer values < 2^24 round-trip float exactly; the guard
    # in DeviceGrid.from_grid refuses otherwise).  Default True; chosen
    # on another chip's gather costs, not yet re-decided on the GPU.
    packed_layer_gather: bool = True
    # Compute the PAIR-LIST REBUILD's candidate distance test in
    # bfloat16 (differences still formed in f32 -- absolute positions
    # would lose ~2e-9 m to bf16 rounding, larger than the collision
    # range -- then cast, squared, and compared against a threshold
    # pre-widened by BF16_HIT_EPS).  The widened bf16 hit set is a
    # guaranteed SUPERSET of the exact f32 set, and coverage stays
    # exact through the existing machinery: extra candidates can only
    # saturate a particle's top-k emission, which queues the one-shot
    # full re-search (pending1) that re-tests in exact f32
    # (ops/pairs.rebuild:198-203).  Resolution always re-tests exact
    # f32 overlap per step, so trajectories are unchanged.  Only the
    # rebuild converts; the per-step sweep narrow phase and the
    # research path stay f32.  Default False; a knob for the
    # interleaved A/B (scripts/ab_bench.py), not yet measured on the GPU.
    rebuild_bf16_hittest: bool = False
    # Skip empty active rows in the rebuild sweep (stable nonempty-
    # first permutation + lax.cond chunk skip).  Default False: the
    # per-rebuild occupancy compaction costs work on every row to save
    # the empty ones, which pays only at sparse occupancies.  The
    # sharded engine never uses it (windowed mode pins the static
    # layout).  Not yet measured on the GPU.
    rebuild_occupancy_skip: bool = False
    # Run the pair-list rebuild OUTSIDE jit: each op, and the chunked
    # sweep's internal lax.scan, compiles and dispatches as its own
    # small program.  Trades ~50 dispatches per rebuild (amortized over
    # K steps) for the smallest possible compiled programs, and its
    # per-op first-dispatch timeline shows which op dominates compile
    # time.  Physics is bitwise-identical (tested); also reachable via
    # ARGON_EAGER_REBUILD=1 without a config change.
    eager_rebuild: bool = False
    # The rebuild as THREE jitted programs (tables | candidate sweep |
    # list epilogue) instead of one: smaller programs to compile at 3
    # dispatches per rebuild.  The tables|sweep boundary (mega, pslot)
    # is already materialized in PairList, so the split adds only the
    # (N, top_k) cands buffer of memory traffic.  Trajectories
    # bitwise-identical (tested); also reachable via
    # ARGON_SPLIT_REBUILD=1 without a config change.
    split_rebuild_programs: bool = False
    # Cap the per-dispatch scan-block length in pairs mode (the host
    # loop's m).  With max_block_steps=1 the only jitted step program
    # is the 1-step scan -- the smallest program the engine can emit --
    # while rebuild_interval still amortizes the rebuild over K steps.
    # Any block partition with <= K steps per rebuild window yields the
    # exact same trajectory (engine._run_epoch contract; bitwise-
    # tested), so this knob trades one dispatch per block for never
    # compiling a K-step scan.  None = uncapped (the default; fused
    # whole-window programs up to fused_epoch_max_particles).
    max_block_steps: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class CubeConfig:
    """Stage 1: specular cube (reference Open_Air_Cube_MC.py:26-82)."""

    geometry: CubeGeometry = CubeGeometry()
    physics: GasPhysics = CUBE_PHYSICS
    seed: int = 127
    nmft: int = 20  # mean-free times to run (Open_Air_Cube_MC.py:62)
    steps_per_mft: int = 25  # (Open_Air_Cube_MC.py:63)
    engine: EngineConfig = EngineConfig(broadphase="allpairs")
    # Optional override of the derived molecule count (for tests/benches).
    num_particles_override: Optional[int] = None
    # Strict C8 fidelity: stratify the position init like the reference
    # (floor(N/cells) particles uniform within each of init_cells_per_axis^3
    # cells, remainder uniform over the box; Open_Air_Cube_MC.py:144-156).
    # Default False: plain uniform has the identical single-particle
    # distribution (stratification is only a variance reduction).
    stratified_init: bool = False
    init_cells_per_axis: int = 15  # Open_Air_Cube_MC.py:30

    @property
    def num_molecules(self) -> int:
        if self.num_particles_override is not None:
            return self.num_particles_override
        return self.physics.num_molecules(self.geometry.volume)

    @property
    def num_timesteps(self) -> int:
        return self.nmft * self.steps_per_mft

    @property
    def dt(self) -> float:
        # dt = Nmft * tau / num_timesteps (Open_Air_Cube_MC.py:64)
        return self.nmft * self.physics.tau / self.num_timesteps


@dataclasses.dataclass(frozen=True)
class PoreConfig:
    """Stages 2+3: thruster pore.

    ``energized=False`` reproduces Open_Air_Pore_MC (all walls specular,
    wall hits end free paths and count as collisions).
    ``energized=True`` reproduces Temperature_Pore_MC (Debye thermal walls,
    momentum/energy ledger, specular walls do not touch paths).
    """

    geometry: PoreGeometry = PoreGeometry()
    energized: bool = False
    seed: int = 17
    nmft: int = 20  # (Open_Air_Pore_MC.py:73)
    steps_per_mft: int = 1000  # (Open_Air_Pore_MC.py:74)
    engine: EngineConfig = EngineConfig(broadphase="cells")
    num_particles_override: Optional[int] = None

    # Thermal-wall parameters (Temperature_Pore_MC.py:72-79); only used
    # when energized=True.
    t_cold: float = 293.0
    t_hot: float = 353.0
    t_debye_graphene: float = debye.T_DEBYE_GRAPHENE
    t_debye_alumina: float = debye.T_DEBYE_ALUMINA
    coated_accommodation_coeff: float = debye.COATED_ACCOMMODATION_COEFF
    gap_accommodation_coeff: float = debye.GAP_ACCOMMODATION_COEFF
    cone_half_angle_deg: float = 85.0  # Temperature_Pore_MC.py:136-138

    @property
    def physics(self) -> GasPhysics:
        return TEMPERATURE_PORE_PHYSICS if self.energized else PORE_PHYSICS

    @property
    def num_molecules(self) -> int:
        if self.num_particles_override is not None:
            return self.num_particles_override
        return self.physics.num_molecules(self.geometry.volume)

    @property
    def num_timesteps(self) -> int:
        return self.nmft * self.steps_per_mft

    @property
    def dt(self) -> float:
        return self.nmft * self.physics.tau / self.num_timesteps

    # --- Debye surface energies (host precompute; Temperature_Pore_MC.py:80-84) ---
    @property
    def surface_energy_cold(self) -> float:
        return float(
            debye.surface_energy(
                self.t_cold,
                self.t_debye_graphene,
                debye.NUM_ATOMS_UNITCELL_GRAPHENE,
                self.physics.boltzmann,
            )
        )

    @property
    def surface_energy_hot(self) -> float:
        return float(
            debye.surface_energy(
                self.t_hot,
                self.t_debye_graphene,
                debye.NUM_ATOMS_UNITCELL_GRAPHENE,
                self.physics.boltzmann,
            )
        )

    def gap_energy_table(self, resolution: int = 512) -> debye.GapEnergyTable:
        return debye.GapEnergyTable.build(
            gap_bottom=self.geometry.gap_bottom,
            gap_top=self.geometry.gap_top,
            t_hot=self.t_hot,
            t_cold=self.t_cold,
            boltzmann=self.physics.boltzmann,
            t_debye=self.t_debye_alumina,
            resolution=resolution,
        )

    def scaled_to(self, target_particles: int) -> "PoreConfig":
        """Scale the geometry so the ideal-gas molecule count ~= target.

        Used by the benchmark configs (1M / 10M particle pores).
        """
        base = self.physics.num_molecules(self.geometry.volume)
        s = (target_particles / base) ** (1.0 / 3.0)
        return dataclasses.replace(self, geometry=self.geometry.scaled(s))


def temperature_pore_config(**kwargs) -> PoreConfig:
    """The north-star workload (Temperature_Pore_MC.py)."""
    kwargs.setdefault("energized", True)
    return PoreConfig(**kwargs)


def _required_cell_size(cfg: EngineConfig, physics: GasPhysics,
                        density: float) -> float:
    """Cell edge length: >= search radius, targeting ``cell_occupancy``."""
    search_radius = physics.collision_range + cfg.skin
    occupancy_size = (cfg.cell_occupancy / density) ** (1.0 / 3.0)
    return max(search_radius, occupancy_size)


def cell_size_for(cfg_engine: EngineConfig, physics: GasPhysics,
                  num_particles: int, fluid_volume: float) -> float:
    density = num_particles / fluid_volume
    return _required_cell_size(cfg_engine, physics, density)


def cell_capacity_for(cfg_engine: EngineConfig, physics: GasPhysics,
                      num_particles: int, fluid_volume: float) -> int:
    """Per-cell slot count covering the Poisson occupancy tail."""
    if cfg_engine.cell_capacity is not None:
        return cfg_engine.cell_capacity
    density = num_particles / fluid_volume
    size = _required_cell_size(cfg_engine, physics, density)
    occ = density * size**3
    cap = occ + 5.0 * math.sqrt(max(occ, 1.0)) + 4.0
    return int(math.ceil(cap / 8.0) * 8)


def pairs_cell_capacity_for(cfg_engine: EngineConfig, physics: GasPhysics,
                            num_particles: int,
                            fluid_volume: float) -> int:
    """Tighter slot count for the PAIRS-rebuild grid (~3.75 sigma).

    The rebuild sweep's cost scales ~cap^2 (with the candidate axis
    grouped to 128 lanes: cap=24 fills 120 of 128, cap=32 spills to
    256 -- a 128-lane choice not yet re-decided on the GPU), and the
    pairs engine can afford a
    thin Poisson tail because a cell-table spill is ABSORBED: the
    spilled particle goes hot and re-searches with fresh positions
    every step (ops/pairs.rebuild), so coverage is preserved where the
    sweep engine would lose the particle outright.  At reference
    occupancy 11 this lands on 24 slots (P[Poisson(11) > 24] ~ 2e-4
    per cell -> a few dozen hot spills per rebuild at 1M particles,
    well inside the research budget) vs the sweep's 32.
    """
    if cfg_engine.cell_capacity is not None:
        return cfg_engine.cell_capacity
    density = num_particles / fluid_volume
    size = _required_cell_size(cfg_engine, physics, density)
    occ = density * size**3
    cap = occ + 3.75 * math.sqrt(max(occ, 1.0)) + 1.0
    # Round to the NEAREST multiple of 8, not up: at reference interior
    # occupancy ~11 the raw value lands at 24.4, and ceil inflated the
    # sweep's (cells, cap, 27*cap) lane count 78% (cap 32 vs 24) for
    # tail mass that spill-to-hot absorbs exactly anyway (counted in
    # PairList.spill; the forced-starvation test pins the coverage).
    return max(8, int(round(cap / 8.0) * 8))
