"""Particle state and measurement accumulators as JAX pytrees.

Struct-of-arrays layout: ``pos``/``vel`` are ``(N, 3)`` so elementwise
physics stays dense vector arithmetic; kernels that want per-component vectors
slice columns (XLA keeps these fused).

The reference keeps the same state as twelve separate numpy arrays plus
unbounded Python lists of completed free paths (Open_Air_Pore_MC.py:385-413).
The lists are the one unbounded-memory structure in the reference; since
its outputs only ever use *binned* densities and means, we accumulate
fixed-size histograms and running sums on device instead (SURVEY.md section 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

# Path component order used everywhere: total, x, y, z.
NUM_PATH_AXES = 4


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ParticleState:
    """Per-particle simulation state.

    pos:  (N, 3) positions [m]
    vel:  (N, 3) velocities [m/s]
    paths: (N, 4) distance accumulated since last collision
           (total, x, y, z) -- reference ``dist*_since_collision``
           (Open_Air_Cube_MC.py:130-133)
    has_collided: (N,) bool -- reference ``full_path_traveled``; the first
           collision ends a *partial* path that is discarded
           (Open_Air_Cube_MC.py:139, 267-280)
    """

    pos: jax.Array
    vel: jax.Array
    paths: jax.Array
    has_collided: jax.Array

    @property
    def num_particles(self) -> int:
        return self.pos.shape[0]

    @staticmethod
    def zeros(n: int, dtype: Any = jnp.float32) -> "ParticleState":
        return ParticleState(
            pos=jnp.zeros((n, 3), dtype),
            vel=jnp.zeros((n, 3), dtype),
            paths=jnp.zeros((n, NUM_PATH_AXES), dtype),
            has_collided=jnp.zeros((n,), jnp.bool_),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Measurements:
    """On-device accumulators replacing the reference's Manager lists.

    hist: (4, num_bins + 1) completed-free-path histogram counts per axis
          (total, x, y, z); the final bin collects values beyond
          ``hist_range`` (the reference's ax.hist simply drops them from
          the plot range but they still enter the mean).
    path_sum / path_count: running sum & count of ALL completed paths per
          axis, for exact mean-free-path reporting
          (Open_Air_Cube_MC.py:386-392).
    collision_count: total collision events (reference
          ``num_collisions_per_step`` accumulated; Open_Air_Pore_MC.py:424).
    err_count: wall-solver degeneracies (reference ``total_errs``,
          Open_Air_Pore_MC.py:336-338).
    overflow_count: ACTUAL particle/visibility loss: cell-table slots
          dropped from over-capacity cells plus, in the sharded engine,
          migration-buffer and receive-side drops (engine diagnostic;
          no reference analogue).
    halo_trunc_count: sharded engine only -- halo-band lanes that did not
          fit the halo buffer.  These particles are NOT lost (they stay on
          their owning shard); only their cross-shard collision visibility
          is, so the counter is separate from ``overflow_count``
          (VERDICT r1 weak #8).
    """

    hist: jax.Array
    path_sum: jax.Array
    path_count: jax.Array
    collision_count: jax.Array
    err_count: jax.Array
    overflow_count: jax.Array
    halo_trunc_count: jax.Array
    # Events beyond the histogram flush's fixed compaction buffer
    # (ops/measure.FLUSH_CAPACITY) -- dropped from the binned histogram
    # only, never from the exact sums.  Zero in every observed workload.
    hist_drop_count: jax.Array
    # Pairs engine: rebuild-time cell-table spills ABSORBED by the hot
    # set (the spilled particle re-searches with fresh positions every
    # step, so its pairs stay covered -- ops/pairs.rebuild).  NOT a
    # loss; tracked separately from overflow_count so a clean run can
    # assert overflow == 0 while running tight pairs-grid capacities.
    hot_spill_count: jax.Array
    # Step-transient staging area for completed-path binning: each event
    # writes its (4,) path values here and ONE scatter per step flushes
    # them into `hist` instead of 10 per-case scatters.  A particle with two collision events in the same step
    # contributes only its last event to the *binned* histogram (the
    # exact sums/counts above still see both); at reference densities
    # that's ~1e-6 of samples.
    pending_vals: jax.Array   # (N, 4)
    pending_mask: jax.Array   # (N,) bool

    @staticmethod
    def zeros(num_bins: int, dtype: Any = jnp.float32,
              num_particles: int = 0) -> "Measurements":
        return Measurements(
            hist=jnp.zeros((NUM_PATH_AXES, num_bins + 1), jnp.float32),
            path_sum=jnp.zeros((NUM_PATH_AXES,), dtype),
            path_count=jnp.zeros((), jnp.int32),
            collision_count=jnp.zeros((), jnp.int32),
            err_count=jnp.zeros((), jnp.int32),
            overflow_count=jnp.zeros((), jnp.int32),
            halo_trunc_count=jnp.zeros((), jnp.int32),
            hist_drop_count=jnp.zeros((), jnp.int32),
            hot_spill_count=jnp.zeros((), jnp.int32),
            pending_vals=jnp.zeros((num_particles, NUM_PATH_AXES), dtype),
            pending_mask=jnp.zeros((num_particles,), jnp.bool_),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StepMetrics:
    """Per-timestep scalars (stacked over an epoch by lax.scan).

    momentum_z / energy_hot / energy_cold mirror the reference's per-step
    ledger (Temperature_Pore_MC.py:685-687, 755-758); the rest are audit
    counters.
    """

    momentum_z: jax.Array
    energy_hot: jax.Array
    energy_cold: jax.Array
    collisions: jax.Array
    wall_hits: jax.Array
    oob_after_walls: jax.Array
    oob_after_pairs: jax.Array
    # Debug/audit channels (zeros unless the EngineConfig flags enable
    # them): residual wall-case predicate counts re-evaluated after the
    # wall phase (reference "missed case" prints,
    # Open_Air_Pore_MC.py:488-511) and non-finite state element counts
    # (the reference's np.seterr(all='raise') analogue,
    # Open_Air_Pore_MC.py:11).
    missed_cases: jax.Array  # (10,) int32
    nonfinite: jax.Array     # () int32
    # Verlet pair-list observability (narrowphase="pairs"; zeros in
    # sweep mode): did this step run a full rebuild, and how many
    # particles were dirty-researched.
    rebuilt: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32))
    dirty_count: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32))
    # One-step-latency diagnostics (ADVICE r2): events whose coverage is
    # restored only at the END of the step they occur in, so an overlap
    # formed that same step resolves one step later than the per-step
    # sweep would.  latent_full = rebuild-time full top-k emissions
    # consumed from the one-shot re-search queue this step; teleports =
    # recapture-teleported particles that went hot this step.
    latent_full: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32))
    teleports: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32))
    # REALIZED latency indicator: dirty-researched candidates already
    # within cr of their stored rebuild-time position -- overlaps that
    # resolve one step later than the per-step sweep would (includes
    # the energized-wall replay edge; ops/pairs.py module docstring).
    # Stored positions lag true ones, so treat as an indicator rather
    # than an exact event count.
    latent_research: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32))
