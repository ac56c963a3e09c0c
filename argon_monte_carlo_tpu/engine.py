"""The jitted simulation engine: step function + epoch scan.

Replaces the reference main loops (Open_Air_Cube_MC.py:175-338,
Open_Air_Pore_MC.py:416-557, Temperature_Pore_MC.py:662-853) with a single
fused, jit-compiled step:

    drift -> wall pass -> recapture -> pair collisions -> recapture -> metrics

and ``lax.scan`` over an epoch of steps so the device never round-trips to
the host mid-epoch.  The reference's CPU parallel runtime (process pools,
Manager lists, locked counters -- SURVEY.md C23) has no equivalent here:
everything is one SPMD program.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .config import CubeConfig, PoreConfig, cell_capacity_for, cell_size_for
from .ops import collide
from .ops import measure as measure_ops
from .ops.compact import compact_indices
from .state import Measurements, ParticleState, StepMetrics


class WallLedger(NamedTuple):
    """Per-step wall-phase totals (Temperature_Pore_MC.py:685-687)."""

    momentum_z: jnp.ndarray
    energy_hot: jnp.ndarray
    energy_cold: jnp.ndarray
    wall_hits: jnp.ndarray
    errs: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class Workload:
    """Everything workload-specific the engine needs.

    wall_pass(state, prior_pos, measure, key) -> (state, measure, ledger)
    post_wall / post_pairs: recapture passes returning (state, oob_count).
    """

    cfg: object
    init_fn: Callable[[jax.Array], ParticleState]
    wall_pass: Callable
    post_wall: Callable
    post_pairs: Callable
    fluid_volume: float
    # Optional: re-evaluate wall-case predicates post-handling, returning
    # (10,) residual counts (reference missed-case audit).
    audit_fn: Optional[Callable] = None


def build_grids(workload: Workload):
    """Host-build the collision grid; returns (host_grid, device_grid)
    or (None, None) for the all-pairs broad phase.

    The grid tables (notably the (C, 27) neighbour map) are passed into
    the jitted epoch as ARGUMENTS, not closure constants: at 10M
    particles the table is ~330MB and baking it into the program blows
    the compile payload.
    """
    cfg = workload.cfg
    eng = cfg.engine
    if eng.broadphase != "cells":
        return None, None
    physics = cfg.physics
    cell_size = cell_size_for(
        eng, physics, cfg.num_molecules, workload.fluid_volume
    )
    if getattr(eng, "narrowphase", "sweep") == "pairs":
        # Tight capacity: rebuild-time spills go hot (coverage kept),
        # and the sweep's cost scales ~cap^2 (config helper).
        from .config import pairs_cell_capacity_for

        capacity = pairs_cell_capacity_for(
            eng, physics, cfg.num_molecules, workload.fluid_volume
        )
    else:
        capacity = cell_capacity_for(
            eng, physics, cfg.num_molecules, workload.fluid_volume
        )
    geom = cfg.geometry
    if hasattr(geom, "total_height"):  # pore
        build = collide.grid_for_pore
        center = (0.0, 0.0)
    else:  # cube
        build = collide.grid_for_cube
        center = (geom.lx / 2.0, geom.ly / 2.0)
    host_grid = build(geom, cell_size, capacity)
    device_grid = collide.DeviceGrid.from_grid(
        host_grid, jnp.dtype(eng.dtype), center,
        packed_layers=getattr(eng, "packed_layer_gather", False),
    )
    return host_grid, device_grid


def build_device_grid(workload: Workload):
    """Back-compat helper returning only the device grid."""
    return build_grids(workload)[1]


def make_step_fn(workload: Workload, device_grid=None, host_grid=None):
    """Build the scannable per-timestep function.

    ``device_grid`` may hold traced arrays (the jitted caller passes the
    grid as an argument); None builds it on the host (small-N tools)."""
    cfg = workload.cfg
    eng = cfg.engine
    if getattr(eng, "narrowphase", "sweep") == "pairs":
        raise ValueError(
            "narrowphase='pairs' uses make_pairs_step_fn (the step "
            "carries the Verlet pair list); Simulation dispatches "
            "automatically"
        )
    if eng.rebuild_interval != 1:
        raise ValueError(
            "rebuild_interval > 1 requires narrowphase='pairs' (the "
            "per-step sweep rebuilds its cell structure every step)"
        )
    physics = cfg.physics
    dt = cfg.dt
    cr = physics.collision_range
    search_radius = cr + eng.skin

    if eng.broadphase == "cells":
        if device_grid is None:
            host_grid, device_grid = build_grids(workload)

        def search(pos):
            return collide.cell_partner_search(pos, device_grid,
                                               search_radius)
    elif eng.broadphase == "allpairs":

        def search(pos):
            return collide.allpairs_partner_search(
                pos, search_radius, eng.allpairs_tile
            )
    else:
        raise ValueError(f"unknown broadphase {eng.broadphase!r}")

    def step(carry, step_index):
        state, measure, base_key = carry
        key = jax.random.fold_in(base_key, step_index)

        # DRIFT (Open_Air_Cube_MC.py:179-187) + path accrual.
        prior = state.pos
        state.paths = measure_ops.accumulate_drift(state, dt)
        state.pos = state.pos + dt * state.vel

        # WALL CASES
        state, measure, ledger = workload.wall_pass(
            state, prior, measure, key
        )
        if eng.debug_audits and workload.audit_fn is not None:
            missed = workload.audit_fn(state, prior)
        else:
            missed = jnp.zeros((10,), jnp.int32)
        state, oob_walls = workload.post_wall(state)

        # PARTICLE-PARTICLE COLLISIONS
        partner, overflow = search(state.pos)
        state, measure, pair_collisions, _ = collide.resolve_collisions(
            state, measure, partner, cr, physics.mass,
            eng.num_bins, eng.hist_range[1],
        )
        state, oob_pairs = workload.post_pairs(state)

        if eng.hist_flush_interval <= 1:
            measure = measure_ops.flush_pending(
                measure, eng.num_bins, eng.hist_range[1],
            )
        else:
            # Events accumulate across the flush window (one pending
            # slot per particle), so the compaction width scales with
            # the interval (ADVICE r2).
            n_particles = state.pos.shape[0]
            flush_cap = min(
                n_particles,
                measure_ops.FLUSH_CAPACITY * eng.hist_flush_interval,
            )
            measure = jax.lax.cond(
                step_index % eng.hist_flush_interval == 0,
                lambda m: measure_ops.flush_pending(
                    m, eng.num_bins, eng.hist_range[1],
                    capacity=flush_cap,
                ),
                lambda m: m,
                measure,
            )
        measure.overflow_count = measure.overflow_count + overflow
        measure.err_count = measure.err_count + ledger.errs
        measure.collision_count = measure.collision_count + ledger.wall_hits

        if eng.check_finite:
            nonfinite = (
                jnp.sum(~jnp.isfinite(state.pos), dtype=jnp.int32)
                + jnp.sum(~jnp.isfinite(state.vel), dtype=jnp.int32)
                + jnp.sum(~jnp.isfinite(state.paths), dtype=jnp.int32)
            )
        else:
            nonfinite = jnp.zeros((), jnp.int32)

        metrics = StepMetrics(
            momentum_z=ledger.momentum_z,
            energy_hot=ledger.energy_hot,
            energy_cold=ledger.energy_cold,
            collisions=pair_collisions + ledger.wall_hits,
            wall_hits=ledger.wall_hits,
            oob_after_walls=oob_walls,
            oob_after_pairs=oob_pairs,
            missed_cases=missed,
            nonfinite=nonfinite,
        )
        return (state, measure, base_key), metrics

    return step


def pairs_config_for(workload: Workload, num_particles: int | None = None):
    """PairConfig for a workload: capacities sized from the physics.

    lambda(K) = density * 4/3 pi (cr + 2 v_mean K dt)^3 is the expected
    in-reach candidate count per particle at rebuild (v_mean is the
    reference's RMS speed -- slightly conservative for capacity).

    ``num_particles`` overrides the population the capacities are sized
    for (the sharded engine passes its per-shard local+ghost lane
    count; the density -- and therefore lambda -- is global either way).
    """
    import math

    from .ops import pairs as pairs_ops

    cfg = workload.cfg
    physics = cfg.physics
    k = max(cfg.engine.rebuild_interval, 1)
    density = cfg.num_molecules / workload.fluid_volume
    radius = physics.collision_range + 2.0 * physics.v_mean * k * cfg.dt
    lam = density * (4.0 / 3.0) * math.pi * radius**3
    # Expected cell-table spills at the grid's capacity: each spilled
    # particle joins the HOT set for the whole window (re-searched
    # every step), so the research/append budgets must absorb them.
    # Interior occupancy is Poisson(density * cell^3); at the default
    # ~3.75-sigma capacity the expectation is ~tens of particles (the
    # sizing below is a no-op), but a deliberately THIN capacity
    # (EngineConfig.cell_capacity) shifts rebuild-sweep lanes (~cap^2)
    # into research lanes (~linear) and needs the budgets to follow.
    from .config import pairs_cell_capacity_for

    n_sized = cfg.num_molecules if num_particles is None else num_particles
    cap_cells = pairs_cell_capacity_for(
        cfg.engine, physics, cfg.num_molecules, workload.fluid_volume
    )
    cs = cell_size_for(cfg.engine, physics, cfg.num_molecules,
                       workload.fluid_volume)
    occ = max(density * cs**3, 1e-9)
    # Log-space Poisson pmf (exp(-occ) underflows above occ ~ 745) and
    # a tail bound of occ + 10 sqrt(occ) terms past the capacity, so a
    # thin capacity relative to a LARGE occupancy is not silently
    # under-sized (the regime this sizing exists for).
    e_spill_per_cell = 0.0
    log_p = -occ  # log P[X = 0]
    j_hi = max(cap_cells + 60, int(occ + 10.0 * math.sqrt(occ)) + 2)
    for j in range(1, j_hi):
        log_p += math.log(occ) - math.log(j)
        if j > cap_cells:
            e_spill_per_cell += (j - cap_cells) * math.exp(log_p)
    e_spill = (n_sized / max(occ, 1e-9)) * e_spill_per_cell
    spill_hot = int(math.ceil(1.5 * e_spill))
    pcfg = pairs_ops.default_pair_config(
        n_sized, k, pair_expectation=lam, spill_hot=spill_hot,
    )
    if getattr(cfg.engine, "rebuild_bf16_hittest", False):
        import dataclasses as _dc

        pcfg = _dc.replace(pcfg, bf16_hit=True)
    if not getattr(cfg.engine, "rebuild_occupancy_skip", True):
        import dataclasses as _dc

        pcfg = _dc.replace(pcfg, occupancy_skip=False)
    # The pair list can only cover collisions when the top-k emission
    # captures essentially every in-reach candidate.  Workloads whose
    # per-step drift is large relative to the collision range (the CUBE
    # stage: dt is 40x the pore's, ~19 collision ranges of drift per
    # step) blow the in-reach expectation up to ~140 and NO top-k can
    # cover it -- refusing is the only correct behaviour (measured: 0
    # of 2 collisions found, 139k overflow).
    if lam / 2.0 > 0.6 * pcfg.top_k:
        # The rebuild emission is one-sided: expected emissions per
        # particle are lambda/2 against the top_k budget.
        raise ValueError(
            f"narrowphase='pairs' cannot cover this workload: expected "
            f"in-reach candidates/particle lambda(K={k}) = {lam:.1f} "
            f"exceeds the top-{pcfg.top_k} emission budget (per-step "
            f"drift {2 * physics.v_mean * cfg.dt / physics.collision_range:.1f} "
            f"collision ranges). Reduce rebuild_interval or use "
            f"narrowphase='sweep'."
        )
    return pcfg


def make_pairs_step_fn(workload: Workload, device_grid, host_grid):
    """Scannable step for the Verlet reach-pair engine (ops/pairs.py).

    Carry: (state, measure, base_key, PairList).  Physics order matches
    make_step_fn exactly -- drift, walls, recapture, pair collisions,
    recapture -- with the narrow phase evaluated on the candidate list
    and dirty particles (speed changed / teleported / hot) re-searched
    in-step so coverage stays exact between rebuilds.

    The scheduled REBUILD is NOT part of this step: Simulation runs it
    as a separate jitted program between scan blocks of at most
    ``rebuild_interval`` steps (pairs_ops.rebuild on pre-drift
    positions).  Splitting the programs roughly halves each compiled
    HLO -- an in-step ``lax.cond`` would carry the entire candidate
    sweep in one branch of every step.  Rebuild *timing* never changes
    trajectories: the pair list is a superset of
    every possible collision pair for up to K steps after any rebuild
    and the per-step test is exact (tests/test_pairs.py asserts bitwise
    equality with the per-step sweep, and checkpoint resume already
    rebuilds on a shifted cadence).

    Scan xs: (step_index, rebuilt_flag) -- the flag only feeds the
    ``rebuilt`` diagnostic in StepMetrics.
    """
    from .ops import pairs as pairs_ops

    cfg = workload.cfg
    eng = cfg.engine
    physics = cfg.physics
    dt = cfg.dt
    cr = physics.collision_range
    if eng.broadphase != "cells":
        raise ValueError("narrowphase='pairs' requires broadphase='cells'")
    pcfg = pairs_config_for(workload)

    def step(carry, xs):
        step_index, rebuilt_flag = xs
        state, measure, base_key, plist = carry
        key = jax.random.fold_in(base_key, step_index)

        speed_pre = jnp.linalg.norm(state.vel, axis=-1)

        # DRIFT (Open_Air_Cube_MC.py:179-187) + path accrual.
        prior = state.pos
        state.paths = measure_ops.accumulate_drift(state, dt)
        state.pos = state.pos + dt * state.vel

        # WALL CASES
        state, measure, ledger = workload.wall_pass(
            state, prior, measure, key
        )
        if eng.debug_audits and workload.audit_fn is not None:
            missed = workload.audit_fn(state, prior)
        else:
            missed = jnp.zeros((10,), jnp.int32)
        pos_pre_recap = state.pos
        state, oob_walls = workload.post_wall(state)
        recap_w = jnp.any(state.pos != pos_pre_recap, axis=-1)

        # PARTICLE-PARTICLE COLLISIONS on the candidate list.
        state, measure, pair_collisions, collided = (
            pairs_ops.test_and_resolve(
                state, measure, plist, cr, eng.num_bins,
                eng.hist_range[1], pcfg.event_capacity,
            )
        )
        pos_pre_recap = state.pos
        state, oob_pairs = workload.post_pairs(state)
        recap_p = jnp.any(state.pos != pos_pre_recap, axis=-1)

        # DIRTY RE-SEARCH: anything whose displacement bound broke this
        # step (speed gain/loss via energized walls or impulses, or a
        # recapture teleport) plus the standing hot set.
        speed_post = jnp.linalg.norm(state.vel, axis=-1)
        bump = (speed_post != speed_pre) | collided
        # Teleported particles break the stale-position bound outright:
        # re-search them with fresh positions every remaining step.
        plist.hot = plist.hot | recap_w | recap_p
        # pending1: one-shot research of rebuild-time full emissions.
        # Consuming the queue here means an overlap such a particle
        # formed THIS step resolves next step (one-step latency vs the
        # sweep; ADVICE r2) -- counted in metrics.latent_full.
        latent_full = jnp.sum(plist.pending1, dtype=jnp.int32)
        dirty = bump | plist.hot | plist.pending1
        n = state.pos.shape[0]

        # ONE N-sized compaction shared by the histogram flush and the
        # dirty re-search instead of one each.  The
        # buffer scales with N: staged events + dirty are both
        # proportional to the per-step collision/wall-hit rate.
        shared_cap = max(measure_ops.FLUSH_CAPACITY, n // 64)
        shared_mask = measure.pending_mask | dirty
        shared_idx = compact_indices(shared_mask, shared_cap, n)
        safe_sh = jnp.clip(shared_idx, 0, n - 1)
        dirty_at = (shared_idx < n) & dirty[safe_sh]
        (dsel,) = jnp.nonzero(
            dirty_at, size=pcfg.research_capacity, fill_value=shared_cap
        )
        dirty_idx = jnp.where(
            dsel < shared_cap,
            shared_idx[jnp.clip(dsel, 0, shared_cap - 1)],
            n,
        )
        # Dirty particles beyond either compaction are a coverage hole;
        # count them and force a full rebuild next step.
        research_dropped = jnp.sum(dirty, dtype=jnp.int32) - jnp.sum(
            dirty_idx < n, dtype=jnp.int32
        )
        plist, research_lost, latent_per = pairs_ops.research_dirty(
            state, plist, dirty_idx, bump, device_grid, pcfg, cr, dt
        )
        latent_research = jnp.sum(latent_per, dtype=jnp.int32)
        # One-shot queue consumed (research_dropped > 0 forces a rebuild
        # anyway, so clearing unconditionally never loses coverage).
        plist.pending1 = jnp.zeros_like(plist.pending1)
        force_rebuild = research_lost | (research_dropped > 0)
        plist.age = jnp.where(
            force_rebuild, jnp.asarray(pairs_ops.INT_BIG, jnp.int32),
            plist.age + 1,
        )

        measure = measure_ops.flush_pending_compacted(
            measure, shared_idx, eng.num_bins, eng.hist_range[1]
        )
        measure.overflow_count = (
            measure.overflow_count + plist.overflow + research_dropped
        )
        measure.hot_spill_count = measure.hot_spill_count + plist.spill
        plist.overflow = jnp.zeros((), jnp.int32)
        plist.spill = jnp.zeros((), jnp.int32)
        measure.err_count = measure.err_count + ledger.errs
        measure.collision_count = measure.collision_count + ledger.wall_hits

        if eng.check_finite:
            nonfinite = (
                jnp.sum(~jnp.isfinite(state.pos), dtype=jnp.int32)
                + jnp.sum(~jnp.isfinite(state.vel), dtype=jnp.int32)
                + jnp.sum(~jnp.isfinite(state.paths), dtype=jnp.int32)
            )
        else:
            nonfinite = jnp.zeros((), jnp.int32)

        metrics = StepMetrics(
            momentum_z=ledger.momentum_z,
            energy_hot=ledger.energy_hot,
            energy_cold=ledger.energy_cold,
            collisions=pair_collisions + ledger.wall_hits,
            wall_hits=ledger.wall_hits,
            oob_after_walls=oob_walls,
            oob_after_pairs=oob_pairs,
            missed_cases=missed,
            nonfinite=nonfinite,
            rebuilt=rebuilt_flag.astype(jnp.int32),
            dirty_count=jnp.sum(dirty, dtype=jnp.int32),
            latent_full=latent_full,
            teleports=jnp.sum(recap_w | recap_p, dtype=jnp.int32),
            latent_research=latent_research,
        )
        return (state, measure, base_key, plist), metrics

    return step, pcfg


def _engine_jit(fun):
    """``jax.jit`` with optional XLA compiler options from the env.

    ``ARGON_COMPILER_OPTIONS`` (a JSON dict, e.g.
    ``{"exec_time_optimization_effort": -1.0}``) is forwarded to every
    engine program compile, so a run can trade optimization effort for
    compile time without a code change.  Unset (the default) takes the
    plain ``jax.jit`` path: byte-identical programs, byte-identical cache
    keys.
    """
    raw = os.environ.get("ARGON_COMPILER_OPTIONS")
    if not raw:
        return jax.jit(fun)
    return jax.jit(fun, compiler_options=json.loads(raw))


class Simulation:
    """Host-side driver: init once, run jitted epochs, stream metrics."""

    def __init__(self, workload: Workload):
        self.workload = workload
        self.cfg = workload.cfg
        self._hgrid, self._dgrid = build_grids(workload)
        hgrid = self._hgrid
        self._pairs_mode = (
            getattr(self.cfg.engine, "narrowphase", "sweep") == "pairs"
        )
        if self._pairs_mode and self._dgrid is None:
            raise ValueError(
                "narrowphase='pairs' requires broadphase='cells' (the "
                "pair-list rebuild sweeps the cell grid)"
            )
        self._aux = None  # PairList carried across epochs (pairs mode)
        # Steps left before the next scheduled rebuild (pairs mode; the
        # host schedules rebuilds at scan-block boundaries).
        self._window_left = 0
        # Identity of the state object the last run() returned: passing
        # any OTHER state invalidates the carried pair list (its indices
        # describe the old trajectory).
        self._last_state_out = None

        if self._pairs_mode:
            from .ops import pairs as pairs_ops

            pcfg = pairs_config_for(workload)
            cr = self.cfg.physics.collision_range
            dt = self.cfg.dt

            def run_rebuild(state, plist, dgrid):
                return pairs_ops.rebuild(state, dgrid, pcfg, cr, dt,
                                         plist)

            # A separate jitted program from the step scan: see the
            # make_pairs_step_fn docstring (compile-size split).
            self._rebuild_jit = _engine_jit(run_rebuild)
            # EngineConfig.eager_rebuild / ARGON_EAGER_REBUILD=1: run the
            # rebuild OUTSIDE jit, so each op -- and the chunked sweep's
            # internal lax.scan -- compiles as its own small program
            # instead of one, at the cost of ~50 dispatches per rebuild
            # (amortized over K steps).  Physics is bitwise-identical:
            # the ops are the same XLA programs, and eager fusion
            # boundaries do not change reduction order (tested).
            self._rebuild_eager = (
                getattr(self.cfg.engine, "eager_rebuild", False)
                or os.environ.get("ARGON_EAGER_REBUILD") == "1"
            )
            self._run_rebuild_eager = run_rebuild
            # Mid-grain alternative (EngineConfig.split_rebuild_programs
            # / ARGON_SPLIT_REBUILD=1): the rebuild as THREE jitted
            # programs -- tables (bin/sort/pack), candidate sweep, list
            # epilogue -- at the seams pairs.rebuild already exposes:
            # three smaller programs, 3 dispatches per rebuild.  The
            # tables|sweep boundary (mega, pslot) is ALREADY
            # materialized in PairList, so the split adds just the
            # (N, top_k) cands buffer of HBM traffic.  Bitwise-
            # identical trajectories (tested).
            self._rebuild_split = (
                getattr(self.cfg.engine, "split_rebuild_programs", False)
                or os.environ.get("ARGON_SPLIT_REBUILD") == "1"
            )
            if self._rebuild_split:
                k_reb = pcfg.rebuild_interval

                def rb_tables(state, dgrid):
                    reach, clipped = pairs_ops.reach_radii(
                        state.vel, cr, dt, k_reb,
                        0.5 * dgrid.cell_size)
                    mega, pslot, overflow = collide.cell_candidate_search(
                        state.pos, dgrid, reach=reach, top_k=pcfg.top_k,
                        one_sided=True, half_shell=True,
                        bf16_hit=pcfg.bf16_hit,
                        occupancy_skip=pcfg.occupancy_skip,
                        tables_only=True,
                    )
                    return mega, pslot, overflow, clipped

                def rb_sweep(mega, pslot, dgrid):
                    return collide.cell_search_sweep(
                        mega, pslot, dgrid, pslot.shape[0],
                        has_ids=False, has_reach=True, top_k=pcfg.top_k,
                        one_sided=True, half_shell=True,
                        bf16_hit=pcfg.bf16_hit,
                        occupancy_skip=pcfg.occupancy_skip,
                    )

                def rb_finish(cands, overflow, pslot, mega, unswept,
                              clipped, plist, dgrid):
                    return pairs_ops.rebuild_finish(
                        cands, overflow, pslot, mega, unswept, clipped,
                        plist, dgrid, pcfg, pslot.shape[0],
                    )

                t_jit = _engine_jit(rb_tables)
                s_jit = _engine_jit(rb_sweep)
                f_jit = _engine_jit(rb_finish)

                def run_rebuild_split(state, plist, dgrid):
                    mega, pslot, overflow, clipped = t_jit(state, dgrid)
                    cands, unswept = s_jit(mega, pslot, dgrid)
                    return f_jit(cands, overflow, pslot, mega, unswept,
                                 clipped, plist, dgrid)

                self._run_rebuild_split = run_rebuild_split

            def run_epoch(state, measure, base_key, step_indices,
                          rebuilt_flags, dgrid, aux):
                step, _ = make_pairs_step_fn(workload, dgrid, hgrid)
                (state, measure, _, aux), metrics = jax.lax.scan(
                    step, (state, measure, base_key, aux),
                    (step_indices, rebuilt_flags),
                )
                return state, measure, metrics, aux

            k_blk = max(self.cfg.engine.rebuild_interval, 1)

            def run_epoch_fused(state, measure, base_key, step_indices,
                                dgrid, aux):
                """Whole-window blocks in ONE program: an outer scan of
                [unconditional rebuild -> inner scan of K steps].  One
                dispatch covers many blocks, so per-dispatch host
                overhead is paid once per epoch instead of twice per
                block (engine._run_epoch uses this fused program for
                every aligned whole-window span and the split programs
                for tails and above fused_epoch_max_particles).  No
                lax.cond anywhere: the rebuild runs exactly at block
                starts, which is bitwise-identical to any other
                rebuild cadence (superset + exact per-step test)."""
                step, _ = make_pairs_step_fn(workload, dgrid, hgrid)
                blocks = step_indices.reshape(-1, k_blk)

                def block(carry, idx_k):
                    state, measure, aux = carry
                    aux = pairs_ops.rebuild(state, dgrid, pcfg, cr, dt,
                                            aux)
                    flags = jnp.zeros((k_blk,), jnp.bool_).at[0].set(
                        True)
                    (state, measure, _, aux), metrics = jax.lax.scan(
                        step, (state, measure, base_key, aux),
                        (idx_k, flags),
                    )
                    return (state, measure, aux), metrics

                (state, measure, aux), metrics = jax.lax.scan(
                    block, (state, measure, aux), blocks
                )
                metrics = jax.tree.map(
                    lambda x: x.reshape((-1,) + x.shape[2:]), metrics
                )
                return state, measure, metrics, aux

            self._run_epoch_fused = _engine_jit(run_epoch_fused)

        else:

            def run_epoch(state, measure, base_key, step_indices, dgrid,
                          aux):
                step = make_step_fn(workload, dgrid, host_grid=hgrid)
                (state, measure, _), metrics = jax.lax.scan(
                    step, (state, measure, base_key), step_indices
                )
                return state, measure, metrics, aux

        self._run_epoch_grid = _engine_jit(run_epoch)

    def _init_aux(self, state):
        if not self._pairs_mode:
            return ()
        from .ops import pairs as pairs_ops

        pcfg = pairs_config_for(self.workload)
        return pairs_ops.PairList.init(
            state.num_particles, self._dgrid, pcfg,
            jnp.dtype(self.cfg.engine.dtype),
        )

    def _run_epoch(self, state, measure, base_key, step_indices):
        if not self._pairs_mode:
            state, measure, metrics, self._aux = self._run_epoch_grid(
                state, measure, base_key, step_indices, self._dgrid,
                self._aux,
            )
            return state, measure, metrics

        # Pairs mode: the epoch is a host loop of scan BLOCKS of at most
        # rebuild_interval steps, each preceded (when the reach window is
        # exhausted) by the separately-jitted rebuild program.  Any block
        # partition with <= K steps per rebuild window yields the exact
        # same trajectory (see make_pairs_step_fn); the window phase is
        # carried across epochs so epoch length never forces an early
        # rebuild.
        if self._aux is None:
            self._aux = self._init_aux(state)
            self._window_left = 0
        k = max(self.cfg.engine.rebuild_interval, 1)
        # The fused whole-window program amortizes per-dispatch host
        # overhead; above the configured N the engine dispatches the
        # smaller rebuild and block programs instead.  See
        # EngineConfig.fused_epoch_max_particles.
        max_block = getattr(self.cfg.engine, "max_block_steps", None)
        if max_block is None:
            env_mb = os.environ.get("ARGON_MAX_BLOCK_STEPS")
            if env_mb:
                max_block = int(env_mb)
        fused_ok = (self.cfg.num_molecules
                    <= self.cfg.engine.fused_epoch_max_particles
                    and not self._rebuild_eager
                    and not self._rebuild_split
                    and max_block is None)
        outs = []
        i, total = 0, int(step_indices.shape[0])
        while i < total:
            remaining = total - i
            if (fused_ok and self._window_left <= 0
                    and remaining >= k):
                m = (remaining // k) * k
                state, measure, metrics, self._aux = (
                    self._run_epoch_fused(
                        state, measure, base_key,
                        step_indices[i:i + m], self._dgrid, self._aux,
                    )
                )
                outs.append(metrics)
                i += m
                continue
            rebuilt = False
            if self._window_left <= 0:
                if self._rebuild_eager:
                    rebuild_fn = self._run_rebuild_eager
                elif self._rebuild_split:
                    rebuild_fn = self._run_rebuild_split
                else:
                    rebuild_fn = self._rebuild_jit
                self._aux = rebuild_fn(state, self._aux, self._dgrid)
                self._window_left = k
                rebuilt = True
            m = int(min(self._window_left, total - i))
            if max_block is not None:
                m = min(m, int(max_block))
            import numpy as _np

            flags = _np.zeros((m,), _np.bool_)
            flags[0] = rebuilt
            state, measure, metrics, self._aux = self._run_epoch_grid(
                state, measure, base_key, step_indices[i:i + m], flags,
                self._dgrid, self._aux,
            )
            outs.append(metrics)
            i += m
            self._window_left -= m
        if len(outs) == 1:
            return state, measure, outs[0]
        metrics = jax.tree.map(
            lambda *xs: jnp.concatenate(xs), *outs
        )
        return state, measure, metrics

    def init(self, seed: Optional[int] = None):
        seed = self.cfg.seed if seed is None else seed
        key = jax.random.PRNGKey(seed)
        init_key, run_key = jax.random.split(key)
        state = self.workload.init_fn(init_key)
        measure = Measurements.zeros(
            self.cfg.engine.num_bins, jnp.dtype(self.cfg.engine.dtype),
            num_particles=state.num_particles,
        )
        return state, measure, run_key

    def run(self, num_steps: Optional[int] = None, seed=None,
            state=None, measure=None, run_key=None, start_step: int = 0,
            epoch_callback=None):
        """Run the simulation; returns (state, measure, stacked metrics).

        ``epoch_callback(epoch_metrics)`` is invoked per epoch with the
        device metrics for streaming/logging.
        """
        if num_steps is None:
            num_steps = self.cfg.num_timesteps
        if state is None:
            state, measure, run_key = self.init(seed)
            # Fresh particle state invalidates any carried pair list
            # (indices refer to the old state); force a rebuild.
            self._aux = None
        elif state is not self._last_state_out:
            # An explicitly-passed state that is NOT the object the last
            # run() returned (e.g. a loaded checkpoint) invalidates the
            # carried pair list: its entries/hot set/packed planes
            # describe the previous trajectory (ADVICE r2).
            self._aux = None
        spe = self.cfg.engine.steps_per_epoch
        all_metrics = []
        step = start_step
        end = start_step + num_steps
        while step < end:
            n = min(spe, end - step)
            indices = jnp.arange(step, step + n, dtype=jnp.int32)
            state, measure, metrics = self._run_epoch(
                state, measure, run_key, indices
            )
            all_metrics.append(metrics)
            if epoch_callback is not None:
                epoch_callback(metrics)
            step += n
        stacked = jax.tree.map(
            lambda *xs: jnp.concatenate([jnp.atleast_1d(x) for x in xs]),
            *all_metrics,
        ) if all_metrics else None
        self._last_state_out = state
        return state, measure, stacked

    @staticmethod
    def finalize_measure(measure: Measurements) -> Measurements:
        """Global accumulator totals (identity on a single chip; the
        sharded engine sums across shards here)."""
        return measure
