"""z-slab domain-decomposed engine over a JAX device mesh.

Device replacement for the reference's single-host multiprocessing
runtime (Pool/Manager/Value, Open_Air_Pore_MC.py:408-549; SURVEY.md
section 2.3): the pore is 1D-dominant along z, so each device owns a
contiguous z-slab with a fixed-capacity particle buffer.  Per step:

1. drift + wall cases + recapture run shard-locally (geometry is global
   and stateless, so no communication);
2. *halo exchange*: particles within ``halo_width = 2 x search_radius`` of
   a slab face are copied to the neighbouring device via ``lax.ppermute``
   (nearest-neighbour traffic only);
3. *pair collisions*: each shard searches partners over local + ghost
   particles, sweeping only its own (halo-padded) window of global grid
   cells.  Because the halo is two search radii deep, both shards see the
   full neighbourhood of every boundary particle and deterministically
   reach the SAME matching decision, so a cross-shard pair is resolved
   consistently on both sides with no result exchange at all -- the
   impulse formula is symmetric (ops/collide.py).  Each pair is counted
   once, by the shard owning the lower global id.
4. *migration*: particles that drifted across a slab face are moved to
   the neighbour (ppermute again) and merged into free buffer slots.

Ledgers are psum'd per step; measurement accumulators stay per-shard and
are summed on the host at reporting time.  The reference's checkerboard
coloring, locked counters and Manager lists have no analogue here: SPMD +
symmetric resolution gives write independence by construction.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import cell_capacity_for, cell_size_for
from ..engine import Workload
from ..ops import collide
from ..ops import measure as measure_ops
from ..ops.compact import compact_indices
from ..state import Measurements, ParticleState, StepMetrics
from .mesh import AXIS, make_mesh

SENTINEL = 1e9


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Host-side decomposition plan (static per run)."""

    n_shards: int
    slab_z: np.ndarray        # (n_shards+1,) slab boundaries, on cell-layer edges
    cell_start: np.ndarray    # (n_shards,) first swept flat cell id
    cell_window: int          # static swept-cell count (max over shards)
    shard_capacity: int
    halo_capacity: int
    migration_capacity: int
    halo_width: float
    park: tuple[float, float, float]
    # --- pairs narrow phase (narrowphase="pairs") ---------------------
    # Ghost-band width at rebuild: 2 * cell_size.  Any pair colliding
    # within the K-step window satisfied |x_i - x_j| < reach_i + reach_j
    # <= cell_size at rebuild time, and computing a boundary particle's
    # mutual-match choice needs its full candidate set -- candidates sit
    # within 2*max_reach = cell_size of a particle itself within
    # cell_size of the face, hence the 2-cell band (ops/pairs.py).
    pairs_band_width: float = 0.0
    pairs_cell_start: Optional[np.ndarray] = None
    pairs_cell_window: int = 0
    pairs_halo_capacity: int = 0
    # Active-cell windows (ops/collide Grid.active_cells): the sorted
    # active list maps each shard's contiguous cell window to a
    # contiguous slice [active_start[s], active_start[s] + window).
    # None when the grid has no active list (cube).
    pairs_active_start: Optional[np.ndarray] = None
    pairs_active_window: int = 0
    # Migration runs only at block boundaries (every K steps), so the
    # buffer covers K steps of crossings.
    pairs_migration_capacity: int = 0


def _volume_profile(geom, z_edges):
    """Fluid cross-section area integrated over each z interval."""
    if hasattr(geom, "total_height"):  # pore stack
        def area(z):
            if z < geom.open_air_height or z >= geom.cold_top:
                return math.pi * geom.open_air_radius**2
            if geom.gap_bottom <= z < geom.gap_top:
                return math.pi * geom.gap_radius**2
            return math.pi * geom.pore_coated_radius**2
    else:  # cube
        def area(z):
            return geom.lx * geom.ly
    mids = 0.5 * (z_edges[:-1] + z_edges[1:])
    widths = np.diff(z_edges)
    return np.array([area(m) for m in mids]) * widths


def make_shard_plan(workload: Workload, n_shards: int,
                    host_grid: collide.Grid) -> ShardPlan:
    cfg = workload.cfg
    geom = cfg.geometry
    physics = cfg.physics
    eng = cfg.engine
    n = cfg.num_molecules
    search_radius = physics.collision_range + eng.skin
    halo_width = 2.0 * search_radius

    # Particle-balanced slab cuts on grid-layer boundaries (SURVEY.md
    # section 7 "load imbalance": volume-weighted, not height-equal).
    cs = host_grid.cell_size
    z_edges = host_grid.z_lo + cs * np.arange(host_grid.nz + 1)
    vol = _volume_profile(geom, z_edges)
    cum = np.concatenate([[0.0], np.cumsum(vol)])
    cum /= cum[-1]
    cut_layers = [0]
    for k in range(1, n_shards):
        cut_layers.append(int(np.searchsorted(cum, k / n_shards)))
    cut_layers.append(host_grid.nz)
    cut_layers = np.maximum.accumulate(cut_layers)  # monotone safety
    slab_z = z_edges[cut_layers]
    slab_z[0] = host_grid.z_lo
    slab_z[-1] = host_grid.z_lo + cs * host_grid.nz

    # Per-shard particle share from the volume profile.
    shares = np.diff(cum[cut_layers])
    max_share = float(shares.max())
    shard_capacity = int(np.ceil(max_share * n * 1.3 / 8.0) * 8) + 8

    # Swept cell windows: own layers +- halo layers.
    halo_layers = int(math.ceil(halo_width / cs)) + 1
    layer_cells = (host_grid.nx.astype(np.int64)) ** 2
    layer_cum = np.concatenate([[0], np.cumsum(layer_cells)])
    starts, widths = [], []
    for s in range(n_shards):
        lo = max(cut_layers[s] - halo_layers, 0)
        hi = min(cut_layers[s + 1] + halo_layers, host_grid.nz)
        starts.append(int(layer_cum[lo]))
        widths.append(int(layer_cum[hi] - layer_cum[lo]))
    cell_window = max(widths)

    # Halo / migration buffer sizing from the local density near cuts.
    density = n / workload.fluid_volume
    max_area = vol.max() / cs  # widest cross-section area
    band = density * max_area * halo_width
    halo_capacity = int(np.ceil((band * 4.0 + 64.0) / 8.0) * 8)
    # Per-step crossings ~= density * area * mean |v_z| * dt; be generous.
    v_scale = 5.0 * physics.a_shape
    crossings = density * max_area * v_scale * cfg.dt
    migration_capacity = int(np.ceil((crossings * 8.0 + 64.0) / 8.0) * 8)

    if hasattr(geom, "total_height"):
        park = (0.0, 0.0, geom.total_height / 2.0)
    else:
        park = (geom.lx / 2.0, geom.ly / 2.0, geom.lz / 2.0)

    # Pairs-mode sizing (see ShardPlan field comments).
    pairs_band = 2.0 * cs
    halo_layers_p = int(math.ceil(pairs_band / cs)) + 1
    starts_p, widths_p = [], []
    for s in range(n_shards):
        lo = max(cut_layers[s] - halo_layers_p, 0)
        hi = min(cut_layers[s + 1] + halo_layers_p, host_grid.nz)
        starts_p.append(int(layer_cum[lo]))
        widths_p.append(int(layer_cum[hi] - layer_cum[lo]))
    band_p = density * max_area * pairs_band
    pairs_halo_capacity = int(np.ceil((band_p * 3.0 + 64.0) / 8.0) * 8)
    if host_grid.active_cells is not None:
        act = host_grid.active_cells
        a_lo = np.searchsorted(act, np.asarray(starts_p, np.int64))
        a_hi = np.searchsorted(
            act, np.asarray(starts_p, np.int64)
            + np.asarray(widths_p, np.int64)
        )
        pairs_active_start = a_lo.astype(np.int32)
        pairs_active_window = int((a_hi - a_lo).max())
    else:
        pairs_active_start = None
        pairs_active_window = 0
    k_steps = max(getattr(eng, "rebuild_interval", 1), 1)
    pairs_migration_capacity = int(
        np.ceil((crossings * 8.0 * k_steps + 64.0) / 8.0) * 8
    )

    return ShardPlan(
        n_shards=n_shards,
        slab_z=slab_z.astype(np.float64),
        cell_start=np.asarray(starts, np.int32),
        cell_window=cell_window,
        shard_capacity=shard_capacity,
        halo_capacity=halo_capacity,
        migration_capacity=migration_capacity,
        halo_width=float(halo_width),
        park=park,
        pairs_band_width=float(pairs_band),
        pairs_cell_start=np.asarray(starts_p, np.int32),
        pairs_cell_window=max(widths_p),
        pairs_halo_capacity=pairs_halo_capacity,
        pairs_migration_capacity=pairs_migration_capacity,
        pairs_active_start=pairs_active_start,
        pairs_active_window=pairs_active_window,
    )


def _compact_band(fields: dict, mask: jnp.ndarray, capacity: int):
    """Pack masked lanes into a fixed-size buffer; returns (buf, n_dropped).

    buf carries a 'flag' field marking filled slots.
    """
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    sel = mask & (rank < capacity)
    slot = jnp.where(sel, rank, capacity)  # capacity = junk slot
    out = {}
    for name, arr in fields.items():
        pad_shape = (capacity + 1,) + arr.shape[1:]
        fill = SENTINEL if name == "pos" else 0
        buf = jnp.full(pad_shape, fill, arr.dtype)
        out[name] = buf.at[slot].set(arr, mode="drop")[:capacity]
    flag = jnp.zeros((capacity + 1,), jnp.bool_).at[slot].set(
        sel, mode="drop"
    )[:capacity]
    out["flag"] = flag
    dropped = jnp.sum(mask & ~sel, dtype=jnp.int32)
    return out, dropped


def _compact_idx(mask: jnp.ndarray, capacity: int):
    """Compact the lane INDICES of masked lanes into a fixed buffer.

    Returns (idx (capacity,) int32 with sentinel n for empty slots,
    flag (capacity,) bool, n_dropped).  The pairs engine freezes these
    export lists at rebuild so ghost lanes stay stable for a whole
    K-step block (the pair list references them by lane)."""
    n = mask.shape[0]
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    sel = mask & (rank < capacity)
    slot = jnp.where(sel, rank, capacity)
    idx = jnp.full((capacity + 1,), n, jnp.int32).at[slot].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )[:capacity]
    flag = jnp.zeros((capacity + 1,), jnp.bool_).at[slot].set(
        sel, mode="drop"
    )[:capacity]
    dropped = jnp.sum(mask & ~sel, dtype=jnp.int32)
    return idx, flag, dropped


def _count_nonfinite(state, valid, eng):
    """Per-shard NaN/inf count over valid lanes (the sharded analogue of
    the single-chip check_finite sanitizer; invalid lanes hold finite
    sentinels but are masked anyway for clarity)."""
    if not eng.check_finite:
        return jnp.zeros((), jnp.int32)
    bad = (
        jnp.sum(~jnp.isfinite(state.pos) & valid[:, None],
                dtype=jnp.int32)
        + jnp.sum(~jnp.isfinite(state.vel) & valid[:, None],
                  dtype=jnp.int32)
        + jnp.sum(~jnp.isfinite(state.paths) & valid[:, None],
                  dtype=jnp.int32)
    )
    return bad


def _ppermute_tree(tree, perm):
    """ppermute every leaf (bools ride as uint8); unaddressed shards
    receive zeros, which read as flag=False / position 0 and are masked
    out by the flag."""

    def go(x):
        if x.dtype == jnp.bool_:
            return jax.lax.ppermute(
                x.astype(jnp.uint8), AXIS, perm
            ).astype(jnp.bool_)
        return jax.lax.ppermute(x, AXIS, perm)

    return jax.tree.map(go, tree)


class ShardedSimulation:
    """Drop-in multi-device counterpart of engine.Simulation."""

    def __init__(self, workload: Workload, n_devices: Optional[int] = None,
                 mesh: Optional[jax.sharding.Mesh] = None):
        self.workload = workload
        self.cfg = workload.cfg
        cfg = self.cfg
        eng = cfg.engine
        self._pairs_mode = getattr(eng, "narrowphase", "sweep") == "pairs"
        if eng.hist_flush_interval != 1:
            # The sharded step flushes staged path events every step with
            # the exact dense scatter (per-shard lane counts make the
            # compacted buffer unnecessary); batching flushes across an
            # interval is a single-chip bandwidth knob that does not
            # apply here.  Refuse rather than silently ignore the knob
            # (VERDICT r2 weak item 6).
            raise ValueError(
                "ShardedSimulation always flushes histograms every step "
                "(exact dense scatter); set hist_flush_interval=1 "
                f"(got {eng.hist_flush_interval})"
            )
        physics = cfg.physics
        self.dtype = jnp.dtype(eng.dtype)

        if mesh is None:
            mesh = make_mesh(n_devices)
        self.mesh = mesh
        n_shards = mesh.devices.size

        cell_size = cell_size_for(eng, physics, cfg.num_molecules,
                                  workload.fluid_volume)
        if self._pairs_mode:
            from ..config import pairs_cell_capacity_for

            capacity = pairs_cell_capacity_for(
                eng, physics, cfg.num_molecules, workload.fluid_volume
            )
        else:
            capacity = cell_capacity_for(eng, physics, cfg.num_molecules,
                                         workload.fluid_volume)
        geom = cfg.geometry
        if hasattr(geom, "total_height"):
            self.host_grid = collide.grid_for_pore(geom, cell_size, capacity)
            center = (0.0, 0.0)
        else:
            self.host_grid = collide.grid_for_cube(geom, cell_size, capacity)
            center = (geom.lx / 2.0, geom.ly / 2.0)
        self.device_grid = collide.DeviceGrid.from_grid(
            self.host_grid, self.dtype, center,
            packed_layers=getattr(cfg.engine, "packed_layer_gather",
                                  False),
        )
        self.plan = make_shard_plan(workload, n_shards, self.host_grid)
        if self._pairs_mode:
            self._ctx = None        # per-block pair context (device)
            self._window_left = 0
            self._last_state_out = None
            self._build_pairs_fns()
        else:
            self._build_epoch_fn()

    # ------------------------------------------------------------------
    def _build_epoch_fn(self):
        plan = self.plan
        cfg = self.cfg
        eng = cfg.engine
        physics = cfg.physics
        workload = self.workload
        grid = self.device_grid
        dt = cfg.dt
        cr = physics.collision_range
        search_radius = cr + eng.skin
        dtype = self.dtype
        cap = plan.shard_capacity
        hcap = plan.halo_capacity
        mcap = plan.migration_capacity
        n_shards = plan.n_shards
        park = jnp.asarray(plan.park, dtype)
        slab_z = jnp.asarray(plan.slab_z, dtype)
        cell_start = jnp.asarray(plan.cell_start)
        perm_up = [(i, i + 1) for i in range(n_shards - 1)]
        perm_down = [(i + 1, i) for i in range(n_shards - 1)]

        def masked_phase(state, valid, fn):
            """Run wall/recapture logic with invalid lanes parked at a
            safe interior point, then restore the far-away sentinel."""
            state.pos = jnp.where(valid[:, None], state.pos, park)
            out = fn(state)
            state = out[0]
            state.pos = jnp.where(valid[:, None], state.pos, SENTINEL)
            return (state,) + out[1:]

        def step(carry, step_index):
            state, valid, gid, measure, shard_key = carry
            key = jax.random.fold_in(shard_key, step_index)
            me = jax.lax.axis_index(AXIS)
            z_lo = slab_z[me]
            z_hi = slab_z[me + 1]

            # DRIFT (invalid lanes have vel=0, pos=SENTINEL: no-ops).
            prior = state.pos
            state.paths = measure_ops.accumulate_drift(state, dt)
            state.pos = state.pos + dt * state.vel

            # WALLS + recapture, shard-local under parking.
            prior_parked = jnp.where(valid[:, None], prior, park)

            def walls(st):
                return workload.wall_pass(st, prior_parked, measure, key)

            state, measure, ledger = masked_phase(state, valid, walls)
            # Missed-case audit (reference re-evaluates every wall-case
            # predicate post-handling, Open_Air_Pore_MC.py:488-511); run
            # on the parked view so invalid lanes can't trip predicates.
            if eng.debug_audits and workload.audit_fn is not None:
                parked = jnp.where(valid[:, None], state.pos, park)
                audit_state = dataclasses.replace(state, pos=parked)
                missed = workload.audit_fn(audit_state, prior_parked)
            else:
                missed = jnp.zeros((10,), jnp.int32)
            state, oob_walls = masked_phase(state, valid, workload.post_wall)

            # HALO EXCHANGE: copy boundary bands to neighbours.
            z = state.pos[:, 2]
            up_band, d1 = _compact_band(
                {"pos": state.pos, "vel": state.vel, "gid": gid},
                valid & (z > z_hi - plan.halo_width), hcap,
            )
            down_band, d2 = _compact_band(
                {"pos": state.pos, "vel": state.vel, "gid": gid},
                valid & (z < z_lo + plan.halo_width), hcap,
            )
            ghost_from_below = _ppermute_tree(up_band, perm_up)
            ghost_from_above = _ppermute_tree(down_band, perm_down)

            def ghost_fix(g):
                flag = g["flag"]
                g["pos"] = jnp.where(flag[:, None], g["pos"], SENTINEL)
                return g

            gb = ghost_fix(ghost_from_below)
            ga = ghost_fix(ghost_from_above)

            # COMBINED local + ghost arrays for the pair phase.
            pos_c = jnp.concatenate([state.pos, gb["pos"], ga["pos"]])
            vel_c = jnp.concatenate([state.vel, gb["vel"], ga["vel"]])
            gid_c = jnp.concatenate([gid, gb["gid"], ga["gid"]])
            valid_c = jnp.concatenate([valid, gb["flag"], ga["flag"]])
            local_c = jnp.concatenate([
                valid,
                jnp.zeros((2 * hcap,), jnp.bool_),
            ])
            paths_c = jnp.concatenate([
                state.paths, jnp.zeros((2 * hcap, 4), dtype)
            ])
            hc_c = jnp.concatenate([
                state.has_collided, jnp.zeros((2 * hcap,), jnp.bool_)
            ])

            partner, overflow = collide.cell_partner_search(
                pos_c, grid, search_radius, ids=gid_c, valid=valid_c,
                cell_window=(cell_start[me], plan.cell_window),
            )
            comb = ParticleState(pos=pos_c, vel=vel_c, paths=paths_c,
                                 has_collided=hc_c)
            comb, measure, _, ok = collide.resolve_collisions(
                comb, measure, partner, cr, physics.mass, eng.num_bins,
                eng.hist_range[1], local_mask=local_c,
            )
            # Count each pair once: the shard owning the lower gid counts.
            safe_p = jnp.where(partner >= 0, partner, 0)
            partner_gid = gid_c[safe_p]
            pair_count = jnp.sum(
                ok & local_c & (gid_c < partner_gid), dtype=jnp.int32
            )
            measure.collision_count = measure.collision_count + pair_count

            state.pos = comb.pos[:cap]
            state.vel = comb.vel[:cap]
            state.paths = comb.paths[:cap]
            state.has_collided = comb.has_collided[:cap]

            state, oob_pairs = masked_phase(state, valid,
                                            workload.post_pairs)
            # Dense scatter (compact=False): per-shard lane counts can
            # exceed the fixed compaction width and the dense path is
            # exact (ADVICE r2).
            measure = measure_ops.flush_pending(
                measure, eng.num_bins, eng.hist_range[1], compact=False
            )

            # MIGRATION: move crossers to the neighbouring shard.
            z = state.pos[:, 2]
            go_up = valid & (z >= z_hi) & (me < n_shards - 1)
            go_down = valid & (z < z_lo) & (me > 0)
            payload = {
                "pos": state.pos, "vel": state.vel, "paths": state.paths,
                "hc": state.has_collided, "gid": gid,
            }
            up_buf, d3 = _compact_band(payload, go_up, mcap)
            down_buf, d4 = _compact_band(payload, go_down, mcap)
            inc_lo = _ppermute_tree(up_buf, perm_up)      # from below
            inc_hi = _ppermute_tree(down_buf, perm_down)  # from above
            valid = valid & ~(go_up | go_down)
            state.pos = jnp.where(valid[:, None], state.pos, SENTINEL)
            state.vel = jnp.where(valid[:, None], state.vel, 0.0)

            # Merge incoming into free slots (argsort(valid): free first).
            inc = jax.tree.map(
                lambda a, b: jnp.concatenate([a, b]), inc_lo, inc_hi
            )
            flag = inc["flag"]
            free_order = jnp.argsort(valid)  # False < True
            num_free = cap - jnp.sum(valid, dtype=jnp.int32)
            rank = jnp.cumsum(flag.astype(jnp.int32)) - 1
            place = flag & (rank < num_free)
            target = jnp.where(place, free_order[jnp.clip(rank, 0, cap - 1)],
                               cap)  # cap = dropped
            state.pos = state.pos.at[target].set(inc["pos"], mode="drop")
            state.vel = state.vel.at[target].set(inc["vel"], mode="drop")
            state.paths = state.paths.at[target].set(inc["paths"],
                                                     mode="drop")
            state.has_collided = state.has_collided.at[target].set(
                inc["hc"], mode="drop"
            )
            gid = gid.at[target].set(inc["gid"], mode="drop")
            valid = valid.at[target].set(place, mode="drop")
            # ACTUAL particle loss: migration-buffer drops (d3, d4) and
            # receive-side buffer-full drops go to overflow_count.  Halo-
            # band truncation (d1, d2) only loses cross-shard collision
            # VISIBILITY (the particle stays on its owner), so it is
            # tracked separately (halo_trunc_count) and a nonzero value
            # asks for a bigger halo_capacity, not a lost-particle hunt.
            lost = jnp.sum(flag & ~place, dtype=jnp.int32) + d3 + d4
            measure.overflow_count = (
                measure.overflow_count + overflow + lost
            )
            measure.halo_trunc_count = (
                measure.halo_trunc_count + d1 + d2
            )
            measure.err_count = measure.err_count + ledger.errs
            measure.collision_count = (
                measure.collision_count + ledger.wall_hits
            )

            metrics = StepMetrics(
                momentum_z=jax.lax.psum(ledger.momentum_z, AXIS),
                energy_hot=jax.lax.psum(ledger.energy_hot, AXIS),
                energy_cold=jax.lax.psum(ledger.energy_cold, AXIS),
                collisions=jax.lax.psum(
                    pair_count + ledger.wall_hits, AXIS
                ),
                wall_hits=jax.lax.psum(ledger.wall_hits, AXIS),
                oob_after_walls=jax.lax.psum(oob_walls, AXIS),
                oob_after_pairs=jax.lax.psum(oob_pairs, AXIS),
                missed_cases=jax.lax.psum(missed, AXIS),
                nonfinite=jax.lax.psum(
                    _count_nonfinite(state, valid, eng), AXIS
                ),
            )
            return (state, valid, gid, measure, shard_key), metrics

        def epoch(state, valid, gid, measure, base_key, step_indices):
            me = jax.lax.axis_index(AXIS)
            shard_key = jax.random.fold_in(base_key, me)
            measure = jax.tree.map(lambda x: x[0], measure)  # unstack
            carry = (state, valid, gid, measure, shard_key)
            carry, metrics = jax.lax.scan(step, carry, step_indices)
            state, valid, gid, measure, _ = carry
            measure = jax.tree.map(lambda x: x[None], measure)  # restack
            return state, valid, gid, measure, metrics

        P = jax.sharding.PartitionSpec
        self._epoch = jax.jit(
            jax.shard_map(
                epoch,
                mesh=self.mesh,
                in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P()),
                out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
            )
        )

    # ------------------------------------------------------------------
    def _build_pairs_fns(self):
        """Sharded Verlet reach-pair engine (narrowphase='pairs').

        Mirrors the single-chip block structure (engine.Simulation): a
        separately-jitted REBUILD program runs at block boundaries and a
        scan-block program runs up to rebuild_interval steps.  The
        sharded specifics:

        * Ghost bands of width ``pairs_band_width`` (2 cells) are
          captured at rebuild with FROZEN membership: the export lane
          lists are part of the block context, so ghost lanes are
          stable for the whole block and the lane-indexed pair list
          stays valid.  Per step only (pos, vel, dirty-flags) of the
          same lanes are exchanged.
        * Candidates carry GLOBAL ids (ops/collide 6-plane packing);
          the mutual match and the keep-lower-side entry rule order by
          gid, so the two shards holding a boundary pair make the same
          decision and apply the identical symmetric update -- ghost
          mirrors stay bitwise-exact through the step, measurement and
          counting stay local (lower-gid ownership), exactly like the
          sweep engine's cross-shard resolution.
        * Dirty propagation: the owner ships wall-speed-change and
          wall-recapture flags with the halo payload; collision and
          post-pairs-recapture dirt is computed identically on both
          sides.  Both shards therefore re-search the same particles
          against rebuild-time planes that agree in the overlap region.
        * MIGRATION is deferred to block boundaries (a particle that
          crosses a slab face mid-block stays owned -- drift, walls and
          the listed pairs are geometry-global), keeping lanes stable;
          the migration buffer is sized for K steps of crossings.

        Replaces the reference's CPU pool exactly like the sweep engine
        (Open_Air_Pore_MC.py:520-549) but carries the amortized narrow
        phase multi-chip (VERDICT r2 item 3).
        """
        from ..engine import pairs_config_for
        from ..ops import pairs as pairs_ops

        plan = self.plan
        cfg = self.cfg
        eng = cfg.engine
        physics = cfg.physics
        workload = self.workload
        grid = self.device_grid
        dt = cfg.dt
        cr = physics.collision_range
        dtype = self.dtype
        cap = plan.shard_capacity
        hcap = plan.pairs_halo_capacity
        mcap = plan.pairs_migration_capacity
        n_comb = cap + 2 * hcap
        n_shards = plan.n_shards
        park = jnp.asarray(plan.park, dtype)
        slab_z = jnp.asarray(plan.slab_z, dtype)
        cell_start = jnp.asarray(plan.pairs_cell_start)
        active_start = (None if plan.pairs_active_start is None
                        else jnp.asarray(plan.pairs_active_start))
        perm_up = [(i, i + 1) for i in range(n_shards - 1)]
        perm_down = [(i + 1, i) for i in range(n_shards - 1)]
        pcfg = pairs_config_for(workload, num_particles=n_comb)
        self._pairs_pcfg = pcfg

        def masked_phase(state, valid, fn):
            state.pos = jnp.where(valid[:, None], state.pos, park)
            out = fn(state)
            state = out[0]
            state.pos = jnp.where(valid[:, None], state.pos, SENTINEL)
            return (state,) + out[1:]

        def unstack(tree):
            return jax.tree.map(lambda x: x[0], tree)

        def restack(tree):
            return jax.tree.map(lambda x: x[None], tree)

        # ---------------- REBUILD program ----------------------------
        def rebuild_shard(state, valid, gid, measure):
            measure = unstack(measure)
            me = jax.lax.axis_index(AXIS)
            z_lo = slab_z[me]
            z_hi = slab_z[me + 1]

            # MIGRATION of block-accumulated crossers.
            z = state.pos[:, 2]
            go_up = valid & (z >= z_hi) & (me < n_shards - 1)
            go_down = valid & (z < z_lo) & (me > 0)
            payload = {
                "pos": state.pos, "vel": state.vel, "paths": state.paths,
                "hc": state.has_collided, "gid": gid,
            }
            up_buf, d3 = _compact_band(payload, go_up, mcap)
            down_buf, d4 = _compact_band(payload, go_down, mcap)
            inc_lo = _ppermute_tree(up_buf, perm_up)
            inc_hi = _ppermute_tree(down_buf, perm_down)
            valid = valid & ~(go_up | go_down)
            state.pos = jnp.where(valid[:, None], state.pos, SENTINEL)
            state.vel = jnp.where(valid[:, None], state.vel, 0.0)
            inc = jax.tree.map(
                lambda a, b: jnp.concatenate([a, b]), inc_lo, inc_hi
            )
            flag = inc["flag"]
            free_order = jnp.argsort(valid)
            num_free = cap - jnp.sum(valid, dtype=jnp.int32)
            rank = jnp.cumsum(flag.astype(jnp.int32)) - 1
            place = flag & (rank < num_free)
            target = jnp.where(
                place, free_order[jnp.clip(rank, 0, cap - 1)], cap
            )
            state.pos = state.pos.at[target].set(inc["pos"], mode="drop")
            state.vel = state.vel.at[target].set(inc["vel"], mode="drop")
            state.paths = state.paths.at[target].set(inc["paths"],
                                                     mode="drop")
            state.has_collided = state.has_collided.at[target].set(
                inc["hc"], mode="drop"
            )
            gid = gid.at[target].set(inc["gid"], mode="drop")
            valid = valid.at[target].set(place, mode="drop")
            lost = jnp.sum(flag & ~place, dtype=jnp.int32) + d3 + d4
            measure.overflow_count = measure.overflow_count + lost

            # GHOST CAPTURE with frozen export lane lists.
            z = state.pos[:, 2]
            band = plan.pairs_band_width
            up_idx, up_flag, t1 = _compact_idx(
                valid & (z > z_hi - band) & (me < n_shards - 1), hcap
            )
            dn_idx, dn_flag, t2 = _compact_idx(
                valid & (z < z_lo + band) & (me > 0), hcap
            )
            measure.halo_trunc_count = measure.halo_trunc_count + t1 + t2

            def take(idx, flag):
                safe = jnp.clip(idx, 0, cap - 1)
                return {
                    "pos": jnp.where(flag[:, None], state.pos[safe],
                                     SENTINEL),
                    "vel": jnp.where(flag[:, None], state.vel[safe], 0.0),
                    "gid": jnp.where(flag, gid[safe], -3),
                    "flag": flag,
                }

            gb = _ppermute_tree(take(up_idx, up_flag), perm_up)
            ga = _ppermute_tree(take(dn_idx, dn_flag), perm_down)
            for g in (gb, ga):
                g["pos"] = jnp.where(g["flag"][:, None], g["pos"],
                                     SENTINEL)
                g["gid"] = jnp.where(g["flag"], g["gid"], -3)

            pos_c = jnp.concatenate([state.pos, gb["pos"], ga["pos"]])
            vel_c = jnp.concatenate([state.vel, gb["vel"], ga["vel"]])
            gid_c = jnp.concatenate([gid, gb["gid"], ga["gid"]])
            valid_c = jnp.concatenate([valid, gb["flag"], ga["flag"]])
            comb = ParticleState(
                pos=pos_c, vel=vel_c,
                paths=jnp.zeros((n_comb, 4), dtype),
                has_collided=jnp.zeros((n_comb,), jnp.bool_),
            )
            plist = pairs_ops.PairList.init(n_comb, grid, pcfg, dtype,
                                            num_planes=6)
            plist = pairs_ops.rebuild(
                comb, grid, pcfg, cr, dt, plist, ids=gid_c,
                valid_lanes=valid_c,
                cell_window=(cell_start[me], plan.pairs_cell_window),
                active_window=(
                    None if active_start is None
                    else (active_start[me], plan.pairs_active_window)
                ),
            )
            ctx = {
                "plist": plist,
                "up_idx": up_idx, "up_flag": up_flag,
                "dn_idx": dn_idx, "dn_flag": dn_flag,
                "gid_b": gb["gid"], "flag_b": gb["flag"],
                "gid_a": ga["gid"], "flag_a": ga["flag"],
            }
            return (state, valid, gid, restack(measure), restack(ctx))

        P = jax.sharding.PartitionSpec
        self._pairs_rebuild = jax.jit(
            jax.shard_map(
                rebuild_shard,
                mesh=self.mesh,
                in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
                out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
            )
        )

        # ---------------- STEP-BLOCK program -------------------------
        def block_shard(state, valid, gid, measure, base_key,
                        step_indices, rebuilt_flags, ctx):
            measure = unstack(measure)
            ctx = unstack(ctx)
            me = jax.lax.axis_index(AXIS)
            shard_key = jax.random.fold_in(base_key, me)
            gid_c = jnp.concatenate([gid, ctx["gid_b"], ctx["gid_a"]])
            valid_c = jnp.concatenate(
                [valid, ctx["flag_b"], ctx["flag_a"]]
            )
            local_c = jnp.concatenate(
                [valid, jnp.zeros((2 * hcap,), jnp.bool_)]
            )

            def step(carry, xs):
                step_index, rebuilt_flag = xs
                state, measure, plist = carry
                key = jax.random.fold_in(shard_key, step_index)
                speed_pre = jnp.linalg.norm(state.vel, axis=-1)

                # DRIFT
                prior = state.pos
                state.paths = measure_ops.accumulate_drift(state, dt)
                state.pos = state.pos + dt * state.vel

                # WALLS + recapture (local lanes).
                prior_parked = jnp.where(valid[:, None], prior, park)

                def walls(st):
                    return workload.wall_pass(st, prior_parked, measure,
                                              key)

                state, measure, ledger = masked_phase(state, valid, walls)
                if eng.debug_audits and workload.audit_fn is not None:
                    parked = jnp.where(valid[:, None], state.pos, park)
                    audit_state = dataclasses.replace(state, pos=parked)
                    missed = workload.audit_fn(audit_state, prior_parked)
                else:
                    missed = jnp.zeros((10,), jnp.int32)
                pos_pre = state.pos
                state, oob_walls = masked_phase(state, valid,
                                                workload.post_wall)
                recap_w = jnp.any(state.pos != pos_pre, axis=-1) & valid
                wall_bump = (
                    (jnp.linalg.norm(state.vel, axis=-1) != speed_pre)
                    & valid
                )

                # GHOST REFRESH at the frozen band lanes: post-wall
                # state + the owner's dirty flags.
                def export(idx, flag):
                    safe = jnp.clip(idx, 0, cap - 1)
                    fl = (
                        wall_bump[safe].astype(jnp.uint8)
                        | (recap_w[safe].astype(jnp.uint8) << 1)
                    ) * flag.astype(jnp.uint8)
                    return {
                        "pos": jnp.where(flag[:, None], state.pos[safe],
                                         SENTINEL),
                        "vel": jnp.where(flag[:, None], state.vel[safe],
                                         0.0),
                        "fl": fl,
                    }

                gb = _ppermute_tree(export(ctx["up_idx"], ctx["up_flag"]),
                                    perm_up)
                ga = _ppermute_tree(export(ctx["dn_idx"], ctx["dn_flag"]),
                                    perm_down)
                fb = ctx["flag_b"]
                fa = ctx["flag_a"]
                pos_c = jnp.concatenate([
                    state.pos,
                    jnp.where(fb[:, None], gb["pos"], SENTINEL),
                    jnp.where(fa[:, None], ga["pos"], SENTINEL),
                ])
                vel_c = jnp.concatenate([state.vel, gb["vel"], ga["vel"]])
                comb = ParticleState(
                    pos=pos_c, vel=vel_c,
                    paths=jnp.concatenate(
                        [state.paths, jnp.zeros((2 * hcap, 4), dtype)]
                    ),
                    has_collided=jnp.concatenate([
                        state.has_collided,
                        jnp.zeros((2 * hcap,), jnp.bool_),
                    ]),
                )

                # PAIR COLLISIONS on the listed candidate lanes.
                comb, measure, pair_cnt, collided_c = (
                    pairs_ops.test_and_resolve(
                        comb, measure, plist, cr, eng.num_bins,
                        eng.hist_range[1], pcfg.event_capacity,
                        ids=gid_c, local_mask=local_c,
                    )
                )

                # POST-PAIRS RECAPTURE on combined lanes: deterministic,
                # so ghost mirrors recapture exactly as their owner.
                pos_pre2 = comb.pos
                comb, _ = masked_phase(comb, valid_c, workload.post_pairs)
                recap_p_c = jnp.any(comb.pos != pos_pre2, axis=-1)
                oob_pairs = jnp.sum(recap_p_c[:cap] & valid,
                                    dtype=jnp.int32)

                # DIRTY DETECTION (combined lanes; ghost wall-dirt comes
                # from the owner's shipped flags).
                wall_bump_c = jnp.concatenate([
                    wall_bump,
                    (gb["fl"] & 1).astype(jnp.bool_),
                    (ga["fl"] & 1).astype(jnp.bool_),
                ])
                recap_w_c = jnp.concatenate([
                    recap_w,
                    (gb["fl"] >> 1).astype(jnp.bool_),
                    (ga["fl"] >> 1).astype(jnp.bool_),
                ])
                bump_c = (wall_bump_c | collided_c) & valid_c
                plist.hot = plist.hot | ((recap_w_c | recap_p_c)
                                         & valid_c)
                # One-step-latency diagnostics (ADVICE r2; see
                # engine.make_pairs_step_fn): local lanes only so the
                # psum'd totals match single-chip semantics.
                latent_full = jnp.sum(plist.pending1 & local_c,
                                      dtype=jnp.int32)
                teleports = jnp.sum(
                    (recap_w_c | recap_p_c) & local_c, dtype=jnp.int32
                )
                dirty = (bump_c | plist.hot | plist.pending1) & valid_c

                # Shared compaction: histogram flush + dirty re-search
                # (engine.make_pairs_step_fn).
                shared_cap = max(measure_ops.FLUSH_CAPACITY, n_comb // 64)
                shared_mask = measure.pending_mask | dirty
                shared_idx = compact_indices(
                    shared_mask, shared_cap, n_comb
                )
                safe_sh = jnp.clip(shared_idx, 0, n_comb - 1)
                dirty_at = (shared_idx < n_comb) & dirty[safe_sh]
                (dsel,) = jnp.nonzero(
                    dirty_at, size=pcfg.research_capacity,
                    fill_value=shared_cap,
                )
                dirty_idx = jnp.where(
                    dsel < shared_cap,
                    shared_idx[jnp.clip(dsel, 0, shared_cap - 1)],
                    n_comb,
                )
                research_dropped = jnp.sum(dirty, dtype=jnp.int32) - \
                    jnp.sum(dirty_idx < n_comb, dtype=jnp.int32)
                plist, research_lost, latent_per = pairs_ops.research_dirty(
                    comb, plist, dirty_idx, bump_c, grid, pcfg, cr, dt,
                    ids=gid_c,
                )
                # Local dirty lanes only, so the psum'd total matches
                # single-chip semantics (ghost researches mirror the
                # owner's).
                d_safe = jnp.clip(dirty_idx, 0, n_comb - 1)
                latent_research = jnp.sum(
                    jnp.where((dirty_idx < n_comb) & local_c[d_safe],
                              latent_per, 0),
                    dtype=jnp.int32,
                )
                # Derived (not fresh) zeros: inside shard_map the scan
                # carry must keep its varying-axes type.
                plist.pending1 = plist.pending1 & False
                force_rebuild = research_lost | (research_dropped > 0)
                plist.age = jnp.where(
                    force_rebuild,
                    jnp.asarray(pairs_ops.INT_BIG, jnp.int32),
                    plist.age + 1,
                )

                measure = measure_ops.flush_pending_compacted(
                    measure, shared_idx, eng.num_bins, eng.hist_range[1]
                )
                measure.overflow_count = (
                    measure.overflow_count + plist.overflow
                    + research_dropped
                )
                measure.hot_spill_count = (
                    measure.hot_spill_count + plist.spill
                )
                plist.overflow = plist.overflow * 0
                plist.spill = plist.spill * 0
                measure.err_count = measure.err_count + ledger.errs
                measure.collision_count = (
                    measure.collision_count + ledger.wall_hits
                )

                # WRITE BACK local lanes.
                state.pos = comb.pos[:cap]
                state.vel = comb.vel[:cap]
                state.paths = comb.paths[:cap]
                state.has_collided = comb.has_collided[:cap]

                metrics = StepMetrics(
                    momentum_z=jax.lax.psum(ledger.momentum_z, AXIS),
                    energy_hot=jax.lax.psum(ledger.energy_hot, AXIS),
                    energy_cold=jax.lax.psum(ledger.energy_cold, AXIS),
                    collisions=jax.lax.psum(
                        pair_cnt + ledger.wall_hits, AXIS
                    ),
                    wall_hits=jax.lax.psum(ledger.wall_hits, AXIS),
                    oob_after_walls=jax.lax.psum(oob_walls, AXIS),
                    oob_after_pairs=jax.lax.psum(oob_pairs, AXIS),
                    missed_cases=jax.lax.psum(missed, AXIS),
                    nonfinite=jax.lax.psum(
                        _count_nonfinite(state, valid, eng), AXIS
                    ),
                    rebuilt=rebuilt_flag.astype(jnp.int32),
                    dirty_count=jax.lax.psum(
                        jnp.sum(dirty, dtype=jnp.int32), AXIS
                    ),
                    latent_full=jax.lax.psum(latent_full, AXIS),
                    teleports=jax.lax.psum(teleports, AXIS),
                    latent_research=jax.lax.psum(latent_research, AXIS),
                )
                return (state, measure, plist), metrics

            carry = (state, measure, ctx["plist"])
            carry, metrics = jax.lax.scan(
                step, carry, (step_indices, rebuilt_flags)
            )
            state, measure, plist = carry
            ctx["plist"] = plist
            return (state, valid, gid, restack(measure), metrics,
                    restack(ctx))

        self._pairs_block = jax.jit(
            jax.shard_map(
                block_shard,
                mesh=self.mesh,
                in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P(),
                          P(), P(AXIS)),
                out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(),
                           P(AXIS)),
            )
        )

    # ------------------------------------------------------------------
    def init(self, seed: Optional[int] = None):
        cfg = self.cfg
        plan = self.plan
        seed = cfg.seed if seed is None else seed
        key = jax.random.PRNGKey(seed)
        init_key, run_key = jax.random.split(key)
        global_state = self.workload.init_fn(init_key)
        n = global_state.pos.shape[0]
        cap = plan.shard_capacity

        pos = np.asarray(global_state.pos)
        vel = np.asarray(global_state.vel)
        shard_of = np.clip(
            np.searchsorted(plan.slab_z, pos[:, 2], side="right") - 1,
            0, plan.n_shards - 1,
        )
        s_pos = np.full((plan.n_shards, cap, 3), SENTINEL, pos.dtype)
        s_vel = np.zeros((plan.n_shards, cap, 3), vel.dtype)
        s_valid = np.zeros((plan.n_shards, cap), bool)
        s_gid = np.zeros((plan.n_shards, cap), np.int32)
        for s in range(plan.n_shards):
            idx = np.nonzero(shard_of == s)[0]
            if len(idx) > cap:
                raise ValueError(
                    f"shard {s} holds {len(idx)} > capacity {cap}; "
                    "increase the capacity factor"
                )
            m = len(idx)
            s_pos[s, :m] = pos[idx]
            s_vel[s, :m] = vel[idx]
            s_valid[s, :m] = True
            s_gid[s, :m] = idx

        state = ParticleState(
            pos=jnp.asarray(s_pos.reshape(-1, 3)),
            vel=jnp.asarray(s_vel.reshape(-1, 3)),
            paths=jnp.zeros((plan.n_shards * cap, 4), self.dtype),
            has_collided=jnp.zeros((plan.n_shards * cap,), jnp.bool_),
        )
        valid = jnp.asarray(s_valid.reshape(-1))
        gid = jnp.asarray(s_gid.reshape(-1))
        hcap = (plan.pairs_halo_capacity if self._pairs_mode
                else plan.halo_capacity)
        measure = jax.tree.map(
            lambda x: jnp.tile(x[None], (plan.n_shards,) + (1,) * x.ndim),
            Measurements.zeros(
                cfg.engine.num_bins, self.dtype,
                num_particles=cap + 2 * hcap,
            ),
        )
        return (state, valid, gid), measure, run_key

    def run(self, num_steps=None, seed=None, state=None, measure=None,
            run_key=None, start_step: int = 0, epoch_callback=None):
        if num_steps is None:
            num_steps = self.cfg.num_timesteps
        if state is None:
            state, measure, run_key = self.init(seed)
            if self._pairs_mode:
                self._ctx = None
        elif self._pairs_mode and state is not self._last_state_out:
            self._ctx = None  # unrelated state: carried list is stale
        st, valid, gid = state
        spe = self.cfg.engine.steps_per_epoch
        all_metrics = []
        step = start_step
        end = start_step + num_steps
        while step < end:
            n = min(spe, end - step)
            indices = jnp.arange(step, step + n, dtype=jnp.int32)
            if self._pairs_mode:
                st, valid, gid, measure, metrics = self._run_pairs_epoch(
                    st, valid, gid, measure, run_key, indices
                )
            else:
                st, valid, gid, measure, metrics = self._epoch(
                    st, valid, gid, measure, run_key, indices
                )
            all_metrics.append(metrics)
            if epoch_callback is not None:
                epoch_callback(metrics)
            step += n
        stacked = jax.tree.map(
            lambda *xs: jnp.concatenate([jnp.atleast_1d(x) for x in xs]),
            *all_metrics,
        ) if all_metrics else None
        out = (st, valid, gid)
        if self._pairs_mode:
            self._last_state_out = out
        return out, measure, stacked

    def _run_pairs_epoch(self, st, valid, gid, measure, run_key, indices):
        """Host block loop: rebuild program at window boundaries, scan
        blocks of at most rebuild_interval steps (engine.Simulation's
        split, shard_map'd)."""
        if self._ctx is None:
            self._window_left = 0
        k = max(self.cfg.engine.rebuild_interval, 1)
        outs = []
        i, total = 0, int(indices.shape[0])
        while i < total:
            rebuilt = False
            if self._window_left <= 0 or self._ctx is None:
                st, valid, gid, measure, self._ctx = self._pairs_rebuild(
                    st, valid, gid, measure
                )
                self._window_left = k
                rebuilt = True
            m = int(min(self._window_left, total - i))
            flags = np.zeros((m,), np.bool_)
            flags[0] = rebuilt
            st, valid, gid, measure, metrics, self._ctx = (
                self._pairs_block(
                    st, valid, gid, measure, run_key, indices[i:i + m],
                    flags, self._ctx,
                )
            )
            outs.append(metrics)
            i += m
            self._window_left -= m
        if len(outs) == 1:
            return st, valid, gid, measure, outs[0]
        metrics = jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)
        return st, valid, gid, measure, metrics

    @staticmethod
    def finalize_measure(measure) -> Measurements:
        """Sum the per-shard accumulators into global totals."""
        return jax.tree.map(lambda x: jnp.sum(x, axis=0), measure)
