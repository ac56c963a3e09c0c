"""Particle-particle hard-sphere collision engine.

Reference hot loop: per cell, an O(n^2) triangular Python sweep resolving
pairs sequentially with in-loop writeback (Open_Air_Pore_MC.py:160-255),
farmed to a process pool under an 8-color checkerboard so concurrently
processed cells never share particles (SURVEY.md C17/C22/C23).

Device redesign (order-free, race-free, gather-only SPMD):

1. *Broad phase* -- particles are binned into a compact region-aware grid
   (cells sized >= collision_range; per-z-layer xy extent hugs the local
   geometry so the empty bounding-box corners cost nothing).  A capacity-
   padded (C, cap) table is built from a single sort; overflow is counted.
2. *Partner search* -- every particle scans the 27-cell neighbourhood and
   selects its lowest-global-index overlapping partner (centre distance
   < collision_range).  Scanning the full neighbourhood from both sides
   makes the relation symmetric without scatters, and the index-min
   choice makes the whole search one fused masked min-reduce.  (>99.9%
   of colliding particles have exactly one overlapping candidate at
   reference densities, so which candidate wins is statistically
   irrelevant; any deterministic symmetric rule works.)
3. *Mutual match* -- a pair (a,b) is resolved iff partner[a]==b and
   partner[b]==a.  Each matched particle then computes its own update from
   gathered partner state: the elastic impulse formula is symmetric, so no
   writes race.  Unmatched overlaps (rare triples) stay overlapped and are
   matched on the next step -- statistically equivalent to the reference's
   sequential in-cell resolution at these densities (~0.1% of particles
   collide per step).

The checkerboard coloring and locked counters disappear entirely: SPMD +
mutual matching gives determinism and write-independence by construction.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..state import Measurements, ParticleState
from . import measure as measure_ops

# Threshold widening for the bf16 rebuild hit test
# (EngineConfig.rebuild_bf16_hittest).  Superset condition: whenever the
# exact f32 test fires (d2 < thresh^2), the bf16 test must too.  With
# bf16 round-to-nearest unit u = 2^-9: the cast+square+2-add d2 path
# satisfies d2_bf16 <= d2 (1 + 5u), and the pre-widened threshold
# (per-plane scale, bf16 cast, add, square) satisfies
# tw^2 >= thresh^2 (1+eps)^2 (1 - 5u); superset therefore needs
# (1+eps)^2 >= (1+5u)/(1-5u) ~ 1 + 10u, i.e. eps >= 0.0098.  1/64 =
# 0.0156 carries a 1.6x margin; the ~1.6% wider reach admits ~5% more
# shell volume, i.e. ~5% more (counted, exactly-retested) candidates.
BF16_HIT_EPS = 1.0 / 64.0


# --------------------------------------------------------------------------
# Host-side grid construction
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Grid:
    """Compact region-aware uniform grid (host-built, numpy arrays).

    z is divided into ``nz`` uniform layers; layer ``iz`` has an
    ``nx[iz] x nx[iz]`` xy grid centred on the axis covering the radius
    reachable in that layer.  ``layer_base[iz]`` is the flat cell id of the
    layer's first cell.  ``neighbors[c, o]`` gives the 27-neighbourhood
    cell ids (pointing at the dummy empty cell ``num_cells`` when a
    neighbour is outside the grid).
    """

    cell_size: float
    z_lo: float
    nz: int
    nx: np.ndarray          # (nz,) int32
    layer_base: np.ndarray  # (nz,) int32
    half_extent: np.ndarray  # (nz,) float - xy half extent per layer
    num_cells: int
    neighbors: np.ndarray   # (num_cells, 27) int32
    capacity: int
    # Sorted ids of cells whose box intersects the gas region (+0.5-cell
    # margin); None when every cell is reachable (cube).  The pairs
    # rebuild sweeps ONLY these rows: the per-layer grid is a square box
    # around a circular region, so 30-45% of cells are corner/slack
    # cells no particle can reach (measured at 1M: 60k of 180k cells
    # unreachable, 33%; 120k stay active) -- lanes spent sweeping them
    # are pure padding.  Coverage stays exact:
    # a particle binned OUTSIDE the active set (stray beyond the margin)
    # is routed to the HOT set like a capacity spill and re-searches
    # both-sided every step (ops/pairs.rebuild ``unswept``).
    active_cells: np.ndarray | None = None


def _build_neighbors(nz, nx, layer_base) -> np.ndarray:
    num_cells = int(layer_base[-1] + nx[-1] * nx[-1])
    neighbors = np.full((num_cells, 27), num_cells, dtype=np.int32)
    offsets = [(dx, dy, dz)
               for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    for iz in range(nz):
        n = int(nx[iz])
        base = int(layer_base[iz])
        ix, iy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        ix = ix.ravel()
        iy = iy.ravel()
        cid = base + iy * n + ix
        for o, (dx, dy, dz) in enumerate(offsets):
            jz = iz + dz
            if jz < 0 or jz >= nz:
                continue
            m = int(nx[jz])
            shift = (m - n) // 2
            jx = ix + dx + shift
            jy = iy + dy + shift
            ok = (jx >= 0) & (jx < m) & (jy >= 0) & (jy < m)
            nid = np.where(
                ok, layer_base[jz] + jy * m + jx, num_cells
            ).astype(np.int32)
            neighbors[cid, o] = nid
    return neighbors


def build_grid(cell_size: float, z_lo: float, z_hi: float,
               radius_of_z, capacity: int,
               region_radius_of_z=None) -> Grid:
    """Build a grid whose per-layer xy extent covers ``radius_of_z``.

    ``radius_of_z(z_lo, z_hi) -> max radius`` reachable in that z range.
    One slack cell is added all around so pre-recapture strays still bin
    into real cells.

    ``region_radius_of_z(z_lo, z_hi) -> exact max gas radius`` (no
    slack) enables the static active-cell list (Grid.active_cells): a
    cell is active iff its xy box comes within ``r + 0.5 cell`` of the
    axis for its (margin-expanded) z range.  The margin covers one-step
    pre-recapture excursions; anything beyond goes hot (counted, exact).
    """
    nz = int(np.ceil((z_hi - z_lo) / cell_size))
    nx = np.zeros(nz, dtype=np.int32)
    half_extent = np.zeros(nz, dtype=np.float64)
    for iz in range(nz):
        lo = z_lo + iz * cell_size
        hi = lo + cell_size
        r = radius_of_z(lo, hi)
        half = int(np.ceil(r / cell_size)) + 1  # +1 slack cell
        nx[iz] = 2 * half
        half_extent[iz] = half * cell_size
    layer_base = np.zeros(nz, dtype=np.int64)
    layer_base[1:] = np.cumsum((nx.astype(np.int64) ** 2))[:-1]
    num_cells = int(layer_base[-1] + nx[-1] ** 2)
    neighbors = _build_neighbors(nz, nx, layer_base)
    active = None
    if region_radius_of_z is not None:
        margin = 0.5 * cell_size
        chunks = []
        for iz in range(nz):
            lo = z_lo + iz * cell_size
            hi = lo + cell_size
            r = float(region_radius_of_z(lo - margin, hi + margin))
            nl = int(nx[iz])
            edge = np.arange(nl) * cell_size - half_extent[iz]
            # Min |coord| inside the cell's [edge, edge+cs) interval.
            cmin = np.where((edge < 0) & (edge + cell_size > 0), 0.0,
                            np.minimum(np.abs(edge),
                                       np.abs(edge + cell_size)))
            d2 = cmin[:, None] ** 2 + cmin[None, :] ** 2
            iy, ix = np.nonzero(d2 <= (r + margin) ** 2)
            chunks.append(
                (layer_base[iz] + iy * nl + ix).astype(np.int64)
            )
        active = np.sort(np.concatenate(chunks)).astype(np.int32)
    return Grid(
        cell_size=float(cell_size),
        z_lo=float(z_lo),
        nz=nz,
        nx=nx.astype(np.int32),
        layer_base=layer_base.astype(np.int32),
        half_extent=half_extent,
        num_cells=num_cells,
        neighbors=neighbors,
        capacity=int(capacity),
        active_cells=active,
    )


def grid_for_cube(geom, cell_size: float, capacity: int) -> Grid:
    """Uniform grid over the box; binning shifts coordinates so the grid
    is centred on the cube centre (DeviceGrid.center_x/y)."""
    r = max(geom.lx, geom.ly) / 2.0
    return build_grid(cell_size, 0.0, geom.lz, lambda lo, hi: r, capacity)


def grid_for_pore(geom, cell_size: float, capacity: int) -> Grid:
    def radius_of_z(lo, hi):
        # Max radius reachable anywhere in [lo, hi): open-air regions use
        # the full open_air_radius; interior pore layers only the gap
        # radius.  Use a one-cell overlap in z so layer edges are safe.
        lo -= cell_size
        hi += cell_size
        if lo < geom.open_air_height or hi > geom.cold_top:
            return geom.open_air_radius
        return geom.gap_radius

    def region_radius_of_z(lo, hi):
        # EXACT max gas radius over [lo, hi] (per z-segment, no slack):
        # drives the active-cell list.  Segment stack per
        # geometry.PoreGeometry (reference Open_Air_Pore_MC.py:23-46).
        segs = (
            (0.0, geom.open_air_height, geom.open_air_radius),
            (geom.open_air_height, geom.gap_bottom,
             geom.pore_coated_radius),
            (geom.gap_bottom, geom.gap_top, geom.gap_radius),
            (geom.gap_top, geom.cold_top, geom.pore_coated_radius),
            (geom.cold_top, geom.total_height, geom.open_air_radius),
        )
        r = 0.0
        for a, b, rr in segs:
            if hi > a and lo < b:
                r = max(r, rr)
        return r

    return build_grid(cell_size, 0.0, geom.total_height, radius_of_z,
                      capacity, region_radius_of_z=region_radius_of_z)


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """Grid tables uploaded to device (a pytree of arrays + static ints)."""

    nx: jax.Array
    layer_base: jax.Array
    half_extent: jax.Array
    neighbors: jax.Array
    cell_size: float
    z_lo: float
    nz: int
    num_cells: int
    capacity: int
    # xy offset applied before binning (cube uses its centre).
    center_x: float = 0.0
    center_y: float = 0.0
    # Static active-cell list (Grid.active_cells) + its inverse: rank of
    # each cell in the list, -1 if inactive ((num_cells+1,), the dummy
    # cell is inactive).  None when every cell is active (cube grids,
    # sharded windows).
    active_cells: jax.Array | None = None
    active_rank: jax.Array | None = None
    # Optional (nz, 4) packed per-layer table [nx, half_extent,
    # layer_base, 0]: when present, assign_cells bins through ONE row
    # gather instead of three (one row read per particle).  Built
    # by from_grid(packed_layers=True); integer columns ride as floats
    # (exact below 2^24 -- guarded) and cid is bitwise-identical.
    layer_packed: jax.Array | None = None

    @staticmethod
    def from_grid(grid: Grid, dtype, center_xy=(0.0, 0.0),
                  packed_layers: bool = False) -> "DeviceGrid":
        act = rank = None
        if grid.active_cells is not None:
            rank_np = np.full(grid.num_cells + 1, -1, np.int32)
            rank_np[grid.active_cells] = np.arange(
                grid.active_cells.shape[0], dtype=np.int32
            )
            act = jnp.asarray(grid.active_cells)
            rank = jnp.asarray(rank_np)
        packed = None
        if packed_layers:
            if (jnp.dtype(dtype) == jnp.float32
                    and (int(np.max(grid.nx)) >= (1 << 24)
                         or grid.num_cells >= (1 << 24))):
                raise ValueError(
                    "packed_layer_gather: layer values exceed float32's "
                    "exact-integer range (2^24); use float64"
                )
            packed = jnp.stack(
                [jnp.asarray(grid.nx, dtype),
                 jnp.asarray(grid.half_extent, dtype),
                 jnp.asarray(grid.layer_base, dtype),
                 jnp.zeros((grid.nz,), dtype)],
                axis=1,
            )
        return DeviceGrid(
            nx=jnp.asarray(grid.nx),
            layer_base=jnp.asarray(grid.layer_base),
            half_extent=jnp.asarray(grid.half_extent, dtype),
            neighbors=jnp.asarray(grid.neighbors),
            cell_size=grid.cell_size,
            z_lo=grid.z_lo,
            nz=grid.nz,
            num_cells=grid.num_cells,
            capacity=grid.capacity,
            center_x=float(center_xy[0]),
            center_y=float(center_xy[1]),
            active_cells=act,
            active_rank=rank,
            layer_packed=packed,
        )


jax.tree_util.register_dataclass(
    DeviceGrid,
    data_fields=["nx", "layer_base", "half_extent", "neighbors",
                 "active_cells", "active_rank", "layer_packed"],
    meta_fields=["cell_size", "z_lo", "nz", "num_cells", "capacity",
                 "center_x", "center_y"],
)


# --------------------------------------------------------------------------
# Device-side binning and partner search
# --------------------------------------------------------------------------


def assign_cells(pos: jnp.ndarray, grid: DeviceGrid,
                 valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """(N,) flat cell id per particle (strays clamp into edge cells).

    Particles with ``valid=False`` map to the dummy cell ``num_cells`` and
    therefore never participate in pair search (sharded-engine padding).
    """
    x = pos[:, 0] - grid.center_x
    y = pos[:, 1] - grid.center_y
    z = pos[:, 2]
    iz = jnp.clip(
        jnp.floor((z - grid.z_lo) / grid.cell_size).astype(jnp.int32),
        0, grid.nz - 1,
    )
    if grid.layer_packed is not None:
        # One packed row gather instead of three (per-row gather cost;
        # EngineConfig.packed_layer_gather).  Integer columns are exact
        # float round-trips (< 2^24, guarded at pack time).
        row = grid.layer_packed[iz]
        nx = row[:, 0].astype(jnp.int32)
        half = row[:, 1]
        base = row[:, 2].astype(jnp.int32)
    else:
        nx = grid.nx[iz]
        half = grid.half_extent[iz]
        base = grid.layer_base[iz]
    ix = jnp.clip(
        jnp.floor((x + half) / grid.cell_size).astype(jnp.int32), 0, nx - 1
    )
    iy = jnp.clip(
        jnp.floor((y + half) / grid.cell_size).astype(jnp.int32), 0, nx - 1
    )
    cid = base + iy * nx + ix
    if valid is not None:
        cid = jnp.where(valid, cid, grid.num_cells)
    return cid


def build_cell_table(cell_id: jnp.ndarray, grid: DeviceGrid):
    """Capacity-padded (C+1, cap) particle-index table from one sort.

    Slot value N (the sentinel) marks an empty slot; callers pad their
    coordinate arrays with a far-away dummy row at index N.
    Returns (table, overflow_count, order).
    """
    n = cell_id.shape[0]
    cap = grid.capacity
    order = jnp.argsort(cell_id)
    sorted_cid = cell_id[order]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sorted_cid[1:] != sorted_cid[:-1]]
    )
    start_idx = jnp.where(is_start, idx, 0)
    first = jax.lax.associative_scan(jnp.maximum, start_idx)
    rank = idx - first
    in_cap = rank < cap
    real = sorted_cid < grid.num_cells  # dummy-binned padding is not overflow
    overflow = jnp.sum(~in_cap & real, dtype=jnp.int32)
    # Out-of-capacity ranks write into the dummy cell's slots (row C).
    slot = jnp.where(
        in_cap, sorted_cid * cap + rank, grid.num_cells * cap
    )
    table = jnp.full(((grid.num_cells + 1) * cap,), n, dtype=jnp.int32)
    table = table.at[slot].set(order.astype(jnp.int32), mode="drop")
    table = table.reshape(grid.num_cells + 1, cap)
    # Wipe the dummy row (collects overflow + invalid padding writes).
    table = table.at[grid.num_cells].set(n)
    # Inverse map particle -> slot (overflow/dummy-binned particles point
    # at the dummy row and read back "no partner"); also used to scatter
    # particle data into the slot planes.
    pslot = jnp.zeros((n,), jnp.int32).at[order].set(
        slot.astype(jnp.int32)
    )
    return table, overflow, pslot


def slot_assignment(cell_id: jnp.ndarray, grid: DeviceGrid):
    """(pslot, overflow) without materializing the cell table.

    pslot = cell_id * capacity + rank-within-cell; over-capacity ranks
    map to ``num_cells * capacity`` (the dummy slot).  The XLA sweep
    needs the full table and uses build_cell_table instead.
    """
    n = cell_id.shape[0]
    cap = grid.capacity
    order = jnp.argsort(cell_id)
    sorted_cid = cell_id[order]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sorted_cid[1:] != sorted_cid[:-1]]
    )
    first = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, idx, 0)
    )
    rank = idx - first
    in_cap = rank < cap
    real = sorted_cid < grid.num_cells
    overflow = jnp.sum(~in_cap & real, dtype=jnp.int32)
    slot = jnp.where(
        in_cap & real, sorted_cid * cap + rank, grid.num_cells * cap
    )
    pslot = jnp.zeros((n,), jnp.int32).at[order].set(slot.astype(jnp.int32))
    return pslot, overflow


def cell_partner_search(
    pos: jnp.ndarray,
    grid: DeviceGrid,
    search_radius: float,
    ids: jnp.ndarray | None = None,
    valid: jnp.ndarray | None = None,
    cell_window: tuple | None = None,
):
    """Lowest-index overlapping partner per particle via the cell table.

    ids:   optional (N,) globally-unique particle ids used for
           self-exclusion (defaults to the array index); the sharded
           engine passes global ids so a particle and its remote ghost
           copy are distinct entries but a particle never pairs with
           itself.
    valid: optional (N,) mask; invalid lanes are excluded entirely.
    cell_window: optional (start, num_cells_static) restricting the sweep
           to a contiguous flat-cell-id range (the sharded engine sweeps
           only its own z-slab's cells; flat ids are z-major so a slab is
           contiguous).

    Returns (partner (N,) int32 with -1 for none, overflow_count).
    """
    cands, overflow, _ = cell_candidate_search(
        pos, grid, search_radius, ids=ids, valid=valid,
        cell_window=cell_window, top_k=1,
    )
    return cands[:, 0], overflow


def cell_candidate_search(
    pos: jnp.ndarray,
    grid: DeviceGrid,
    search_radius: float | None = None,
    reach: jnp.ndarray | None = None,
    top_k: int = 1,
    ids: jnp.ndarray | None = None,
    valid: jnp.ndarray | None = None,
    cell_window: tuple | None = None,
    one_sided: bool = False,
    half_shell: bool = False,
    active_window: tuple | None = None,
    bf16_hit: bool = False,
    occupancy_skip: bool = True,
    tables_only: bool = False,
):
    """Up to ``top_k`` lowest-index in-range candidates per particle.

    The generalization of the narrow-phase sweep behind both engines:

    * ``search_radius`` -- scalar hit test ``d^2 < r^2`` (the per-step
      sweep narrow phase, reference Open_Air_Pore_MC.py:160-255);
    * ``reach`` -- per-particle radii, hit test
      ``d^2 < (reach_i + reach_j)^2`` (the Verlet pair-list rebuild:
      reach_i = cr/2 + |v_i| K dt bounds everything particle i can touch
      within K steps, ops/pairs.py);
    * ``top_k`` -- emit the K lowest-index candidates, ascending
      (K=1 reproduces cell_partner_search exactly; K=4 feeds the pair
      list, covering multi-candidate particles);
    * ``one_sided`` -- emit only candidates with HIGHER id (index, or
      global id when ``ids`` is given).  Every unordered pair then
      appears in exactly its lower-id side's list, which is all the
      pair-list rebuild consumes (it discarded the higher-id half
      anyway) -- the per-particle emission expectation halves, so
      ``top_k`` (and with it the dominant cost of the top-k
      min-passes) shrinks.  The per-step sweep narrow phase MUST stay
      two-sided: its mutual-match rule needs every particle's own
      lowest-index overlap.
    * ``half_shell`` (requires ``one_sided``) -- scan only the 14 cells
      whose offset is lexicographically >= (0,0,0) in (dz, dy, dx):
      columns 13..26 of the neighbour table (_build_neighbors
      enumerates offsets in exactly that order, and the table is
      symmetric -- layer widths ``nx`` are even, so the inter-layer
      shift round-trips).  Each unordered cross-cell pair appears at a
      positive offset from exactly one of its two cells and is emitted
      from THAT side (id order decides only within the self cell), so
      coverage is identical to the 27-cell one-sided sweep while the
      hit test + top-k lanes shrink 27 -> 14 (the rebuild's dominant
      term by operation count).  Which side emits
      changes (cell-lexicographic, not lower-id), but every consumer
      treats entries symmetrically (ops/pairs.test_and_resolve;
      research_dirty re-searches the full 27-neighbourhood two-sided).
      SHARDED windows included: cell ids are global, so shards sharing
      a boundary pair agree on the emitting cell, which is one of the
      two endpoint cells and therefore inside both shards' halo-padded
      windows; within the self cell the id test runs on GLOBAL ids
      (shard-consistent), and a lane can never meet its own ghost
      cross-cell (same rebuild-time position => same cell).

    Returns (candidates (N, top_k) int32 ascending with -1 padding,
    overflow_count, pack) where ``pack`` is the (pslot, mega) packing
    reused by ops/pairs.research_dirty for stale-neighbourhood lookups.
    """
    if half_shell and not one_sided:
        raise ValueError(
            "half_shell requires one_sided=True: the half-shell scan "
            "emits each unordered pair exactly once, which is only "
            "coherent under one-sided emission"
        )
    if bf16_hit and reach is None:
        raise ValueError(
            "bf16_hit applies only to the reach-mode rebuild sweep: "
            "the per-step narrow phase (search_radius) must stay "
            "exact f32 -- its mutual-match rule has no superset-"
            "recovery backstop (see EngineConfig.rebuild_bf16_hittest)"
        )
    n = pos.shape[0]
    cap = grid.capacity
    num_rows = grid.num_cells + 1
    cell_id = assign_cells(pos, grid, valid)
    table, overflow, pslot = build_cell_table(cell_id, grid)

    # Build dense per-slot component planes (num_rows, cap) with ONE
    # packed row gather through the table (a slot-row scatter variant was
    # measured ~2x slower).  All later neighbour access is contiguous
    # CELL-row gathers of the planes; the index plane IS the table, so it
    # needs no data movement at all.
    flat_idx = table.reshape(-1)                       # slot -> particle
    in_slot = flat_idx < n
    src = jnp.where(in_slot, flat_idx, 0)
    far = jnp.asarray(1e9, pos.dtype)
    if reach is not None:
        # Ride the reach values in the same slot gather (a separate
        # reach[src] gather measured 43 ms/rebuild at 1M).
        gath = jnp.concatenate(
            [pos, reach.astype(pos.dtype)[:, None]], axis=1
        )
    else:
        gath = pos
    packed = jnp.where(in_slot[:, None], gath[src], far)

    def plane(col):
        return packed[:, col].reshape(num_rows, cap)

    px, py, pz = plane(0), plane(1), plane(2)
    pix = table                                        # (num_rows, cap)
    has_ids = ids is not None
    if has_ids:
        pid = jnp.where(
            in_slot, ids.astype(jnp.int32)[src], jnp.int32(-2)
        ).reshape(num_rows, cap)
    else:
        # Self-exclusion ids == particle indices: the candidate-index
        # plane IS the id plane (empty slots hold n and die on the far
        # sentinel anyway), so no separate plane is packed or gathered
        # -- the neighbour gathers are bandwidth-bound and the pid plane
        # was 1/6 of every row.  (The Pallas kernel always worked this
        # way and bitwise-matches.)
        pid = pix
    if reach is not None:
        # Empty slots carry the far sentinel as "reach"; the pair test
        # d^2 < (r_i + r_j)^2 against a slot at distance ~1e9 with reach
        # ~1e9 could spuriously fire, so zero them explicitly.
        pr = jnp.where(in_slot.reshape(num_rows, cap), plane(3), 0.0)
    else:
        assert search_radius is not None
        pr = None

    # All candidate planes packed side by side so each neighbour-cell
    # access is ONE wide row gather instead of several narrow ones.
    # Integer planes
    # ride along VALUE-converted to float (exact below 2^24 for f32 /
    # 2^53 for f64).  NOT bitcast: small int32 bit patterns are f32
    # DENORMALS, and the XLA CPU backend flushes denormals inside the
    # fused gather pipeline -- measured 0 of 24,627 indices surviving
    # the round-trip (other backends preserved them, which is why only
    # CPU+f32 runs silently lost their collisions).
    if pos.dtype == jnp.float32 and n >= (1 << 24):
        raise ValueError(
            f"float32 index planes are exact only below 2^24 rows "
            f"(n={n}); use float64 or split the index plane"
        )

    def as_f(p):
        return p.astype(pos.dtype)

    planes_list = [px, py, pz, as_f(pix)]
    ix_plane = 3
    if has_ids:
        planes_list.append(as_f(pid))
    id_plane = 4 if has_ids else 3
    if pr is not None:
        planes_list.append(pr)
        reach_plane = len(planes_list) - 1
    mega = jnp.concatenate(planes_list, axis=1)       # (num_rows, P*cap)

    def unpack_int(block_col):
        return block_col.astype(jnp.int32)

    if tables_only:
        return mega, pslot, overflow
    cands, unswept = _candidate_sweep(
        mega, table, pslot, px, py, pz, pid, pr, grid, n,
        search_radius=search_radius, top_k=top_k, has_ids=has_ids,
        cell_window=cell_window, one_sided=one_sided,
        half_shell=half_shell, active_window=active_window,
        bf16_hit=bf16_hit,
        occupancy_skip=occupancy_skip,
    )
    return cands, overflow, (pslot, mega, unswept)


def _candidate_sweep(
    mega, table, pslot, px, py, pz, pid, pr, grid, n, *,
    search_radius=None, top_k=1, has_ids=False, cell_window=None,
    one_sided=False, half_shell=False, active_window=None,
    bf16_hit=False, occupancy_skip=True,
):
    """The candidate sweep half of ``cell_candidate_search`` (moved
    verbatim; the head builds the cell table and packed planes).  Split
    out so ``cell_search_sweep`` can run it as its OWN jitted program
    in the split-rebuild mode (EngineConfig.split_rebuild_programs):
    the fused path passes the head's original plane views, so its
    traced HLO is byte-identical to the pre-split monolith."""
    cap = grid.capacity
    num_rows = grid.num_cells + 1
    has_reach = pr is not None
    ix_plane = 3
    id_plane = 4 if has_ids else 3
    if has_reach:
        reach_plane = (5 if has_ids else 4)

    def unpack_int(block_col):
        return block_col.astype(jnp.int32)

    # Active-cell sweep (pairs rebuild): iterate only the static
    # active-cell list -- 30-45% of the region-aware grid's cells are
    # unreachable box corners/slack whose emission lanes are pure
    # padding.  Gated on ``reach`` because only the pairs engine has
    # the hot-set backstop for particles binned outside the list; the
    # per-step sweep narrow phase (search_radius) must sweep every row
    # or a stray's own mutual-match row would silently vanish.
    # SHARDED windows ride the same list: it is sorted, so a shard's
    # contiguous cell window maps to a contiguous SLICE of it --
    # ``active_window`` = (rank of the window's first active cell,
    # static max slice width over shards).
    use_active = (grid.active_cells is not None and has_reach
                  and (cell_window is None or active_window is not None))
    a_start = 0
    if use_active:
        if cell_window is None:
            width = int(grid.active_cells.shape[0])
        else:
            a_start, width = active_window
        start = 0  # emission rows come from the active list
    elif cell_window is None:
        start, width = 0, grid.num_cells
    else:
        start, width = cell_window

    r2 = (None if search_radius is None
          else jnp.asarray(search_radius * search_radius, mega.dtype))
    int_big = jnp.int32(2**30)
    # Offsets per gather group: the candidate minor axis is group*cap
    # wide; pick the largest group with group*cap <= 128 (cap 24 -> 5 =
    # 120 lanes, cap 16 -> 8 = 128, cap 32 -> 4 = 128).  The 128 was
    # chosen for a 128-lane vector unit and is not yet re-decided on the
    # GPU.  Grouping only batches the masked min-reduces; the emitted
    # top-k set is grouping-invariant.
    group = max(1, min(27, 128 // cap))

    # The sweep is chunked over cells so the (chunk, cap, group*cap)
    # intermediates stay ~256MB regardless of grid size (an unchunked
    # sweep at 1M particles allocates multi-GB buffers).  Chunks run
    # under lax.scan; unrolling them makes compiles at large N long.
    chunk = max(4096, (64 * 1024 * 1024) // (cap * group * cap))
    if os.environ.get("ARGON_SWEEP_CHUNK"):
        # Test hook: shrink the chunk so the multi-chunk lax.cond
        # dispatch path (occupancy skip) is exercisable at CPU-test
        # particle counts.  Never set in production runs.
        chunk = int(os.environ["ARGON_SWEEP_CHUNK"])
    n_chunks = -(-width // chunk)
    chunk = -(-width // n_chunks)  # balance the chunks

    # Pad the planes/neighbour table so every scanned chunk is full-size
    # (padding rows look like the dummy empty cell).  In windowed mode
    # the window may START anywhere up to num_cells, and dynamic_slice
    # silently CLAMPS an out-of-range start -- which would misalign the
    # partner readback and drop collisions near late shards' boundaries
    # (caught by tests/test_cross_shard_pair.py) -- so pad by the full
    # scanned extent.
    # Occupancy skip (single-chip active mode): ~24% of active rows hold
    # no particle at any given rebuild (Poisson occupancy + the 0.5-cell
    # static margin) yet cost full (cap, 14*cap) hit-test/top-k lanes --
    # the sweep's dominant term by operation count.  Stably permute NONEMPTY rows first and skip whole
    # trailing chunks with a lax.cond.  Per-particle candidates are
    # unchanged (row order only affects buffer layout; readback is
    # per-particle through the cell->row map), so the engine's bitwise
    # gates hold.  Windowed (sharded) mode keeps the static layout: its
    # a_start/active_rank contract assumes list order.
    # occupancy_skip=False pins the static layout (A/B knob:
    # EngineConfig.rebuild_occupancy_skip lets a bench measure both
    # forms on the SAME tree).
    dyn_skip = use_active and cell_window is None and occupancy_skip
    if use_active:
        # Emission rows are GATHERED through the active list; one far
        # pad row (index num_rows) absorbs list padding, and the
        # neighbour table gets two dummy rows so a padded active id
        # still reads "all neighbours outside".  The list is padded by
        # the full scanned extent because a windowed ``a_start`` may
        # point anywhere in it (dynamic_slice clamps silently -- same
        # hazard as the windowed plane slices below).
        pad_rows = 1
        if dyn_skip:
            act = grid.active_cells
            counts = jnp.sum(table[act] < n, axis=1, dtype=jnp.int32)
            row_has = counts > 0
            perm = jnp.argsort(~row_has)       # stable: nonempty first
            n_nonempty = jnp.sum(row_has, dtype=jnp.int32)
            act_used = act[perm]
            # cell -> permuted row (or -1: inactive, or empty this
            # rebuild -- no particle reads an empty cell's row).
            dyn_rank = jnp.full((grid.num_cells + 1,), -1, jnp.int32)
            dyn_rank = dyn_rank.at[act_used].set(
                jnp.where(row_has[perm],
                          jnp.arange(act.shape[0], dtype=jnp.int32),
                          -1),
                mode="drop",
            )
        else:
            act_used = grid.active_cells
        act_p = jnp.pad(act_used, (0, n_chunks * chunk),
                        constant_values=num_rows)
        nbr_p = jnp.pad(grid.neighbors, ((0, 2), (0, 0)),
                        constant_values=grid.num_cells)
    elif cell_window is None:
        pad_rows = max(n_chunks * chunk - width, 0)
    else:
        pad_rows = n_chunks * chunk
    if not use_active:
        nbr_p = jnp.pad(grid.neighbors, ((0, pad_rows), (0, 0)),
                        constant_values=grid.num_cells)
    px_p = jnp.pad(px, ((0, pad_rows), (0, 0)), constant_values=1e9)
    py_p = jnp.pad(py, ((0, pad_rows), (0, 0)), constant_values=1e9)
    pz_p = jnp.pad(pz, ((0, pad_rows), (0, 0)), constant_values=1e9)
    pid_p = jnp.pad(pid, ((0, pad_rows), (0, 0)), constant_values=-2)
    pr_p = (None if pr is None else
            jnp.pad(pr, ((0, pad_rows), (0, 0)), constant_values=0.0))

    def sweep_chunk(c0):
        if use_active:
            sel_cells = jax.lax.dynamic_slice_in_dim(act_p, a_start + c0,
                                                     chunk)

            def window(p):
                return p[sel_cells]

            nbr = nbr_p[sel_cells]
        else:
            def window(p):
                return jax.lax.dynamic_slice_in_dim(p, start + c0,
                                                    chunk, axis=0)

            nbr = jax.lax.dynamic_slice_in_dim(nbr_p, start + c0, chunk,
                                               axis=0)

        c_len = chunk
        ox, oy, oz = window(px_p), window(py_p), window(pz_p)
        oid = window(pid_p)
        orc = None if pr_p is None else window(pr_p)
        # Emitter-side pre-widened bf16 reach plane, hoisted out of the
        # offset loop (2D; the widening factor is applied per PLANE so
        # the full-shape threshold work stays one bf16 add + mul).
        orc_w = (None if (orc is None or not bf16_hit) else
                 (orc * (1.0 + BF16_HIT_EPS)).astype(jnp.bfloat16))
        bests = tuple(oid * 0 + int_big for _ in range(top_k))

        # Offset-grouped: the candidate (minor) axis is group*cap wide --
        # near-full 128-lane rows instead of the ~19% a bare `cap` axis
        # fills.  The candidate choice is the
        # LOWEST-INDEX in-range candidate: one fused masked min-reduce
        # per group (top_k > 1 re-reduces with the previous minimum
        # masked out).  (Nearest-overlap needed a second d2-equality pass
        # that defeated fusion and doubled HBM traffic; which overlapping
        # candidate wins is physically arbitrary -- >99.9% of colliding
        # particles have exactly one candidate at these densities -- and
        # lowest-index is just as deterministic and shard-consistent.)
        for o0 in range(13 if half_shell else 0, 27, group):
            sel = nbr[:, o0:o0 + group]                # (c_len, g)
            g = sel.shape[1]
            block = mega[sel]                          # (c_len, g, P*cap)

            def part(k):
                return block[:, :, k * cap:(k + 1) * cap].reshape(
                    c_len, g * cap
                )

            nx_, ny_, nz_ = part(0), part(1), part(2)
            nix = unpack_int(part(ix_plane))
            nid = unpack_int(part(id_plane)) if has_ids else nix
            dx = ox[:, :, None] - nx_[:, None, :]
            dy = oy[:, :, None] - ny_[:, None, :]
            dz = oz[:, :, None] - nz_[:, None, :]
            if r2 is not None:
                d2 = dx * dx + dy * dy + dz * dz       # (c_len, cap, g*cap)
                in_range = d2 < r2
            elif bf16_hit:
                # Cast-form bf16 hit test (EngineConfig.
                # rebuild_bf16_hittest).  Differences stay f32 (bf16
                # ABSOLUTE positions would round by ~|x| 2^-9 -- more
                # than the collision range at pore scales); the small
                # differences cast exactly enough, and the threshold is
                # pre-widened by BF16_HIT_EPS so the bf16 hit set is a
                # guaranteed SUPERSET of the exact f32 set (error
                # budget in the BF16_HIT_EPS comment).  Extra
                # candidates only saturate top-k, which queues the
                # pending1 exact re-search (ops/pairs.rebuild), and
                # resolution re-tests exact f32 overlap per step --
                # coverage and trajectories are unchanged.
                bf = jnp.bfloat16
                dxb = dx.astype(bf)
                dyb = dy.astype(bf)
                dzb = dz.astype(bf)
                d2b = dxb * dxb + dyb * dyb + dzb * dzb
                prw = (part(reach_plane)
                       * (1.0 + BF16_HIT_EPS)).astype(bf)
                tw = orc_w[:, :, None] + prw[:, None, :]
                in_range = d2b < tw * tw
            else:
                d2 = dx * dx + dy * dy + dz * dz       # (c_len, cap, g*cap)
                thresh = orc[:, :, None] + part(reach_plane)[:, None, :]
                in_range = d2 < thresh * thresh
            if half_shell:
                # Cross-cell lanes need no id test at all (distinct
                # cells can never hold the same particle; empty slots
                # die on the far-sentinel position); id order applies
                # only within the self cell, column 13.
                if o0 <= 13 < o0 + g:
                    self_lanes = jnp.asarray(
                        np.repeat(np.arange(o0, o0 + g) == 13, cap)
                    )
                    hit = in_range & jnp.where(
                        self_lanes[None, None, :],
                        nid[:, None, :] > oid[:, :, None],
                        True,
                    )
                else:
                    hit = in_range
            elif one_sided:
                # Strict > excludes self AND the lower-id half (empty
                # slots still die on the far-sentinel position).
                hit = in_range & (nid[:, None, :] > oid[:, :, None])
            else:
                hit = in_range & (nid[:, None, :] != oid[:, :, None])
            masked = jnp.where(hit, nix[:, None, :], int_big)
            # Sequential top-k masked min-passes.
            prev = None
            for k in range(top_k):
                if prev is not None:
                    masked = jnp.where(
                        masked > prev[:, :, None], masked, int_big
                    )
                cand = jnp.min(masked, axis=-1)
                prev = cand
                # Insertion into the ascending running top-k (group
                # minima arrive ascending, so a single min/max
                # bubble pass per candidate keeps `bests` sorted).
                new = []
                for b in bests:
                    lo = jnp.minimum(b, cand)
                    cand = jnp.maximum(b, cand)
                    new.append(lo)
                bests = tuple(new)
        stacked = jnp.stack(bests, axis=-1)            # (c_len, cap, K)
        out = jnp.where(stacked < int_big, stacked, -1)
        return out

    if dyn_skip and n_chunks > 1:
        # Chunks whose first row rank >= n_nonempty contain only empty
        # rows (nonempty rows were permuted to the front): skip the
        # sweep body entirely.  The skipped rows' buffer content is
        # never read (no particle lives in an empty cell).
        def chunk_or_skip(carry, c0):
            out = jax.lax.cond(
                c0 < n_nonempty,
                sweep_chunk,
                lambda _: jnp.full((chunk, cap, top_k), -1,
                                   jnp.int32),
                c0,
            )
            return carry, out

        _, parts = jax.lax.scan(
            chunk_or_skip, None,
            jnp.arange(n_chunks, dtype=jnp.int32) * chunk,
        )
        cand_flat = parts.reshape(-1, top_k)[: width * cap]
    elif n_chunks == 1:
        cand_flat = sweep_chunk(0).reshape(-1, top_k)
    else:
        _, parts = jax.lax.scan(
            lambda carry, c0: (carry, sweep_chunk(c0)),
            None,
            jnp.arange(n_chunks, dtype=jnp.int32) * chunk,
        )
        cand_flat = parts.reshape(-1, top_k)[: width * cap]
    # Read back to particle order through the particle->slot map (an
    # N-sized gather; the former slot->particle scatter moved C*cap
    # elements and cost ~5% of the whole step).
    if use_active:
        # Active mode: cand_flat rows are in active-LIST order (offset
        # by ``a_start`` in windowed mode); map each particle's cell
        # through the static rank table.  A particle in an INACTIVE
        # cell (stray beyond the 0.5-cell margin) was not swept as an
        # emission row -- report it in ``unswept`` so the rebuild
        # routes it hot (re-searched both-sided every step, exactly
        # like a capacity spill).  Table-dropped particles
        # (pslot == num_cells*cap) are already hot via their own path.
        cell_of = pslot // cap
        if dyn_skip:
            # Same one N-row gather as the static path, through the
            # per-rebuild cell->permuted-row map instead.
            rel_row = dyn_rank[jnp.minimum(cell_of, grid.num_cells)]
            covered = rel_row >= 0
        else:
            arank = grid.active_rank[jnp.minimum(cell_of, grid.num_cells)]
            rel_row = arank - a_start
            covered = (arank >= 0) & (rel_row >= 0) & (rel_row < width)
        rel = jnp.clip(rel_row * cap + pslot % cap, 0, width * cap - 1)
        cands = jnp.where(covered[:, None], cand_flat[rel], -1)
        unswept = (~covered) & (pslot < grid.num_cells * cap)
    else:
        rel = pslot - jnp.int32(start) * cap
        in_window = (rel >= 0) & (rel < width * cap)
        rel = jnp.clip(rel, 0, width * cap - 1)
        cands = jnp.where(in_window[:, None], cand_flat[rel], -1)
        unswept = jnp.zeros((n,), jnp.bool_)
    return cands, unswept


def cell_search_sweep(
    mega, pslot, grid, n, *,
    has_ids=False, has_reach=True, top_k=1, cell_window=None,
    one_sided=False, half_shell=False, active_window=None,
    bf16_hit=False, occupancy_skip=True,
):
    """Run the candidate sweep as a STANDALONE program from a packed
    plane set produced by ``cell_candidate_search(tables_only=True)``.

    Split-rebuild mode (EngineConfig.split_rebuild_programs): the
    rebuild compiles as tables | sweep | epilogue, three smaller
    programs instead of one.
    The planes are reconstructed from ``mega`` by slicing (the integer
    planes ride as floats, exact below 2^24 -- enforced at pack time),
    so values -- and therefore trajectories -- are bitwise-identical
    to the fused path (tested); only the program boundaries move.
    """
    cap = grid.capacity

    def plane(k):
        return mega[:, k * cap:(k + 1) * cap]

    px, py, pz = plane(0), plane(1), plane(2)
    table = plane(3).astype(jnp.int32)
    pid = plane(4).astype(jnp.int32) if has_ids else table
    pr = plane(5 if has_ids else 4) if has_reach else None
    return _candidate_sweep(
        mega, table, pslot, px, py, pz, pid, pr, grid, n,
        search_radius=None, top_k=top_k, has_ids=has_ids,
        cell_window=cell_window, one_sided=one_sided,
        half_shell=half_shell, active_window=active_window,
        bf16_hit=bf16_hit,
        occupancy_skip=occupancy_skip,
    )



def allpairs_partner_search(
    pos: jnp.ndarray, search_radius: float, tile: int
):
    """Exact O(N^2) lowest-index-overlap partner search, tiled for VMEM.

    For small N (cube stage: ~25k particles) this is faster and simpler
    than any grid.  Returns (partner (N,), overflow=0).
    """
    n = pos.shape[0]
    n_pad = ((n + tile - 1) // tile) * tile
    pos_pad = jnp.concatenate(
        [pos, jnp.full((n_pad - n, 3), 1e9, pos.dtype)], axis=0
    )
    tiles = pos_pad.reshape(n_pad // tile, tile, 3)
    r2 = jnp.asarray(search_radius * search_radius, pos.dtype)
    my_idx = jnp.arange(n_pad, dtype=jnp.int32)

    def body(best_idx, inp):
        tile_pos, tile_off = inp
        diff = pos_pad[:, None, :] - tile_pos[None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)             # (n_pad, tile)
        cand_idx = tile_off + jnp.arange(tile, dtype=jnp.int32)
        hit = (d2 < r2) & (my_idx[:, None] != cand_idx[None, :])
        # Lowest-index overlapping candidate (see cell_partner_search).
        cand = jnp.min(
            jnp.where(hit, cand_idx[None, :], 2**30), axis=-1
        )
        return jnp.minimum(best_idx, cand), None

    offsets = jnp.arange(0, n_pad, tile, dtype=jnp.int32)
    init = jnp.full((n_pad,), 2**30, dtype=jnp.int32)
    best_idx, _ = jax.lax.scan(body, init, (tiles, offsets))
    partner = jnp.where(best_idx < 2**30, best_idx, -1)[:n]
    return partner, jnp.zeros((), jnp.int32)


# --------------------------------------------------------------------------
# Resolution (shared by both broad phases)
# --------------------------------------------------------------------------


def resolve_collisions(
    state: ParticleState,
    measure: Measurements,
    partner: jnp.ndarray,
    collision_range: float,
    mass: float,
    num_bins: int,
    hist_hi: float,
    local_mask: jnp.ndarray | None = None,
):
    """Mutually-matched elastic hard-sphere impulse exchange.

    Implements the reference collision kernel exactly, but symmetrically
    per particle (Open_Air_Pore_MC.py:181-240):

      t  = max root of |dx - dv t|^2 = collision_range^2  (penetration time)
      qa = pos_a - vel_a t ; qb = pos_b - vel_b t        (rewind)
      n  = (qb - qa)/collision_range                     (contact normal)
      va' = va - ((va-vb).n) n ;  vb' = vb + ((va-vb).n) n
      pos' = q + v' t                                    (replay)

    Each matched particle computes only ITS OWN update from gathered
    partner state; the formula's symmetry guarantees both sides agree, so
    there are no scatters and no write races.

    ``local_mask`` (sharded engine): lanes holding remote ghost copies are
    False -- they participate in matching but their state/measurement
    updates belong to the owning shard.  When given, the returned count is
    sum(ok & local) (each cross-shard pair contributes once per side; the
    caller psums across shards and divides by 2).

    Returns (state, measure, n_collisions, ok_mask).
    """
    n = state.pos.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    has_partner = partner >= 0
    safe_partner = jnp.where(has_partner, partner, 0)

    # One packed row gather for everything needed from the partner:
    # position, velocity, and the partner's own choice (for the mutual
    # check): one 8-wide row gather instead of three.  The index rides VALUE-converted (exact below 2^24 in
    # f32), never bitcast: small-int bit patterns are denormals and the
    # XLA CPU backend flushes them in the gather pipeline (see
    # cell_candidate_search).
    if state.pos.dtype == jnp.float32 and n >= (1 << 24):
        raise ValueError(
            f"float32 packed partner column is exact only below 2^24 "
            f"particles (n={n}); use float64"
        )
    partner_f = partner.astype(state.pos.dtype)
    pv = jnp.concatenate(
        [state.pos, state.vel, partner_f[:, None]], axis=1
    )
    pv_b = pv[safe_partner]
    pos_b = pv_b[:, :3]
    vel_b = pv_b[:, 3:6]
    partner_of_partner = pv_b[:, 6].astype(jnp.int32)
    mutual = has_partner & (partner_of_partner == idx)
    dxv = pos_b - state.pos              # x2 - x1 from "my" perspective
    dvv = state.vel - vel_b              # v1 - v2

    a = jnp.sum(dvv * dvv, axis=-1)
    b = 2.0 * jnp.sum(dxv * dvv, axis=-1)
    c = jnp.sum(dxv * dxv, axis=-1) - collision_range * collision_range
    disc = b * b - 4.0 * a * c
    # c < 0 <=> currently overlapping; partner search guarantees this at
    # skin=0 but a Verlet skin would admit non-touching candidates.
    ok = mutual & (a > 0.0) & (disc >= 0.0) & (c < 0.0)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.where(a == 0.0, 1.0, a)
    t = jnp.maximum((-b + sq) / (2.0 * a_safe), (-b - sq) / (2.0 * a_safe))

    qa = state.pos - state.vel * t[:, None]
    qb = pos_b - vel_b * t[:, None]
    normal = (qb - qa) / collision_range
    p_scal = jnp.sum(dvv * normal, axis=-1)
    new_vel = state.vel - p_scal[:, None] * normal
    new_pos = qa + new_vel * t[:, None]

    apply = ok if local_mask is None else (ok & local_mask)

    # Record completed paths with the PRE-collision velocity and t.
    measure = measure_ops.record_completed(
        measure, state.paths, state.has_collided, state.vel, t, apply,
        num_bins, hist_hi,
    )

    state.pos = jnp.where(apply[:, None], new_pos, state.pos)
    state.vel = jnp.where(apply[:, None], new_vel, state.vel)
    state = measure_ops.end_paths(state, apply, t, state.vel,
                                  zero_residual=False)

    if local_mask is None:
        n_collisions = jnp.sum(ok, dtype=jnp.int32) // 2
        measure.collision_count = measure.collision_count + n_collisions
    else:
        # The sharded caller counts each pair exactly once itself (on the
        # shard owning the lower global id) and updates the accumulator.
        n_collisions = jnp.sum(apply, dtype=jnp.int32)
    return state, measure, n_collisions, ok
