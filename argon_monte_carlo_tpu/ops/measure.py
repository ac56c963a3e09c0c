"""Free-path measurement: the partial/full path state machine + histograms.

The reference appends every completed free path to Manager() lists and
histograms them at the end (Open_Air_Pore_MC.py:408-413, 571-599).  Lists
are unbounded host memory and an RPC per append; since every output only
uses binned densities and the mean, we bin on device into fixed
``(4, num_bins+1)`` accumulators (last bin = beyond-range overflow) and
keep exact running sums/counts for the means.

Path state machine (Open_Air_Cube_MC.py:267-280): a particle's first-ever
collision ends a *partial* path which is discarded (``has_collided`` flips
True); each subsequent collision emits the completed path, corrected by the
overshoot ``|v| * t`` beyond the true impact time.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..state import Measurements, ParticleState


def path_components(vel: jnp.ndarray) -> jnp.ndarray:
    """(N, 4) |velocity| magnitudes in path-axis order (total, x, y, z)."""
    speed = jnp.linalg.norm(vel, axis=-1)
    return jnp.stack(
        [speed, jnp.abs(vel[..., 0]), jnp.abs(vel[..., 1]),
         jnp.abs(vel[..., 2])],
        axis=-1,
    )


def accumulate_drift(state: ParticleState, dt: float) -> jnp.ndarray:
    """Distance accrued during one drift (Open_Air_Cube_MC.py:184-187)."""
    return state.paths + dt * path_components(state.vel)


def record_completed(
    measure: Measurements,
    paths_before: jnp.ndarray,      # (N, 4) accumulators before this event
    has_collided_before: jnp.ndarray,  # (N,)
    vel_before: jnp.ndarray,        # (N, 3) velocity before the event
    t: jnp.ndarray,                 # (N,) back-trace time of the event
    mask: jnp.ndarray,              # (N,) which particles had the event
    num_bins: int,
    hist_hi: float,
) -> Measurements:
    """Record completed paths ``|path_k - |v_k| * t|`` for masked particles.

    Only particles whose partial path already ended (has_collided) emit
    (Open_Air_Cube_MC.py:267-272).  Events are staged into
    ``measure.pending_*``; ``flush_pending`` folds them into the sums,
    counts and histogram once per step (see state.Measurements for the
    one-slot-per-particle semantics).
    """
    emit = mask & has_collided_before
    comps = jnp.abs(paths_before - path_components(vel_before) * t[:, None])
    m = comps.shape[0]
    pn = measure.pending_vals.shape[0]
    if pn == m:
        measure.pending_vals = jnp.where(
            emit[:, None], comps, measure.pending_vals
        )
        measure.pending_mask = measure.pending_mask | emit
    elif pn > m:
        # Sharded engine: wall-phase events cover only the local buffer
        # lanes of a pending area sized for local+ghost lanes.
        measure.pending_vals = measure.pending_vals.at[:m].set(
            jnp.where(emit[:, None], comps, measure.pending_vals[:m])
        )
        measure.pending_mask = measure.pending_mask.at[:m].set(
            measure.pending_mask[:m] | emit
        )
    # pn == 0 (unit tests on bare accumulators): binning disabled.
    return measure


# Fixed event-compaction width for the histogram flush.  Events per step
# are bounded by colliding + energized-wall particles -- O(N/steps_per_mft
# + wall-hit rate), a few thousand at reference scale -- so 16K slots are
# ~10x headroom at any benchmarked N; overflow (never observed) would
# drop the excess events from the histogram only (the exact sums/counts
# are computed over the full mask regardless) and is surfaced via
# Measurements.hist_drop_count.
FLUSH_CAPACITY = 16384


def flush_pending_compacted(measure: Measurements, event_idx: jnp.ndarray,
                            num_bins: int, hist_hi: float) -> Measurements:
    """Flush with a caller-provided compaction.

    ``event_idx`` (E,) holds indices covering every set ``pending_mask``
    lane (a superset is fine -- lanes are filtered by the mask; index n
    = inert padding).  Lets the engine share ONE N-sized nonzero between
    the histogram flush and the dirty re-search instead of one each.
    """
    n = measure.pending_vals.shape[0]
    emitted = measure.pending_mask[:, None]
    measure.path_sum = measure.path_sum + jnp.sum(
        jnp.where(emitted, measure.pending_vals, 0.0), axis=0
    )
    n_events = jnp.sum(measure.pending_mask, dtype=jnp.int32)
    measure.path_count = measure.path_count + n_events
    safe = jnp.clip(event_idx, 0, n - 1)
    valid = (event_idx < n) & measure.pending_mask[safe]
    vals = measure.pending_vals[safe]
    bin_width = hist_hi / num_bins
    ids = jnp.clip(
        jnp.floor(vals / bin_width).astype(jnp.int32), 0, num_bins
    )
    offsets = jnp.arange(4, dtype=jnp.int32) * (num_bins + 1)
    flat = jnp.where(
        valid[:, None], ids + offsets[None, :], 4 * (num_bins + 1)
    ).reshape(-1)
    w = jnp.broadcast_to(
        valid[:, None].astype(jnp.float32), ids.shape
    ).reshape(-1)
    measure.hist = (
        measure.hist.reshape(-1).at[flat].add(w, mode="drop")
        .reshape(measure.hist.shape)
    )
    measure.hist_drop_count = measure.hist_drop_count + (
        n_events - jnp.sum(valid, dtype=jnp.int32)
    )
    measure.pending_vals = jnp.zeros_like(measure.pending_vals)
    measure.pending_mask = jnp.zeros_like(measure.pending_mask)
    return measure


def flush_pending(measure: Measurements, num_bins: int,
                  hist_hi: float,
                  compact: bool = True,
                  capacity: int | None = None) -> Measurements:
    """Flush all staged events: running sums/counts + one histogram update.

    ``compact=True`` (default) first compacts the staged events to a
    fixed ``FLUSH_CAPACITY`` buffer and bins only those instead of a
    direct scatter-add of all N*4 mostly-empty lanes (a scatter touches
    every row whether or not its weight is zero).  ``compact=False``
    keeps the dense scatter
    (used inside shard_map where the event count per shard is the lane
    count anyway, and on CPU).

    ``capacity`` overrides the compaction width (the engine scales it
    with ``hist_flush_interval``: events accumulate across the flush
    window, one slot per particle, so a fixed 16K width could drop
    events a wider window legitimately staged -- ADVICE r2).
    """
    emitted = measure.pending_mask[:, None]
    measure.path_sum = measure.path_sum + jnp.sum(
        jnp.where(emitted, measure.pending_vals, 0.0), axis=0
    )
    measure.path_count = measure.path_count + jnp.sum(
        measure.pending_mask, dtype=jnp.int32
    )
    bin_width = hist_hi / num_bins
    n = measure.pending_vals.shape[0]
    cap = FLUSH_CAPACITY if capacity is None else capacity
    if compact and n > cap:
        from .compact import compact_indices

        event_idx = compact_indices(measure.pending_mask, cap, n)
        valid = event_idx < n
        vals = measure.pending_vals[jnp.where(valid, event_idx, 0)]
        ids = jnp.clip(
            jnp.floor(vals / bin_width).astype(jnp.int32), 0, num_bins
        )
        offsets = jnp.arange(4, dtype=jnp.int32) * (num_bins + 1)
        flat = jnp.where(
            valid[:, None], ids + offsets[None, :], 4 * (num_bins + 1)
        ).reshape(-1)
        w = jnp.broadcast_to(
            valid[:, None].astype(jnp.float32), ids.shape
        ).reshape(-1)
        n_events = jnp.sum(measure.pending_mask, dtype=jnp.int32)
        measure.hist_drop_count = measure.hist_drop_count + jnp.maximum(
            n_events - cap, 0
        )
    else:
        ids = jnp.clip(
            jnp.floor(measure.pending_vals / bin_width).astype(jnp.int32),
            0, num_bins,
        )
        offsets = jnp.arange(4, dtype=jnp.int32) * (num_bins + 1)
        flat = (ids + offsets[None, :]).reshape(-1)
        w = jnp.broadcast_to(
            measure.pending_mask[:, None].astype(jnp.float32), ids.shape
        ).reshape(-1)
    measure.hist = (
        measure.hist.reshape(-1).at[flat].add(w, mode="drop")
        .reshape(measure.hist.shape)
    )
    measure.pending_vals = jnp.zeros_like(measure.pending_vals)
    measure.pending_mask = jnp.zeros_like(measure.pending_mask)
    return measure


def end_paths(
    state: ParticleState,
    mask: jnp.ndarray,
    t: jnp.ndarray,
    vel_after: jnp.ndarray,
    zero_residual: bool,
) -> ParticleState:
    """Reset path accumulators after a collision event.

    Specular walls / pair collisions leave the overshoot distance already
    travelled along the *new* direction: residual = |v'_k| * t
    (Open_Air_Pore_MC.py:281-284, 332-335, 233-240).  Energized walls place
    the particle exactly at the wall, so the residual is zero
    (Temperature_Pore_MC.py:398-401).
    """
    if zero_residual:
        residual = jnp.zeros_like(state.paths)
    else:
        residual = jnp.abs(path_components(vel_after) * t[:, None])
    state.paths = jnp.where(mask[:, None], residual, state.paths)
    state.has_collided = state.has_collided | mask
    return state
