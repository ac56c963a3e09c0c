"""Benchmark harness: particle-steps/sec per device on the temperature pore.

Runs the Temperature_Pore workload (the reference's final stage,
Temperature_Pore_MC.py) scaled to BENCH_PARTICLES molecules at ambient
density on the first GPU, and prints ONE JSON line whose keys include

    {"metric": ..., "value": N, "unit": ..., "platform": "gpu",
     "device_kind": ..., "device_count": N, "card": "<name>, <limit> W"}

It refuses to measure anything but a GPU: when JAX finds no GPU it exits
non-zero, unless ``JAX_PLATFORMS=cpu`` was set explicitly (the CPU smoke
test of this script), and then every result says ``"platform": "cpu"``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BENCH_PARTICLES = int(os.environ.get("BENCH_PARTICLES", 1_000_000))
# Epoch length: a multiple of the K=8 rebuild interval so the pairs
# engine compiles exactly ONE scan-block length (engine.py splits each
# epoch into K-step blocks between separately-jitted rebuilds).
STEPS_PER_EPOCH = int(os.environ.get("BENCH_SPE", 48))
WARMUP_STEPS = int(os.environ.get("BENCH_WARMUP_STEPS", STEPS_PER_EPOCH))
# Five timed epochs, reported as the median with the best beside it.
TIMED_STEPS = int(os.environ.get("BENCH_STEPS", 5 * STEPS_PER_EPOCH))


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v != "0"


def card_description() -> str | None:
    """``nvidia-smi``'s "name, power.limit" of the card(s), or None when
    there is no NVIDIA driver (the explicit CPU smoke run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def main() -> int:
    import jax

    from argon_monte_carlo_tpu.utils.cache import enable_compile_cache

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        print(f"bench: JAX found no GPU (platform {platform!r}); set "
              "JAX_PLATFORMS=cpu to run the CPU smoke deliberately",
              file=sys.stderr)
        return 2
    enable_compile_cache()

    import argon_monte_carlo_tpu as amc

    eng = amc.EngineConfig(
        dtype="float32", broadphase="cells",
        steps_per_epoch=STEPS_PER_EPOCH,
        # Exact histogram semantics: benchmark the same program the
        # parity/golden runs validate.
        hist_flush_interval=1,
        # Verlet reach-pair narrow phase (ops/pairs.py): bitwise-equal
        # trajectories to the per-step sweep (tests/test_pairs.py), the
        # full neighbour sweep amortized over 8 steps.
        narrowphase=os.environ.get("BENCH_NARROWPHASE", "pairs"),
        rebuild_interval=int(os.environ.get("BENCH_REBUILD_INTERVAL", 8)),
        # Grid-shape sweep knobs: the rebuild sweep's dominant term
        # scales ~rows * cap^2 while spill-to-hot keeps ANY capacity
        # coverage-exact (tests/test_pairs.py forced-starvation at cap
        # 4) and pairs_config_for grows the research budgets to absorb
        # the thinner Poisson tail.  Defaults (occ 11 -> cap 24) are
        # the shipping config; BENCH_CELL_CAP/BENCH_CELL_OCC measure
        # alternatives without a code change.
        cell_capacity=(int(os.environ["BENCH_CELL_CAP"])
                       if os.environ.get("BENCH_CELL_CAP") else None),
        cell_occupancy=float(os.environ.get("BENCH_CELL_OCC", 11.0)),
        # Rebuild levers (EngineConfig docstrings); unset env inherits
        # the shipping default, so a bare run measures exactly the
        # configuration a user gets.
        packed_layer_gather=_env_bool("BENCH_PACKED_LAYERS", True),
        rebuild_bf16_hittest=_env_bool("BENCH_BF16_HIT", False),
        rebuild_occupancy_skip=_env_bool("BENCH_OCC_SKIP", False),
        eager_rebuild=os.environ.get("BENCH_EAGER_REBUILD") == "1",
        split_rebuild_programs=(
            os.environ.get("BENCH_SPLIT_REBUILD") == "1"),
        max_block_steps=(int(os.environ["BENCH_MAX_BLOCK"])
                         if os.environ.get("BENCH_MAX_BLOCK") else None),
    )
    cfg = amc.temperature_pore_config(engine=eng).scaled_to(BENCH_PARTICLES)
    n = cfg.num_molecules
    device_kind = devices[0].device_kind
    print(f"bench: N={n} device={device_kind} "
          f"warmup={WARMUP_STEPS} timed={TIMED_STEPS}", file=sys.stderr)

    workload = amc.make_workload(cfg)
    sim = amc.Simulation(workload)
    t0 = time.time()
    state, measure, key = sim.init()
    jax.block_until_ready(state.pos)
    print(f"bench: init done in {time.time()-t0:.1f}s", file=sys.stderr,
          flush=True)

    # Derived pair-check rate (BASELINE.md tracked metric): exact
    # narrow-phase tests per step = the listed-pair buffer width (every
    # entry is one d^2 < cr^2 test), plus the rebuild sweep's hit-test
    # lanes amortized over the K-step window (pairs mode; the sweep
    # engine re-tests its full lane volume every step).
    if eng.narrowphase == "pairs":
        from argon_monte_carlo_tpu.engine import pairs_config_for
        pcfg = pairs_config_for(workload)
        g = sim._hgrid
        rows = (g.active_cells.shape[0] if g.active_cells is not None
                else g.num_cells)
        sweep_lanes = rows * g.capacity * 14 * g.capacity
        checks_per_step = (pcfg.pair_capacity
                           + sweep_lanes / max(eng.rebuild_interval, 1))
    else:
        g = sim._hgrid
        checks_per_step = g.num_cells * g.capacity * 27 * g.capacity

    t0 = time.time()
    state, measure, _ = sim.run(
        num_steps=WARMUP_STEPS, state=state, measure=measure, run_key=key
    )
    jax.block_until_ready(state.pos)
    print(f"bench: warmup (incl. compile) {time.time()-t0:.1f}s",
          file=sys.stderr)

    # Each epoch ends in a device->host pull of a checksum, so its wall
    # time covers the work; the headline is the median epoch.
    spe = eng.steps_per_epoch
    n_epochs = max(TIMED_STEPS // spe, 1)
    epoch_times = []
    step0 = WARMUP_STEPS
    t_all = time.time()
    for e in range(n_epochs):
        t0 = time.time()
        state, measure, metrics = sim.run(
            num_steps=spe, state=state, measure=measure, run_key=key,
            start_step=step0,
        )
        checksum = float(state.pos[:, 2].sum())
        epoch_times.append(time.time() - t0)
        step0 += spe
        print(f"bench: epoch {e}: {epoch_times[-1]:.2f}s "
              f"({n*spe/epoch_times[-1]:.3g} ps/s)", file=sys.stderr)
    elapsed = time.time() - t_all
    median = sorted(epoch_times)[len(epoch_times) // 2]

    value = n * spe / median
    result = {
        "metric": "particle-steps/sec/device, median epoch "
                  f"(Temperature_Pore, {BENCH_PARTICLES} particles)",
        "value": value,
        "unit": "particle-steps/sec/device",
        "platform": platform,
        "device_kind": device_kind,
        "device_count": len(devices),
        "card": card_description(),
        "elapsed_throughput": n * n_epochs * spe / elapsed,
        "particles": n,
        "timed_steps": n_epochs * spe,
        "elapsed_sec": elapsed,
        "epoch_times_sec": [round(t, 3) for t in epoch_times],
        "median_epoch_sec": round(median, 3),
        "best_epoch_sec": round(min(epoch_times), 3),
        "best_epoch_throughput": n * spe / min(epoch_times),
        "steps_per_sec": value / n,
        "pair_checks_per_sec": (value / n) * checks_per_step,
        "collisions": int(sim.finalize_measure(measure).collision_count),
        "checksum": checksum,
    }
    from argon_monte_carlo_tpu.io.metrics import device_memory_stats

    mem = device_memory_stats()
    if mem:
        result["device_memory"] = mem
    # Record non-default compile options (engine._engine_jit): the
    # measurement must say which program it timed.
    if os.environ.get("ARGON_COMPILER_OPTIONS"):
        result["compiler_options"] = json.loads(
            os.environ["ARGON_COMPILER_OPTIONS"])
    # Stamp non-default bench knobs so lever/sweep artifacts are
    # self-describing (which program shape produced this number).
    knobs = {k: os.environ[k] for k in
             ("BENCH_CELL_CAP", "BENCH_CELL_OCC",
              "BENCH_PACKED_LAYERS", "BENCH_BF16_HIT",
              "BENCH_OCC_SKIP",
              "BENCH_EAGER_REBUILD", "ARGON_EAGER_REBUILD",
              "BENCH_SPLIT_REBUILD", "ARGON_SPLIT_REBUILD",
              "BENCH_MAX_BLOCK", "ARGON_MAX_BLOCK_STEPS",
              "BENCH_REBUILD_INTERVAL", "BENCH_SPE")
             if os.environ.get(k)}
    if knobs:
        result["bench_knobs"] = knobs
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
