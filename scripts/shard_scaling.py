"""Multi-chip scaling characterization on the virtual CPU mesh.

The sharded engine's overhead on the virtual CPU mesh.  This measures,
on an
``--xla_force_host_platform_device_count`` virtual mesh:

- STRONG scaling: fixed total N across 1/2/4/8 shards,
- WEAK scaling: fixed N per shard,
- the per-step communication volumes implied by the shard plan's
  capacities (halo + migration ppermute payloads),

plus the unsharded single-device engine at the same N as the reference
point.  IMPORTANT CAVEAT (recorded in the output): this host has ONE
physical core, so all virtual devices timeshare it -- wall-clock here
measures sharding OVERHEAD (collectives, ghost-band work, fixed-capacity
padding), not parallel speedup; ideal strong scaling on real hardware
shows up here as flat-or-mildly-growing total time.  The numbers still
smoke out shard-count-dependent capacity bugs and quantify the overhead
a real multi-device mesh would amortize.

Launch (CPU platform + 8 virtual devices forced before jax loads):

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python scripts/shard_scaling.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argon_monte_carlo_tpu as amc  # noqa: E402
from argon_monte_carlo_tpu.utils.cache import enable_compile_cache  # noqa: E402
from argon_monte_carlo_tpu.parallel.mesh import make_mesh  # noqa: E402
from argon_monte_carlo_tpu.parallel.shard import ShardedSimulation  # noqa: E402

STEPS = int(os.environ.get("SCALING_STEPS", 16))
WARMUP = int(os.environ.get("SCALING_WARMUP", 8))
K = 4


def engine():
    return amc.EngineConfig(
        dtype="float32", broadphase="cells", narrowphase="pairs",
        rebuild_interval=K, steps_per_epoch=K,
    )


def comm_volumes(plan, dtype_bytes=4):
    """Per-step ppermute payload bytes implied by the plan capacities.

    Sweep-mode halo bands carry pos(3)+vel(3) dtype + gid(i32) + flag
    per slot, both directions; migration adds paths(4)+has_collided and
    runs once per step (sweep) / per block boundary (pairs).  Pairs mode
    freezes ghost bands per K-step block, so its halo volume amortizes
    by 1/K.
    """
    halo_row = 6 * dtype_bytes + 4 + 1
    mig_row = (6 + 4) * dtype_bytes + 4 + 1 + 1
    return {
        "halo_bytes_per_step_sweep": 2 * plan.halo_capacity * halo_row,
        "migration_bytes_per_step": 2 * plan.migration_capacity * mig_row,
        "pairs_halo_bytes_per_block": 2 * plan.pairs_halo_capacity * halo_row,
        "pairs_halo_bytes_per_step_amortized":
            2 * plan.pairs_halo_capacity * halo_row / K,
        "pairs_migration_bytes_per_boundary":
            2 * plan.pairs_migration_capacity * mig_row,
    }


def run_sharded(n: int, d: int, dense: bool = False) -> dict:
    if dense:
        # Bench-like AMBIENT density: scale the geometry to hold n
        # molecules at the reference pressure (exactly what bench.py
        # does), so the shard plan's capacity sizing, ghost-band
        # widths, and overflow behaviour are exercised at the particle
        # density the committed bench numbers run at -- not the ~12x
        # thinner density num_particles_override leaves in the
        # unscaled pore (VERDICT r4 item 7a).
        cfg = amc.temperature_pore_config(engine=engine()).scaled_to(n)
    else:
        cfg = amc.temperature_pore_config(
            num_particles_override=n, engine=engine()
        )
    devs = jax.devices("cpu")
    mesh = make_mesh(d, devices=devs[:d])
    sim = ShardedSimulation(amc.make_workload(cfg), mesh=mesh)
    st0, m0, key = sim.init()
    t0 = time.time()
    state, measure, _ = sim.run(num_steps=WARMUP, state=st0, measure=m0,
                                run_key=key)
    jax.block_until_ready(measure.collision_count)
    compile_s = time.time() - t0
    t0 = time.time()
    state, measure, _ = sim.run(num_steps=STEPS, state=state,
                                measure=measure, run_key=key,
                                start_step=WARMUP)
    jax.block_until_ready(measure.collision_count)
    dt_s = time.time() - t0
    total = sim.finalize_measure(measure)
    plan = sim.plan
    return {
        "n_devices": d, "n": cfg.num_molecules,
        "steps_per_sec": STEPS / dt_s,
        "particle_steps_per_sec": cfg.num_molecules * STEPS / dt_s,
        "timed_sec": dt_s, "warmup_incl_compile_sec": compile_s,
        "collisions": int(total.collision_count),
        "overflow": int(total.overflow_count),
        "errs": int(total.err_count),
        "shard_capacity": plan.shard_capacity,
        "halo_capacity": plan.halo_capacity,
        "migration_capacity": plan.migration_capacity,
        "pairs_halo_capacity": plan.pairs_halo_capacity,
        "pairs_migration_capacity": plan.pairs_migration_capacity,
        **comm_volumes(plan),
    }


def run_single(n: int) -> dict:
    cfg = amc.temperature_pore_config(
        num_particles_override=n, engine=engine()
    )
    sim = amc.Simulation(amc.make_workload(cfg))
    st0, m0, key = sim.init()
    state, measure, _ = sim.run(num_steps=WARMUP, state=st0, measure=m0,
                                run_key=key)
    jax.block_until_ready(measure.collision_count)
    t0 = time.time()
    state, measure, _ = sim.run(num_steps=STEPS, state=state,
                                measure=measure, run_key=key,
                                start_step=WARMUP)
    jax.block_until_ready(measure.collision_count)
    dt_s = time.time() - t0
    return {
        "n_devices": 0, "n": cfg.num_molecules,
        "steps_per_sec": STEPS / dt_s,
        "particle_steps_per_sec": cfg.num_molecules * STEPS / dt_s,
        "timed_sec": dt_s,
        "collisions": int(sim.finalize_measure(measure).collision_count),
    }


def main():
    assert jax.devices()[0].platform == "cpu" and len(jax.devices()) >= 8, (
        "launch with JAX_PLATFORMS=cpu and "
        "XLA_FLAGS=--xla_force_host_platform_device_count=8"
    )
    enable_compile_cache()
    n_strong = int(os.environ.get("SCALING_N", 48000))
    per_dev = int(os.environ.get("SCALING_N_PER_DEV", 6000))

    # Single-point mode: the XLA:CPU in-process collective executor
    # reproducibly aborts (rendezvous watchdog) on the SECOND 8-device
    # mesh built in one process on this 1-core host, so the aggregate
    # mode below shells out one subprocess per point.
    if len(sys.argv) >= 3 and sys.argv[1] in ("single", "strong", "weak",
                                              "dense"):
        kind, d = sys.argv[1], int(sys.argv[2])
        if kind == "single":
            r = run_single(n_strong)
        elif kind == "strong":
            r = run_sharded(n_strong, d)
        elif kind == "dense":
            r = run_sharded(n_strong, d, dense=True)
        else:
            r = run_sharded(per_dev * d, d)
        print(json.dumps(r))
        return

    if os.environ.get("SCALING_INPROC") != "1":
        import subprocess

        out = {
            "caveat": ("single physical core: virtual devices timeshare "
                       "it; these numbers measure sharding overhead, not "
                       "parallel speedup"),
            "steps": STEPS, "warmup": WARMUP, "rebuild_interval": K,
            "strong": [], "weak": [],
        }

        def point(kind, d, tries=3):
            # The 8-device rendezvous abort is FLAKY (identical configs
            # pass ~50% on this timeshared core): retry in fresh
            # subprocesses before recording a failure.
            for attempt in range(tries):
                pr = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), kind,
                     str(d)],
                    capture_output=True, text=True, env=dict(os.environ),
                )
                if pr.returncode == 0:
                    break
                tail = (pr.stderr or "").strip().splitlines()[-3:]
                print(f"point {kind} d={d} attempt {attempt + 1} FAILED "
                      f"rc={pr.returncode}: {tail}", file=sys.stderr)
            if pr.returncode != 0:
                return {"kind": kind, "n_devices": d, "failed": True}
            r = json.loads(pr.stdout.strip().splitlines()[-1])
            print(f"{kind} d={d}: {r['particle_steps_per_sec']:.3g} ps/s "
                  f"overflow={r.get('overflow')}", file=sys.stderr)
            return r

        out["unsharded_baseline"] = point("single", 0)
        for d in (1, 2, 4, 8):
            out["strong"].append(point("strong", d))
        for d in (1, 2, 4, 8):
            out["weak"].append(point("weak", d))
        os.makedirs("runs/shard_scaling", exist_ok=True)
        path = os.environ.get("SCALING_OUT",
                              "runs/shard_scaling/cpu_mesh.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out))
        return
    out = {
        "caveat": ("single physical core: virtual devices timeshare it; "
                   "these numbers measure sharding overhead, not "
                   "parallel speedup"),
        "steps": STEPS, "warmup": WARMUP, "rebuild_interval": K,
        "unsharded_baseline": run_single(n_strong),
        "strong": [], "weak": [],
    }
    os.makedirs("runs/shard_scaling", exist_ok=True)
    path = os.environ.get("SCALING_OUT", "runs/shard_scaling/cpu_mesh.json")

    def checkpoint():
        # The 8-virtual-device rendezvous can abort the PROCESS under
        # host CPU contention (xla::cpu collective watchdog); keep every
        # completed point on disk.
        with open(path, "w") as f:
            json.dump(out, f, indent=1)

    checkpoint()
    print(f"baseline: {out['unsharded_baseline']}", file=sys.stderr)
    for d in (1, 2, 4, 8):
        r = run_sharded(n_strong, d)
        out["strong"].append(r)
        checkpoint()
        print(f"strong d={d}: {r['particle_steps_per_sec']:.3g} ps/s "
              f"overflow={r['overflow']}", file=sys.stderr)
    for d in (1, 2, 4, 8):
        r = run_sharded(per_dev * d, d)
        out["weak"].append(r)
        checkpoint()
        print(f"weak d={d} (n={per_dev * d}): "
              f"{r['particle_steps_per_sec']:.3g} ps/s "
              f"overflow={r['overflow']}", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
