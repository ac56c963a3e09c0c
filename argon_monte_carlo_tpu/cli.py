"""Command-line entry point.

The reference's "CLI" is editing module constants and running
``python <script>.py`` (README.md:22-23).  Here each workload is a
subcommand with flags for the common knobs, periodic checkpointing,
JSONL metrics, and the reference-format artifacts written at the end.

    python -m argon_monte_carlo_tpu.cli temperature_pore \
        --steps 20000 --out runs/tp --checkpoint-every 2000
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import jax.numpy as jnp
import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="argon_monte_carlo_tpu",
        description="JAX hard-sphere argon Monte Carlo",
    )
    sub = p.add_subparsers(dest="workload", required=True)
    for name in ("cube", "pore", "temperature_pore"):
        w = sub.add_parser(name)
        w.add_argument("--steps", type=int, default=None,
                       help="timesteps (default: the workload's reference "
                            "count)")
        w.add_argument("--particles", type=int, default=None,
                       help="override the ideal-gas molecule count")
        w.add_argument("--target-particles", type=int, default=None,
                       help="scale the geometry to this molecule count at "
                            "ambient density (pore workloads)")
        w.add_argument("--seed", type=int, default=None)
        w.add_argument("--steps-per-mft", type=int, default=None,
                       help="timesteps per mean-free time (reference: "
                            "cube 25, pores 1000; the cube's 25 leaves "
                            "~9 collision ranges of drift per step, so "
                            "overlap detection under-samples crossings "
                            "-- 1000 resolves them)")
        w.add_argument("--out", type=str, default=".",
                       help="output directory for artifacts")
        w.add_argument("--dtype", choices=["float32", "float64"],
                       default="float32")
        w.add_argument("--narrowphase", choices=["sweep", "pairs"],
                       default=None,
                       help="'pairs' = Verlet reach-pair list (sweep only "
                            "every --rebuild-interval steps).  Default: "
                            "pairs for the pore workloads (the measured-"
                            "best flagship engine, ~2x the sweep's "
                            "throughput at 1M), sweep for the cube (its "
                            "per-step drift is ~19 collision ranges -- "
                            "no top-k pair budget can cover it, and the "
                            "engine refuses).")
        w.add_argument("--rebuild-interval", type=int, default=None,
                       help="pair-list rebuild period K (narrowphase="
                            "pairs; default 8, the bench configuration)")
        w.add_argument("--broadphase", choices=["cells", "allpairs"],
                       default=None)
        w.add_argument("--steps-per-epoch", type=int, default=100)
        w.add_argument("--checkpoint-every", type=int, default=0,
                       help="steps between checkpoints (0 = off)")
        w.add_argument("--resume", type=str, default=None,
                       help="checkpoint .npz to resume from")
        w.add_argument("--metrics", type=str, default=None,
                       help="JSONL metrics path (default: <out>/metrics.jsonl)")
        w.add_argument("--mesh", type=int, default=1,
                       help="number of devices for the sharded engine "
                            "(1 = single device)")
        w.add_argument("--quiet", action="store_true")
        w.add_argument("--plot", action="store_true",
                       help="save the 4-panel histogram figure "
                            "(histograms.png in --out)")
        w.add_argument("--debug-audits", action="store_true",
                       help="re-check wall-case predicates each step "
                            "(reference missed-case audit)")
        w.add_argument("--check-finite", action="store_true",
                       help="count non-finite state values each step")
    return p


def make_config(args):
    from .config import CubeConfig, EngineConfig, PoreConfig

    # Workload-aware engine defaults: the pore workloads ship the
    # flagship pairs/K=8 engine (the configuration every committed
    # bench number measures); the cube stays on the per-step sweep
    # (pairs_config_for refuses its ~19-collision-range-per-step
    # drift regime outright).
    narrowphase = getattr(args, "narrowphase", None)
    if narrowphase is None:
        narrowphase = "sweep" if args.workload == "cube" else "pairs"
    rebuild_interval = getattr(args, "rebuild_interval", None)
    if rebuild_interval is None:
        rebuild_interval = 8 if narrowphase == "pairs" else 1
    eng_kwargs = dict(dtype=args.dtype, steps_per_epoch=args.steps_per_epoch,
                      debug_audits=args.debug_audits,
                      check_finite=args.check_finite,
                      narrowphase=narrowphase,
                      rebuild_interval=rebuild_interval)
    if args.workload == "cube":
        eng_kwargs.setdefault("broadphase", args.broadphase or "allpairs")
        cfg = CubeConfig(
            num_particles_override=args.particles,
            engine=EngineConfig(**eng_kwargs),
        )
    else:
        eng_kwargs.setdefault("broadphase", args.broadphase or "cells")
        cfg = PoreConfig(
            energized=(args.workload == "temperature_pore"),
            num_particles_override=args.particles,
            engine=EngineConfig(**eng_kwargs),
        )
        if args.target_particles:
            cfg = cfg.scaled_to(args.target_particles)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.steps_per_mft is not None:
        cfg = dataclasses.replace(cfg, steps_per_mft=args.steps_per_mft)
    return cfg


@dataclasses.dataclass
class RunResult:
    """What one CLI run leaves behind, for callers that drive ``run()``
    in-process (``chip_smoke.py``): the simulation object, the final
    state, the finalized measurements and the per-step ledgers."""

    cfg: object
    sim: object
    state: object
    measure: object
    momentum_z: np.ndarray
    energy_cold: np.ndarray
    energy_hot: np.ndarray
    nonfinite: np.ndarray
    num_steps: int
    elapsed_s: float


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None) -> RunResult:
    """Parse ``argv``, run the workload, write its files (see module
    docstring) and return the ``RunResult``."""
    from .utils.cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    if args.dtype == "float64":
        # Without this, jax silently truncates every array to float32
        # (the round-3 cube run did exactly that and then hit the CPU
        # f32 denormal-flush bug this session fixed).
        import jax

        jax.config.update("jax_enable_x64", True)
    from . import Simulation, make_workload
    from .io import checkpoint as ckpt_io
    from .io import metrics as metrics_io
    from .io import writers

    cfg = make_config(args)
    os.makedirs(args.out, exist_ok=True)
    logger = metrics_io.MetricsLogger(
        args.metrics or os.path.join(args.out, "metrics.jsonl"),
        resume=bool(args.resume),
    )

    if args.mesh > 1:
        from .parallel import shard as shard_mod

        sim = shard_mod.ShardedSimulation(make_workload(cfg), args.mesh)
    else:
        sim = Simulation(make_workload(cfg))
    sharded = args.mesh > 1
    num_steps = args.steps if args.steps is not None else cfg.num_timesteps

    if args.resume:
        loader = (ckpt_io.load_sharded_checkpoint if sharded
                  else ckpt_io.load_checkpoint)
        state, measure, run_key, start_step = loader(args.resume)
        if not args.quiet:
            print(f"resumed from {args.resume} at step {start_step}")
    else:
        state, measure, run_key = sim.init()
        start_step = 0

    n = cfg.num_molecules
    if not args.quiet:
        print(f"{args.workload}: N={n} steps={num_steps} dt={cfg.dt:.4e} "
              f"broadphase={cfg.engine.broadphase} dtype={cfg.engine.dtype}")

    all_momentum, all_ehot, all_ecold, all_nonfinite = [], [], [], []
    step = start_step
    next_ckpt = (
        step + args.checkpoint_every if args.checkpoint_every else None
    )
    t0 = time.time()
    while step < start_step + num_steps:
        chunk = min(cfg.engine.steps_per_epoch,
                    start_step + num_steps - step)
        if next_ckpt is not None:
            chunk = min(chunk, next_ckpt - step)
        state, measure, metrics = sim.run(
            num_steps=chunk, state=state, measure=measure, run_key=run_key,
            start_step=step,
        )
        record = logger.log_epoch(metrics, n, step)
        all_momentum.append(np.asarray(metrics.momentum_z))
        all_ehot.append(np.asarray(metrics.energy_hot))
        all_ecold.append(np.asarray(metrics.energy_cold))
        all_nonfinite.append(np.asarray(metrics.nonfinite))
        step += chunk
        if not args.quiet:
            print(f"  step {step}/{start_step + num_steps}  "
                  f"collisions={record['collisions']}  "
                  f"{record['particle_steps_per_sec']:.3e} particle-steps/s")
        if next_ckpt is not None and step >= next_ckpt:
            path = os.path.join(args.out, f"checkpoint_{step:08d}.npz")
            saver = (ckpt_io.save_sharded_checkpoint if sharded
                     else ckpt_io.save_checkpoint)
            saver(path, state, measure, run_key, step)
            if not args.quiet:
                print(f"  checkpoint -> {path}")
            next_ckpt = step + args.checkpoint_every

    elapsed = time.time() - t0
    measure = sim.finalize_measure(measure)
    # Reference-format artifacts.
    writers.write_histograms(
        measure, cfg.engine.num_bins, cfg.engine.hist_range, args.out
    )
    if args.workload == "temperature_pore":
        writers.write_momentum_energy_csv(
            np.concatenate(all_momentum),
            np.concatenate(all_ecold),
            np.concatenate(all_ehot),
            os.path.join(args.out, "momentum_energy.csv"),
        )
    if args.plot:
        from . import plotting
        from .io.writers import histogram_densities

        edges, dens = histogram_densities(
            measure, cfg.engine.num_bins, cfg.engine.hist_range
        )
        fig = plotting.histogram_figure(
            edges, dens, fit=(args.workload == "cube"),
            title=args.workload,
        )
        fig.savefig(os.path.join(args.out, "histograms.png"), dpi=110,
                    bbox_inches="tight")
    if not args.quiet:
        from .analysis import path_statistics

        stats = path_statistics(
            measure, cfg.engine.num_bins, cfg.engine.hist_range
        )
        print(f"Simulation mean free path: {stats.mean_free_path:.6e}")
        print(f"Simulation mean x free path: {stats.mean_x_free_path:.6e}")
        print(f"Simulation mean y free path: {stats.mean_y_free_path:.6e}")
        print(f"Simulation mean z free path: {stats.mean_z_free_path:.6e}")
        print(f"Num of measured full paths total: "
              f"{stats.num_completed_paths}")
        if stats.num_completed_paths:
            print(f"exp fit: a={stats.exp_fit_a:.6e} "
                  f"b={stats.exp_fit_b:.6e} (-1/b = "
                  f"{stats.fitted_mfp:.6e} m)")
        print(f"total collisions: {int(measure.collision_count)}  "
              f"errs: {int(measure.err_count)}  "
              f"overflow: {int(measure.overflow_count)}")
        print(f"runtime: {elapsed/60.0:.2f} minutes  "
              f"({num_steps * n / max(elapsed, 1e-9):.3e} "
              f"particle-steps/sec)")
    logger.close()
    def cat(chunks):
        return np.concatenate(chunks) if chunks else np.zeros(0)

    return RunResult(
        cfg=cfg, sim=sim, state=state, measure=measure,
        momentum_z=cat(all_momentum), energy_cold=cat(all_ecold),
        energy_hot=cat(all_ehot), nonfinite=cat(all_nonfinite),
        num_steps=num_steps, elapsed_s=elapsed,
    )


if __name__ == "__main__":
    sys.exit(main())
