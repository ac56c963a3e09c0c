"""On-card smoke test: the temperature-pore main path on one NVIDIA GPU.

    python chip_smoke.py                 # all one-card phases
    python chip_smoke.py --devices 4     # only the sharded path on 4 cards
    python chip_smoke.py --compile-10m   # also compile (not run) the 10M
                                         # step and rebuild programs

One process drives the card(s): a JAX process reserves most of a card's
memory when it starts, so no phase starts another JAX process.  Every
phase prints what it measured on earlier lines; the LAST line of
standard output is exactly

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and is printed only when every phase passed.  The script exits non-zero
without that line when JAX finds no GPU (there is no CPU fallback), when
the package cannot be imported, or when any phase fails.  Outputs go to
``chiprun_out/chip_smoke/`` in the checkout.

Phases (one card):
  device    platform must be "gpu"; card name and power limit, JAX version
            and the compile-cache directory.
  main      ``argon_monte_carlo_tpu.cli`` in-process: temperature_pore,
            400 steps at the reference's 557,649 molecules with the CLI
            defaults (float32, pairs narrow phase, K=8); checks the 8
            histogram files, the 400-row ledger CSV, the counters.
  profile   the per-op GPU device-time table of that configuration
            (``utils/profiling.profile_steps``, as scripts/profile_step.py).
  golden    the matched-golden configuration (scale 0.35, 23,909
            molecules, 2,500 steps, float32) against the reference
            script's committed outputs in runs/matched_golden/reference_run.
  bitwise   fixed-seed determinism, pairs == sweep, and checkpoint resume,
            each compared bit for bit.
  search    cell-list candidate search == plain all-pairs search on
            131,072 positions at reference density (float64).
  oracle    pair impulse exchange, specular plane/cylinder and thermal
            exchange on 557,649 rows vs the float64 C++ oracle, in float64
            and float32 (tolerances in native/compare.py).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
REFERENCE_N = 557_649
MAIN_STEPS = 400

# Bounds on the main run's counters, per particle-step (22 at 557,649 x
# 400 steps).  err_count counts wall back-traces whose geometry was
# degenerate (reference ``total_errs``): the particle is left untouched
# and recaptured, so a few per run are expected -- the reference's own
# 2,500-step matched run logged 1, and the full 20,000-step pore runs
# logged ~1e-8 per particle-step.  overflow_count counts particles that
# lost collision visibility for one step (one-shot research-budget drops
# at rebuild boundaries, healed at the next rebuild; never a lost
# particle): the full-scale runs logged 1-2e-8 per particle-step.  Ten
# times that is a capacity formula gone wrong.
MAX_ERR_PER_PARTICLE_STEP = 1e-7
MAX_OVERFLOW_PER_PARTICLE_STEP = 1e-7
# BASELINE.json's single-card scale, compiled by --compile-10m.
LARGE_N = 10_000_000


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card(s), one line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def peak_bytes(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_main(ctx: dict) -> None:
    import jax
    import numpy as np

    from argon_monte_carlo_tpu import cli
    from argon_monte_carlo_tpu.io.writers import AXIS_NAMES
    from argon_monte_carlo_tpu.golden import read_histograms, read_ledger_csv

    out = os.path.join(OUT, "main")
    argv = ["temperature_pore", "--steps", str(MAIN_STEPS),
            "--check-finite", "--out", out]
    log(f"main: cli {' '.join(argv)}")
    res = cli.run(argv)
    n = res.cfg.num_molecules
    m = res.measure
    check(n == REFERENCE_N, f"molecule count {n} != {REFERENCE_N}")
    eng = res.cfg.engine
    check((eng.dtype, eng.narrowphase, eng.rebuild_interval)
          == ("float32", "pairs", 8),
          f"CLI defaults changed: {eng.dtype} {eng.narrowphase} "
          f"K={eng.rebuild_interval}")

    hists = read_histograms(out)
    for ax in AXIS_NAMES:
        edges, dens = hists[ax]
        check(edges.shape == (eng.num_bins,) and dens.shape == edges.shape,
              f"histogram {ax} shape {edges.shape} {dens.shape}")
        check(bool(np.isfinite(dens).all()) and dens.sum() > 0,
              f"histogram {ax} not finite/empty")
    ledger = read_ledger_csv(os.path.join(out, "momentum_energy.csv"))
    for col in ("Momentum", "EnergyCold", "EnergyHot"):
        check(ledger[col].shape == (MAIN_STEPS,),
              f"momentum_energy.csv {col} has {ledger[col].shape} rows")
        check(bool(np.isfinite(ledger[col]).all()), f"{col} not finite")

    collisions = int(m.collision_count)
    nonfinite = int(res.nonfinite.sum())
    err, overflow = int(m.err_count), int(m.overflow_count)
    err_bound = int(MAX_ERR_PER_PARTICLE_STEP * n * MAIN_STEPS)
    overflow_bound = int(MAX_OVERFLOW_PER_PARTICLE_STEP * n * MAIN_STEPS)
    pos = np.asarray(res.state.pos)
    log(f"main: N={n} steps={MAIN_STEPS} collisions={collisions} "
        f"paths={int(m.path_count)} err_count={err} (bound {err_bound}) "
        f"overflow_count={overflow} (bound {overflow_bound}) "
        f"hist_drop_count={int(m.hist_drop_count)} "
        f"hot_spill_count={int(m.hot_spill_count)} nonfinite={nonfinite}")
    check(collisions > 0, "no collisions")
    check(nonfinite == 0, f"{nonfinite} non-finite state values")
    check(int(m.hist_drop_count) == 0, "histogram events dropped")
    check(pos.shape == (n, 3) and bool(np.isfinite(pos).all()),
          "particle count not conserved / positions not finite")
    check(err <= err_bound, f"err_count {err} > {err_bound}")
    check(overflow <= overflow_bound, f"overflow_count {overflow}")

    # Informative timings from the CLI's own per-epoch records.
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epochs = np.diff([r["elapsed_s"] for r in recs], prepend=0.0)
    steps = np.asarray([r["steps"] for r in recs])
    steady = sorted((epochs / steps)[1:]) if len(recs) > 1 else [np.nan]
    per_step = steady[len(steady) // 2]
    first = epochs[0] - per_step * steps[0]
    log(f"main timing ({ctx['card']}): first epoch incl. compile "
        f"{epochs[0]:.3f}s (compile ~{first:.3f}s), median steady epoch "
        f"{per_step * eng.steps_per_epoch:.4f}s per {eng.steps_per_epoch} "
        f"steps, {n / per_step:.4g} particle-steps/s, "
        f"peak_bytes_in_use={peak_bytes(jax.devices()[0])} "
        "[informative; not a benchmark]")


def phase_profile(ctx: dict) -> None:
    import argon_monte_carlo_tpu as amc
    from argon_monte_carlo_tpu.utils import profiling

    steps = 16
    eng = amc.EngineConfig(dtype="float32", broadphase="cells",
                           steps_per_epoch=steps, narrowphase="pairs",
                           rebuild_interval=8)
    cfg = amc.temperature_pore_config(engine=eng)
    ms, rows = profiling.profile_steps(cfg, steps,
                                       os.path.join(OUT, "profile"))
    check(len(rows) > 0, "empty op table")
    total = sum(r[0] for r in rows)
    busy, window = profiling.device_busy(os.path.join(OUT, "profile"))
    log(f"profile ({ctx['card']}): N={cfg.num_molecules} untraced "
        f"{ms:.3f} ms/step; traced window: device busy {busy:.3f} ms of "
        f"{window:.3f} ms (idle share {1 - busy / window:.3f}); top "
        f"{len(rows)} ops, device ms over {steps} steps (sum "
        f"{total:.3f}):")
    for dev_ms, count, name in rows:
        log(f"profile:   {dev_ms:9.3f} ms  x{count:<5d} {name[:100]}")


def phase_golden(ctx: dict) -> None:
    from argon_monte_carlo_tpu import golden

    ref_dir = os.path.join(REPO, "runs", "matched_golden", "reference_run")
    out = os.path.join(OUT, "golden")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    summary = golden.run_matched_config(out, scale=0.35, steps=2500,
                                        dtype="float32")
    wall = time.perf_counter() - t0
    ref_mfp = golden.reference_mfp_from_log(os.path.join(ref_dir, "run.log"))
    rep = golden.compare_runs(ref_dir, out, summary["mfp_total"], ref_mfp)
    z = {k: round(v["z"], 3) for k, v in rep["ledger"].items()}
    log(f"golden: N={summary['n']} steps=2500 float32 engine vs NumPy "
        f"float64 reference; different RNG streams, so agreement is "
        f"statistical, not bitwise")
    log(f"golden: hist corr {json.dumps(rep['hist_correlation'])} "
        f"(>= {golden.HIST_CORR_MIN}); mfp ours {summary['mfp_total']:.6e} "
        f"ref {ref_mfp:.6e} ratio {rep['mfp_ratio']:.5f} (within "
        f"{golden.MFP_REL_TOL:.0%}); ledger z {z}; collisions "
        f"{summary['collisions']} err {summary['err']} overflow "
        f"{summary['overflow']} nonfinite {summary['nonfinite']}; "
        f"{wall:.1f}s incl. compile")
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump({"ours": summary, **rep}, f, indent=2)
    check(rep["pass_hist"], "histogram correlation below limit")
    check(rep["pass_mfp"], "mean free path outside limit")
    check(summary["nonfinite"] == 0 and summary["overflow"] == 0,
          "golden run counters")


def _small_sim(narrowphase="pairs", n=20_000, spe=48, dtype="float32"):
    import argon_monte_carlo_tpu as amc

    eng = amc.EngineConfig(
        dtype=dtype, broadphase="cells", steps_per_epoch=spe,
        narrowphase=narrowphase,
        rebuild_interval=8 if narrowphase == "pairs" else 1)
    cfg = amc.temperature_pore_config(num_particles_override=n, engine=eng)
    return amc.Simulation(amc.make_workload(cfg))


def _bit_diff(a, b) -> list[str]:
    """Names of the fields that differ bit for bit between two
    (state, measure) pairs."""
    import numpy as np

    (sa, ma), (sb, mb) = a, b
    fields = {"pos": (sa.pos, sb.pos), "vel": (sa.vel, sb.vel),
              "paths": (sa.paths, sb.paths), "hist": (ma.hist, mb.hist),
              "path_sum": (ma.path_sum, mb.path_sum),
              "collision_count": (ma.collision_count, mb.collision_count)}
    return [k for k, (x, y) in fields.items()
            if not np.array_equal(np.asarray(x), np.asarray(y))]


def phase_bitwise(ctx: dict) -> None:
    from argon_monte_carlo_tpu.io import checkpoint as ckpt_io

    steps = 48
    results = {}
    # 1. Same seed, two runs, two Simulation objects.
    runs = []
    for _ in range(2):
        st, m, _ = _small_sim().run(num_steps=steps)
        runs.append((st, m))
    results["same_seed"] = _bit_diff(*runs)
    # 2. pairs narrow phase == per-step sweep.
    st_s, m_s, _ = _small_sim("sweep", spe=8).run(num_steps=steps)
    results["pairs_vs_sweep"] = _bit_diff(runs[0], (st_s, m_s))
    # 3. Checkpoint resume at step 24 == the uninterrupted run.
    sim = _small_sim(spe=24)
    s0, m0, k0 = sim.init()
    s_half, m_half, _ = sim.run(num_steps=24, state=s0, measure=m0,
                                run_key=k0)
    path = os.path.join(OUT, "resume.npz")
    ckpt_io.save_checkpoint(path, s_half, m_half, k0, 24)
    s_l, m_l, k_l, step = ckpt_io.load_checkpoint(path)
    s_res, m_res, _ = sim.run(num_steps=24, state=s_l, measure=m_l,
                              run_key=k_l, start_step=step)
    results["resume"] = _bit_diff(runs[0], (s_res, m_res))
    collisions = int(runs[0][1].collision_count)
    for name, diff in results.items():
        log(f"bitwise: {name}: "
            + ("identical" if not diff else f"DIFFER in {diff}")
            + f" (N=20000, {steps} steps, float32, {collisions} collisions)")
    check(collisions > 0, "no collisions in the bitwise runs")
    check(not any(results.values()), f"bitwise claims failed: {results}")


def phase_search(ctx: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import argon_monte_carlo_tpu as amc
    from argon_monte_carlo_tpu.engine import build_grids
    from argon_monte_carlo_tpu.ops import collide

    jax.config.update("jax_enable_x64", True)
    n = 131_072
    eng = amc.EngineConfig(dtype="float64", broadphase="cells")
    cfg = amc.temperature_pore_config(engine=eng).scaled_to(n)
    wl = amc.make_workload(cfg)
    _, dgrid = build_grids(wl)
    pos = wl.init_fn(jax.random.PRNGKey(42)).pos
    cr = cfg.physics.collision_range
    for radius in (cr, 10.0 * cr):
        cands, overflow, _ = jax.jit(lambda p: collide.cell_candidate_search(
            p, dgrid, radius, top_k=1))(pos)
        exact, _ = jax.jit(lambda p: collide.allpairs_partner_search(
            p, radius, tile=512))(pos)
        cands, exact = np.asarray(cands[:, 0]), np.asarray(exact)
        matched = int((exact >= 0).sum())
        mismatch = int((cands != exact).sum())
        log(f"search: N={cfg.num_molecules} radius={radius:.3e} m "
            f"(float64): {matched} particles with a partner, "
            f"{mismatch} mismatches, cell overflow {int(overflow)}")
        check(int(overflow) == 0, "cell table overflowed")
        check(matched > 0, "no partners found")
        check(mismatch == 0, "cell search != all-pairs")


def phase_oracle(ctx: dict) -> None:
    import jax

    from argon_monte_carlo_tpu.native import compare, load_oracle

    jax.config.update("jax_enable_x64", True)
    oracle = load_oracle()
    bad = []
    for dtype in ("float64", "float32"):
        for fn in compare.CHECKS:
            r = fn(oracle, REFERENCE_N, dtype)
            extra = ""
            if "hits" in r:
                extra = (f" hits={r['hits']} misses flagged="
                         f"{r['misses_flagged_as_err']}")
            log(f"oracle: {r['name']:<18} {dtype} rows={r['rows']} "
                f"max row-rel err {r['max_row_rel_err']:.3e} "
                f"(tol {r['tol']:.0e}) {'ok' if r['ok'] else 'FAIL'}"
                + extra)
            if not r["ok"]:
                bad.append((r["name"], dtype))
    check(not bad, f"oracle mismatches: {bad}")


def phase_compile_10m(ctx: dict) -> None:
    """Compile, without running, the 10M-particle rebuild and K-step
    block programs that the pairs engine dispatches above its fused-epoch
    threshold; print their memory analysis and compile times."""
    import jax
    import jax.numpy as jnp

    import argon_monte_carlo_tpu as amc

    eng = amc.EngineConfig(dtype="float32", broadphase="cells",
                           steps_per_epoch=48, narrowphase="pairs",
                           rebuild_interval=8)
    cfg = amc.temperature_pore_config(engine=eng).scaled_to(LARGE_N)
    t0 = time.perf_counter()
    sim = amc.Simulation(amc.make_workload(cfg))
    log(f"compile-10m: N={cfg.num_molecules} host grid "
        f"{time.perf_counter() - t0:.1f}s")
    state, measure, key = jax.eval_shape(sim.init)
    aux = jax.eval_shape(sim._init_aux, state)
    k = eng.rebuild_interval
    idx = jax.ShapeDtypeStruct((k,), jnp.int32)
    flags = jax.ShapeDtypeStruct((k,), jnp.bool_)
    programs = {
        "rebuild": (sim._rebuild_jit, (state, aux, sim._dgrid)),
        f"block_{k}_steps": (sim._run_epoch_grid,
                             (state, measure, key, idx, flags, sim._dgrid,
                              aux)),
    }
    for name, (fn, args) in programs.items():
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        dt = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        log(f"compile-10m ({ctx['card']}): {name}: compiled in {dt:.1f}s; "
            f"memory_analysis: {mem}")


def phase_devices4(ctx: dict) -> None:
    """The sharded path on 4 cards and what it is compared with."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import argon_monte_carlo_tpu as amc
    from argon_monte_carlo_tpu import cli
    from argon_monte_carlo_tpu.config import EngineConfig
    from argon_monte_carlo_tpu.parallel.mesh import make_mesh
    from argon_monte_carlo_tpu.parallel.shard import ShardedSimulation

    devs = jax.devices()
    check(len(devs) >= 4, f"--devices 4 needs 4 GPUs, found {len(devs)}")
    steps = MAIN_STEPS
    out = os.path.join(OUT, "mesh4")
    res4 = cli.run(["temperature_pore", "--steps", str(steps), "--mesh", "4",
                    "--check-finite", "--quiet", "--out", out])
    st, valid, gid = res4.state
    n = res4.cfg.num_molecules
    tot = res4.measure
    alive = int(jnp.sum(valid))
    gids = np.sort(np.asarray(gid)[np.asarray(valid)])
    placement = {}
    for name, arr in (("pos", st.pos), ("vel", st.vel), ("valid", valid),
                      ("gid", gid)):
        shards = arr.addressable_shards
        check(not arr.sharding.is_fully_replicated
              and len({str(s.index) for s in shards}) == len(shards),
              f"{name} is replicated, not split across the mesh")
        placement[name] = sorted(s.device.id for s in shards)
    peaks = {d.id: peak_bytes(d) for d in devs[:4]}
    log(f"mesh4: N={n} steps={steps} alive={alive} "
        f"collisions={int(tot.collision_count)} "
        f"overflow_count={int(tot.overflow_count)} "
        f"halo_trunc_count={int(tot.halo_trunc_count)} "
        f"err_count={int(tot.err_count)} "
        f"nonfinite={int(res4.nonfinite.sum())} "
        f"{res4.elapsed_s:.2f}s incl. compile")
    log(f"mesh4: shard devices {placement}; peak_bytes_in_use per device "
        f"{peaks} ({ctx['card']})")
    # Migration drops lose particles, so alive == N with every global id
    # present proves there were none; halo truncation is counted apart.
    check(alive == n, f"alive {alive} != N {n}")
    check(np.array_equal(gids, np.arange(n)), "global ids not {0..N-1}")
    check(int(tot.halo_trunc_count) == 0, "halo truncation")
    check(int(tot.overflow_count)
          <= MAX_OVERFLOW_PER_PARTICLE_STEP * n * steps,
          "overflow_count above the main run's bound")
    check(int(res4.nonfinite.sum()) == 0, "non-finite values")
    for name, ids in placement.items():
        check(ids == [d.id for d in devs[:4]],
              f"{name} shards on devices {ids}")

    res1 = cli.run(["temperature_pore", "--steps", str(steps),
                    "--check-finite", "--quiet",
                    "--out", os.path.join(OUT, "mesh1")])
    c1, c4 = int(res1.measure.collision_count), int(tot.collision_count)
    e1, e4 = float(res1.energy_cold.sum()), float(res4.energy_cold.sum())
    log(f"mesh4 vs 1 card: collisions {c4} vs {c1} "
        f"(|diff| {abs(c1 - c4)}, bound {5 * np.sqrt(max(c1, c4)):.0f}); "
        f"energy_cold sum {e4:.4e} vs {e1:.4e}")
    check(abs(c1 - c4) <= 5 * max(np.sqrt(max(c1, c4)), 3.0),
          "collision totals disagree")
    check(np.sign(e1) == np.sign(e4) and 0.3 < abs(e1) / abs(e4) < 3.0,
          "energy ledgers disagree")

    # Sharded pairs == sharded sweep, bit for bit (specular pore, small N).
    jax.config.update("jax_enable_x64", True)
    nn, ss = 3000, 12
    runs = {}
    for narrow, k, spe in (("sweep", 1, 5), ("pairs", 4, 4)):
        eng = EngineConfig(dtype="float64", broadphase="cells",
                           steps_per_epoch=spe, narrowphase=narrow,
                           rebuild_interval=k)
        cfg = amc.PoreConfig(num_particles_override=nn, engine=eng)
        sim = ShardedSimulation(amc.make_workload(cfg), mesh=make_mesh(4))
        (s, v, g), m, _ = sim.run(num_steps=ss)
        v = np.asarray(v)
        order = np.argsort(np.asarray(g)[v])
        runs[narrow] = (np.asarray(s.pos)[v][order],
                        np.asarray(s.vel)[v][order],
                        int(sim.finalize_measure(m).collision_count))
    same = (np.array_equal(runs["sweep"][0], runs["pairs"][0])
            and np.array_equal(runs["sweep"][1], runs["pairs"][1])
            and runs["sweep"][2] == runs["pairs"][2])
    log(f"mesh4: sharded pairs vs sharded sweep (N={nn}, {ss} steps, "
        f"float64): {'identical' if same else 'DIFFER'}; collisions "
        f"{runs['pairs'][2]} vs {runs['sweep'][2]}")
    check(same, "sharded pairs != sharded sweep")


ONE_CARD_PHASES = (phase_main, phase_profile, phase_golden, phase_bitwise,
                   phase_search, phase_oracle)


def run_phases(phases, ctx) -> list[str]:
    failed = []
    for phase in phases:
        name = phase.__name__.removeprefix("phase_")
        t0 = time.perf_counter()
        log(f"== {name}")
        try:
            phase(ctx)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(name)
        log(f"== {name}: {'FAILED' if name in failed else 'passed'} in "
            f"{time.perf_counter() - t0:.1f}s")
    return failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded path on 4 cards and "
                         "what it is compared with")
    ap.add_argument("--compile-10m", action="store_true",
                    help="after the one-card phases, compile the 10M "
                         "step and rebuild programs without running them")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {platform!r}); "
              "this test runs only on the card", file=sys.stderr)
        return 2
    from argon_monte_carlo_tpu.utils.cache import enable_compile_cache

    ctx = {"card": card_line()}
    log(f"device: {ctx['card']}")
    log(f"device: jax {jax.__version__}; {len(devices)} x "
        f"{devices[0].device_kind}; compile cache {enable_compile_cache()}")
    os.makedirs(OUT, exist_ok=True)

    if args.devices == 4:
        phases = (phase_devices4,)
    else:
        phases = ONE_CARD_PHASES
        if args.compile_10m:
            phases = phases + (phase_compile_10m,)
    failed = run_phases(phases, ctx)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    log(f"card: {ctx['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
