"""Per-op device-time breakdown of the engine step at a given N.

Usage: python scripts/profile_step.py [N] [steps] [sweep|pairs] [K]

Runs the temperature pore at N molecules (default: the reference's
557,649), warms up, times one window, traces another, and prints the
per-op GPU device-time table.  It needs a GPU: the reduction reads only
GPU device planes and refuses a trace without them.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argon_monte_carlo_tpu as amc  # noqa: E402
from argon_monte_carlo_tpu.utils import profiling  # noqa: E402
from argon_monte_carlo_tpu.utils.cache import enable_compile_cache  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else None
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    narrow = sys.argv[3] if len(sys.argv) > 3 else "pairs"
    k = int(sys.argv[4]) if len(sys.argv) > 4 else 8
    enable_compile_cache()
    eng = amc.EngineConfig(dtype="float32", broadphase="cells",
                           steps_per_epoch=steps, narrowphase=narrow,
                           rebuild_interval=(k if narrow == "pairs" else 1))
    cfg = amc.temperature_pore_config(engine=eng)
    if n is not None:
        cfg = cfg.scaled_to(n)
    print(f"N={cfg.num_molecules} narrow={narrow}", file=sys.stderr)
    log_dir = os.path.join("chiprun_out", "profile_step")
    ms, rows = profiling.profile_steps(cfg, steps, log_dir)
    total = sum(r[0] for r in rows)
    print(f"untraced window: {ms:.3f} ms/step "
          f"({cfg.num_molecules * 1e3 / ms:.4g} particle-steps/s)")
    print(f"top ops (device ms over {steps} steps; total of these "
          f"{total:.3f}):")
    for dev_ms, count, name in rows:
        print(f"  {dev_ms:9.3f} ms  x{count:<5d} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
