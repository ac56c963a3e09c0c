"""bench.py and chip_smoke.py on the CPU.

bench.py runs at tiny scale when the CPU is requested explicitly and
must print its one JSON contract line.  Without a GPU and without that
explicit request, both bench.py and chip_smoke.py must exit non-zero and
print no result: no code path may report a number it did not measure on
the card.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**overrides):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [REPO, env.get("PYTHONPATH", "")] if p
    )
    for k, v in overrides.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    return env


def test_bench_script_prints_contract_json():
    env = _env(JAX_PLATFORMS="cpu", BENCH_PARTICLES="20000", BENCH_SPE="8",
               BENCH_WARMUP_STEPS="8", BENCH_STEPS="16")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = proc.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    for key in ("metric", "value", "unit", "platform", "device_kind",
                "device_count", "card", "elapsed_throughput",
                "pair_checks_per_sec", "collisions", "median_epoch_sec"):
        assert key in result, key
    assert "vs_baseline" not in result
    assert result["platform"] == "cpu"
    assert result["value"] > 0
    assert result["unit"] == "particle-steps/sec/device"
    assert result["particles"] == 20000 or result["particles"] == 19999
    assert result["collisions"] > 0


def test_bench_refuses_cpu_backend_not_requested():
    """No GPU here and JAX_PLATFORMS unset: JAX falls back to the CPU,
    and bench.py must refuse to measure it."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=_env(JAX_PLATFORMS=None, BENCH_PARTICLES="2000"),
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no GPU" in proc.stderr


def test_chip_smoke_fails_without_gpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_env(JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr
