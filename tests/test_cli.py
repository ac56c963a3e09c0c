"""End-to-end CLI smoke tests (subprocess, real artifact files)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "argon_monte_carlo_tpu.cli"] + args,
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=900,
    )


def test_temperature_pore_cli(tmp_path):
    out = tmp_path / "run"
    r = run_cli(
        ["temperature_pore", "--steps", "12", "--particles", "2000",
         "--steps-per-epoch", "6", "--out", str(out),
         "--checkpoint-every", "6"],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    files = os.listdir(out)
    for name in ("momentum_energy.csv", "metrics.jsonl",
                 "hist_x_axis_total_data.txt", "hist_y_axis_z_data.txt",
                 "checkpoint_00000006.npz"):
        assert name in files, (name, files)
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records and records[0]["steps"] == 6

    # Resume from the checkpoint for 6 more steps.
    r2 = run_cli(
        ["temperature_pore", "--steps", "6", "--particles", "2000",
         "--steps-per-epoch", "6", "--out", str(out),
         "--resume", str(out / "checkpoint_00000006.npz")],
        tmp_path,
    )
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed" in r2.stdout


def test_cube_cli_with_plot(tmp_path):
    out = tmp_path / "cube"
    r = run_cli(
        ["cube", "--steps", "10", "--particles", "1500",
         "--steps-per-epoch", "5", "--out", str(out), "--plot"],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "histograms.png").exists()
    assert "mean free path" in r.stdout


def test_default_engine_is_flagship_pairs():
    """The CLI's shipping defaults must be the flagship engine that
    bench.py measures: pairs/K=8 for the pore workloads,
    sweep for the cube (whose drift regime the pairs engine refuses)
    (README quick start == the benchmarked configuration)."""
    from argon_monte_carlo_tpu.cli import build_parser, make_config

    p = build_parser()
    for workload, narrow, k in (("temperature_pore", "pairs", 8),
                                ("pore", "pairs", 8),
                                ("cube", "sweep", 1)):
        args = p.parse_args([workload])
        cfg = make_config(args)
        assert cfg.engine.narrowphase == narrow, workload
        assert cfg.engine.rebuild_interval == k, workload

    # Explicit overrides still win.
    args = p.parse_args(["temperature_pore", "--narrowphase", "sweep"])
    cfg = make_config(args)
    assert cfg.engine.narrowphase == "sweep"
    assert cfg.engine.rebuild_interval == 1
