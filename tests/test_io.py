"""Artifact format parity and checkpoint/resume exactness."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import argon_monte_carlo_tpu as amc
from argon_monte_carlo_tpu.analysis import fit_exponential
from argon_monte_carlo_tpu.io import checkpoint as ckpt_io
from argon_monte_carlo_tpu.io import writers
from argon_monte_carlo_tpu.state import Measurements

REFERENCE_RUN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "runs", "matched_golden", "reference_run")


def _measure_with_hist(num_bins=200):
    m = Measurements.zeros(num_bins, jnp.float64, num_particles=0)
    # Fill with a decaying histogram.
    counts = np.exp(-np.arange(num_bins) / 25.0) * 1000
    hist = np.zeros((4, num_bins + 1))
    hist[:, :num_bins] = counts
    m.hist = jnp.asarray(hist)
    m.path_sum = jnp.asarray([1.0, 0.5, 0.5, 0.5])
    m.path_count = jnp.asarray(1000, jnp.int32)
    return m


def test_histogram_files_match_reference_format(tmp_path):
    """Our hist files parse with the same reader that parses the
    reference's committed artifacts, and have the same shape/units."""
    m = _measure_with_hist()
    paths = writers.write_histograms(m, 200, (0.0, 1e-6), str(tmp_path))
    assert len(paths) == 8
    edges = writers.read_reference_histogram(
        str(tmp_path / "hist_x_axis_total_data.txt")
    )
    dens = writers.read_reference_histogram(
        str(tmp_path / "hist_y_axis_total_data.txt")
    )
    assert edges.shape == (200,) and dens.shape == (200,)
    assert edges[0] == 0.0 and edges[1] == pytest.approx(5e-9)
    # density normalization: sum(density)*width == 1
    assert (dens * 5e-9).sum() == pytest.approx(1.0, rel=1e-9)

    # The reference script's own committed outputs parse with the
    # same reader.
    ref_edges = writers.read_reference_histogram(
        os.path.join(REFERENCE_RUN, "hist_x_axis_total_data.txt")
    )
    assert ref_edges.shape == (200,)
    assert ref_edges[1] - ref_edges[0] == pytest.approx(5e-9)


def test_momentum_csv_matches_reference_format(tmp_path):
    from argon_monte_carlo_tpu.golden import read_ledger_csv

    path = str(tmp_path / "momentum_energy.csv")
    writers.write_momentum_energy_csv(
        np.arange(5.0) * 1e-23, np.ones(5) * -1e-18, np.ones(5) * 2e-19,
        path,
    )
    ref_path = os.path.join(REFERENCE_RUN, "momentum_energy.csv")
    with open(path) as f, open(ref_path) as g:
        ours_lines, ref_lines = f.read().splitlines(), g.read().splitlines()
    assert ours_lines[0] == ref_lines[0] == ",Momentum,EnergyCold,EnergyHot"
    assert ours_lines[1].split(",")[0] == ref_lines[1].split(",")[0] == "0"
    ours, ref = read_ledger_csv(path), read_ledger_csv(ref_path)
    assert list(ours) == list(ref) == ["Momentum", "EnergyCold", "EnergyHot"]
    np.testing.assert_array_equal(ours["Momentum"], np.arange(5.0) * 1e-23)


def test_momentum_csv_writes_exact_float_reprs(tmp_path):
    """The plain writer keeps pandas' ``to_csv`` format: the index, then
    each value as the shortest repr that round-trips its float64."""
    vals = np.array([-1.35472744900562e-23, 1.0 / 3.0, 2e-19])
    path = str(tmp_path / "m.csv")
    writers.write_momentum_energy_csv(vals, vals * 2, vals * 3, path)
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == 4
    assert lines[1] == (f"0,{vals[0]!r},{vals[0] * 2!r},{vals[0] * 3!r}"
                        .replace("np.float64(", "").replace(")", ""))
    assert "np.float64" not in "".join(lines)
    back = np.loadtxt(path, delimiter=",", skiprows=1)
    np.testing.assert_array_equal(back[:, 1], vals)
    np.testing.assert_array_equal(back[:, 0], np.arange(3))


def test_checkpoint_resume_bit_exact(tmp_path):
    """Resume from a checkpoint reproduces the uninterrupted run exactly
    (counter-based RNG keyed on the global step index)."""
    cfg = amc.CubeConfig(
        num_particles_override=500,
        engine=amc.EngineConfig(broadphase="allpairs", dtype="float64",
                                steps_per_epoch=10),
    )
    sim = amc.Simulation(amc.make_workload(cfg))

    # Uninterrupted 20 steps.
    s0, m0, k0 = sim.init()
    s_full, m_full, _ = sim.run(num_steps=20, state=s0, measure=m0,
                                run_key=k0)

    # 10 steps, checkpoint, reload, 10 more.
    s0, m0, k0 = sim.init()
    s_half, m_half, _ = sim.run(num_steps=10, state=s0, measure=m0,
                                run_key=k0)
    path = str(tmp_path / "ck.npz")
    ckpt_io.save_checkpoint(path, s_half, m_half, k0, 10)
    s_l, m_l, k_l, step = ckpt_io.load_checkpoint(path)
    assert step == 10
    s_res, m_res, _ = sim.run(num_steps=10, state=s_l, measure=m_l,
                              run_key=k_l, start_step=10)

    np.testing.assert_array_equal(np.asarray(s_full.pos),
                                  np.asarray(s_res.pos))
    np.testing.assert_array_equal(np.asarray(s_full.vel),
                                  np.asarray(s_res.vel))
    np.testing.assert_array_equal(np.asarray(m_full.hist),
                                  np.asarray(m_res.hist))
    assert int(m_full.collision_count) == int(m_res.collision_count)


def test_exponential_fit_recovers_rate():
    x = np.arange(200) * 5e-9
    lam = 8e-8
    y = 1.0 / lam * np.exp(-x / lam)
    a, b = fit_exponential(x, y)
    assert -1.0 / b == pytest.approx(lam, rel=1e-6)
    assert a == pytest.approx(1.0 / lam, rel=1e-6)


def test_replot_roundtrip(tmp_path):
    from argon_monte_carlo_tpu import plotting

    m = _measure_with_hist()
    writers.write_histograms(m, 200, (0.0, 1e-6), str(tmp_path))
    out = plotting.replot_run(str(tmp_path))
    assert os.path.exists(out) and os.path.getsize(out) > 10000
