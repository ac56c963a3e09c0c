"""The matched-golden comparison (argon_monte_carlo_tpu.golden) on the
committed outputs: this engine's matched run vs the reference script's."""

import json
import os
import shutil

import numpy as np
import pytest

from argon_monte_carlo_tpu import golden
from argon_monte_carlo_tpu.io.writers import AXIS_NAMES

RUNS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "runs", "matched_golden")
REF = os.path.join(RUNS, "reference_run")
OURS = os.path.join(RUNS, "ours")


def _our_mfp():
    with open(os.path.join(OURS, "summary.json")) as f:
        return json.load(f)["mfp_total"]


def test_committed_matched_run_passes():
    ref_mfp = golden.reference_mfp_from_log(os.path.join(REF, "run.log"))
    assert ref_mfp == pytest.approx(2.085350767509122e-08)
    rep = golden.compare_runs(REF, OURS, _our_mfp(), ref_mfp)
    assert rep["pass_hist"] and rep["pass_mfp"]
    assert min(rep["hist_correlation"].values()) >= golden.HIST_CORR_MIN
    assert abs(rep["mfp_ratio"] - 1.0) <= golden.MFP_REL_TOL
    for col in golden.LEDGER_COLUMNS:
        assert abs(rep["ledger"][col]["z"]) < 3.0


@pytest.mark.parametrize("axis", AXIS_NAMES)
def test_shifted_bin_fails_histogram_rule(tmp_path, axis):
    """Shift one axis' densities by one bin: the correlation rule must
    catch it (a one-bin shift is a 5 nm error in every free path)."""
    for name in os.listdir(OURS):
        shutil.copy(os.path.join(OURS, name), tmp_path)
    path = tmp_path / f"hist_y_axis_{axis}_data.txt"
    dens = golden.read_reference_histogram(str(path))
    shifted = np.concatenate([[0.0], dens[:-1]])
    with np.printoptions(threshold=np.iinfo(np.int64).max):
        path.write_text(str(shifted))
    rep = golden.compare_runs(REF, str(tmp_path), _our_mfp(), None)
    assert not rep["pass_hist"]
    assert rep["hist_correlation"][axis] < golden.HIST_CORR_MIN
    assert not rep["pass_mfp"]  # no reference MFP given: never passes


def test_mfp_rule_bounds():
    ref_mfp = golden.reference_mfp_from_log(os.path.join(REF, "run.log"))
    ok = golden.compare_runs(REF, OURS, ref_mfp * 1.029, ref_mfp)
    bad = golden.compare_runs(REF, OURS, ref_mfp * 1.031, ref_mfp)
    assert ok["pass_mfp"] and not bad["pass_mfp"]
