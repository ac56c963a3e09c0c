"""utils/profiling.op_breakdown reads GPU device planes only."""

import glob

import jax
import jax.numpy as jnp
import pytest

from argon_monte_carlo_tpu.utils import profiling


def test_cpu_trace_has_no_device_events(tmp_path):
    """A trace recorded on the CPU backend holds only host planes; the
    reduction must refuse it instead of returning an empty table."""
    f = jax.jit(lambda a: jnp.sin(a) * 2.0 + 1.0)
    x = jnp.ones((256, 256))
    f(x).block_until_ready()
    with profiling.trace(str(tmp_path)):
        f(x).block_until_ready()
    assert glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)
    with pytest.raises(ValueError, match="/device:GPU"):
        profiling.op_breakdown(str(tmp_path))


def test_missing_trace_is_an_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.op_breakdown(str(tmp_path))


def test_device_busy_merges_overlapping_intervals(monkeypatch):
    ev = [("/device:GPU:0", "Stream #13", "a", 0.0, 2e6),
          ("/device:GPU:0", "Stream #13", "b", 1e6, 2e6),
          ("/device:GPU:0", "Stream #14", "c", 5e6, 1e6)]
    monkeypatch.setattr(profiling, "_device_events", lambda d: ev)
    busy, window = profiling.device_busy("unused")
    assert busy == 4.0 and window == 6.0
    rows = profiling.op_breakdown("unused")
    assert rows[0][0] == 2.0
    assert sorted(r[2] for r in rows) == ["a", "b", "c"]
