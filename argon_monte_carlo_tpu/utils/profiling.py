"""Device tracing helpers (the reference's only profiling is wall-clock
prints, SURVEY.md section 5 "Tracing / profiling").

* ``trace()`` -- context manager around jax.profiler capturing a device
  trace viewable in TensorBoard/Perfetto;
* ``op_breakdown()`` -- reads the captured ``.xplane.pb`` and returns the
  per-op device-time table of the GPU device planes;
* ``profile_steps()`` -- warm a Simulation, trace a short window and
  reduce it with ``op_breakdown()`` (``scripts/profile_step.py``).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os

# Device planes in an XLA:GPU trace are named "/device:GPU:<n>"; host
# threads live in "/host:CPU".  A GPU plane has one line per CUDA stream
# ("Stream #13(Compute,MemcpyD2D,Memset)", "Stream #14(MemcpyH2D)"),
# whose events are the kernels (XLA fusion names, library kernels such as
# cub's radix sort) and copies/memsets (JAX 0.9.0 on an H100).
DEVICE_PLANE_PREFIX = "/device:GPU:"
STREAM_LINE_PREFIX = "Stream"


@contextlib.contextmanager
def trace(log_dir: str):
    import jax

    with jax.profiler.trace(log_dir):
        yield


def _device_events(log_dir: str):
    """(plane, line, event name, start ns, duration ns) of every event on
    a GPU device plane of the newest trace under ``log_dir``."""
    import jax

    files = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb trace under {log_dir}")
    data = jax.profiler.ProfileData.from_file(files[-1])
    out = []
    for plane in data.planes:
        if not plane.name.startswith(DEVICE_PLANE_PREFIX):
            continue
        for line in plane.lines:
            if not line.name.startswith(STREAM_LINE_PREFIX):
                continue
            for ev in line.events:
                out.append((plane.name, line.name, ev.name,
                            float(ev.start_ns), float(ev.duration_ns)))
    return out


def device_busy(log_dir: str):
    """(busy ms, window ms) over the GPU device events of the trace:
    busy is the union of the event intervals, the window runs from the
    first event's start to the last event's end.  1 - busy/window is the
    device's idle share inside the traced window."""
    spans = sorted((t, t + d) for _, _, _, t, d in _device_events(log_dir))
    if not spans:
        raise ValueError(f"trace under {log_dir} has no GPU device events")
    busy, cur_lo, cur_hi = 0.0, spans[0][0], spans[0][1]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return busy / 1e6, (spans[-1][1] - spans[0][0]) / 1e6


def op_breakdown(log_dir: str, top: int = 30):
    """[(device_ms, count, op_name)] summed over the GPU device planes.

    Raises ValueError when the trace holds no device events (for example
    a trace recorded on the CPU backend): an empty table would read as
    "nothing ran" instead of "nothing was measured".
    """
    events = _device_events(log_dir)
    if not events:
        raise ValueError(
            f"trace under {log_dir} has no events on a "
            f"'{DEVICE_PLANE_PREFIX}*' plane; op_breakdown reads GPU "
            "device time only")
    dur = collections.Counter()
    cnt = collections.Counter()
    for _, _, name, _, ns in events:
        dur[name] += ns
        cnt[name] += 1
    return [(d / 1e6, cnt[name], name) for name, d in dur.most_common(top)]


def profile_steps(cfg, steps: int, log_dir: str, top: int = 25):
    """Warm a Simulation of ``cfg`` for two windows of ``steps`` steps
    (the second call can still compile: its inputs are the first call's
    committed outputs), time a third window with the profiler off, then
    trace a fourth.

    Returns (host ms per step of the untraced window, op_breakdown rows).
    """
    import time

    import jax

    from .. import Simulation, make_workload

    sim = Simulation(make_workload(cfg))
    state, measure, key = sim.init()
    step = 0

    def window():
        nonlocal state, measure, step
        state, measure, _ = sim.run(num_steps=steps, state=state,
                                    measure=measure, run_key=key,
                                    start_step=step)
        jax.block_until_ready(state.pos)
        step += steps

    window()
    window()
    t0 = time.perf_counter()
    window()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / steps
    with trace(log_dir):
        window()
    return ms_per_step, op_breakdown(log_dir, top=top)
