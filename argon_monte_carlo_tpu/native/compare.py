"""The device wall and collision functions against the float64 oracle.

Each ``check_*`` draws ``n`` random rows from ``seed`` on the host, runs
the jitted JAX function on the default device in ``dtype`` and the C++
oracle (native/oracle.cpp) in float64 on the same inputs -- rounded to
``dtype`` first, so input rounding is not counted as error -- and
returns the largest row-relative error with the tolerance it is held
to.  ``tests/test_native_oracle.py`` runs them on CPU at small ``n``;
``chip_smoke.py`` runs them on the GPU at the reference's 557,649 rows.

Row-relative error: max over a row's components of |got - want| divided
by the row's scale -- its largest |want| component, or for the pair
velocities the pair's largest incoming speed component (an elementwise
or per-vector relative error is meaningless for a component or a
post-collision velocity that happens to be near zero).

float64 is held to 1e-12: the oracle and the JAX functions associate
the same formulas differently, so they agree to rounding noise.
float32 is held to 1e-3: the contact-time quadratics (pair contact,
cylinder back-trace) subtract nearly equal squares -- positions ~1e-7 m
that differ by ~3e-10 m, radii within 0.1-5% of the wall's -- which
costs up to three to four decades of float32's 6e-8 unit roundoff
(worst of 557,649 random rows on XLA:CPU: 9.6e-5 for the pairs, 1.7e-4
for the cylinder); the margin covers a backend that contracts other
multiply-adds into FMAs.  A wrong formula misses 1e-3 by orders of
magnitude.  None of
these functions is a matrix product, so TF32 or any other
reduced-precision matmul mode does not apply to them.
"""

from __future__ import annotations

import numpy as np

CR = 3.385137501286538e-10   # argon collision range (m)
MASS = 6.63e-26              # argon atom mass (kg)
TOL = {"float64": 1e-12, "float32": 1e-3}


def _row_rel_err(got, want, scale=None) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.ndim == 1:
        want, got = want[:, None], got[:, None]
    if want.size == 0:
        return 0.0
    if scale is None:
        scale = np.max(np.abs(want), axis=1)
    scale = np.asarray(scale, np.float64)[:, None]
    scale = np.where(scale == 0.0, 1.0, scale)
    return float(np.max(np.abs(got - want) / scale))


def _result(name, dtype, n, errs: dict, extra_ok: bool = True) -> dict:
    worst = max(errs.values())
    return {"name": name, "dtype": dtype, "rows": int(n),
            "max_row_rel_err": worst, "errors": errs, "tol": TOL[dtype],
            "ok": bool(extra_ok and worst <= TOL[dtype])}


def _rounded(a, dtype):
    return np.asarray(a, dtype=np.dtype(dtype)).astype(np.float64)


def check_pair_collisions(oracle, n: int, dtype: str, seed: int = 0):
    """``collide.resolve_collisions`` on n overlapping pairs."""
    import jax
    import jax.numpy as jnp

    from ..ops import collide
    from ..state import Measurements, ParticleState

    rng = np.random.default_rng(seed)
    p1 = rng.uniform(0, 1e-7, (n, 3))
    off = rng.normal(size=(n, 3))
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    p2 = p1 + off * CR * rng.uniform(0.3, 0.99, (n, 1))
    v1 = rng.normal(0, 300, (n, 3))
    v2 = rng.normal(0, 300, (n, 3))
    p1, p2, v1, v2 = (_rounded(a, dtype) for a in (p1, p2, v1, v2))
    _, p1o, v1o, p2o, v2o = oracle.pair_collisions(p1, v1, p2, v2, CR)

    dt = jnp.dtype(dtype)
    partner = np.concatenate([np.arange(n, 2 * n), np.arange(0, n)])

    @jax.jit
    def run(pos, vel, partner):
        st = ParticleState.zeros(2 * n, dt)
        st.pos, st.vel = pos, vel
        measure = Measurements.zeros(200, dt, num_particles=2 * n)
        st, _, ncol, _ = collide.resolve_collisions(
            st, measure, partner, CR, MASS, 200, 1e-6)
        return st.pos, st.vel, ncol

    pos, vel, ncol = run(jnp.asarray(np.concatenate([p1, p2]), dt),
                         jnp.asarray(np.concatenate([v1, v2]), dt),
                         jnp.asarray(partner, jnp.int32))
    pos, vel = np.asarray(pos), np.asarray(vel)
    v_scale = np.maximum(np.abs(v1).max(axis=1), np.abs(v2).max(axis=1))
    errs = {"pos1": _row_rel_err(pos[:n], p1o),
            "vel1": _row_rel_err(vel[:n], v1o, v_scale),
            "pos2": _row_rel_err(pos[n:], p2o),
            "vel2": _row_rel_err(vel[n:], v2o, v_scale)}
    return _result("pair_collisions", dtype, n, errs,
                   extra_ok=int(ncol) == n)


def check_specular_plane(oracle, n: int, dtype: str, seed: int = 1):
    """``walls.specular_plane`` on n rows that crossed z = plane."""
    import jax
    import jax.numpy as jnp

    from ..ops import walls
    from ..state import ParticleState

    rng = np.random.default_rng(seed)
    plane = 5e-8
    vel = rng.normal(0, 300, (n, 3))
    pos = rng.uniform(0, 1e-7, (n, 3))
    pos[:, 2] = plane + np.sign(vel[:, 2]) * rng.uniform(1e-12, 1e-9, n)
    pos, vel = _rounded(pos, dtype), _rounded(vel, dtype)
    _, pos_o, vel_o = oracle.specular_planes(pos, vel, 2, plane)

    dt = jnp.dtype(dtype)

    @jax.jit
    def run(pos, vel):
        st = ParticleState.zeros(n, dt)
        st.pos, st.vel = pos, vel
        ev = walls.specular_plane(st, jnp.ones((n,), jnp.bool_), 2, plane)
        return ev.state.pos, ev.state.vel

    got_p, got_v = run(jnp.asarray(pos, dt), jnp.asarray(vel, dt))
    errs = {"pos": _row_rel_err(got_p, pos_o),
            "vel": _row_rel_err(got_v, vel_o)}
    return _result("specular_plane", dtype, n, errs)


def check_specular_cylinder(oracle, n: int, dtype: str, seed: int = 2):
    """``walls.specular_cylinder`` on n rows just outside radius R moving
    outward; rows whose backward ray misses must be flagged, not moved."""
    import jax
    import jax.numpy as jnp

    from ..ops import walls
    from ..state import ParticleState

    rng = np.random.default_rng(seed)
    radius = 3e-8
    theta = rng.uniform(0, 2 * np.pi, n)
    r = radius * rng.uniform(1.001, 1.05, n)
    pos = np.stack([r * np.cos(theta), r * np.sin(theta),
                    rng.uniform(0, 1e-7, n)], axis=1)
    vel = rng.normal(0, 300, (n, 3))
    inward = vel[:, 0] * pos[:, 0] + vel[:, 1] * pos[:, 1] < 0
    vel[inward, :2] = -vel[inward, :2]
    pos, vel = _rounded(pos, dtype), _rounded(vel, dtype)
    t_o, pos_o, vel_o = oracle.specular_cylinders(pos, vel, radius)
    hit = t_o >= 0

    dt = jnp.dtype(dtype)

    @jax.jit
    def run(pos, vel):
        st = ParticleState.zeros(n, dt)
        st.pos, st.vel = pos, vel
        ev = walls.specular_cylinder(st, jnp.ones((n,), jnp.bool_), radius)
        return ev.state.pos, ev.state.vel, ev.err_mask

    got_p, got_v, err = run(jnp.asarray(pos, dt), jnp.asarray(vel, dt))
    got_p, got_v, err = np.asarray(got_p), np.asarray(got_v), np.asarray(err)
    errs = {"pos": _row_rel_err(got_p[hit], pos_o[hit]),
            "vel": _row_rel_err(got_v[hit], vel_o[hit])}
    out = _result("specular_cylinder", dtype, n, errs,
                  extra_ok=bool(hit.sum() > n // 2))
    out["hits"] = int(hit.sum())
    out["misses_flagged_as_err"] = int(err[~hit].sum())
    return out


def check_thermal_exchange(oracle, n: int, dtype: str, seed: int = 3,
                           surface_energy: float = 1.7e-21,
                           alpha: float = 0.95):
    """``walls._thermal_exchange`` (Debye accommodation) on n speeds."""
    import jax
    import jax.numpy as jnp

    from ..ops.walls import _thermal_exchange

    rng = np.random.default_rng(seed)
    vel = _rounded(rng.normal(0, 300, (n, 3)), dtype)
    want = oracle.thermal_speeds(np.linalg.norm(vel, axis=1),
                                 surface_energy, alpha, MASS)
    got, _ = jax.jit(lambda v: _thermal_exchange(
        v, surface_energy, alpha, MASS))(jnp.asarray(vel, jnp.dtype(dtype)))
    return _result("thermal_exchange", dtype, n,
                   {"speed": _row_rel_err(got, want)})


CHECKS = (check_pair_collisions, check_specular_plane,
          check_specular_cylinder, check_thermal_exchange)
