"""Build + ctypes bindings for the native oracle library."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "oracle.cpp")

_cached = None


def library_path() -> str:
    """``liboracle-<sha256 of oracle.cpp, 16 hex>.so`` beside the source:
    a library built from any other source text has another name, so a
    stale or foreign binary is never loaded."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_DIR, f"liboracle-{digest}.so")


def build(force: bool = False) -> str:
    """Compile oracle.cpp to a shared library (no-op when one built from
    this exact source exists).  The compiler writes a private temporary
    name that is renamed into place, so concurrent builders never load a
    half-written file."""
    lib = library_path()
    if not force and os.path.exists(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", _SRC, "-o", tmp],
                       check=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


class Oracle:
    """Typed ctypes wrapper over the built oracle library."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        d = ctypes.c_double
        dp = ctypes.POINTER(ctypes.c_double)
        lib.oracle_pair_collision.restype = d
        lib.oracle_pair_collision.argtypes = [dp, dp, dp, dp, d]
        lib.oracle_specular_plane.restype = d
        lib.oracle_specular_plane.argtypes = [dp, dp, ctypes.c_int, d]
        lib.oracle_specular_cylinder.restype = d
        lib.oracle_specular_cylinder.argtypes = [dp, dp, d]
        lib.oracle_thermal_speed.restype = d
        lib.oracle_thermal_speed.argtypes = [d, d, d, d]
        lib.oracle_debye_integral.restype = d
        lib.oracle_debye_integral.argtypes = [d]
        lib.oracle_surface_energy.restype = d
        lib.oracle_surface_energy.argtypes = [d, d, ctypes.c_int, d]
        lib.oracle_pair_collisions.restype = None
        lib.oracle_pair_collisions.argtypes = [
            dp, dp, dp, dp, dp, ctypes.c_int64, d
        ]
        lib.oracle_specular_planes.restype = None
        lib.oracle_specular_planes.argtypes = [
            dp, dp, dp, ctypes.c_int64, ctypes.c_int, d
        ]
        lib.oracle_specular_cylinders.restype = None
        lib.oracle_specular_cylinders.argtypes = [
            dp, dp, dp, ctypes.c_int64, d
        ]
        lib.oracle_thermal_speeds.restype = None
        lib.oracle_thermal_speeds.argtypes = [
            dp, dp, ctypes.c_int64, d, d, d
        ]

    @staticmethod
    def _buf(arr):
        # Always copy: the C functions mutate in place and callers keep
        # their inputs.
        import numpy as np

        a = np.array(arr, dtype=np.float64, order="C", copy=True)
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def pair_collision(self, p1, v1, p2, v2, collision_range):
        """Returns (t, p1', v1', p2', v2')."""
        a1, b1 = self._buf(p1)
        a2, b2 = self._buf(v1)
        a3, b3 = self._buf(p2)
        a4, b4 = self._buf(v2)
        t = self._lib.oracle_pair_collision(b1, b2, b3, b4,
                                            float(collision_range))
        return t, a1, a2, a3, a4

    def pair_collisions(self, p1, v1, p2, v2, collision_range):
        """Vectorized: arrays (n, 3); returns (t (n,), p1', v1', p2', v2')."""
        import numpy as np

        a1, b1 = self._buf(p1)
        a2, b2 = self._buf(v1)
        a3, b3 = self._buf(p2)
        a4, b4 = self._buf(v2)
        n = a1.shape[0]
        t = np.zeros(n, np.float64)
        bt = t.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        self._lib.oracle_pair_collisions(b1, b2, b3, b4, bt, n,
                                         float(collision_range))
        return t, a1, a2, a3, a4

    def specular_plane(self, pos, vel, axis, plane):
        a1, b1 = self._buf(pos)
        a2, b2 = self._buf(vel)
        t = self._lib.oracle_specular_plane(b1, b2, int(axis), float(plane))
        return t, a1, a2

    def specular_cylinder(self, pos, vel, radius):
        a1, b1 = self._buf(pos)
        a2, b2 = self._buf(vel)
        t = self._lib.oracle_specular_cylinder(b1, b2, float(radius))
        return t, a1, a2

    def specular_planes(self, pos, vel, axis, plane):
        """Vectorized: pos/vel (n, 3); returns (t (n,), pos', vel')."""
        import numpy as np

        a1, b1 = self._buf(pos)
        a2, b2 = self._buf(vel)
        t = np.zeros(a1.shape[0], np.float64)
        self._lib.oracle_specular_planes(
            b1, b2, t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            a1.shape[0], int(axis), float(plane))
        return t, a1, a2

    def specular_cylinders(self, pos, vel, radius):
        """Vectorized: pos/vel (n, 3); returns (t (n,), pos', vel');
        t < 0 marks rows whose backward ray misses the circle."""
        import numpy as np

        a1, b1 = self._buf(pos)
        a2, b2 = self._buf(vel)
        t = np.zeros(a1.shape[0], np.float64)
        self._lib.oracle_specular_cylinders(
            b1, b2, t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            a1.shape[0], float(radius))
        return t, a1, a2

    def thermal_speeds(self, speed, surface_energy, alpha, mass):
        """Vectorized thermal_speed over a (n,) speed array."""
        import numpy as np

        a1, b1 = self._buf(speed)
        out = np.zeros(a1.shape[0], np.float64)
        self._lib.oracle_thermal_speeds(
            b1, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            a1.shape[0], float(surface_energy), float(alpha), float(mass))
        return out

    def thermal_speed(self, speed, surface_energy, alpha, mass):
        return self._lib.oracle_thermal_speed(
            float(speed), float(surface_energy), float(alpha), float(mass)
        )

    def debye_integral(self, upper):
        return self._lib.oracle_debye_integral(float(upper))

    def surface_energy(self, temperature, t_debye, num_atoms, boltzmann):
        return self._lib.oracle_surface_energy(
            float(temperature), float(t_debye), int(num_atoms),
            float(boltzmann),
        )


def load_oracle() -> Oracle:
    global _cached
    if _cached is None:
        _cached = Oracle(ctypes.CDLL(build()))
    return _cached
