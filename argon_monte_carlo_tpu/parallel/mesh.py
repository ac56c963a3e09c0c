"""Device-mesh helpers for the z-slab domain-decomposed engine."""

from __future__ import annotations

import jax

AXIS = "z"


def make_mesh(n_devices: int | None = None, devices=None) -> jax.sharding.Mesh:
    """A 1-D mesh over ``n_devices`` (default: all visible devices).

    The engine decomposes the simulation domain into z-slabs, one per
    device, with neighbour halo exchange between adjacent slabs -- the
    replacement for the reference's process pool (SURVEY.md section 2.3).
    The mesh is 1-D: the slabs form a chain, and the devices of one host
    (NVLink joins 4 H100s all to all) need no topology mapping.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh({n_devices}) but only {len(devices)} devices "
                f"are visible ({[d.platform for d in devices]}); a "
                "silently-truncated mesh would run a vacuous 1-shard "
                "simulation"
            )
        devices = devices[:n_devices]
    import numpy as np

    return jax.sharding.Mesh(np.array(devices), (AXIS,))
