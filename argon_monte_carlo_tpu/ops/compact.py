"""Sort-based index compaction: ``jnp.nonzero(size=)`` but cheaper here.

Every hot phase of the engine compacts a sparse boolean mask into a
fixed-width index buffer (staged histogram events, colliding pair
entries, dirty re-search queues, pair-list emission).  ``jnp.nonzero``
with a static ``size`` lowers to a full-width cumsum plus a scatter;
``compact_indices`` lowers the same exact
contract -- set indices in ascending order, padded with ``fill_value``
-- as ONE key argsort: keys put set indices (by value) ahead of unset
ones, so the sorted prefix IS the compaction.  The swap is
output-identical to ``jnp.nonzero(mask, size=size,
fill_value=fill_value)[0]`` (asserted element-wise in
tests/test_pairs.py), so every caller stays bitwise-equal.
"""

from __future__ import annotations

import jax.numpy as jnp


def compact_indices(mask: jnp.ndarray, size: int,
                    fill_value: int) -> jnp.ndarray:
    """Ascending indices of True entries, padded with ``fill_value``.

    Exactly ``jnp.nonzero(mask, size=size, fill_value=fill_value)[0]``
    for a 1-D boolean ``mask`` (truncation beyond ``size`` drops the
    highest indices, padding fills the tail), lowered as an int32 key
    sort (see module docstring for the measured motivation).
    """
    n = mask.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    # Distinct keys: set entries keep their index, unset entries shift
    # past every set one; ascending sort yields set indices (ascending)
    # first.  n is static and 2n < 2^31 at any supported N.
    keys = jnp.where(mask, idx, idx + n)
    order = jnp.argsort(keys)
    take = min(size, n)
    out = order[:take].astype(jnp.int32)
    out = jnp.where(mask[out], out, fill_value)
    if size > n:
        out = jnp.concatenate(
            [out, jnp.full((size - n,), fill_value, jnp.int32)]
        )
    return out
