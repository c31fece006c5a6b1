"""Stable lexicographic sort -- the coarse pass's painter's-order engine."""

from __future__ import annotations

import jax


def stable_sort_multi(keys, val: jax.Array):
    """Stable lexicographic sort of (keys..., val) by ``keys``.

    Returns (sorted_keys_tuple, sorted_val).
    """
    keys = tuple(keys)
    out = jax.lax.sort(keys + (val,), dimension=0, num_keys=len(keys),
                       is_stable=True)
    return out[:-1], out[-1]
