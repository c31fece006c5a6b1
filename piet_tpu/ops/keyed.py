"""Keyed reduction (segment sum) of the coarse pass.

Call sites: per-candidate emitted-command counts (hit records ->
candidates) and winding-delta accumulation (delta records -> candidates).
Both sum small integers, so the f32 sums are exact and order-free while
totals stay below 2^24.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def keyed_sum_xla(values: jax.Array, keys: jax.Array,
                  n_out: int) -> jax.Array:
    """(n_out, V) sums of ``values`` rows by key; keys outside
    [0, n_out) are dropped."""
    k = jnp.where((keys >= 0) & (keys < n_out), keys, n_out)
    return jax.ops.segment_sum(values, k, num_segments=n_out + 1)[:n_out]
