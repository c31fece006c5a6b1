"""Ragged expansion + row gather, the coarse pass's record generator.

The coarse binning pass (ops/coarse.py) repeatedly performs *ragged
expansion*: source i (an item or a segment) owns ``counts[i]`` consecutive
output slots, and every output slot needs the source's attribute row.  It
replaces the ballot-and-walk work distribution of the reference's tiler
(PietRender.metal:191-213,254-305).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def expand_rows_xla(rows: jax.Array, counts: jax.Array, cap: int,
                    excl: jax.Array | None = None) -> jax.Array:
    """Ragged expansion + row gather: ``out[p] = rows[src(p)]`` for the
    ``total = sum(counts)`` live slots (source i owns ``counts[i]``
    consecutive slots), all-zero rows past ``total``.

    Owner lookup, formulation chosen by DIRECTION (static shapes):

    * S > cap (many sources, few outputs -- the winding-delta case):
      BINARY SEARCH on the inclusive cumsum -- output p belongs to the
      first source s with incl[s] > p (zero-count sources collapse and
      are skipped by side="right"), so the work scales with the
      outputs.
    * S <= cap (few sources, many outputs -- segment/candidate/hit
      expansions): scatter-seed + cummax over outputs; the scatter is
      only S elements, where a search would pay log2(S) gathers per
      output.

    Output-identical either way."""
    S, _ = rows.shape
    if excl is None:
        excl = jnp.cumsum(counts) - counts
    total = (excl[-1] + counts[-1]) if S else jnp.int32(0)
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < total
    if S > cap:
        incl = (excl + counts).astype(jnp.int32)
        src = jnp.searchsorted(incl, idx, side="right").astype(jnp.int32)
        src = jnp.minimum(src, S - 1)
    else:
        ids = jnp.arange(S, dtype=jnp.int32)
        starts = jnp.where(counts > 0, excl, cap)
        seed = jnp.zeros((cap,), jnp.int32).at[starts].max(ids, mode="drop")
        src = jax.lax.cummax(seed)
    zero = jax.lax.bitcast_convert_type(jnp.uint32(0), rows.dtype)
    return jnp.where(valid[:, None], rows[src], zero)
