"""Row gathers at monotone indices.

The coarse pass fetches rows at nondecreasing indices: segment endpoints
``points[i0]`` / ``points[i0 + 1]`` and the backdrop row-start base
``csum[cand_row_start - 1]``.  XLA:GPU lowers these to native gathers.
"""

from __future__ import annotations

import jax


def gather_monotone_xla(rows: jax.Array, idxs: tuple) -> tuple:
    """``rows[i]`` for every index array ``i`` in ``idxs``."""
    return tuple(rows[i] for i in idxs)
