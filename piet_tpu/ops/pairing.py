"""Entry pairing: pack two same-class records into one 16-word entry.

The fine interpreter's cost is per-ENTRY dispatch (~60 ns of scalar-unit
work regardless of class; ROADMAP dead-ends), and the two dominant entry
classes each use only half the record:

* plain Fill (no left-edge crossing): slot 1 only (tag0 == 0),
* Line (stroke segment): slot 0 only (tag1 == 0).

Two ADJACENT same-class entries of the same (tile, item) group merge
into one record -- F2 (fill#1 in slot 0, fill#2 in slot 1) or L2 (line#2
in slot 1) -- and the fine kernel applies slot 0 before slot 1
(ops/fine.py), which preserves the oracle's exact sequential
accumulation order: fill area adds stay in segment order (bit-exact; the
order-free alternative was tried and reverted, see cmd_math.py NOTE),
and line df is a bitwise-commutative min.  Measured pairable fraction:
33-43% of live entries across every BASELINE config (tiger 4K
39.7k -> 24.4k, beziers_10k 257k -> 148k).

Reference context: the reference's PTCL has no such packing -- its
per-thread interpreter reads commands at ~1 word/cycle and gains nothing
from merging (PietRender.metal:474-560); merging pays only where the
interpreter's per-entry dispatch dominates its per-entry math.

Adjacency rule: entries are stable-sorted by (tile, item, class), so
same-group records are consecutive and in segment order; runs are paired
(0,1), (2,3), ... -- the alternating rule, vectorized via run-position
parity.  Command COUNTS are unchanged (a merged entry carries 2), so all
per-tile command diagnostics and the oracle comparison are unaffected.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..layout.entry_stream import (W_META, W_S0_ARG, W_S0_TAG, W_S1_ARG,
                                   W_S1_TAG)
from ..raster.ptcl import CMD_FILL, CMD_LINE

f32 = jnp.float32


def pair_mode_from_env(default: str = "off") -> str:
    """Resolve the PIET_PAIR env knob: 0 = off, 1 = compact, hole/off/
    compact by name.  Shared by the renderer and the profiler so both
    run the same pipeline."""
    v = os.environ.get("PIET_PAIR", default)
    return {"0": "off", "1": "compact"}.get(v, v)


class PairedEntries(NamedTuple):
    rows: jax.Array         # (E, 16) f32, dead slots all-zero
    live: jax.Array         # (E,) bool
    e_tile: jax.Array       # (E,) int32, dead slots == n_tiles
    e_ncmds: jax.Array      # (E,) int32 (merged entries carry 2)
    e_is_opaque: jax.Array  # (E,) bool
    e_is_clear: jax.Array   # (E,) bool


def pair_entries(rows: jax.Array, keys: Tuple[jax.Array, ...],
                 live: jax.Array, e_tile: jax.Array, e_ncmds: jax.Array,
                 e_is_opaque: jax.Array, e_is_clear: jax.Array,
                 n_tiles, mode: str = "compact") -> PairedEntries:
    """Merge adjacent pairable entries; compact or hole-out the seconds.

    Args:
      rows: (E, 16) sorted entry rows (dead slots all-zero).
      keys: the sort keys (each (E,) f32) -- equal keys <=> same
        (tile, item, class) group.
      live/e_tile/e_ncmds/e_is_opaque/e_is_clear: per-entry metadata in
        sorted order (dead entries: live False).
      n_tiles: tile count (dead e_tile sentinel).
      mode: "compact" removes merged seconds from the stream (a scatter +
        record-sized gather); "hole" zeroes them IN PLACE: an all-zero
        entry matches no class in the fine kernel's dispatch, so a hole
        costs only the per-entry dispatch (two tag reads + compares)
        instead of full class work, and the coarse side pays two vector
        selects instead of the compaction.

    Returns PairedEntries (same capacity E; under "compact" the live
    prefix shrinks by the number of merged pairs, under "hole" it does
    not but merged seconds are no-op entries).
    """
    E = rows.shape[0]
    idx = jnp.arange(E, dtype=jnp.int32)
    tag0 = rows[:, W_S0_TAG]
    tag1 = rows[:, W_S1_TAG]
    pf = live & (tag0 == 0.0) & (tag1 == f32(CMD_FILL))
    ln = live & (tag0 == f32(CMD_LINE)) & (tag1 == 0.0)
    cls = jnp.where(pf, 1, jnp.where(ln, 2, 0))

    prev = lambda x: jnp.concatenate([x[:1], x[:-1]])
    same_key = jnp.ones((E,), bool)
    for k in keys:
        same_key &= k == prev(k)
    same_key = same_key.at[0].set(False)
    pairable = (cls > 0) & (cls == prev(cls)) & same_key

    # Run-position parity == the sequential alternating-pair rule:
    # position 1, 3, 5... of each maximal pairable chain is a "second".
    run_start = (cls > 0) & ~pairable
    start_idx = jax.lax.cummax(jnp.where(run_start, idx, -1))
    pos_in_run = idx - start_idx
    is_second = (cls > 0) & (start_idx >= 0) & (pos_in_run % 2 == 1)
    has_partner = jnp.concatenate([is_second[1:], jnp.zeros((1,), bool)])

    # Merged rows (vector splices; the partner is ALWAYS the next entry,
    # so its payload is a shift, not a gather).
    nxt = jnp.concatenate([rows[1:], jnp.zeros((1, rows.shape[1]), f32)])
    merged = rows
    mpf = (has_partner & pf)[:, None]
    mln = (has_partner & ln)[:, None]
    # F2: own fill moves slot1 -> slot0; partner fill lands in slot1
    # (all 5 fill words [sx, sy, ey, m, K]).  L2: the partner line's
    # words map [sx, sy, ex, ey, inv_denom] = slot-0 words [0,1,2,3,5]
    # onto slot-1 words 0..4 (word 4 = hw is unused by the line math;
    # the fine kernel's paired-line reader remaps 5 -> 4, ops/fine.py).
    for k in range(5):
        own_s1 = rows[:, W_S1_ARG + k]
        part_s1 = nxt[:, W_S1_ARG + k]
        part_s0 = nxt[:, W_S0_ARG + (k if k < 4 else 5)]
        col0 = jnp.where(mpf[:, 0], own_s1, rows[:, W_S0_ARG + k])
        col1 = jnp.where(mpf[:, 0], part_s1,
                         jnp.where(mln[:, 0], part_s0,
                                   rows[:, W_S1_ARG + k]))
        merged = merged.at[:, W_S0_ARG + k].set(col0)
        merged = merged.at[:, W_S1_ARG + k].set(col1)
    merged = merged.at[:, W_S0_TAG].set(
        jnp.where(mpf[:, 0], f32(CMD_FILL), rows[:, W_S0_TAG]))
    merged = merged.at[:, W_S1_TAG].set(
        jnp.where(mpf[:, 0], f32(CMD_FILL),
                  jnp.where(mln[:, 0], f32(CMD_LINE), rows[:, W_S1_TAG])))
    # Meta ncmds 1 -> 2 (other meta bits identical across the pair).
    merged = merged.at[:, W_META].set(
        rows[:, W_META] + has_partner.astype(f32))

    if mode == "hole":
        # In-place: the merged first keeps its stream position; the second
        # becomes an all-zero no-op entry.  Tile ranges stay contiguous
        # (seconds remain live and keep e_tile), command totals are
        # unchanged (first carries 2, second 0), and bail analysis is
        # unaffected: the pair is ADJACENT and never opaque (F2/L2 are
        # hit records), so moving a last-clear index from the second to
        # the first cannot cross an opaque entry.
        out_rows = jnp.where(is_second[:, None], 0.0, merged)
        mncmds = jnp.where(is_second, 0,
                           e_ncmds + has_partner.astype(jnp.int32))
        return PairedEntries(rows=out_rows, live=live, e_tile=e_tile,
                             e_ncmds=mncmds,
                             e_is_opaque=e_is_opaque & ~is_second,
                             e_is_clear=e_is_clear & ~is_second)

    # Stable compaction: drop seconds, keep order.
    keep = live & ~is_second
    total = keep.sum().astype(jnp.int32)
    new_live = idx < total
    mncmds = e_ncmds + has_partner.astype(jnp.int32)
    pos = jnp.cumsum(keep.astype(jnp.int32)) - keep.astype(jnp.int32)
    pos_idx = (jnp.zeros((E,), jnp.int32)
               .at[jnp.where(keep, pos, E)].set(idx, mode="drop"))
    out_rows = jnp.where(new_live[:, None], merged[pos_idx], 0.0)
    out_tile = jnp.where(new_live, e_tile[pos_idx], n_tiles)
    out_ncmds = jnp.where(new_live, mncmds[pos_idx], 0)
    out_opq = new_live & e_is_opaque[pos_idx]
    out_clr = new_live & e_is_clear[pos_idx]
    return PairedEntries(rows=out_rows, live=new_live, e_tile=out_tile,
                         e_ncmds=out_ncmds, e_is_opaque=out_opq,
                         e_is_clear=out_clr)
