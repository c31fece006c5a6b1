"""XLA coarse rasterizer: sort-based device binning (Scene -> PTCL arrays).

The replacement for the reference's ``tileKernel``
(PietRender.metal:160-454).  The reference's core parallel pattern is a SIMT
cooperative ballot: threads vote on surviving segments in a threadgroup
bitmap, then serially walk set bits (PietRender.metal:191-213,254-305).
Here the same O(hits) goal is reached with dense vectorized math +
expansion + one sort, all plain XLA (SURVEY.md section 7, translation
decision 4):

  1. segment derivation  -- every item's segments as flat arrays (gathers)
  2. rect expansion      -- per segment, the conservative rectangle of tiles
                            it may emit commands into; expanded to (segment,
                            tile) *hit records* via cumsum + scatter/cummax
  3. exact per-record tests -- the reference's per-tile f32 sign tests,
                            evaluated identically (see raster/cpu_tiler.py),
                            emitting <= 2 command slots per record
  4. winding deltas      -- each (fill segment, tile row)'s crossing
                            column is emitted BY that row's first hit
                            record (round-5 fold -- the hit pipeline
                            already visits every (segment, row), so no
                            second expansion); keyed +-1 sums + a
                            per-row prefix give each (item, tile)
                            candidate its integer backdrop (replaces
                            the per-tile left-ray accumulation,
                            PietRender.metal:331-333)
  5. candidates          -- per (item, tile-in-bbox) records that emit the
                            trailing CmdDrawFill/CmdSolid/CmdStroke/CmdCircle
  6. one stable sort     -- key (tile, item, class, segment) restores
                            painter's order per tile
  7. bail analysis       -- per-tile last-opaque-solid / last-clearing-draw
                            positions reproduce the TileEncoder cursor-reset
                            optimization (PietRender.metal:127-151) without
                            rewriting a stream (one fused segment_max)
  8. output              -- production: the ENTRY STREAM (CoarseEntries):
                            the sorted records themselves plus per-tile
                            index ranges, no scatter and no per-tile
                            capacity at all; portable/test path: dense
                            (T, CAP) arrays with counts/solid/overflow
                            (overflow *detected*, unlike the reference's
                            silent 4096-byte cap)

Exactness: every geometric test is evaluated in f32 with the same expressions
as the CPU golden tiler, and expansion rectangles are exact supersets
(tile sizes are powers of two, so the / and * by tile dims are exact), so the
resulting PTCL is command-for-command identical to the oracle -- tested in
tests/test_coarse.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..layout.entry_stream import (ENTRY_WORDS, META_CLEAR_BIT,
                                   META_NCMDS_MASK, META_OPAQUE_BIT,
                                   W_BAIL, W_META)
from ..raster.ptcl import (ARG_WORDS, CMD_CIRCLE, CMD_DRAW_FILL, CMD_FILL,
                           CMD_FILL_EDGE, CMD_LINE, CMD_SOLID, CMD_STROKE)
from .cmd_math import div_det, dot2_det
from ..raster.ptcl import (CMD_BEGIN_CLIP, CMD_BEGIN_LAYER, CMD_END_CLIP,
                           CMD_END_LAYER)
from ..raster.ptcl import (CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD, CMD_WIND)
from ..scene.scene import (FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL,
                           FLAG_FILL_CONT, FLAG_FILL_FINAL,
                           FLAG_IN_GROUP, FLAG_POP_LAYER, TAG_CIRCLE,
                           TAG_CLIP, TAG_FILL, TAG_LAYER, TAG_LINE, TAG_POLY,
                           TAG_POP)
from .expand import expand_rows_xla
from .keyed import keyed_sum_xla
from .pairing import pair_entries
from .sort import stable_sort_multi

def _db(*xs):
    """Barrier the expansion/gather outputs: XLA then cannot fuse the
    downstream record math into the gathers.  Measured on an H100 (400 W
    limit) it is as fast or faster than without, and without it XLA:GPU
    contracts mul+add across the gather boundary, changing the 4K tiger's
    entry stream."""
    out = jax.lax.optimization_barrier(xs)
    return out if len(xs) > 1 else out[0]


class DeviceScene(NamedTuple):
    """Padded device-resident scene arrays (see renderer/renderer.py for
    host-side preparation; colors are pre-decoded on host so the CPU oracle
    and the device agree bit-for-bit on operand values)."""
    tags: jax.Array        # (NI,) int32, 0 = padding
    colors_u32: jax.Array  # (NI,) uint32 logical 0xRRGGBBAA
    colors_lin: jax.Array  # (NI, 4) f32 linear r,g,b + alpha
    widths: jax.Array      # (NI,) f32
    bboxes: jax.Array      # (NI, 4) int32 quantized
    pt_offset: jax.Array   # (NI,) int32
    n_pts: jax.Array       # (NI,) int32
    points: jax.Array      # (NP, 2) f32
    flags: jax.Array       # (NI,) uint32; bit 0 = even-odd fill rule
    clips: jax.Array       # (NI, 4) f32 clip rect (piet clip extension)
    grads: jax.Array       # (NI, 8) f32 gradient-brush payload (extension)
    n_items: jax.Array     # () int32
    #: Optional host-precomputed segment stage (renderer/segstage.py;
    #: bitwise-identical to the device derivation).  None on paths whose
    #: geometry is computed inside the jit (device animation, shards) --
    #: the coarse pass then derives segments on device as before.
    seg_pre: object = None


class CoarseEntries(NamedTuple):
    """Entry-stream PTCL: the sorted (tile, item)-grouped records themselves,
    with per-tile index ranges -- no per-tile capacity, no scatter.

    ``stream`` holds one ENTRY_WORDS-word row per entry (64 contiguous
    bytes), words per the single-source map in layout/entry_stream.py
    (slot0 = FillEdge|Line|tail command, slot1 = Fill; tag 0 = empty slot).
    """
    stream: jax.Array       # (E, ENTRY_WORDS) f32
    first: jax.Array        # (T,) int32 first live entry (post bail-reset)
    n_entries: jax.Array    # (T,) int32 live entries
    counts: jax.Array       # (T,) int32 live commands (diagnostics)
    solid: jax.Array        # (T,) uint32 bail color, 0 = none
    diag: dict


class CoarseOutput(NamedTuple):
    tags: jax.Array      # (T, CAP) int32
    args: jax.Array      # (T, CAP * ARG_WORDS) f32
    counts: jax.Array    # (T,) int32
    solid: jax.Array     # (T,) uint32 bail color, 0 = none
    overflow: jax.Array  # (T,) int32 dropped commands
    diag: dict           # capacity diagnostics (record totals vs caps)


def _exclusive_cumsum(x):
    c = jnp.cumsum(x)
    return c - x, c  # (exclusive, inclusive)


def _fdivmod(local: jax.Array, w: jax.Array):
    """Exact floor-div/mod of small nonneg ints via f32 division.

    The raw quotient would be exact under correctly-rounded division
    (local < 2^23), but a backend may divide through a reciprocal
    approximation that is 1 ulp off -- fatal at exact multiples, where
    floor() turns 1 ulp into an off-by-one.  The residue fixup below makes
    the pair exact for ANY division error < 1 quotient step: correct q is
    the unique integer with 0 <= local - q*w < w.  ``w`` must be >= 1."""
    wf = w.astype(jnp.float32)
    q = jnp.floor(local.astype(jnp.float32) / wf).astype(jnp.int32)
    r = local - q * w
    q = q + jnp.where(r >= w, 1, 0) - jnp.where(r < 0, 1, 0)
    return q, local - q * w


def _sign(x):
    return jnp.sign(x)


def _bar(x):
    """FMA-contraction barrier.

    The CPU golden tiler (numpy) rounds every multiply and add separately;
    XLA backends may contract mul+add chains into FMAs, perturbing the sign
    tests and edge intercepts by 1 ulp -- enough to flip a command at an
    exact tile boundary.  Materializing each product through an
    optimization_barrier forces separate rounding, making the device PTCL
    bit-identical to the oracle (verified in tests/test_coarse.py).
    """
    return jax.lax.optimization_barrier(x)


def _item_tile_rect(bboxes, tw: int, th: int, tiles_x: int, tiles_y: int,
                    active, row0):
    """Quantized item bbox -> inclusive tile rect, exactly the reference hit
    test (PietRender.metal:214) solved for tx/ty; empty if offscreen.

    ``row0``/``tiles_y`` window the rect to tile rows [row0, row0+tiles_y)
    -- the row-sharding hook (parallel/sharding.py): each shard computes
    exactly the commands of its slab, in absolute pixel coordinates, so
    sharded and unsharded PTCLs are identical."""
    x0 = jnp.maximum(bboxes[:, 0] // tw, 0)
    y0 = jnp.maximum(bboxes[:, 1] // th, row0)
    x1 = jnp.minimum(bboxes[:, 2] // tw, tiles_x - 1)
    y1 = jnp.minimum(bboxes[:, 3] // th, row0 + tiles_y - 1)
    w = jnp.where(active, jnp.maximum(x1 - x0 + 1, 0), 0)
    h = jnp.where(active, jnp.maximum(y1 - y0 + 1, 0), 0)
    return x0, y0, x1, y1, w, h


def coarse_rasterize(scene: DeviceScene, *, tiles_x: int, tiles_y: int,
                     tile_w: int, tile_h: int, cmd_capacity: int,
                     max_segments: int, max_hits: int, max_candidates: int,
                     max_deltas: int = 0, row0=0,
                     output: str = "dense", pair="compact",
                     with_probes: bool = False) -> CoarseOutput:
    """row0: first tile row of this shard's slab (traced OK); tiles_y is
    the number of LOCAL rows.  Defaults cover the whole viewport.

    pair: entry pairing (ops/pairing.py): False/"off" disables,
    True/"compact" merges and compacts the stream, "hole" merges and
    leaves zeroed no-op seconds in place (no compaction cost; the holes
    cost only the fine kernel's dispatch floor).

    with_probes=True adds ``diag["probes"]``: an ordered dict of cheap
    scalars, one per pipeline stage, each forcing exactly that stage's
    dependency closure.  The profiler (piet_tpu/profiling.py) jits
    cumulative prefixes of them to time each stage on hardware; production
    callers leave it False (the probe sums are then never built)."""
    NI = scene.tags.shape[0]
    row0 = jnp.int32(row0)
    n_tiles = tiles_x * tiles_y
    twf = jnp.float32(tile_w)
    thf = jnp.float32(tile_h)
    f32 = jnp.float32

    probes = {}

    def stage_probe(name, *vals):
        if with_probes:
            probes[name] = sum(jnp.sum(v, dtype=jnp.float32) for v in vals)

    item_ids = jnp.arange(NI, dtype=jnp.int32)
    active = (item_ids < scene.n_items) & (scene.tags > 0)
    tags = jnp.where(active, scene.tags, 0)

    def i2f(x):
        return jax.lax.bitcast_convert_type(x.astype(jnp.int32), f32)

    exp_rows = expand_rows_xla

    # ---- item bbox tile rects + candidate expansion -------------------
    bx0, by0, bx1, by1, bw, bh = _item_tile_rect(
        scene.bboxes, tile_w, tile_h, tiles_x, tiles_y, active, row0)
    cand_counts = bw * bh
    cand_excl, cand_incl = _exclusive_cumsum(cand_counts)
    n_cand = cand_incl[-1]
    item_pack = jnp.stack(
        [tags, scene.n_pts, scene.pt_offset, cand_excl,
         bx0, by0, bx1, by1, bw], axis=1)               # (NI, 9) int32

    # All per-candidate attributes ride ONE expansion (colors for the
    # tail commands, clip rect, flags, the packed item ints, the item
    # id): no per-attribute gathers at candidate indices.
    cand_pack = jnp.concatenate(
        [scene.colors_lin, scene.bboxes.astype(f32),
         (f32(0.5) * scene.widths)[:, None],
         jax.lax.bitcast_convert_type(scene.colors_u32, f32)[:, None],
         scene.flags.astype(f32)[:, None],               # item flag bits
         scene.clips,                                    # clip rect
         jax.lax.bitcast_convert_type(item_pack, f32),
         i2f(item_ids)[:, None],
         scene.grads[:, :7]],                            # gradient payload
        axis=1)                                          # (NI, 32)
    stride = 2 * (NI + 1)
    packed_ok = n_tiles * stride < 2**24
    ca = _db(exp_rows(cand_pack, cand_counts, max_candidates, cand_excl))
    cf = ca[:, :15]
    ci = jax.lax.bitcast_convert_type(ca[:, 15:24], jnp.int32)
    cg = ca[:, 25:32]      # gradient payload (params3 + c1 linear rgba)
    cand_idx = jnp.arange(max_candidates, dtype=jnp.int32)
    cand_valid = cand_idx < n_cand
    cand_item = jax.lax.bitcast_convert_type(ca[:, 24], jnp.int32)
    cand_local = cand_idx - ci[:, 3]
    cand_w = jnp.maximum(ci[:, 8], 1)
    c_dy, c_dx = _fdivmod(cand_local, cand_w)
    cand_ty = ci[:, 5] + c_dy
    cand_tx = ci[:, 4] + c_dx
    cand_tile = (cand_ty - row0) * tiles_x + cand_tx
    stage_probe("cand_expand", cand_tile)

    sp = getattr(scene, "seg_pre", None)
    if sp is None:
        # ---- segment derivation ------------------------------------------
        # Fill items: n wrap-around segments; poly: n-1; line: 1; circle: 0.
        # All per-item attributes a segment needs ride one expansion row
        # instead of one 1-D gather per attribute.
        is_fill_item = (tags == TAG_FILL) | (tags == TAG_CLIP)
        seg_counts = jnp.where(
            is_fill_item, scene.n_pts,
            jnp.where(tags == TAG_POLY, jnp.maximum(scene.n_pts - 1, 0),
                      jnp.where(tags == TAG_LINE, 1, 0)))
        seg_excl, seg_incl = _exclusive_cumsum(seg_counts)
        n_segs = seg_incl[-1]
        np_max = scene.points.shape[0] - 1
        # The item's FIRST point rides the expansion row (words 12-13): it is
        # the fill wrap-around endpoint (i1 = pt_offset at the last segment,
        # src/lib.rs:195-207 wrap semantics), letting the engine path below
        # fetch p1 from the monotone stream i0+1 alone.  NI-sized gather:
        # ~30x smaller than the per-segment gathers it replaces.
        first_pt = scene.points[jnp.clip(scene.pt_offset, 0, np_max)]
        item_rows = jnp.concatenate(
            [jax.lax.bitcast_convert_type(item_pack, f32),
             scene.widths[:, None], i2f(seg_excl)[:, None],
             i2f(item_ids)[:, None], first_pt], axis=1)      # (NI, 14)
        sitem_f = _db(exp_rows(item_rows, seg_counts, max_segments, seg_excl))
        stage_probe("seg_expand", sitem_f)
        sitem = jax.lax.bitcast_convert_type(sitem_f[:, :9], jnp.int32)
        seg_idx = jnp.arange(max_segments, dtype=jnp.int32)
        seg_valid = seg_idx < n_segs
        seg_local = seg_idx - jax.lax.bitcast_convert_type(
            sitem_f[:, 10], jnp.int32)
        seg_item = jax.lax.bitcast_convert_type(sitem_f[:, 11], jnp.int32)
        s_tag = sitem[:, 0]
        s_npts = sitem[:, 1]
        s_ptoff = sitem[:, 2]
        s_cand_excl = sitem[:, 3]
        s_bx0, s_by0, s_bx1, s_by1, s_bw = (sitem[:, 4], sitem[:, 5],
                                            sitem[:, 6], sitem[:, 7],
                                            sitem[:, 8])
        i0 = s_ptoff + seg_local
        s_is_fill_tag = (s_tag == TAG_FILL) | (s_tag == TAG_CLIP)
        wrap = s_is_fill_tag & (seg_local + 1 == s_npts)
        # ONE row gather delivers both endpoints: pair_rows[k] =
        # (pt_k, pt_{k+1}), p1 from the +1 column, the fill wrap-around
        # from the carried per-item first point (bit-identical to
        # points[where(wrap, ptoff, i0+1)] -- the carried word IS
        # points[ptoff]): one gather of 4-word rows instead of two of
        # 2-word rows.
        nxt = jnp.concatenate([scene.points[1:], scene.points[-1:]],
                              axis=0)
        pair_rows = jnp.concatenate([scene.points, nxt], axis=1)
        pr = pair_rows[jnp.clip(i0, 0, np_max)]
        p0e = pr[:, 0:2]
        p1e = jnp.where(wrap[:, None], sitem_f[:, 12:14], pr[:, 2:4])
        # Dead slots zero on BOTH paths so every downstream word (and the
        # profiler's stage probes) is impl-independent.
        p0, p1 = _db(jnp.where(seg_valid[:, None], p0e, 0.0),
                     jnp.where(seg_valid[:, None], p1e, 0.0))
        stage_probe("seg_points", p0, p1)
        sx, sy = p0[:, 0], p0[:, 1]
        ex, ey = p1[:, 0], p1[:, 1]
        a = ey - sy
        b = sx - ex
        c = -(_bar(a * sx) + _bar(b * sy))
        xmn = jnp.minimum(p0, p1)
        xmx = jnp.maximum(p0, p1)
        s_hw = f32(0.5) * sitem_f[:, 9] + f32(0.5)
        is_fill_seg = seg_valid & s_is_fill_tag
        is_stroke_seg = seg_valid & ((s_tag == TAG_POLY) | (s_tag == TAG_LINE))
        stage_probe("seg_derive", a, b, c)

        # ---- per-segment emission rects ----------------------------------
        # Fill: exact solve of the reference's x/y-extent conditions (tile dims
        # are powers of two so // and f32 / are exact).  Stroke: inflated rect
        # with +-1 slop (the inflation adds round in f32; the exact per-record
        # cull re-filters).  Line items: the item bbox rect (the reference
        # applies no segment-level cull for single lines, :223-247).
        def _range_x_fill():
            lo = jnp.floor(xmn[:, 0] / twf).astype(jnp.int32)
            hi = jnp.ceil(xmx[:, 0] / twf).astype(jnp.int32) - 1
            return lo, hi

        def _range_y_fill():
            lo = jnp.floor(xmn[:, 1] / thf).astype(jnp.int32)
            hi = jnp.floor(xmx[:, 1] / thf).astype(jnp.int32)
            return lo, hi

        fx_lo, fx_hi = _range_x_fill()
        fy_lo, fy_hi = _range_y_fill()
        # Stroke rects: the f32 divisions can be off by an ulp at exact tile
        # boundaries, so the floor/ceil bound alone could miss an edge tile.
        # Instead of a blanket +-1 ring (which inflates stroke hits ~2-4x for
        # short segments), probe the one boundary tile with the SAME f32 cull
        # expressions the per-record test uses -- the result is exactly the
        # set of tiles the cull can pass, still a guaranteed superset.
        def _stroke_range(lo_v, hi_v, dim, step):
            lo = jnp.floor(lo_v / step).astype(jnp.int32)
            hi = jnp.ceil(hi_v / step).astype(jnp.int32) - 1

            def passes(t):
                o = t.astype(f32) * step
                return ((xmx[:, dim] > o - s_hw)
                        & (xmn[:, dim] < o + step + s_hw))

            lo = jnp.where(passes(lo - 1), lo - 1, lo)
            hi = jnp.where(passes(hi + 1), hi + 1, hi)
            return lo, hi

        st_x_lo, st_x_hi = _stroke_range(xmn[:, 0] - s_hw, xmx[:, 0] + s_hw,
                                         0, twf)
        st_y_lo, st_y_hi = _stroke_range(xmn[:, 1] - s_hw, xmx[:, 1] + s_hw,
                                         1, thf)

        is_line_item = s_tag == TAG_LINE
        r_x_lo = jnp.where(is_fill_seg, fx_lo,
                           jnp.where(is_line_item, s_bx0, st_x_lo))
        r_x_hi = jnp.where(is_fill_seg, fx_hi,
                           jnp.where(is_line_item, s_bx1, st_x_hi))
        r_y_lo = jnp.where(is_fill_seg, fy_lo,
                           jnp.where(is_line_item, s_by0, st_y_lo))
        r_y_hi = jnp.where(is_fill_seg, fy_hi,
                           jnp.where(is_line_item, s_by1, st_y_hi))
        # Clip to the item's bbox rect (the reference's per-tile `hit` gate).
        r_x_lo = jnp.maximum(r_x_lo, s_bx0)
        r_x_hi = jnp.minimum(r_x_hi, s_bx1)
        r_y_lo = jnp.maximum(r_y_lo, s_by0)
        r_y_hi = jnp.minimum(r_y_hi, s_by1)
        r_w = jnp.maximum(r_x_hi - r_x_lo + 1, 0)
        r_h = jnp.maximum(r_y_hi - r_y_lo + 1, 0)
        # Round 5 (delta fold): winding deltas are emitted BY the hit
        # records (one per (fill segment, tile row), from the dx == 0
        # record) instead of a second full expansion of ``seg_all`` -- the
        # round-4 profile's largest coarse stage (del_expand, 1.6 ms at 4K).
        # Delta rows are always a subset of the fill rect's rows
        # (ceil(ymin/th) >= floor(ymin/th); identical bbox/viewport clamps),
        # but the COLUMN range can be empty while deltas exist -- a segment
        # left of the viewport still swings the winding of tiles to its
        # right, and a vertical segment on an exact tile boundary has
        # ceil(xmax/tw) - 1 < floor(xmin/tw).  Guarantee one column for
        # such segments: the forced records pass none of the exact coverage
        # tests (PTCL unchanged -- the cull re-filters) and exist only to
        # carry the per-row crossing emission.  Mirrored in
        # renderer/capacity.py::count_records.
        widen = (is_fill_seg & (a != 0.0) & (r_w == 0) & (r_h > 0)
                 & (s_bx0 <= s_bx1))
        wcol = jnp.clip(fx_lo, s_bx0, s_bx1)
        r_x_lo = jnp.where(widen, wcol, r_x_lo)
        r_x_hi = jnp.where(widen, wcol, r_x_hi)
        r_w = jnp.where(widen, 1, r_w)
        # (Valid slots always map to owners with count > 0 by construction,
        # so seg_valid alone gates.)
        hit_counts = jnp.where(seg_valid, r_w * r_h, 0)
        stage_probe("seg_rects", hit_counts)

        hit_excl, hit_incl = _exclusive_cumsum(hit_counts)
        n_hits = hit_incl[-1]
        stage_probe("hit_expand", hit_excl)
        # Per-segment attributes packed into one (S, 26) row matrix;
        # hit records then ride ONE expansion (ops/expand.py) instead of
        # a scatter/cummax plus ~15 1-D gathers (the dominant cost of
        # this pass before packing -- measured, see ROADMAP).
        seg_flags = (is_fill_seg.astype(jnp.int32)
                     | (is_stroke_seg.astype(jnp.int32) << 1)
                     | (is_line_item.astype(jnp.int32) << 2))
        seg_i32 = jnp.stack(
            [seg_flags, r_x_lo, r_y_lo, jnp.maximum(r_w, 1), seg_item,
             s_cand_excl, s_by0, jnp.maximum(s_bw, 1), s_bx0, s_by1,
             s_bx1],
            axis=1)                                      # (S, 11)
        # Per-SEGMENT constants of the division-free fine math (round 5;
        # cmd_math.py module doc), computed ONCE here -- both hit-record
        # paths (staged XLA and the fused kernel) gather the SAME words,
        # and the numpy oracle derives them identically
        # (cpu_tiler.py::_segments), so the wire stays bitwise
        # impl-independent.  dot2_det keeps the norm contraction-immune;
        # degenerate fills carry zeroed m/K (the masked/guard paths read
        # neither); zero-length strokes carry inv_denom = +inf (the dot
        # semantic, line_field_sq).
        lvx = ex - sx
        lvy = ey - sy
        s_invd = div_det(f32(1.0), dot2_det(lvx, lvy, _bar), _bar)
        s_m = div_det(lvx, lvy, _bar)
        s_K = div_det(-lvy, jnp.abs(lvx), _bar)
        s_m = jnp.where(jnp.abs(s_m) < jnp.inf, s_m, 0.0)
        s_K = jnp.where(jnp.abs(s_K) < jnp.inf, s_K, 0.0)
        seg_all = jnp.concatenate(
            [jnp.stack([sx, sy, ex, ey, a, b, c, xmn[:, 0], xmn[:, 1],
                        xmx[:, 0], xmx[:, 1], s_hw], axis=1),
             jax.lax.bitcast_convert_type(seg_i32, f32),
             jnp.stack([s_invd, s_m, s_K], axis=1)],
            axis=1)                                      # (S, 26)
        seg_rows = jnp.concatenate(
            [seg_all, i2f(hit_excl)[:, None]], axis=1)   # (S, 27)
    else:
        # ---- segment stage PRECOMPUTED on host (renderer/segstage.py)
        # -- bitwise-identical to the derivation above; the arrays were
        # built once at scene staging, so a static scene's frame skips
        # the endpoint gathers, line equations, rect solves and the
        # division-constant selection entirely.
        # uint32 -> f32 bitcast: the table ships as bit patterns (a
        # denormal flush on the way would zero integer payloads uploaded
        # as f32 -- see SegPre docstring).
        seg_rows = jax.lax.bitcast_convert_type(sp.seg_rows, f32)
        seg_all = seg_rows[:, :26]
        hit_counts = sp.hit_counts
        hit_excl = sp.hit_excl
        n_segs = sp.n_segs[0]
        n_hits = sp.n_hits[0]
        seg_idx = jnp.arange(max_segments, dtype=jnp.int32)
        seg_valid = seg_idx < n_segs
        # Columns the later diag/delta code reads (same word map).
        a = seg_all[:, 4]
        xmn = seg_all[:, 7:9]
        xmx = seg_all[:, 9:11]
        is_fill_seg = ((jax.lax.bitcast_convert_type(seg_all[:, 12],
                                                     jnp.int32) & 1)
                       != 0) & seg_valid
        stage_probe("seg_expand", seg_all)
        stage_probe("hit_expand", hit_excl)

    hit_idx = jnp.arange(max_hits, dtype=jnp.int32)
    hit_valid = hit_idx < n_hits
    ha = _db(exp_rows(seg_rows, hit_counts, max_hits, hit_excl))
    hf = ha[:, :12]
    hi = jax.lax.bitcast_convert_type(ha[:, 12:23], jnp.int32)
    h_invd, h_m, h_K = ha[:, 23], ha[:, 24], ha[:, 25]
    hit_local = hit_idx - jax.lax.bitcast_convert_type(ha[:, 26], jnp.int32)
    h_flags = hi[:, 0]
    h_w = jnp.maximum(hi[:, 3], 1)
    h_dy, h_dx = _fdivmod(hit_local, h_w)
    h_ty = hi[:, 2] + h_dy
    h_tx = hi[:, 1] + h_dx
    h_item = hi[:, 4]
    h_tile = (h_ty - row0) * tiles_x + h_tx
    h_cand = hi[:, 5] + (h_ty - hi[:, 6]) * hi[:, 7] + (h_tx - hi[:, 8])
    stage_probe("hit_gather", h_tile, h_cand)

    # ---- exact per-record tests (f32, identical to cpu_tiler.py) ------
    x0f = h_tx.astype(f32) * twf
    y0f = h_ty.astype(f32) * thf
    h_sx, h_sy, h_ex, h_ey = hf[:, 0], hf[:, 1], hf[:, 2], hf[:, 3]
    h_a, h_b, h_c = hf[:, 4], hf[:, 5], hf[:, 6]
    h_xmn = hf[:, 7:9]
    h_xmx = hf[:, 9:11]
    h_is_fill = ((h_flags & 1) != 0) & hit_valid
    h_is_stroke = ((h_flags & 2) != 0) & hit_valid

    # Fill tests (PietRender.metal:307-354).
    ycull = (h_xmx[:, 1] >= y0f) & (h_xmn[:, 1] < y0f + thf)
    left = _bar(h_a * x0f)
    right = _bar(h_a * (x0f + twf))
    ytop = jnp.maximum(y0f, h_xmn[:, 1])
    ybot = jnp.minimum(y0f + thf, h_xmx[:, 1])
    top = _bar(h_b * ytop)
    bot = _bar(h_b * ybot)
    s00 = _sign(top + left + h_c)
    s01 = _sign(top + right + h_c)
    s10 = _sign(bot + left + h_c)
    s11 = _sign(bot + right + h_c)
    four = s00 * s01 + s00 * s10 + s00 * s11 < f32(3.0)
    crosses_left = (h_xmn[:, 0] < x0f) & (h_xmx[:, 0] > x0f)
    # div_det: the FillEdge intercept is a PTCL operand, so the
    # division must match the numpy oracle bitwise (cpu_tiler.py uses
    # div_det_np); raw device division is <= 2 ulp off IEEE.
    t_edge = div_det(h_sx - x0f, h_b, _bar)
    y_edge = h_sy + _bar((h_ey - h_sy) * t_edge)
    edge_in = crosses_left & (y_edge >= y0f) & (y_edge < y0f + thf)
    plain = ((crosses_left & ~edge_in & four)
             | (~crosses_left & four & (h_xmn[:, 0] < x0f + twf)
                & (h_xmx[:, 0] > x0f)))

    fill_emit_edge = h_is_fill & ycull & edge_in
    fill_emit_plain = h_is_fill & ycull & plain

    # Clipped fill coords for the left-edge crossing (:339-344).
    # (The clipped end-x is NOT shipped: the fill math needs only
    # [sx, sy, ey] plus the per-segment m/K constants.)
    clip_sx = jnp.where(h_b > 0, h_sx, x0f)
    clip_sy = jnp.where(h_b > 0, h_sy, y_edge)
    clip_ey = jnp.where(h_b > 0, y_edge, h_ey)

    # Stroke tests (:411-435 for polys; :223-247 for lines -- the line case
    # has no segment bbox cull, matching the reference).
    h_hw = hf[:, 11]
    st_bcull = ((h_xmx[:, 1] > y0f - h_hw) & (h_xmn[:, 1] < y0f + thf + h_hw)
                & (h_xmx[:, 0] > x0f - h_hw) & (h_xmn[:, 0] < x0f + twf + h_hw))
    st_bcull = jnp.where((h_flags & 4) != 0, True, st_bcull)
    sleft = _bar(h_a * (x0f - h_hw))
    sright = _bar(h_a * (x0f + twf + h_hw))
    stop = _bar(h_b * (y0f - h_hw))
    sbot = _bar(h_b * (y0f + thf + h_hw))
    z00 = _sign(stop + sleft + h_c)
    z01 = _sign(stop + sright + h_c)
    z10 = _sign(sbot + sleft + h_c)
    z11 = _sign(sbot + sright + h_c)
    st_four = z00 * z01 + z00 * z10 + z00 * z11 < f32(3.0)
    stroke_emit = h_is_stroke & st_bcull & st_four

    # Per-record command slots: slot0 = FillEdge | Line, slot1 = Fill.
    slot0_valid = fill_emit_edge | stroke_emit
    slot0_tag = jnp.where(stroke_emit, CMD_LINE, CMD_FILL_EDGE)
    slot0_args = jnp.zeros((max_hits, ARG_WORDS), f32)
    slot0_args = slot0_args.at[:, 0].set(
        jnp.where(stroke_emit, h_sx, s00))
    slot0_args = slot0_args.at[:, 1].set(
        jnp.where(stroke_emit, h_sy, y_edge))
    slot0_args = slot0_args.at[:, 2].set(jnp.where(stroke_emit, h_ex, 0))
    slot0_args = slot0_args.at[:, 3].set(jnp.where(stroke_emit, h_ey, 0))
    # Word 4 (unused by the line math): the emitting stroke's hw + 0.5,
    # the fine kernel's row-cull threshold (ops/fine.py footprint
    # restriction; the oracle encoder mirrors it, raster/ptcl.py::line).
    slot0_args = slot0_args.at[:, 4].set(jnp.where(stroke_emit, h_hw, 0))
    # Word 5: the per-segment inverse squared length (division-free
    # fine math, cmd_math.py::line_field_sq) -- gathered with the
    # record, computed once at the segment stage above.
    slot0_args = slot0_args.at[:, 5].set(
        jnp.where(stroke_emit, h_invd, 0))

    slot1_valid = fill_emit_edge | fill_emit_plain
    slot1_tag = jnp.full((max_hits,), CMD_FILL, jnp.int32)
    f1_sx = jnp.where(fill_emit_edge, clip_sx, h_sx)
    f1_sy = jnp.where(fill_emit_edge, clip_sy, h_sy)
    f1_ey = jnp.where(fill_emit_edge, clip_ey, h_ey)
    # Fill operands [sx, sy, ey, m, K] (division-free trapezoid math,
    # cmd_math.py::fill_delta): the per-SEGMENT slope/Jacobian words,
    # shared by plain and edge-clipped fills (a clipped sub-segment
    # lies on the same line -- one definition, mirrored by the
    # oracle's per-segment constants).
    slot1_args = jnp.zeros((max_hits, ARG_WORDS), f32)
    slot1_args = slot1_args.at[:, 0].set(f1_sx)
    slot1_args = slot1_args.at[:, 1].set(f1_sy)
    slot1_args = slot1_args.at[:, 2].set(f1_ey)
    slot1_args = slot1_args.at[:, 3].set(h_m)
    slot1_args = slot1_args.at[:, 4].set(h_K)

    # Zero the args of non-emitting slots: the hit math produces NaN/Inf
    # there (0/0 from all-zero dead expansion rows; x/0 y_edge on live
    # degenerate segments) and those words are never interpreted, but they
    # flow into the entry stream and the stage probes -- zeroing makes
    # both deterministic and finite.
    slot0_args = jnp.where(slot0_valid[:, None], slot0_args, 0.0)
    slot1_args = jnp.where(slot1_valid[:, None], slot1_args, 0.0)

    hit_n_cmds = slot0_valid.astype(jnp.int32) + slot1_valid.astype(jnp.int32)
    stage_probe("hit_tests", hit_n_cmds, slot0_args, slot1_args)

    # Per-candidate emitted-command count (drives anyFill/anyStroke);
    # dead hits carry no commands.
    cand_emit = keyed_sum_xla(hit_n_cmds.astype(f32)[:, None], h_cand,
                              max_candidates)[:, 0].astype(jnp.int32)

    # ---- winding deltas (backdrop), FOLDED into the hit records -------
    # One crossing record per (fill segment, tile row), emitted from that
    # row's dx == 0 hit record -- the hit pipeline already decodes every
    # (segment, row), so no second expansion of ``seg_all`` is needed;
    # only the keyed +-1 sums and the prefix machinery remain.  The rect widening at
    # ``seg_rects`` guarantees a dx == 0 record exists for every delta
    # row.  (The reference derives backdrop in the same per-tile walk
    # as the coverage commands, PietRender.metal:257-364.)
    stage_probe("cand_emit", cand_emit)
    # Count-only diagnostic (rows whose top edge y0 lies in [ymin, ymax];
    # exact for power-of-two tile heights).
    d_y_lo = jnp.maximum(jnp.ceil(xmn[:, 1] / thf).astype(jnp.int32), row0)
    d_y_hi = jnp.minimum(jnp.floor(xmx[:, 1] / thf).astype(jnp.int32),
                         row0 + tiles_y - 1)
    n_deltas = jnp.sum(jnp.where(is_fill_seg & (a != 0),
                                 jnp.maximum(d_y_hi - d_y_lo + 1, 0), 0))
    # The record is a delta emitter iff it is the row's first column
    # and the row's top edge lies inside the segment's y-span
    # (y0 >= ymin <=> ty >= ceil(ymin/th), exactly, for power-of-two
    # tile heights -- the round-4 delta stage's row condition).
    del_ok = (h_is_fill & (h_a != 0.0) & (h_dx == 0)
              & (h_xmn[:, 1] <= y0f) & (h_xmx[:, 1] >= y0f)
              & (hi[:, 8] <= hi[:, 10]))
    # Crossing column: first tx with sign(a*x0 + b*y0 + c) ==
    # sign(a).  The f32-evaluated expression is monotone in x0, so
    # probe +-2 tiles around the analytic crossing to match the
    # per-tile sign test bit-for-bit (expressions verbatim from the
    # round-4 delta stage).
    x_cross = -(_bar(h_b * y0f) + h_c) / h_a
    tx_guess = jnp.floor(x_cross / twf).astype(jnp.int32) + 1
    sign_a = _sign(h_a)

    def dprobe(dtx):
        x0p = (tx_guess + dtx).astype(f32) * twf
        return _sign(_bar(h_a * x0p) + _bar(h_b * y0f) + h_c) == sign_a

    tx_c = jnp.where(dprobe(-1), tx_guess - 1,
                     jnp.where(dprobe(0), tx_guess,
                               jnp.where(dprobe(1), tx_guess + 1,
                                         tx_guess + 2)))
    # Clamp the crossing column into the item's bbox rect row; drop
    # crossings right of it.  d_value is the reference's
    # `backdrop -= s00` with s00 == sign(a).
    tx_eff = jnp.maximum(tx_c, hi[:, 8])
    d_ok = del_ok & (tx_eff <= hi[:, 10])
    d_cand = hi[:, 5] + (h_ty - hi[:, 6]) * hi[:, 7] + (tx_eff - hi[:, 8])
    delta_scatter = keyed_sum_xla(
        jnp.where(d_ok, -sign_a, 0.0)[:, None],
        jnp.where(d_ok, d_cand, max_candidates), max_candidates)[:, 0]
    stage_probe("del_scatter", delta_scatter)
    # Per-(item, row) prefix sum along tx: candidates are row-major per item,
    # so subtract the running total at each row start.  (cf/ci rows were
    # expanded up front with the candidate records.)
    csum = jnp.cumsum(delta_scatter)
    cand_row_start = (ci[:, 3]
                      + (cand_ty - ci[:, 5]) * jnp.maximum(ci[:, 8], 1))
    # cand_row_start is nondecreasing (candidates expand item- and
    # row-major; dead slots continue as cand_idx), so the row-start base
    # fetch rides the monotone-gather engine on the Pallas path.
    start_base = jnp.where(cand_row_start > 0,
                           csum[cand_row_start - 1], 0.0)
    # csum at the candidate's own slot IS csum[cand_idx] == csum
    # elementwise: candidates expand row-major, so row_start + dx =
    # cand_excl + dy*w + dx = cand_idx (holds for dead slots too, where
    # the zeroed row gives row_start = dy = cand_idx).  No gather.
    backdrop = csum - start_base
    stage_probe("deltas", backdrop)

    # ---- candidate tail commands --------------------------------------
    c_tag_item = ci[:, 0]
    c_color_lin = cf[:, 0:4]
    c_color_u32 = jax.lax.bitcast_convert_type(cf[:, 9], jnp.uint32)
    c_any = cand_emit > 0
    c_backdrop_nz = backdrop != 0.0

    cflags = cf[:, 10].astype(jnp.int32)
    c_even_odd = (cflags & 1).astype(f32)
    c_ingroup = (cflags & FLAG_IN_GROUP) != 0
    # Gradient brush bits (extension): the fill's RESOLVE becomes a
    # gradient draw; interior (winding-only) tiles get the same draw --
    # a gradient can never bail to a per-tile solid color.
    c_grad_lin = (cflags & FLAG_BRUSH_LINEAR) != 0
    c_grad_rad = (cflags & FLAG_BRUSH_RADIAL) != 0
    c_is_grad_item = c_grad_lin | c_grad_rad
    # Multi-subpath fill bits (hole extension): a CONT subpath carries
    # its interior winding in a CMD_WIND (never resolves, never solids);
    # the FINAL subpath resolves UNCONDITIONALLY over the union bbox (a
    # sibling may have contributed where it has no presence of its own)
    # and never uses the solid fast path.
    c_cont = (cflags & FLAG_FILL_CONT) != 0
    c_final = (cflags & FLAG_FILL_FINAL) != 0

    is_circle = cand_valid & (c_tag_item == TAG_CIRCLE)
    is_fill_cand = cand_valid & (c_tag_item == TAG_FILL)
    is_wind = is_fill_cand & c_cont & c_backdrop_nz
    is_grad = (is_fill_cand & c_is_grad_item & ~c_cont
               & (c_any | c_backdrop_nz | c_final))
    is_drawfill = (is_fill_cand & ~c_is_grad_item & ~c_cont
                   & (c_any | c_final))
    is_solid = (is_fill_cand & ~c_is_grad_item & ~c_cont & ~c_final
                & ~c_any & c_backdrop_nz)
    is_stroke = cand_valid & ((c_tag_item == TAG_POLY)
                              | (c_tag_item == TAG_LINE)) & c_any
    # Clip / layer group commands (extension): emitted in EVERY candidate
    # tile -- outside the clip path the coverage must still become 0, and
    # push/pop nesting must be consistent across all tiles.
    is_clip = cand_valid & (c_tag_item == TAG_CLIP)
    is_layer = cand_valid & (c_tag_item == TAG_LAYER)
    is_pop = cand_valid & (c_tag_item == TAG_POP)
    pop_layer = is_pop & ((cflags & FLAG_POP_LAYER) != 0)
    is_group_cmd = is_clip | is_layer | is_pop

    cand_cmd_valid = (is_circle | is_drawfill | is_solid | is_stroke
                      | is_grad | is_wind | is_group_cmd)
    cand_tag = jnp.where(
        is_circle, CMD_CIRCLE,
        jnp.where(is_drawfill, CMD_DRAW_FILL,
                  jnp.where(is_solid, CMD_SOLID,
                            jnp.where(is_wind, CMD_WIND,
                                      jnp.where(is_grad & c_grad_rad, CMD_DRAW_RAD_GRAD,
                                                jnp.where(is_grad, CMD_DRAW_LIN_GRAD,
                                                          jnp.where(is_clip, CMD_BEGIN_CLIP,
                                                                    jnp.where(is_layer, CMD_BEGIN_LAYER,
                                                                              jnp.where(pop_layer,
                                                                                        CMD_END_LAYER,
                                                                                        jnp.where(is_pop,
                                                                                                  CMD_END_CLIP,
                                                                                                  CMD_STROKE))))))))))
    cbb = cf[:, 4:8]
    chw = cf[:, 8]
    cand_args = jnp.zeros((max_candidates, ARG_WORDS), f32)
    a0 = jnp.where(is_circle, cbb[:, 0],
                   jnp.where(is_drawfill, backdrop,
                             jnp.where(is_stroke, chw, c_color_lin[:, 0])))
    a1 = jnp.where(is_circle, cbb[:, 1],
                   jnp.where(is_solid, c_color_lin[:, 1], c_color_lin[:, 0]))
    a2 = jnp.where(is_circle, cbb[:, 2],
                   jnp.where(is_solid, c_color_lin[:, 2], c_color_lin[:, 1]))
    a3 = jnp.where(is_circle, cbb[:, 3],
                   jnp.where(is_solid, c_color_lin[:, 3], c_color_lin[:, 2]))
    a4 = jnp.where(is_solid | is_circle, 0.0, c_color_lin[:, 3])
    # DrawFill word 5: even-odd fill-rule flag (0/1) -- API extension, see
    # scene/scene.py::FLAG_EVEN_ODD.
    a5 = jnp.where(is_drawfill, c_even_odd, 0.0)
    # Group-command operands: BeginClip [backdrop, even_odd]; EndLayer
    # [alpha] (the layer's alpha = 2 * (0.5*width) -- exact in f32).
    a0 = jnp.where(is_clip, backdrop,
                   jnp.where(pop_layer, f32(2.0) * chw,
                             jnp.where(is_layer | is_pop, 0.0, a0)))
    a1 = jnp.where(is_clip, c_even_odd,
                   jnp.where(is_layer | is_pop, 0.0, a1))
    a2 = jnp.where(is_group_cmd, 0.0, a2)
    a3 = jnp.where(is_group_cmd, 0.0, a3)
    a4 = jnp.where(is_group_cmd, 0.0, a4)
    # Gradient resolve operands (raster/ptcl.py tags 14/15): [backdrop,
    # params3, c0 rgba, c1 rgba] -- ALL 12 words; no rect clip.
    a0 = jnp.where(is_grad, backdrop, a0)
    a1 = jnp.where(is_grad, cg[:, 0], a1)
    a2 = jnp.where(is_grad, cg[:, 1], a2)
    a3 = jnp.where(is_grad, cg[:, 2], a3)
    a4 = jnp.where(is_grad, c_color_lin[:, 0], a4)
    a5 = jnp.where(is_grad, c_color_lin[:, 1], a5)
    a6 = jnp.where(is_grad, c_color_lin[:, 2], 0.0)
    a7 = jnp.where(is_grad, c_color_lin[:, 3], 0.0)
    # Winding-carry operands (hole extension, raster/ptcl.py tag 16):
    # [backdrop] only.
    a0 = jnp.where(is_wind, backdrop, a0)
    a1 = jnp.where(is_wind, 0.0, a1)
    a2 = jnp.where(is_wind, 0.0, a2)
    a3 = jnp.where(is_wind, 0.0, a3)
    a4 = jnp.where(is_wind, 0.0, a4)
    a5 = jnp.where(is_wind, 0.0, a5)
    a6 = jnp.where(is_wind, 0.0, a6)
    a7 = jnp.where(is_wind, 0.0, a7)
    cand_args = cand_args.at[:, 0].set(a0)
    cand_args = cand_args.at[:, 1].set(a1)
    cand_args = cand_args.at[:, 2].set(a2)
    cand_args = cand_args.at[:, 3].set(a3)
    cand_args = cand_args.at[:, 4].set(a4)
    cand_args = cand_args.at[:, 5].set(a5)
    cand_args = cand_args.at[:, 6].set(a6)
    cand_args = cand_args.at[:, 7].set(a7)
    # Draw-command clip rect (words 8-11; piet clip extension).  Group
    # commands carry no rect (the oracle zero-pads their args); gradient
    # resolves carry the second stop's linear rgba there instead.
    cand_args = cand_args.at[:, 8:12].set(
        jnp.where(is_grad[:, None], cg[:, 3:7],
                  jnp.where((is_group_cmd | is_wind)[:, None], 0.0,
                            cf[:, 11:15])))

    # A clipped solid cannot bail the tile (the clip may not cover it);
    # must match the oracle's predicate exactly (raster/ptcl.py::solid).
    c_uncl = ((cf[:, 11] == f32(-1e9)) & (cf[:, 12] == f32(-1e9))
              & (cf[:, 13] == f32(1e9)) & (cf[:, 14] == f32(1e9)))
    is_opaque_solid = (is_solid & ((c_color_u32 & 0xFF) == 0xFF) & c_uncl
                       & ~c_ingroup)
    # Clearing commands (reset the bail state): Circle, Line, Stroke,
    # DrawFill (TileEncoder, PietRender.metal:81,90,99,124) -- clipped or
    # in-group solids (partial draws, raster/ptcl.py::solid), and all
    # clip/layer group commands.
    cand_is_clear = (is_circle | is_drawfill | is_stroke | is_grad
                     | (is_solid & ~(c_uncl & ~c_ingroup)) | is_group_cmd)

    # ---- pre-sort row assembly (entries output) -----------------------
    # The post-sort side then needs only TWO gathers (rows, meta) instead
    # of a dozen per-attribute gathers at sorted indices.
    if output == "entries":
        # NOTE: promoting a lone slot-1 Fill into slot 0 (saving a no-op
        # switch dispatch) was tried and measured 3.5 ms SLOWER at 4K --
        # the interpreter's cheap path is the first switch branch.
        hit_tag0 = jnp.where(slot0_valid, slot0_tag, 0)
        hit_tag1 = jnp.where(slot1_valid, jnp.int32(CMD_FILL), 0)
        # Word map: layout/entry_stream.py (the single source; pinned by
        # tests/test_layout.py).
        hit_meta = (hit_n_cmds
                    | stroke_emit.astype(jnp.int32) * META_CLEAR_BIT)
        hit_rows = jnp.concatenate(
            [hit_tag0.astype(f32)[:, None],              # W_S0_TAG
             slot0_args[:, :7],                          # W_S0_ARG + 0..6
             hit_tag1.astype(f32)[:, None],              # W_S1_TAG
             slot1_args[:, :5],                          # W_S1_ARG + 0..4
             hit_meta.astype(f32)[:, None],              # W_META
             jnp.zeros((max_hits, 1), f32)],             # W_PAD
            axis=1)
    if output == "entries":
        cand_tag0 = jnp.where(cand_cmd_valid, cand_tag, 0)
        cand_meta = (cand_cmd_valid.astype(jnp.int32)
                     | is_opaque_solid.astype(jnp.int32) * META_OPAQUE_BIT
                     | cand_is_clear.astype(jnp.int32) * META_CLEAR_BIT)
        cand_rows = jnp.concatenate(
            [cand_tag0.astype(f32)[:, None],             # W_S0_TAG
             cand_args[:, :7],                           # W_S0_ARG + 0..6
             # W_S1_TAG: empty (0) for every candidate EXCEPT gradient
             # resolves, whose arg 7 (c0 alpha, in [0,1] -- never a valid
             # tag value) rides here; see layout/entry_stream.py.
             cand_args[:, 7:8],
             cand_args[:, 8:12],                         # clip rect | c1
             jax.lax.bitcast_convert_type(
                 jnp.where(is_opaque_solid, c_color_u32,
                           jnp.uint32(0)), f32)[:, None],  # W_BAIL
             cand_meta.astype(f32)[:, None],             # W_META
             jnp.zeros((max_candidates, 1), f32)],       # W_PAD
            axis=1)
        assert hit_rows.shape[1] == ENTRY_WORDS
        assert cand_rows.shape[1] == ENTRY_WORDS
        all_rows = jnp.concatenate([hit_rows, cand_rows])
        # Probe masks dead slots (NaN from all-zero expansion rows).
        stage_probe("rows", jnp.where(
            jnp.concatenate([hit_valid, cand_valid])[:, None],
            all_rows, 0.0))

    # ---- global sort: stable key (tile, item, class) --------------------
    # Packed key = tile * 2*(NI+1) + item * 2 + class.  Segment order
    # within a (tile, item) group needs no key bits: hit records are
    # generated segment-major with nondecreasing item, and candidate
    # records item-major, so a STABLE sort preserves painter's order
    # within groups for free.
    #
    # Keys are f32 (exact for integers < 2^24): one f32 key plus an int32
    # payload is the shape XLA:GPU can hand to a radix sort.
    # Falls back to an UNPACKED (tile, item*2+class) two-key sort when the
    # packed key would lose integer exactness in f32 (huge item counts x
    # tile grids; tests/test_coarse.py covers the fallback at a config
    # that trips it).
    assert n_tiles < 2**24 and 2 * NI + 2 < 2**24, "f32 key range"
    hit_live = hit_valid & (hit_n_cmds > 0)
    E = max_hits + max_candidates
    DEAD = f32(jnp.inf)
    order_idx = jnp.arange(E, dtype=jnp.int32)
    if packed_ok:
        hit_key1 = jnp.where(
            hit_live, (h_tile * stride + h_item * 2).astype(f32), DEAD)
        cand_key1 = jnp.where(
            cand_cmd_valid,
            (cand_tile * stride + cand_item * 2 + 1).astype(f32), DEAD)
        all_keys = (jnp.concatenate([hit_key1, cand_key1]),)
    else:
        all_keys = (
            jnp.concatenate(
                [jnp.where(hit_live, h_tile.astype(f32), DEAD),
                 jnp.where(cand_cmd_valid, cand_tile.astype(f32), DEAD)]),
            jnp.concatenate(
                [jnp.where(hit_live, (h_item * 2).astype(f32), DEAD),
                 jnp.where(cand_cmd_valid,
                           (cand_item * 2 + 1).astype(f32), DEAD)]))
    sorted_keys, sorted_idx = stable_sort_multi(all_keys, order_idx)
    live = sorted_keys[0] < DEAD
    if packed_ok:
        # Dead keys (+inf) cap to n_tiles * stride, so tile decode needs
        # no select: n_tiles*stride // stride == n_tiles == "no tile".
        key_cap = jnp.minimum(sorted_keys[0], f32(n_tiles * stride))
        e_tile = key_cap.astype(jnp.int32) // stride
    else:
        e_tile = jnp.minimum(sorted_keys[0],
                             f32(n_tiles)).astype(jnp.int32)
    stage_probe("sort", e_tile, sorted_idx)
    if output == "entries":
        e_rows = _db(all_rows[sorted_idx])
        stage_probe("sorted_gather", e_rows)
        # Zero dead rows FIRST (f32 select), then read meta from the
        # zeroed array -- avoids s32 selects on record-sized arrays.
        stream16 = jnp.where(live[:, None], e_rows, 0.0)
        e_meta = stream16[:, W_META].astype(jnp.int32)
        e_ncmds = e_meta & META_NCMDS_MASK
        e_is_opaque = (e_meta & META_OPAQUE_BIT) != 0
        # Clearing state: CmdLine clears bail (PietRender.metal:90); fill
        # coverage commands do not (:102-117); candidate clears per tag.
        e_is_clear = (e_meta & META_CLEAR_BIT) != 0
        pair_mode = {True: "compact", False: "off"}.get(pair, pair)
        if pair_mode not in ("off", "compact", "hole"):
            raise ValueError(f"unknown pair mode {pair!r}")
        if pair_mode != "off":
            # Entry pairing (ops/pairing.py): two same-class records of a
            # (tile, item) group per 16-word entry -- 33-43% fewer live
            # entries on every BASELINE config; command counts unchanged.
            p = pair_entries(stream16, sorted_keys, live, e_tile, e_ncmds,
                             e_is_opaque, e_is_clear, n_tiles,
                             mode=pair_mode)
            stream16, live, e_tile = p.rows, p.live, p.e_tile
            e_ncmds, e_is_opaque, e_is_clear = (p.e_ncmds, p.e_is_opaque,
                                                p.e_is_clear)
            stage_probe("pairing", stream16)
        else:
            stage_probe("pairing", e_tile)
    else:
        src_is_hit = sorted_idx < max_hits
        hidx = jnp.minimum(sorted_idx, max_hits - 1)
        cidx = jnp.maximum(sorted_idx - max_hits, 0)
        e_ncmds = jnp.where(
            live, jnp.where(src_is_hit, hit_n_cmds[hidx], 1), 0)
        e_is_opaque = live & ~src_is_hit & is_opaque_solid[cidx]
        e_is_clear = live & ~src_is_hit & cand_is_clear[cidx]
        e_is_clear = e_is_clear | (live & src_is_hit & stroke_emit[hidx])
        stage_probe("pairing", e_ncmds)  # no pairing on the dense path

    # In-tile command positions and per-tile reductions.  Entries are
    # tile-sorted with the dead suffix last, so per-tile entry ranges and
    # command bases are CUMSUMS of per-tile counts; the
    # last-opaque/last-clear positions come from GLOBAL cumulative maxima
    # (vectorized log-step scans) sampled at each tile's last entry.
    # The dense path keeps the one-shot f32 segment_max formulation (its
    # scatter needs per-entry positions anyway).
    cpos_excl, cpos_incl = _exclusive_cumsum(e_ncmds)
    eidx = jnp.arange(E, dtype=jnp.int32)
    assert E < 2**24, "f32 entry-index range"
    seg_tile = jnp.minimum(e_tile, n_tiles)
    if output == "entries":
        # Per-tile entry ranges by BINARY SEARCH on the sorted tile ids
        # -- the stream is tile-sorted with dead entries decoding to
        # e_tile == n_tiles at the end (pairing preserves both,
        # ops/pairing.py), so boundary positions give exact live counts
        # and command totals with ~log2(E) small gathers instead of a
        # keyed-histogram scatter over E entries.
        bnd = jnp.searchsorted(seg_tile, jnp.arange(n_tiles + 1,
                                                    dtype=jnp.int32),
                               side="left").astype(jnp.int32)
        first_t = bnd[:-1]
        n_ent = bnd[1:] - first_t
        has_entries = n_ent > 0
        first_raw = jnp.where(has_entries, first_t, E + 1)
        last_raw = jnp.where(has_entries, first_t + n_ent - 1, -1)
        first_c = jnp.clip(first_raw, 0, E - 1)
        last_c = jnp.clip(last_raw, 0, E - 1)
        cpos_ext = jnp.concatenate([cpos_excl, cpos_incl[-1:]])
        cmd_b = cpos_ext[bnd[:-1]]
        tile_cmd_base = jnp.where(has_entries, cmd_b, 0)
        tile_cmd_total = jnp.where(has_entries,
                                   cpos_ext[bnd[1:]] - cmd_b, 0)
        gm_opq = jax.lax.cummax(jnp.where(e_is_opaque, eidx, -1))
        gm_clr = jax.lax.cummax(jnp.where(e_is_clear, eidx, -2))
        opq_t = jnp.where(has_entries, gm_opq[last_c], -1)
        opq_e = jnp.where(opq_t >= first_raw, opq_t, -1)
        clr_t = jnp.where(has_entries, gm_clr[last_c], -2)
        clr_e = jnp.where(clr_t >= first_raw, clr_t, -2)
        best_entry = jnp.maximum(opq_e, 0)
        last_opaque = jnp.where(opq_e >= 0,
                                cpos_excl[best_entry] - tile_cmd_base, -1)
        stage_probe("tile_reduce", n_ent, last_opaque)
    else:
        # First/last/last-opaque/last-clear as index maxima of per-entry
        # values (first via the negated index); runs in f32 (entry
        # indices < 2^24 exact; arithmetic masks beat slow s32 selects).
        eidx_f = jnp.arange(E, dtype=f32)
        packed = jnp.stack(
            [-eidx_f - 1,                                 # -> first entry
             eidx_f,                                      # -> last entry
             e_is_opaque.astype(f32) * (eidx_f + 1) - 1,  # -> last opaque
             e_is_clear.astype(f32) * (eidx_f + 2) - 2],  # -> last clearing
            axis=1)
        red_f = jax.ops.segment_max(packed, seg_tile,
                                    num_segments=n_tiles + 1)[:n_tiles]
        # Empty tiles reduce to -inf; clamp into exact-int f32 range before
        # the i32 conversion (the clamp value keeps every downstream
        # comparison's outcome identical to the old INT32_MIN behavior).
        red = jnp.maximum(red_f, f32(-(E + 2))).astype(jnp.int32)
        first_raw = -red[:, 0] - 1
        last_raw = red[:, 1]
        has_entries = last_raw >= 0
        first_c = jnp.clip(first_raw, 0, E - 1)
        last_c = jnp.clip(last_raw, 0, E - 1)
        tile_cmd_base = jnp.where(has_entries, cpos_excl[first_c], 0)
        tile_cmd_total = jnp.where(
            has_entries, cpos_excl[last_c] + e_ncmds[last_c] - tile_cmd_base,
            0)
        opq_e = jnp.maximum(red[:, 2], -1)
        clr_e = jnp.maximum(red[:, 3], -2)
        best_entry = jnp.maximum(opq_e, 0)
        stage_probe("tile_reduce", red)

    if output != "entries":
        e_pos = cpos_excl - tile_cmd_base[jnp.minimum(e_tile, n_tiles - 1)]

    # ---- bail analysis (from the fused reduction) ---------------------
    bail = clr_e < opq_e
    if output != "entries":
        # Command position of the last opaque solid (the dense path's
        # stream reset point); -1 when the tile has none.
        last_opaque = jnp.where(opq_e >= 0, e_pos[best_entry], -1)
    if output == "entries":
        # stream16, not e_rows: best_entry indexes the (possibly paired/
        # compacted) stream.
        best_color = jax.lax.bitcast_convert_type(
            stream16[best_entry, W_BAIL], jnp.uint32)
    else:
        best_color = c_color_u32[cidx[best_entry]]
    solid_color = jnp.where(
        bail, jnp.where(last_opaque >= 0, best_color,
                        jnp.uint32(0xFFFFFFFF)), jnp.uint32(0))

    # ---- scatter into (T, CAP) ---------------------------------------
    start = jnp.where(bail, jnp.int32(0),
                      jnp.where(last_opaque >= 0, last_opaque, 0))
    count_post = jnp.where(bail, 0, tile_cmd_total - start)
    overflow = jnp.maximum(count_post - cmd_capacity, 0)
    counts = jnp.minimum(count_post, cmd_capacity)

    if output == "entries":
        # Entry-stream PTCL: the sorted rows ARE the command list; each
        # tile gets an index range -- no scatter at all (the dense path's
        # two row scatters are ~30 ms at 128k records).  Dead entries
        # carry tag 0 rows by construction.
        stream = stream16
        # Per-tile live range: the dense path's start/count logic, in
        # entry units.  The stream reset at an opaque solid keeps entries
        # from best_entry on (TileEncoder cursor reset,
        # PietRender.metal:127-142).
        first_live = jnp.where(last_opaque >= 0, best_entry, first_c)
        n_live = jnp.where(bail | ~has_entries, 0,
                           last_raw - first_live + 1)
        first_live = jnp.where(n_live > 0, first_live, 0)
        diag = {
            "n_segments": n_segs, "n_hits": n_hits, "n_candidates": n_cand,
            "n_deltas": n_deltas,
            # Entries the fine kernel actually interprets (post bail /
            # cursor reset) -- the roofline model's fine-stage work unit.
            "live_entries": n_live.sum(),
            "seg_overflow": jnp.maximum(n_segs - max_segments, 0),
            "hit_overflow": jnp.maximum(n_hits - max_hits, 0),
            "cand_overflow": jnp.maximum(n_cand - max_candidates, 0),
            "delta_overflow": jnp.int32(0),  # deltas ride the hit records
            # (round-5 fold): no separate capacity to overflow.
        }
        if with_probes:
            diag["probes"] = probes
        return CoarseEntries(stream=stream, first=first_live,
                             n_entries=n_live, counts=count_post,
                             solid=solid_color, diag=diag)

    # Slot contents per sorted entry (slot0 = FillEdge|Line or the tail
    # command; slot1 = Fill).
    e_slot0_valid = live & jnp.where(src_is_hit, slot0_valid[hidx],
                                     cand_cmd_valid[cidx])
    e_slot0_tag = jnp.where(src_is_hit, slot0_tag[hidx], cand_tag[cidx])
    e_slot0_args = jnp.where(src_is_hit[:, None], slot0_args[hidx],
                             cand_args[cidx])
    e_s1_valid = live & src_is_hit & slot1_valid[hidx]
    e_s1_args = slot1_args[hidx]

    # One fused (1 + ARG_WORDS)-wide f32 row per command, tag bitcast into
    # word 0, so each slot costs a single scatter.
    out_rows = jnp.zeros((n_tiles * cmd_capacity + 1, 1 + ARG_WORDS), f32)

    e_tile_c = jnp.minimum(e_tile, n_tiles - 1)
    rel = e_pos - start[e_tile_c]

    def scatter_slot(out_rows, slot_off, s_valid, s_tag, s_args):
        pos = rel + slot_off
        ok = s_valid & (pos >= 0) & (pos < counts[e_tile_c]) \
            & ~bail[e_tile_c]
        # Bailed tiles keep nothing (counts == 0), handled by `ok`.
        flat = jnp.where(ok, e_tile_c * cmd_capacity + pos,
                         n_tiles * cmd_capacity)
        row = jnp.concatenate(
            [jax.lax.bitcast_convert_type(
                jnp.where(ok, s_tag, 0), f32)[:, None],
             jnp.where(ok[:, None], s_args, 0.0)], axis=1)
        return out_rows.at[flat].set(row, mode="drop")

    # A fill hit whose slot0 (FillEdge) is invalid but slot1 (Fill) valid
    # must place the Fill at position rel+0, not rel+1.
    out_rows = scatter_slot(
        out_rows, 0,
        e_slot0_valid | (e_s1_valid & ~e_slot0_valid),
        jnp.where(e_slot0_valid, e_slot0_tag, slot1_tag[hidx]),
        jnp.where(e_slot0_valid[:, None], e_slot0_args, e_s1_args))
    out_rows = scatter_slot(
        out_rows, 1, e_s1_valid & e_slot0_valid,
        slot1_tag[hidx], e_s1_args)
    out_tags = jax.lax.bitcast_convert_type(out_rows[:-1, 0], jnp.int32)
    out_args = out_rows[:-1, 1:]

    diag = {
        "n_segments": n_segs, "n_hits": n_hits, "n_candidates": n_cand,
        "n_deltas": n_deltas,
        "seg_overflow": jnp.maximum(n_segs - max_segments, 0),
        "hit_overflow": jnp.maximum(n_hits - max_hits, 0),
        "cand_overflow": jnp.maximum(n_cand - max_candidates, 0),
        "delta_overflow": jnp.int32(0),  # deltas ride the hit records
            # (round-5 fold): no separate capacity to overflow.
    }
    if with_probes:
        diag["probes"] = probes
    return CoarseOutput(
        tags=out_tags.reshape(n_tiles, cmd_capacity),
        args=out_args.reshape(n_tiles, cmd_capacity * ARG_WORDS),
        counts=counts, solid=solid_color, overflow=overflow, diag=diag)
