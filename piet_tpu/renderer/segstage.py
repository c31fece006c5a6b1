"""Host-side segment staging: the coarse pass's segment stage, computed
once at scene-staging time (round 5).

For a STATIC scene the per-segment derivation -- endpoint fetch, line
equations, emission rects, the division constants -- is a pure function
of (scene, tile geometry): recomputing it on device EVERY FRAME cost
0.7 ms of the 4K tiger frame and 2.5 ms of beziers_10k (round-5
profile: seg_expand + seg_points + seg_derive + seg_rects).  This module
computes the exact ``seg_all`` row matrix the device stage would have
produced -- BITWISE: every operation is an exactly-rounded f32
mul/add/min/max, an integer op, or the shared deterministic division
selection (raster/ptcl.py::div_det_np / dot2_det_np), all of which numpy
and the device agree on by construction (ops/cmd_math.py) -- so the
device pipeline consumes it with no semantic change
(tests/test_segstage.py pins the equality).

This is the analog of the reference's encode-once design: the scene
is encoded at init/resize and frames are GPU-only re-renders
(TestApp/PietRenderer.m:59-103,105-146); derived per-segment data is
part of that encoding.  Device-side animation paths (scene/animate.py,
scene/affine.py) recompute geometry inside the jit and therefore keep
the device derivation (``seg_pre=None``).

Shares the record-count arithmetic with renderer/capacity.py (which
remains the count-only entry point for fitting).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..raster.ptcl import div_det_np, dot2_det_np
from ..scene.scene import TAG_CLIP, TAG_FILL, TAG_LINE, TAG_POLY

F = np.float32


class SegPre(NamedTuple):
    """Precomputed segment-stage arrays (host numpy; staged to device by
    renderer.prepare_scene).  Shapes are capacity-padded; dead slots are
    all-zero rows, matching the device expansion contract.

    ``seg_rows`` ships as UINT32 bit patterns and is bitcast to f32 once
    on device: many of its words are int32 payloads whose f32 bit
    patterns are denormals, and shipping them as f32 exposed them to a
    backend path that flushed them inside the fused coarse graph
    (measured on chip, round 5: the appended hit_excl word read back as
    zero, walking every record's tile decode off its segment; the same
    jaxpr was bitwise-correct on CPU).  Integer transfers and bitcasts
    cannot flush."""
    seg_rows: np.ndarray    # (max_segments, 27) uint32 -- bit patterns of
                            # ops/coarse.py's seg_all + the hit_excl word
    hit_counts: np.ndarray  # (max_segments,) int32
    hit_excl: np.ndarray    # (max_segments,) int32 exclusive cumsum
    n_segs: np.ndarray      # (1,) int32
    n_hits: np.ndarray      # (1,) int32


def build_seg_pre(scene, config, row0: int = 0) -> SegPre:
    """Compute the segment stage for ``scene`` under ``config``.

    ``row0``/``config.tiles_y`` window the rects exactly like the device
    stage (row-sharded callers must build per-shard tables; the
    single-chip renderer uses row0=0 over the full grid).
    Raises nothing on overflow: counts are clamped by capacity exactly
    like the device's padded arrays (the renderer's stats checks still
    see the true totals via n_segs/n_hits).
    """
    tw, th = config.tile_width, config.tile_height
    tiles_x, tiles_y = config.tiles_x, config.tiles_y
    S = config.max_segments
    tags = scene.tags.astype(np.int32)
    n_pts = scene.n_pts.astype(np.int32)

    # ---- item tile rects + candidate layout (ops/coarse.py
    # _item_tile_rect; integer, exact) --------------------------------
    bx0 = np.maximum(scene.bboxes[:, 0] // tw, 0).astype(np.int32)
    by0 = np.maximum(scene.bboxes[:, 1] // th, row0).astype(np.int32)
    bx1 = np.minimum(scene.bboxes[:, 2] // tw, tiles_x - 1).astype(np.int32)
    by1 = np.minimum(scene.bboxes[:, 3] // th,
                     row0 + tiles_y - 1).astype(np.int32)
    bw = np.maximum(bx1 - bx0 + 1, 0)
    bh = np.maximum(by1 - by0 + 1, 0)
    cand_counts = bw * bh
    cand_excl = (np.cumsum(cand_counts) - cand_counts).astype(np.int32)

    # ---- segment enumeration ----------------------------------------
    is_fill_item = (tags == TAG_FILL) | (tags == TAG_CLIP)
    seg_counts = np.where(
        is_fill_item, n_pts,
        np.where(tags == TAG_POLY, np.maximum(n_pts - 1, 0),
                 np.where(tags == TAG_LINE, 1, 0))).astype(np.int32)
    seg_excl = (np.cumsum(seg_counts) - seg_counts).astype(np.int32)
    n_segs = int(seg_counts.sum())
    n_live = min(n_segs, S)

    item_of_seg = np.repeat(np.arange(scene.n_items, dtype=np.int32),
                            seg_counts)[:n_live]
    local = (np.arange(n_live, dtype=np.int32)
             - seg_excl[item_of_seg])
    i0 = scene.pt_offset[item_of_seg].astype(np.int32) + local
    wrap = is_fill_item[item_of_seg] & (local + 1 == n_pts[item_of_seg])
    i1 = np.where(wrap, scene.pt_offset[item_of_seg].astype(np.int32),
                  i0 + 1)
    p0 = scene.points[i0].astype(F)
    p1 = scene.points[i1].astype(F)

    # ---- line equations + bounds (verbatim device expressions) -------
    sx, sy = p0[:, 0], p0[:, 1]
    ex, ey = p1[:, 0], p1[:, 1]
    a = ey - sy
    b = sx - ex
    c = -(a * sx + b * sy)
    xmn = np.minimum(p0, p1)
    xmx = np.maximum(p0, p1)
    widths = scene.widths[item_of_seg].astype(F)
    s_hw = F(0.5) * widths + F(0.5)

    lvx = ex - sx
    lvy = ey - sy
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        s_invd = np.asarray(div_det_np(np.ones_like(lvx),
                                       dot2_det_np(lvx, lvy)), F)
        s_m = np.asarray(div_det_np(lvx, lvy), F)
        s_K = np.asarray(div_det_np(-lvy, np.abs(lvx)), F)
    s_m = np.where(np.isfinite(s_m), s_m, F(0.0))
    s_K = np.where(np.isfinite(s_K), s_K, F(0.0))

    # ---- emission rects (ops/coarse.py; f32 expressions verbatim) ----
    twf, thf = F(tw), F(th)
    is_fill = is_fill_item[item_of_seg]
    is_line = tags[item_of_seg] == TAG_LINE
    is_stroke = (tags[item_of_seg] == TAG_POLY) | is_line

    fx_lo = np.floor(xmn[:, 0] / twf).astype(np.int32)
    fx_hi = np.ceil(xmx[:, 0] / twf).astype(np.int32) - 1
    fy_lo = np.floor(xmn[:, 1] / thf).astype(np.int32)
    fy_hi = np.floor(xmx[:, 1] / thf).astype(np.int32)

    def _stroke_range(lo_v, hi_v, dim, step):
        lo = np.floor(lo_v / step).astype(np.int32)
        hi = np.ceil(hi_v / step).astype(np.int32) - 1

        def passes(t):
            o = t.astype(F) * step
            return ((xmx[:, dim] > o - s_hw)
                    & (xmn[:, dim] < o + step + s_hw))

        lo = np.where(passes(lo - 1), lo - 1, lo)
        hi = np.where(passes(hi + 1), hi + 1, hi)
        return lo, hi

    st_x_lo, st_x_hi = _stroke_range(xmn[:, 0] - s_hw, xmx[:, 0] + s_hw,
                                     0, twf)
    st_y_lo, st_y_hi = _stroke_range(xmn[:, 1] - s_hw, xmx[:, 1] + s_hw,
                                     1, thf)

    sb0 = bx0[item_of_seg]
    sb1 = by0[item_of_seg]
    sb2 = bx1[item_of_seg]
    sb3 = by1[item_of_seg]
    r_x_lo = np.maximum(np.where(is_fill, fx_lo,
                                 np.where(is_line, sb0, st_x_lo)), sb0)
    r_x_hi = np.minimum(np.where(is_fill, fx_hi,
                                 np.where(is_line, sb2, st_x_hi)), sb2)
    r_y_lo = np.maximum(np.where(is_fill, fy_lo,
                                 np.where(is_line, sb1, st_y_lo)), sb1)
    r_y_hi = np.minimum(np.where(is_fill, fy_hi,
                                 np.where(is_line, sb3, st_y_hi)), sb3)
    r_w = np.maximum(r_x_hi - r_x_lo + 1, 0)
    r_h = np.maximum(r_y_hi - r_y_lo + 1, 0)
    # Delta-fold widening (ops/coarse.py rationale).
    widen = (is_fill & (a != 0.0) & (r_w == 0) & (r_h > 0) & (sb0 <= sb2))
    wcol = np.clip(fx_lo, sb0, sb2)
    r_x_lo = np.where(widen, wcol, r_x_lo)
    r_w = np.where(widen, 1, r_w)
    hit_counts_live = (r_w * r_h).astype(np.int32)

    # ---- pack rows (layout identical to ops/coarse.py::seg_all) ------
    seg_flags = (is_fill.astype(np.int32)
                 | (is_stroke.astype(np.int32) << 1)
                 | (is_line.astype(np.int32) << 2))
    seg_i32 = np.stack(
        [seg_flags, r_x_lo, r_y_lo, np.maximum(r_w, 1), item_of_seg,
         cand_excl[item_of_seg], sb1, np.maximum(bw[item_of_seg], 1),
         sb0, sb3, sb2], axis=1).astype(np.int32)
    seg_f32 = np.stack([sx, sy, ex, ey, a, b, c, xmn[:, 0], xmn[:, 1],
                        xmx[:, 0], xmx[:, 1], s_hw], axis=1).astype(F)
    consts = np.stack([s_invd, s_m, s_K], axis=1).astype(F)

    seg_all = np.zeros((S, 26), F)
    seg_all[:n_live, :12] = seg_f32
    seg_all[:n_live, 12:23] = seg_i32.view(F)
    seg_all[:n_live, 23:26] = consts
    # Dead slots of the INVD column: the device path computes
    # div_det(1, 0) = +inf there before zeroing p0/p1... no: the device
    # zeroes endpoints first, giving inv = inf on dead slots too.  Dead
    # slots are never expanded (hit_counts 0), and the device's
    # ``seg_all`` is only consumed through the expansion, whose dead
    # outputs are all-zero rows on both paths -- but the PRE-expansion
    # array itself must match bitwise only where probes/inputs read it:
    # the expansion engine reads only live windows.  We still mirror the
    # device's dead-slot inv = +inf for the bitwise table equality test.
    if n_live < S:
        seg_all[n_live:, 23] = np.inf

    hit_counts = np.zeros(S, np.int32)
    hit_counts[:n_live] = hit_counts_live
    hc64 = hit_counts.astype(np.int64)
    hit_excl = (np.cumsum(hc64) - hc64).astype(np.int32)
    n_hits = int(hc64.sum())

    seg_rows = np.zeros((S, 27), np.uint32)
    seg_rows[:, :26] = seg_all.view(np.uint32)
    seg_rows[:, 26] = hit_excl.view(np.uint32)
    return SegPre(
        seg_rows=seg_rows,
        hit_counts=hit_counts,
        hit_excl=hit_excl,
        n_segs=np.array([n_segs], np.int32),
        n_hits=np.array([n_hits], np.int32),
    )
