"""Pallas fine rasterizer for the GPU: the entry-stream PTCL interpreter.

The device counterpart of the reference's ``renderKernel``
(PietRender.metal:457-566), written for Pallas's Triton route.  The
reference runs one threadgroup per tile and one thread per pixel, and every
thread interprets its tile's command list with scalar state.  Here one
program interprets one horizontal STRIP of a tile (``STRIP_H`` rows x
``tile_w`` columns): the per-pixel state (r, g, b, squared line field,
signed area) is a set of register tensors, and the program walks its
tile's entry range ``[first, first + n)`` of the coarse pass's sorted
entry stream (ops/coarse.py::CoarseEntries) in a loop whose trip count is
that tile's own.  Every strip of a tile re-reads the same entries; the
reads are uniform across the program's threads and hit L1/L2.

Per entry, slot 0 (FillEdge | Line | paired Fill | tail command) applies
before slot 1 (Fill | paired Line), each dispatched on its own tag, so
paired streams (ops/pairing.py) need no separate kernel.  The dispatch is a
chain of ``lax.cond`` (``scf.if`` on this route) with the dominant classes
first.

Clip and layer groups keep their stacks (``group_depth`` coverage planes
and ``3 * group_depth`` saved-rgb planes per strip) in a scratch output in
device memory: only group commands and draws under an open clip touch it.
``group_depth`` is the scene's own nesting (RenderConfig.max_group_depth);
at 0 the kernel has no scratch output and no group branches.

Numerics: ``bar`` is an FMA-contraction barrier.  In interpret mode it is
``optimization_barrier``; compiled, it is an explicitly rounded
``add.rn.f32 x, -0.0`` in inline PTX -- an identity for every f32 value
that neither LLVM (opaque asm) nor ptxas (explicit rounding mode) fuses
with the product feeding it, so each guarded product is rounded on its
own, as the numpy oracle (raster/cpu_fine.py) rounds it.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..layout.entry_stream import (ENTRY_WORDS, W_S0_ARG, W_S0_TAG, W_S1_ARG,
                                   W_S1_TAG)
from ..raster.ptcl import (CMD_BEGIN_CLIP, CMD_BEGIN_LAYER, CMD_CIRCLE,
                           CMD_DRAW_FILL, CMD_DRAW_LIN_GRAD,
                           CMD_DRAW_RAD_GRAD, CMD_END_CLIP, CMD_END_LAYER,
                           CMD_FILL, CMD_FILL_EDGE, CMD_LINE, CMD_SOLID,
                           CMD_STROKE, CMD_WIND)
from ..config import MAX_GROUP_DEPTH
from .cmd_math import (DF2_INIT, clip_alpha, edge_delta, fill_delta,
                       ieee_sqrt, line_field_sq, make_commands,
                       make_grad_commands, pack_rgba8)

#: Rows of a tile interpreted by one program (fewer where the tile
#: height is not a multiple: the largest power of two dividing both).
STRIP_H = 8
#: Warps per program.
NUM_WARPS = 4


def _asm_bar(x):
    """Compiled FMA barrier (module docstring): x + (-0.0), rounded."""
    (y,) = plt.elementwise_inline_asm(
        "add.rn.f32 $0, $1, 0f80000000;", args=[x], constraints="=f,f",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, x.dtype)])
    return y


def _dispatch(cases, default, *ops):
    """First ``fn(*ops)`` of ``cases = [(pred, fn), ...]`` whose scalar
    predicate holds, else ``default(*ops)``: a chain of ``lax.cond`` (the
    Triton route lowers ``lax.switch``'s index clamp incorrectly)."""
    if not cases:
        return default(*ops)
    (pred, fn), rest = cases[0], cases[1:]
    return jax.lax.cond(pred, fn,
                        lambda *o: _dispatch(rest, default, *o), *ops)


def _fine_kernel(first_ref, n_ref, solid_ref, row0_ref, stream_ref, out_ref,
                 *stack, tile_h: int, tile_w: int, strip_h: int,
                 tiles_x: int, depth: int, interpret: bool):
    # stack: () at depth 0, else the (4 * depth, strip_h, tile_w) scratch
    # planes: clip coverage for depths 1..depth, then the saved r, g, b of
    # each layer level.
    D = depth
    stack_ref = stack[0] if stack else None
    bar = jax.lax.optimization_barrier if interpret else _asm_bar
    f32 = jnp.float32
    t = pl.program_id(0)
    s = pl.program_id(1)
    n = n_ref[t]
    shp = (strip_h, tile_w)

    @pl.when(n == 0)
    def _():
        # Empty tile: the present fast path (PietRender.metal:34-44) -- the
        # bail solid's raw sRGB bytes, or the white background.
        sol = solid_ref[t]
        px = jnp.where(sol == 0, jnp.uint32(0xFFFFFFFF), sol)
        out_ref[...] = jnp.full(shp, px, jnp.uint32)

    @pl.when(n > 0)
    def _():
        fe = first_ref[t]
        ty = row0_ref[0] + t // tiles_x
        tx = t % tiles_x
        X = (tx * tile_w).astype(f32) + jax.lax.broadcasted_iota(
            jnp.int32, shp, 1).astype(f32)
        Y = (ty * tile_h + s * strip_h).astype(f32) + \
            jax.lax.broadcasted_iota(jnp.int32, shp, 0).astype(f32)
        ones = jnp.ones(shp, f32)

        def sync():
            # Scratch planes are written and read back by the same program;
            # barriers around each write order it against its threads'
            # earlier and later reads.
            if not interpret:
                plt.debug_barrier()

        def cov_plane(cdep):
            """Current clip-stack coverage (exactly 1.0 with no open clip)."""
            if not D:
                return ones
            return jax.lax.cond(cdep > 0,
                                lambda: stack_ref[jnp.maximum(cdep, 1) - 1],
                                lambda: ones)

        # ---- per-entry branches: (e, state) -> state -------------------
        # state = (r, g, b, df2, area, clip depth, layer depth); df2 is the
        # SQUARED line field (min commutes with the monotone sqrt, which the
        # stroke resolve applies; cmd_math.line_field_sq).
        def s0(e):
            return lambda k: stream_ref[e, W_S0_ARG + k]

        def s1(e):
            return lambda k: stream_ref[e, W_S1_ARG + k]

        def line(arg, st):
            r, g, b, df, area, cd, ld = st
            return (r, g, b, jnp.minimum(df, line_field_sq(arg, X, Y, bar)),
                    area, cd, ld)

        def fill(arg, st):
            r, g, b, df, area, cd, ld = st
            m, d = fill_delta(arg, X, Y, bar)
            return r, g, b, df, jnp.where(m, area + d, area), cd, ld

        def keep(e, st):
            return st

        def s0_line(e, st):
            return line(s0(e), st)

        def s0_edge(e, st):
            r, g, b, df, area, cd, ld = st
            return r, g, b, df, area + edge_delta(s0(e), Y, bar), cd, ld

        def s0_fill(e, st):
            return fill(s0(e), st)

        def s1_fill(e, st):
            return fill(s1(e), st)

        def s1_line(e, st):
            # Paired second line: slot-1 word 4 carries inv_denom (slot-0
            # word 5; ops/pairing.py).
            a1 = s1(e)
            return line(lambda k: a1(4 if k == 5 else k), st)

        # Tail commands: the resolves and group commands (one per (item,
        # tile)).
        def lift(i):
            def branch(e, st):
                r, g, b, df, area, cd, ld = st
                cmds = make_commands(X, Y, bar, cov=lambda: cov_plane(cd))
                r, g, b, _, area = cmds[i](s0(e), r, g, b, df, area)
                return r, g, b, df, area, cd, ld
            return branch

        def stroke(e, st):
            r, g, b, df, area, cd, ld = st
            cmds = make_commands(X, Y, bar, cov=lambda: cov_plane(cd))
            r, g, b, _, _ = cmds[3](s0(e), r, g, b, ieee_sqrt(df, bar),
                                    area)
            return (r, g, b, jnp.full(shp, DF2_INIT, f32), area, cd, ld)

        def grad(radial):
            def branch(e, st):
                r, g, b, df, area, cd, ld = st
                lin, rad = make_grad_commands(X, Y, bar,
                                              cov=lambda: cov_plane(cd))
                cmd = rad if radial else lin
                r, g, b, _, area = cmd(s0(e), r, g, b, df, area)
                return r, g, b, df, area, cd, ld
            return branch

        def begin_clip(e, st):
            r, g, b, df, area, cd, ld = st
            a = s0(e)
            ca = clip_alpha(area + a(0), a(1), bar)
            nd = jnp.minimum(cd + 1, D)
            cov = cov_plane(cd) * ca
            sync()
            stack_ref[nd - 1] = cov
            sync()
            return r, g, b, df, jnp.zeros(shp, f32), nd, ld

        def end_clip(e, st):
            r, g, b, df, area, cd, ld = st
            return r, g, b, df, area, jnp.maximum(cd - 1, 0), ld

        def begin_layer(e, st):
            r, g, b, df, area, cd, ld = st
            lv = jnp.minimum(ld, D - 1)
            sync()
            stack_ref[D + 3 * lv] = r
            stack_ref[D + 3 * lv + 1] = g
            stack_ref[D + 3 * lv + 2] = b
            sync()
            return r, g, b, df, area, cd, lv + 1

        def end_layer(e, st):
            r, g, b, df, area, cd, ld = st
            alpha = s0(e)(0)
            lv = jnp.maximum(ld - 1, 0)

            def mix(c, cur):
                sv = stack_ref[D + 3 * lv + c]
                return sv + bar((cur - sv) * alpha)

            return mix(0, r), mix(1, g), mix(2, b), df, area, cd, lv

        def wind(e, st):
            r, g, b, df, area, cd, ld = st
            return r, g, b, df, area + s0(e)(0), cd, ld

        tail = ((CMD_DRAW_FILL, lift(5)), (CMD_STROKE, stroke),
                (CMD_SOLID, lift(6)), (CMD_CIRCLE, lift(0)),
                (CMD_DRAW_LIN_GRAD, grad(False)),
                (CMD_DRAW_RAD_GRAD, grad(True)), (CMD_WIND, wind))
        if D:
            tail += ((CMD_BEGIN_CLIP, begin_clip), (CMD_END_CLIP, end_clip),
                     (CMD_BEGIN_LAYER, begin_layer),
                     (CMD_END_LAYER, end_layer))

        def body(e, st):
            tag0 = stream_ref[e, W_S0_TAG]
            tag1 = stream_ref[e, W_S1_TAG]
            st = _dispatch(
                [(tag0 == 0.0, keep), (tag0 == f32(CMD_LINE), s0_line),
                 (tag0 == f32(CMD_FILL_EDGE), s0_edge),
                 (tag0 == f32(CMD_FILL), s0_fill)]
                + [(tag0 == f32(tag), fn) for tag, fn in tail], keep, e, st)
            # Gradient resolves carry c0 alpha in word 8 (in [0, 1], never
            # a slot-1 tag; layout/entry_stream.py).
            return _dispatch([(tag1 == f32(CMD_FILL), s1_fill),
                              (tag1 == f32(CMD_LINE), s1_line)], keep, e, st)

        st0 = (ones, ones, ones, jnp.full(shp, DF2_INIT, f32),
               jnp.zeros(shp, f32), jnp.int32(0), jnp.int32(0))
        r, g, b, *_ = jax.lax.fori_loop(fe, fe + n, body, st0)
        out_ref[...] = pack_rgba8(r, g, b, bar)


@functools.partial(jax.jit, static_argnames=("tile_h", "tile_w", "tiles_x",
                                             "group_depth", "interpret"))
def fine_rasterize_entries(first: jax.Array, n_entries: jax.Array,
                           solid: jax.Array, stream: jax.Array, row0=0, *,
                           tile_h: int, tile_w: int, tiles_x: int,
                           group_depth: int = MAX_GROUP_DEPTH,
                           interpret: bool = False) -> jax.Array:
    """Rasterize all tiles from an entry stream (CoarseEntries).

    Args:
      first: (T,) int32 first live entry per tile.
      n_entries: (T,) int32 live entries per tile.
      solid: (T,) uint32 present-format bail color bytes (0 = none); the
        present composite (reference C11) is fused into the kernel's
        empty-tile path.
      stream: (E, ENTRY_WORDS) f32 entry rows (layout/entry_stream.py).
      row0: first tile row of this shard's slab (traced OK).
      group_depth: deepest clip/layer nesting in the stream (0: none);
        deeper groups are clamped to it, so it must cover the scene.

    Returns:
      (T // tiles_x * tile_h, tiles_x * tile_w) uint32 packed RGBA8 pixels.
    """
    n_tiles = first.shape[0]
    tiles_y = n_tiles // tiles_x
    if stream.shape[1] != ENTRY_WORDS:
        raise ValueError(f"stream rows must be {ENTRY_WORDS} words")
    if not 0 <= group_depth <= MAX_GROUP_DEPTH:
        raise ValueError(f"group_depth must be in [0, {MAX_GROUP_DEPTH}]")
    strip_h = math.gcd(STRIP_H, tile_h)
    nst = tile_h // strip_h
    kernel = functools.partial(
        _fine_kernel, tile_h=tile_h, tile_w=tile_w, strip_h=strip_h,
        tiles_x=tiles_x, depth=group_depth, interpret=interpret)
    out_specs = [pl.BlockSpec((strip_h, tile_w),
                              lambda t, s: ((t // tiles_x) * nst + s,
                                            t % tiles_x))]
    out_shape = [jax.ShapeDtypeStruct((tiles_y * tile_h, tiles_x * tile_w),
                                      jnp.uint32)]
    if group_depth:
        planes = 4 * group_depth
        out_specs.append(pl.BlockSpec((None, planes, strip_h, tile_w),
                                      lambda t, s: (t * nst + s, 0, 0, 0)))
        out_shape.append(jax.ShapeDtypeStruct(
            (n_tiles * nst, planes, strip_h, tile_w), jnp.float32))
    img, *_ = pl.pallas_call(
        kernel,
        grid=(n_tiles, nst),
        in_specs=[pl.BlockSpec()] * 5,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="fine_entries",
    )(first, n_entries, solid, jnp.asarray(row0, jnp.int32).reshape(1),
      stream)
    return img
