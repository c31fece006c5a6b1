"""Pure-XLA fine rasterizer: portable PTCL interpreter.

Second device implementation of the reference ``renderKernel``
(TestApp/PietRender.metal:457-566), built from the same shared command
math as the Pallas kernel (ops/cmd_math.py) but expressed as plain XLA:
``vmap`` over tiles of a ``fori_loop`` over command slots, with the 7-way
dispatch vectorized as compute-all-branches + select (the standard vmap
lowering of ``lax.switch``).

Roles:
* the plain reference the GPU kernel (ops/fine.py) is compared with, and
  the path ``fine_impl="auto"`` takes off the GPU (within the documented
  FMA tolerance through XLA:CPU -- see tests/_imgcmp.py),
* the fast CPU test vehicle for the shared command math.

It pays the full ``max(counts)`` trip count for every tile and evaluates
all fifteen branches per command: on the H100 it is three orders of
magnitude slower than the kernel, which walks each tile's own entries.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..raster.ptcl import ARG_WORDS
from ..scene.scene import MAX_GROUP_DEPTH
from .cmd_math import (DF_INIT, clip_alpha, make_commands,
                       make_grad_commands, pack_rgba8)


@functools.partial(jax.jit, static_argnames=("tile_h", "tile_w",
                                             "cmd_capacity"))
def fine_rasterize_xla(counts: jax.Array, tags: jax.Array, args: jax.Array,
                       row0=0, *, tile_h: int, tile_w: int,
                       cmd_capacity: int) -> jax.Array:
    """Rasterize all tiles from the dense (T, CAP) PTCL.

    Args:
      counts: (tiles_y, tiles_x) int32 live-command counts.
      tags: (T, CAP) int32 command tags.
      args: (T, CAP * ARG_WORDS) float32 command operands (ARG_WORDS =
        12; words 8-11 carry the draw-command clip rect).

    ``row0``: first tile row of this shard's slab (traced OK) -- pixel
    coordinates are absolute, output shape is the local slab.

    Returns:
      (tiles_y * tile_h, tiles_x * tile_w) uint32 packed RGBA8 pixels.
    """
    tiles_y, tiles_x = counts.shape
    n_tiles = tiles_y * tiles_x
    bar = jax.lax.optimization_barrier
    args3 = args.reshape(n_tiles, cmd_capacity, ARG_WORDS)
    origins_x = (jnp.arange(n_tiles, dtype=jnp.int32) % tiles_x) * tile_w
    origins_y = (jnp.int32(row0)
                 + jnp.arange(n_tiles, dtype=jnp.int32) // tiles_x) * tile_h
    n_max = jnp.max(counts)

    D = MAX_GROUP_DEPTH

    def tile_fn(tag_row, arg_row, count, ox, oy):
        X = ox.astype(jnp.float32) + jax.lax.broadcasted_iota(
            jnp.int32, (tile_h, tile_w), 1).astype(jnp.float32)
        Y = oy.astype(jnp.float32) + jax.lax.broadcasted_iota(
            jnp.int32, (tile_h, tile_w), 0).astype(jnp.float32)
        shp = (tile_h, tile_w)

        # Interpreter state: pixel state + clip/layer group stacks (the
        # arbitrary-path clip extension).  cov[depth] multiplies every
        # draw's alpha; plane 0 is constant 1.0 (no open clip -- an exact
        # no-op multiply, preserving reference bit-parity).
        # st = (r, g, b, df, area, cov (D+1,th,tw), cdep, saved (D,3,th,tw),
        #       ldep)

        def cur_cov_of(st):
            return lambda: st[5][st[6]]

        # lax.switch can't take a function operand; pass the (ARG_WORDS,)
        # vector and let each lifted branch index it.  make_commands'
        # draw evaluators take the clip-stack coverage via closure, so the
        # command tuple is rebuilt per branch with the state's cov thunk.
        def lift_core(i):
            def branch(words, st):
                cov = cur_cov_of(st)
                cmds = make_commands(X, Y, bar, cov=cov)
                r, g, b, df, area = cmds[i](lambda k: words[k], *st[:5])
                return (r, g, b, df, area) + st[5:]
            return branch

        def begin_clip(words, st):
            r, g, b, df, area, covs, cdep, saved, ldep = st
            x = area + words[0]
            ca = clip_alpha(x, words[1], bar)
            nd = jnp.minimum(cdep + 1, D)
            covs = jax.lax.dynamic_update_index_in_dim(
                covs, covs[cdep] * ca, nd, 0)
            return (r, g, b, df, jnp.zeros_like(area), covs, nd, saved,
                    ldep)

        def end_clip(words, st):
            r, g, b, df, area, covs, cdep, saved, ldep = st
            return (r, g, b, df, area, covs, jnp.maximum(cdep - 1, 0),
                    saved, ldep)

        def begin_layer(words, st):
            r, g, b, df, area, covs, cdep, saved, ldep = st
            saved = jax.lax.dynamic_update_index_in_dim(
                saved, jnp.stack([r, g, b]), jnp.minimum(ldep, D - 1), 0)
            return (r, g, b, df, area, covs, cdep, saved,
                    jnp.minimum(ldep + 1, D))

        def end_layer(words, st):
            r, g, b, df, area, covs, cdep, saved, ldep = st
            alpha = words[0]
            ld = jnp.maximum(ldep - 1, 0)
            sv = saved[ld]
            r = sv[0] + (r - sv[0]) * alpha
            g = sv[1] + (g - sv[1]) * alpha
            b = sv[2] + (b - sv[2]) * alpha
            return (r, g, b, df, area, covs, cdep, saved, ld)

        def noop(words, st):
            return st  # tag 9 (Bail) never appears in the arrays

        def lift_grad(radial):
            def branch(words, st):
                cov = cur_cov_of(st)
                lin, rad = make_grad_commands(X, Y, bar, cov=cov)
                cmd = rad if radial else lin
                r, g, b, df, area = cmd(lambda k: words[k], *st[:5])
                return (r, g, b, df, area) + st[5:]
            return branch

        def wind(words, st):
            # Winding carry (multi-subpath fill extension).
            return st[:4] + (st[4] + words[0],) + st[5:]

        branches = tuple(lift_core(i) for i in range(7)) + (
            noop, begin_clip, end_clip, begin_layer, end_layer,
            lift_grad(False), lift_grad(True), wind)

        def body(j, st):
            idx = jnp.clip(tag_row[j] - 2, 0, 14)
            new = jax.lax.switch(idx, branches, arg_row[j], st)
            live = j < count
            return jax.tree.map(
                lambda n, o: jnp.where(live, n, o), new, st)

        st0 = (jnp.ones(shp, jnp.float32), jnp.ones(shp, jnp.float32),
               jnp.ones(shp, jnp.float32),
               jnp.full(shp, DF_INIT, jnp.float32),
               jnp.zeros(shp, jnp.float32),
               jnp.ones((D + 1,) + shp, jnp.float32),
               jnp.int32(0),
               jnp.zeros((D, 3) + shp, jnp.float32),
               jnp.int32(0))
        st = jax.lax.fori_loop(0, n_max, body, st0)
        return pack_rgba8(st[0], st[1], st[2], bar)

    tiles = jax.vmap(tile_fn)(tags, args3, counts.reshape(-1),
                              origins_x, origins_y)
    return (tiles.reshape(tiles_y, tiles_x, tile_h, tile_w)
            .transpose(0, 2, 1, 3)
            .reshape(tiles_y * tile_h, tiles_x * tile_w))
