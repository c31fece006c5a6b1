"""Multi-chip rendering: row-sharded SPMD over a jax.sharding.Mesh.

The reference is strictly single-GPU (SURVEY.md section 2, "parallelism
strategy inventory"); this module is the scale-out design:

* the tile grid is sharded by TILE ROWS over a 1D mesh axis -- each device
  runs the full coarse+fine+present pipeline (renderer/renderer.py::
  render_slab) on its slab, in absolute pixel coordinates, so the sharded
  image is bit-identical to the single-chip one per slab;
* the scene (a few MB of SoA arrays) is replicated -- the analog of the
  reference's single shared scene buffer (PietRenderer.m:52-53);
* there is NO cross-device traffic during the frame: binning, winding
  backdrops and blending are all row-local (the left-ray backdrop runs
  along x, PietRender.metal:331-333, so rows never couple).  The only
  collective is the implicit all-gather if the caller assembles the full
  framebuffer on one host -- at most H*W*4 bytes;
* capacity limits (max_hits etc. in RenderConfig) apply PER DEVICE, so a
  mesh of N devices also scales the record budget by N.

Row sharding (not column) is load-balanced for typical scenes at 16-px
tile height (hundreds of rows) and keeps the backdrop math local; a 2D
(row x column) mesh would need a backdrop reduce_scatter along x and is
not worth it at these scene sizes.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..ops.coarse import DeviceScene
from ..renderer.renderer import (Renderer, _resolve_fine_impl, prepare_scene,
                                 render_slab)


def make_sharded_render_fn(config: RenderConfig, mesh: Mesh,
                           fine_impl: str = "auto", interleave: int = 1,
                           interpret: bool = False):
    """Build the jitted multi-chip render step.

    Returns a function DeviceScene -> (image_u32, stats).  With
    ``interleave == 1`` (default) image_u32 is the full padded framebuffer
    (contiguous slabs, row-sharded across the mesh) and stats are
    per-device arrays of shape (n_devices,).

    ``interleave = B > 1`` is the LOAD-BALANCED partition: each device
    renders B row blocks STRIDED across the viewport (device d gets
    global blocks d, d+N, d+2N, ...), so a horizontal complexity band
    (e.g. the tiger's head) spreads over every device instead of
    saturating one slab's owner.  SPMD needs static shapes, so uneven
    contiguous slabs are not expressible; strided equal blocks are the
    static-shape balancer.  Blocks run under ``lax.map`` (one compiled
    pipeline, B sequential steps per device); capacity limits apply PER
    BLOCK.  The image is returned as (N*B, block_h, padded_W) row blocks
    in device-major order -- ``ShardedRenderer.render`` reassembles.
    """
    if len(mesh.axis_names) != 1:
        raise ValueError("expected a 1D mesh (row sharding)")
    axis = mesh.axis_names[0]
    ndev = mesh.shape[axis]
    if config.tiles_y % ndev:
        raise ValueError(
            f"tiles_y={config.tiles_y} not divisible by mesh size {ndev}")
    rows = config.tiles_y // ndev
    impl = _resolve_fine_impl(fine_impl)

    if interleave > 1:
        if rows % interleave:
            raise ValueError(
                f"rows-per-device {rows} not divisible by "
                f"interleave {interleave}")
        k = rows // interleave

        def shard_fn(scene: DeviceScene):
            # The precomputed segment stage is whole-viewport (row0=0);
            # shard-local windows must derive on device.
            scene = scene._replace(seg_pre=None)
            d = jax.lax.axis_index(axis)
            block_ids = d + jnp.arange(interleave, dtype=jnp.int32) * ndev

            def one(b):
                img, stats = render_slab(scene, config, tiles_y=k,
                                         row0=b * k, fine_impl=impl,
                                         interpret=interpret)
                return img, {kk: jnp.asarray(v) for kk, v in stats.items()}

            imgs, stats = jax.lax.map(one, block_ids)
            # max_tile_cmds is a max across blocks; overflow counters sum.
            stats = {kk: (v.max() if kk == "max_tile_cmds" else v.sum()
                          ).reshape(1) for kk, v in stats.items()}
            return imgs, stats

        sharded = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=P(),                      # scene replicated
            out_specs=(P(axis, None, None), P(axis)),
            check_vma=False)
        return jax.jit(sharded)

    def shard_fn(scene: DeviceScene):
        scene = scene._replace(seg_pre=None)  # shard-local (see above)
        row0 = jax.lax.axis_index(axis) * rows
        img, stats = render_slab(scene, config, tiles_y=rows, row0=row0,
                                 fine_impl=impl, interpret=interpret)
        # Scalars -> (1,) so the stacked per-device stats shard over `axis`.
        stats = {k: jnp.asarray(v).reshape(1) for k, v in stats.items()}
        return img, stats

    # check_vma=False: the fine interpreter's lax.switch has branches that
    # pass state through untouched, which trips the varying-axes analysis
    # (pass-through outputs look replicated, computed ones look varying).
    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=P(),                      # scene replicated
        out_specs=(P(axis, None), P(axis)),
        check_vma=False)

    return jax.jit(sharded)


class ShardedRenderer:
    """Multi-chip renderer over a 1D device mesh.

    Usage:
        mesh = jax.make_mesh((len(jax.devices()),), ("y",))
        r = ShardedRenderer(config, mesh)
        image = r.render(scene)      # (H, W, 4) uint8, gathered to host
    """

    def __init__(self, config: RenderConfig, mesh: Mesh,
                 fine_impl: str = "auto", interleave: int = 1,
                 interpret: bool = False):
        self.config = config
        self.mesh = mesh
        self.interleave = interleave
        self._render = make_sharded_render_fn(config, mesh, fine_impl,
                                              interleave, interpret)
        self._scene_sharding = NamedSharding(mesh, P())
        self.last_stats: Optional[Dict] = None

    def render_u32(self, scene) -> jax.Array:
        dev = prepare_scene(scene, self.config, seg_pre=False)
        dev = jax.device_put(dev, self._scene_sharding)
        img, stats = self._render(dev)
        self.last_stats = {k: np.asarray(v) for k, v in stats.items()}
        self._check_capacity()
        return img

    def render(self, scene) -> np.ndarray:
        img = np.ascontiguousarray(np.asarray(self.render_u32(scene)))
        if self.interleave > 1:
            # (N*B, kh, W) device-major row blocks -> global block g sits
            # at (d=g%N, i=g//N), i.e. stacked order is (d, i); reorder to
            # (i, d) = global order, then flatten rows.
            ndev = self.mesh.shape[self.mesh.axis_names[0]]
            nb, kh, w = img.shape
            img = (img.reshape(ndev, nb // ndev, kh, w)
                   .transpose(1, 0, 2, 3).reshape(nb * kh, w))
        return img.view(np.uint8).reshape(
            self.config.padded_height, self.config.padded_width,
            4)[:self.config.height, :self.config.width]

    def _check_capacity(self) -> None:
        from ..renderer.renderer import SceneCapacityError
        s = self.last_stats
        for k in ("seg_overflow", "hit_overflow", "cand_overflow",
                  "delta_overflow", "overflow_cmds"):
            if int(s[k].sum()) > 0:
                raise SceneCapacityError(
                    f"coarse capacity exceeded on some device: {k}="
                    f"{s[k].tolist()}; raise the RenderConfig limit")
