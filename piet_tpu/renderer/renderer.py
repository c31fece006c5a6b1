"""Host orchestration: one-jit scene rendering.

The equivalent of the reference's ``PietRenderer``
(TestApp/PietRenderer.m): where the reference encodes a scene into shared
memory and dispatches three GPU passes per frame (tileKernel -> renderKernel
-> present, PietRenderer.m:59-103), piet-tpu stages the scene as padded SoA
device arrays and runs coarse binning + fine rasterization + solid-tile
composite inside a SINGLE ``jax.jit`` step -- XLA sees the whole frame.

The present pass (reference C11: point sprites painting fully-solid tiles,
PietRender.metal:16-44) is fused into the fine kernel's empty-tile path on
the GPU route, and is a ``jnp.where`` composite on the portable XLA
route.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..ops.coarse import DeviceScene, coarse_rasterize
from ..ops.fine import fine_rasterize_entries
from ..ops.fine_xla import fine_rasterize_xla
from ..ops.pairing import pair_mode_from_env
from ..scene.color import decode_color_linear
from ..scene.scene import Scene


class SceneCapacityError(ValueError):
    pass


def _check_fits(scene: Scene, config: RenderConfig) -> None:
    """Host-side capacity checks of a scene about to be staged."""
    ni, np_ = scene.n_items, scene.n_points
    if ni > config.max_items:
        raise SceneCapacityError(f"{ni} items > max_items {config.max_items}")
    if np_ > config.max_points:
        raise SceneCapacityError(
            f"{np_} points > max_points {config.max_points}")
    if scene.group_depth > config.max_group_depth:
        raise SceneCapacityError(
            f"groups nest {scene.group_depth} deep > max_group_depth "
            f"{config.max_group_depth}")


def prepare_scene(scene: Scene, config: RenderConfig,
                  seg_pre: bool = True) -> DeviceScene:
    """Pad an SoA scene into device arrays (capacity-bucketed, so the
    compiled executable is reused across scenes/frames -- the reference
    re-encodes into a fixed 16 MiB buffer for the same reason,
    PietRenderer.m:52-53).

    ``seg_pre=True`` also stages the host-precomputed segment stage
    (renderer/segstage.py) -- bitwise-identical to the device derivation
    and skipped per frame; pass False for paths that mutate geometry on
    device (animation) or render shard-local windows."""
    _check_fits(scene, config)
    ni = scene.n_items

    def pad(arr, n, fill=0):
        out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
        out[:arr.shape[0]] = arr
        return out

    pre = None
    if seg_pre:
        from .segstage import build_seg_pre
        pre = jax.tree.map(jnp.asarray, build_seg_pre(scene, config))

    colors_lin = decode_color_linear(scene.colors)  # host-side decode: the
    # CPU oracle and device kernels must agree bit-for-bit on operand values
    # (pow differs across backends; see tests/test_fine.py).
    return DeviceScene(
        seg_pre=pre,
        tags=jnp.asarray(pad(scene.tags, config.max_items)),
        colors_u32=jnp.asarray(pad(scene.colors, config.max_items)),
        colors_lin=jnp.asarray(pad(colors_lin, config.max_items)),
        widths=jnp.asarray(pad(scene.widths, config.max_items)),
        bboxes=jnp.asarray(pad(scene.bboxes, config.max_items)),
        pt_offset=jnp.asarray(pad(scene.pt_offset, config.max_items)),
        n_pts=jnp.asarray(pad(scene.n_pts, config.max_items)),
        points=jnp.asarray(pad(scene.points, config.max_points)),
        flags=jnp.asarray(pad(scene.flags, config.max_items)),
        clips=jnp.asarray(pad(scene.clips, config.max_items)),
        grads=jnp.asarray(pad(scene.grads, config.max_items)),
        n_items=jnp.int32(ni),
    )


def pack_scene(scene: Scene, config: RenderConfig) -> np.ndarray:
    """Pack a scene into ONE flat uint32 staging buffer (padded to the
    config's capacity buckets).

    The per-frame re-encode path pays one host->device transfer per
    DeviceScene leaf (10 of them) if staged with prepare_scene; one buffer
    pays one.  This is the analog of the reference's single shared scene
    buffer (PietRenderer.m:52-53):
    everything rides one buffer, sliced apart on device inside the jit
    (unpack_scene -- free at compile time, the slices are static)."""
    _check_fits(scene, config)
    ni = scene.n_items
    NI, NP = config.max_items, config.max_points
    colors_lin = decode_color_linear(scene.colors)

    def pad_u32(arr, n):
        flat = np.ascontiguousarray(arr).view(np.uint32).reshape(
            arr.shape[0], -1)
        out = np.zeros((n, flat.shape[1]), np.uint32)
        out[:flat.shape[0]] = flat
        return out.reshape(-1)

    return np.concatenate([
        pad_u32(scene.tags, NI), pad_u32(scene.colors, NI),
        pad_u32(colors_lin, NI), pad_u32(scene.widths, NI),
        pad_u32(scene.bboxes, NI), pad_u32(scene.pt_offset, NI),
        pad_u32(scene.n_pts, NI), pad_u32(scene.flags, NI),
        pad_u32(scene.clips, NI), pad_u32(scene.grads, NI),
        pad_u32(scene.points, NP),
        np.array([ni], np.uint32)])


def unpack_scene(buf: jax.Array, config: RenderConfig) -> DeviceScene:
    """Slice a packed staging buffer back into a DeviceScene (traceable;
    static offsets, so XLA sees bitcasts of buffer views)."""
    NI, NP = config.max_items, config.max_points
    widths = [NI, NI, 4 * NI, NI, 4 * NI, NI, NI, NI, 4 * NI, 8 * NI,
              2 * NP, 1]
    parts = []
    off = 0
    for w in widths:
        parts.append(buf[off:off + w])
        off += w
    f32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.float32)  # noqa: E731
    i32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)  # noqa: E731
    return DeviceScene(
        tags=i32(parts[0]),
        colors_u32=parts[1],
        colors_lin=f32(parts[2]).reshape(NI, 4),
        widths=f32(parts[3]),
        bboxes=i32(parts[4]).reshape(NI, 4),
        pt_offset=i32(parts[5]),
        n_pts=i32(parts[6]),
        flags=parts[7],
        clips=f32(parts[8]).reshape(NI, 4),
        grads=f32(parts[9]).reshape(NI, 8),
        points=f32(parts[10]).reshape(NP, 2),
        n_items=i32(parts[11])[0],
    )


def _solid_to_present_u32(solid: jax.Array) -> jax.Array:
    """Logical 0xRRGGBBAA -> packed framebuffer u32 (R in low byte), i.e.
    the raw sRGB bytes the present fast path writes (PietRender.metal:34-44).
    """
    r = (solid >> 24) & 0xFF
    g = (solid >> 16) & 0xFF
    b = (solid >> 8) & 0xFF
    a = solid & 0xFF
    return r | (g << 8) | (b << 16) | (a << 24)


def _resolve_fine_impl(fine_impl: str) -> str:
    """"auto" -> the Pallas GPU kernel on a GPU, the XLA interpreter
    elsewhere."""
    if fine_impl != "auto":
        return fine_impl
    return "pallas" if jax.default_backend() == "gpu" else "xla"


def render_slab(scene: DeviceScene, config: RenderConfig, *, tiles_y: int,
                row0, fine_impl: str, interpret: bool = False):
    """Coarse + fine + present for a horizontal slab of ``tiles_y`` tile
    rows starting at ``row0`` (the whole viewport when row0=0 and
    tiles_y=config.tiles_y).  Returns (slab_image_u32, stats) where the
    image covers the slab's padded pixels.  The building block shared by
    the single-chip renderer and the row-sharded multi-chip path
    (parallel/sharding.py)."""
    tiles_x = config.tiles_x
    base_kw = dict(
        tiles_x=tiles_x, tiles_y=tiles_y, tile_w=config.tile_width,
        tile_h=config.tile_height, cmd_capacity=config.cmd_capacity,
        max_segments=config.max_segments, max_hits=config.max_hits,
        max_candidates=config.max_candidates,
        max_deltas=config.max_deltas, row0=row0,
        # Entry pairing (ops/pairing.py): PIET_PAIR in {0, 1, hole}
        # (0 = off, 1 = merge + compact, hole = merge + in-place no-op
        # seconds).  Default "off".
        pair=pair_mode_from_env())
    if fine_impl == "xla":
        # Portable path: dense (T, CAP) PTCL + pure-XLA interpreter.
        coarse = coarse_rasterize(scene, **base_kw)
        counts2d = coarse.counts.reshape(tiles_y, tiles_x)
        fine = fine_rasterize_xla(
            counts2d, coarse.tags, coarse.args, row0,
            tile_h=config.tile_height, tile_w=config.tile_width,
            cmd_capacity=config.cmd_capacity)
        overflow_cmds = coarse.overflow.sum()
    else:
        # GPU path: entry-stream PTCL (no scatter, no per-tile capacity --
        # see ops/coarse.py::CoarseEntries).  The present composite is
        # fused into the kernel's empty-tile path.
        coarse = coarse_rasterize(scene, output="entries", **base_kw)
        img = fine_rasterize_entries(
            coarse.first, coarse.n_entries,
            _solid_to_present_u32(coarse.solid), coarse.stream, row0,
            tile_h=config.tile_height, tile_w=config.tile_width,
            tiles_x=tiles_x, group_depth=config.max_group_depth,
            interpret=interpret)
        bail2d = coarse.solid.reshape(tiles_y, tiles_x) != 0
        stats = {
            "max_tile_cmds": coarse.counts.max(),
            "overflow_cmds": jnp.int32(0),
            "bail_tiles": bail2d.sum(),
            **coarse.diag,
        }
        return img, stats
    # Present composite: bailed tiles take their solid color bytes
    # (reference present fast path, PietRender.metal:34-44).
    solid2d = coarse.solid.reshape(tiles_y, tiles_x)
    bail2d = solid2d != 0
    present = _solid_to_present_u32(solid2d)
    bail_px = jnp.repeat(jnp.repeat(bail2d, config.tile_height, axis=0),
                         config.tile_width, axis=1)
    present_px = jnp.repeat(
        jnp.repeat(present, config.tile_height, axis=0),
        config.tile_width, axis=1)
    img = jnp.where(bail_px, present_px, fine)
    stats = {
        "max_tile_cmds": coarse.counts.max(),
        "overflow_cmds": overflow_cmds,
        "bail_tiles": bail2d.sum(),
        # Fine-stage work unit of the dense path (commands interpreted
        # post-bail); the entries path reports live_entries.
        "live_cmds": coarse.counts.sum(),
        **coarse.diag,
    }
    return img, stats


def make_render_fn(config: RenderConfig, interpret: bool = False,
                   fine_impl: str = "auto"):
    """Build the jitted render step: DeviceScene -> (image_u32, stats).

    image_u32 is (height, width) uint32 packed RGBA8 (R low byte).

    fine_impl: "pallas" (the GPU kernel, ops/fine.py), "xla" (portable
    pure-XLA path over the dense PTCL), or "auto" (see _resolve_fine_impl).
    ``interpret=True`` runs the Pallas kernel in interpret mode (CPU
    tests).
    """
    tiles_x, tiles_y = config.tiles_x, config.tiles_y
    fine_impl = _resolve_fine_impl(fine_impl)

    @jax.jit
    def render(scene: DeviceScene):
        img, stats = render_slab(scene, config, tiles_y=tiles_y, row0=0,
                                 fine_impl=fine_impl, interpret=interpret)
        return img[:config.height, :config.width], stats

    return render


def make_render_sequence_fn(config: RenderConfig, interpret: bool = False,
                            fine_impl: str = "auto"):
    """Build a jitted multi-frame render step: stacked DeviceScene (leading
    frame axis on every leaf) -> (N, H, W) uint32 images.

    Frames run sequentially inside ONE dispatch (lax.map), so per-frame
    host/dispatch overhead is amortized -- the analog of the reference's
    free-running 60 Hz redraw loop (PietRenderer.m:59-103) for animation
    workloads where every frame re-encodes the scene (BASELINE config 5).
    """
    tiles_x, tiles_y = config.tiles_x, config.tiles_y
    impl = _resolve_fine_impl(fine_impl)

    @jax.jit
    def render_seq(scenes: DeviceScene):
        def one(scene):
            img, stats = render_slab(scene, config, tiles_y=tiles_y, row0=0,
                                     fine_impl=impl, interpret=interpret)
            return img[:config.height, :config.width], stats

        return jax.lax.map(one, scenes)

    return render_seq


def stack_scenes(scenes, config: RenderConfig) -> DeviceScene:
    """Stage a list of scenes as one stacked DeviceScene (frame axis 0)."""
    prepared = [prepare_scene(s, config) for s in scenes]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *prepared)


class Renderer:
    """User-facing renderer: holds a config and its compiled render step.

    Usage:
        r = Renderer(RenderConfig(width=1024, height=1024))
        image = r.render(scene)          # (H, W, 4) uint8 RGBA
    """

    def __init__(self, config: RenderConfig, interpret: bool = False,
                 fine_impl: str = "auto"):
        self.config = config
        self._fine_impl = fine_impl
        self._interpret = interpret
        self._render = make_render_fn(config, interpret=interpret,
                                      fine_impl=fine_impl)
        self.last_stats: Optional[Dict] = None

    @classmethod
    def for_scene(cls, scene, width: int, height: int,
                  fine_impl: str = "auto", bucket: bool = True,
                  interpret: bool = False, **config_kw) -> "Renderer":
        """Renderer with record capacities fitted to ``scene`` (see
        renderer/capacity.py; bucket=True leaves headroom for animation)."""
        from .capacity import fit_capacities
        base = RenderConfig(width=width, height=height, **config_kw)
        return cls(fit_capacities(scene, base, bucket=bucket),
                   interpret=interpret, fine_impl=fine_impl)

    def packed_render_fn(self):
        """The jitted packed-buffer render step (buf_u32) -> (img, stats).
        Frames dispatched through it do NOT sync on stats -- callers doing
        multi-frame loops should check capacity once at the end (see
        cli.py::cmd_bench --reencode)."""
        if not hasattr(self, "_render_packed"):
            cfg, interp = self.config, self._interpret
            impl = self._fine_impl

            @jax.jit
            def render_packed(buf):
                scene_dev = unpack_scene(buf, cfg)
                img, stats = render_slab(
                    scene_dev, cfg, tiles_y=cfg.tiles_y, row0=0,
                    fine_impl=_resolve_fine_impl(impl), interpret=interp)
                return img[:cfg.height, :cfg.width], stats

            self._render_packed = render_packed
        return self._render_packed

    def render_packed_u32(self, scene: Scene) -> jax.Array:
        """Single-transfer render: pack the scene into one staging buffer
        on host (native-encode friendly), unpack + render in one jit.
        The per-frame re-encode fast path (see pack_scene)."""
        fn = self.packed_render_fn()
        img, stats = fn(jnp.asarray(pack_scene(scene, self.config)))
        self.last_stats = jax.tree.map(lambda x: np.asarray(x), stats)
        self._check_capacity(self.last_stats)
        return img

    def render_u32(self, scene: Scene) -> jax.Array:
        dev = prepare_scene(scene, self.config)
        self._staged_dev = dev  # partial-restage base (render_updated)
        img, stats = self._render(dev)
        self.last_stats = jax.tree.map(lambda x: np.asarray(x), stats)
        self._check_capacity(self.last_stats)
        return img

    def render(self, scene: Scene) -> np.ndarray:
        img = np.asarray(self.render_u32(scene))
        return img.view(np.uint8).reshape(self.config.height,
                                          self.config.width, 4)

    def render_sequence(self, scenes) -> np.ndarray:
        """Render N scenes in one device dispatch -> (N, H, W, 4) uint8.

        Per-frame stats land in ``last_stats`` (frame axis 0) and get the
        same overflow checks as the single-frame path -- a frame whose
        records exceed capacity raises instead of rendering corrupted
        pixels."""
        if not hasattr(self, "_render_seq"):
            self._render_seq = make_render_sequence_fn(
                self.config, interpret=self._interpret,
                fine_impl=self._fine_impl)
        stacked = stack_scenes(scenes, self.config)
        imgs_dev, stats = self._render_seq(stacked)
        imgs = np.ascontiguousarray(np.asarray(imgs_dev))
        self.last_stats = jax.tree.map(lambda x: np.asarray(x), stats)
        self._check_capacity(
            {k: v.sum() for k, v in self.last_stats.items()})
        return imgs.view(np.uint8).reshape(
            len(scenes), self.config.height, self.config.width, 4)

    #: DeviceScene fields eligible for partial restaging, keyed by the
    #: Scene attribute that sources them.
    _DYNAMIC_FIELDS = ("points", "colors", "bboxes", "widths", "grads",
                       "clips", "flags")

    def render_updated(self, scene: Scene,
                       fields=("points", "colors", "bboxes")) -> jax.Array:
        """Incremental re-render: restage ONLY ``fields`` of the staged
        scene (dirty-field update), reusing every other device array.

        The host-side analog of the reference's static-scene frame loop
        (PietRenderer.m:59-103 re-renders without re-encoding): an
        animation that mutates geometry/colors but not topology transfers
        points + colors + bboxes (~KBs) instead of the full wire buffer.
        Topology fields (tags, offsets, counts, n_items) must be
        unchanged since the last full render_u32/render call.  For
        fixture-style parametric animation prefer scene/animate.py, which
        moves even this transfer into the jit."""
        base = getattr(self, "_staged_dev", None)
        if base is None:
            return self.render_u32(scene)
        dev = base
        cfg = self.config

        def pad(arr, n):
            out = np.zeros((n,) + arr.shape[1:], arr.dtype)
            out[:arr.shape[0]] = arr
            return out

        geom_dirty = False
        for f in fields:
            if f not in self._DYNAMIC_FIELDS:
                raise ValueError(f"field {f!r} is not restageable")
            if f == "points":
                dev = dev._replace(points=jnp.asarray(
                    pad(scene.points, cfg.max_points)))
            elif f == "colors":
                from ..scene.color import decode_color_linear
                dev = dev._replace(
                    colors_u32=jnp.asarray(pad(scene.colors,
                                               cfg.max_items)),
                    colors_lin=jnp.asarray(pad(
                        decode_color_linear(scene.colors), cfg.max_items)))
            else:
                dev = dev._replace(**{f: jnp.asarray(
                    pad(getattr(scene, f), cfg.max_items))})
            geom_dirty |= f in ("points", "bboxes", "widths")
        if geom_dirty and dev.seg_pre is not None:
            # The precomputed segment stage depends on geometry: rebuild
            # it for the updated scene (host; the staged TOPOLOGY is
            # unchanged by contract, see the docstring).
            from .segstage import build_seg_pre
            dev = dev._replace(seg_pre=jax.tree.map(
                jnp.asarray, build_seg_pre(scene, cfg)))
        self._staged_dev = dev
        img, stats = self._render(dev)
        self.last_stats = jax.tree.map(lambda x: np.asarray(x), stats)
        self._check_capacity(self.last_stats)
        return img

    def _check_capacity(self, stats: Dict) -> None:
        for k in ("seg_overflow", "hit_overflow", "cand_overflow",
                  "delta_overflow"):
            if int(stats[k]) > 0:
                raise SceneCapacityError(
                    f"coarse capacity exceeded: {k}={int(stats[k])}; "
                    f"raise the corresponding RenderConfig limit")
        if int(stats["overflow_cmds"]) > 0:
            # Per-tile PTCL overflow: detected and reported (the reference
            # silently corrupts past 4096 B/tile, PietShaderTypes.h:24-27).
            raise SceneCapacityError(
                f"PTCL overflow: {int(stats['overflow_cmds'])} commands "
                f"dropped; raise RenderConfig.cmd_capacity")
