"""Device-side animation: per-frame geometry computed INSIDE the render jit.

The reference's per-frame path is GPU-only because its scene is static
(TestApp/PietRenderer.m:59-103; re-encode only on resize, :105-146), while
an animated scene re-encoded on the HOST pays encode + staging every
frame.  The fix here is not a faster host encoder but NO host encoder: the animated fixture's frame is a pure function of scalar ``t``
and a handful of seeded parameters, so stage the parameters once and
evaluate the geometry on device as the first stage of the jitted render
step.  Per-frame host work drops to dispatching one jit call with one
f32 argument.

The animated fixture (scene/fixtures.py::make_animated_frame): n items,
item i is a 12-gon of radius r/2 orbiting (centers[i], radii[i]) at
angular phase ``phases[i] + t * (1 + 0.2*(i%7))``; every third item is a
closed stroked polyline (width 2 + i%5), the rest are fills; alpha
oscillates as ``int(96 + 96 sin(t + phase))``.  Topology (tags, counts,
offsets, flags, clip/grad payloads) is t-independent, so it comes from a
host-built TEMPLATE scene staged once; this module recomputes only
points, bboxes, and colors.

Device trig (jnp.cos/sin) differs from libm in the last ulp, so device
frames are not bit-identical to host-built frames at the same ``t``; they
are deterministic in their own right (same t -> same image, any number of
runs).  Exactness of the RENDER of an animated frame is pinned by
rendering from the device-computed arrays through the oracle
(tests/test_animate.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp


class AnimatedParams(NamedTuple):
    """Static (t-independent) animation parameters, staged once."""
    centers: jax.Array    # (n, 2) f32
    radii: jax.Array      # (n,) f32
    phases: jax.Array     # (n,) f32
    speed: jax.Array      # (n,) f32: 1 + 0.2*(i % 7)
    color_hi: jax.Array   # (n,) uint32: rgb << 8
    is_poly: jax.Array    # (n,) bool: every third item strokes
    half_width: jax.Array  # (n,) f32: bbox inflation (width/2; 0 for fills)
    slot_item: jax.Array  # (NP,) int32: flat point slot -> item
    slot_vert: jax.Array  # (NP,) int32: flat point slot -> vertex (mod 12)
    n_live_points: int    # static: total live points


K_VERTS = 12


def host_params(size: int = 1024, n: int = 200, seed: int = 5
                ) -> AnimatedParams:
    """Build the staged parameter arrays (same seeded draws, in the same
    numpy call order, as make_animated_frame / _animated_params)."""
    from .fixtures import _animated_params

    centers, radii, phases, color_hi = _animated_params(size, n, seed)
    idx = np.arange(n)
    speed = (1.0 + 0.2 * (idx % 7)).astype(np.float32)
    is_poly = (idx % 3) == 0
    width = np.where(is_poly, 2.0 + (idx % 5), 0.0).astype(np.float32)
    # f32 width * f32 0.5, matching SceneBuilder.polyline's host math.
    half_width = (width.astype(np.float32) * np.float32(0.5))

    # Flat point layout: item i owns n_pts[i] consecutive slots (polys
    # carry the closing 13th vertex == vertex 0, builder's pts + [pts[0]]).
    n_pts = np.where(is_poly, K_VERTS + 1, K_VERTS)
    offsets = np.concatenate([[0], np.cumsum(n_pts)[:-1]])
    total = int(n_pts.sum())
    slot_item = np.repeat(idx, n_pts).astype(np.int32)
    slot_local = (np.arange(total) -
                  offsets[slot_item]).astype(np.int32)
    slot_vert = (slot_local % K_VERTS).astype(np.int32)

    return AnimatedParams(
        centers=jnp.asarray(centers.astype(np.float32)),
        radii=jnp.asarray(radii.astype(np.float32)),
        phases=jnp.asarray(phases.astype(np.float32)),
        speed=jnp.asarray(speed),
        color_hi=jnp.asarray(color_hi),
        is_poly=jnp.asarray(is_poly),
        half_width=jnp.asarray(half_width),
        slot_item=jnp.asarray(slot_item),
        slot_vert=jnp.asarray(slot_vert),
        n_live_points=total,
    )


def template_scene(size: int = 1024, n: int = 200, seed: int = 5):
    """The t=0 host-built frame: source of every t-independent scene
    field (tags, offsets, counts, flags, widths, clips, grads)."""
    from .fixtures import make_animated_frame
    return make_animated_frame(0.0, size=size, n=n, seed=seed)


def animate_device_scene(base, p: AnimatedParams, t):
    """Recompute the t-dependent fields of a staged DeviceScene.

    ``base`` is prepare_scene(template_scene(...), config); ``t`` is a
    traced f32 scalar.  Runs inside the render jit."""
    t = jnp.float32(t)
    n = p.centers.shape[0]
    th = p.phases + t * p.speed                      # (n,)
    r = p.radii
    ox = p.centers[:, 0] + jnp.cos(th) * r
    oy = p.centers[:, 1] + jnp.sin(th) * r
    j = jnp.arange(K_VERTS, dtype=jnp.float32) * jnp.float32(
        2.0 * math.pi / K_VERTS)
    ang = j[None, :] + th[:, None]                   # (n, 12)
    vx = ox[:, None] + jnp.cos(ang) * (r * 0.5)[:, None]
    vy = oy[:, None] + jnp.sin(ang) * (r * 0.5)[:, None]
    verts = jnp.stack([vx, vy], axis=-1)             # (n, 12, 2)

    pts = verts[p.slot_item, p.slot_vert]            # (NP_live, 2)
    points = base.points.at[:p.n_live_points].set(pts)

    # Bbox: min/max over the item's vertices, polyline inflation, then
    # the u16 quantization of scene.quantize_bbox (floor mins / ceil
    # maxes, clamp [0, 65535]).
    mn = verts.min(axis=1) - p.half_width[:, None]
    mx = verts.max(axis=1) + p.half_width[:, None]

    def q(v, up):
        v = jnp.ceil(v) if up else jnp.floor(v)
        return jnp.clip(v, 0.0, 65535.0).astype(jnp.int32)

    bbox = jnp.concatenate([q(mn, False), q(mx, True)], axis=1)
    bboxes = base.bboxes.at[:n].set(bbox)

    # Alpha: int(96 + 96 sin(t + phase)) & 0xFF -- value in [0, 192], so
    # Python's truncating int() == floor.
    alpha = jnp.floor(jnp.float32(96.0)
                      + jnp.float32(96.0) * jnp.sin(t + p.phases)
                      ).astype(jnp.int32).astype(jnp.uint32) & 0xFF
    colors_u32 = base.colors_u32.at[:n].set(p.color_hi | alpha)
    # Linear decode: rgb channels are t-independent (already in base);
    # alpha's linear value is code/255 (scene/color.py).
    alpha_lin = alpha.astype(jnp.float32) / jnp.float32(255.0)
    colors_lin = base.colors_lin.at[:n, 3].set(alpha_lin)

    return base._replace(points=points, bboxes=bboxes,
                         colors_u32=colors_u32, colors_lin=colors_lin,
                         seg_pre=None)


def make_animated_render_fn(config, *, size: int = 1024, n: int = 200,
                            seed: int = 5, fine_impl: str = "auto",
                            interpret: bool = False):
    """Jitted t -> (image_u32, stats) with the whole frame -- geometry,
    coarse, fine, present -- in ONE device dispatch.  Returns
    (render_fn, base_scene_template) so callers can capacity-check."""
    from ..renderer.renderer import (make_render_fn, prepare_scene)

    tmpl = template_scene(size=size, n=n, seed=seed)
    base = prepare_scene(tmpl, config, seg_pre=False)
    params = host_params(size=size, n=n, seed=seed)
    render = make_render_fn(config, interpret=interpret,
                            fine_impl=fine_impl)

    @jax.jit
    def render_t(t):
        scene = animate_device_scene(base, params, t)
        return render(scene)

    return render_t, tmpl
