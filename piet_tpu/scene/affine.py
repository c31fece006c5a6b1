"""Device-side affine animation for ARBITRARY scenes (round 5).

``scene/animate.py`` answers the reference's
static-scene 60 Hz loop for the animated FIXTURE (its geometry is a
closed-form function of ``t``), but the reference's scene model is
arbitrary -- any encoded scene can be re-encoded under a new transform
(src/lib.rs:286-328 applies ``Affine::scale(8.0)`` at encode time;
PietRenderer.m:105-146,203-205 re-runs the encode).  This module makes
that a DEVICE capability: stage any scene once, then render frames under
per-item affine transforms computed inside the jit from scalar ``t`` --
zero host encode per frame, for any scene.

A transform is a per-item row ``[a, b, c, d, e, f]``:

    x' = a*x + b*y + e        y' = c*x + d*y + f

applied to every geometry field that depends on coordinates:

* points      -- gathered per-item rows, transformed in one vector pass;
* bboxes      -- recomputed EXACTLY as the builder would (segment
                 min/max over the item's transformed points, stroke
                 items inflated by width/2, then the u16 floor/ceil
                 quantization of scene.quantize_bbox); point-free items
                 (circles) transform their staged bbox corners instead;
* grads       -- gradient geometry is remapped analytically: a linear
                 brush's plane equation composes with the INVERSE
                 affine; a radial brush's center maps through the
                 affine and its 1/r scales by 1/sqrt(|det|) (exact for
                 similarity transforms -- rotation+uniform-scale+
                 translation; non-uniform scales would need an
                 elliptical brush, which the 2-stop model cannot
                 represent);
* clips       -- rect clips map to the bounding rect of their
                 transformed corners: exact for axis-preserving
                 transforms, conservative otherwise (use clip GROUPS --
                 path clips -- for exact transformed clipping).

Stroke widths are left untouched (device-space widths, the piet stroke
model); scale-aware widths can ride a per-item width multiplier staged
by the caller.

Determinism: the transform is mul/add only (exactly rounded), so
a frame is a pure deterministic function of (scene, mats); exactness of
the RENDER of a transformed frame is pinned by pulling the
device-computed arrays and rendering them through the numpy oracle
(tests/test_affine.py), the same contract as scene/animate.py.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .scene import TAG_CIRCLE, TAG_LINE, TAG_POLY


class AffineBase(NamedTuple):
    """Static staging for affine animation (built once per scene)."""
    point_item: jax.Array   # (NP,) int32 point slot -> item (NI = dead)
    has_pts: jax.Array      # (NI,) bool item derives its bbox from points
    inflate: jax.Array      # (NI,) f32 bbox inflation (width/2 on strokes)
    corners: jax.Array      # (NI, 4, 2) f32 staged bbox corners (circles)
    is_grad_lin: jax.Array  # (NI,) bool
    is_grad_rad: jax.Array  # (NI,) bool


def identity_mats(n: int) -> np.ndarray:
    m = np.zeros((n, 6), np.float32)
    m[:, 0] = 1.0
    m[:, 3] = 1.0
    return m


def rotation_about(cx: float, cy: float, angle, scale=1.0):
    """(6,) affine rotating by ``angle`` (traced OK) about (cx, cy) with
    uniform ``scale`` -- a convenience for the common spin/zoom demo."""
    ca = jnp.cos(angle) * scale
    sa = jnp.sin(angle) * scale
    e = cx - ca * cx + sa * cy
    f = cy - sa * cx - ca * cy
    return jnp.stack([ca, -sa, sa, ca, e, f])


def build_base(scene, config) -> AffineBase:
    """Stage the t-independent affine-animation arrays for ``scene``
    under ``config``'s capacity padding."""
    from .scene import (FLAG_BRUSH_LINEAR, FLAG_BRUSH_RADIAL)

    NI, NP = config.max_items, config.max_points
    ni = scene.n_items
    point_item = np.full(NP, NI, np.int32)
    for i in range(ni):
        o, n = int(scene.pt_offset[i]), int(scene.n_pts[i])
        point_item[o:o + n] = i
    tags = np.zeros(NI, scene.tags.dtype)
    tags[:ni] = scene.tags
    n_pts = np.zeros(NI, np.int32)
    n_pts[:ni] = scene.n_pts
    widths = np.zeros(NI, np.float32)
    widths[:ni] = scene.widths
    flags = np.zeros(NI, np.uint32)
    flags[:ni] = scene.flags
    bb = np.zeros((NI, 4), np.float32)
    bb[:ni] = scene.bboxes.astype(np.float32)
    corners = np.stack([bb[:, [0, 1]], bb[:, [2, 1]],
                        bb[:, [0, 3]], bb[:, [2, 3]]], axis=1)
    is_stroke = (tags == TAG_POLY) | (tags == TAG_LINE)
    inflate = np.where(is_stroke,
                       widths.astype(np.float32) * np.float32(0.5),
                       np.float32(0.0))
    return AffineBase(
        point_item=jnp.asarray(point_item),
        has_pts=jnp.asarray((n_pts > 0) & (tags != TAG_CIRCLE)),
        inflate=jnp.asarray(inflate.astype(np.float32)),
        corners=jnp.asarray(corners.astype(np.float32)),
        is_grad_lin=jnp.asarray((flags & FLAG_BRUSH_LINEAR) != 0),
        is_grad_rad=jnp.asarray((flags & FLAG_BRUSH_RADIAL) != 0),
    )


def _quantize_bbox(mn, mx):
    """scene.quantize_bbox semantics: floor mins / ceil maxes, clamp to
    [0, 65535] (src/lib.rs:88-97)."""
    lo = jnp.clip(jnp.floor(mn), 0.0, 65535.0).astype(jnp.int32)
    hi = jnp.clip(jnp.ceil(mx), 0.0, 65535.0).astype(jnp.int32)
    return lo, hi


def transform_device_scene(dev, ab: AffineBase, mats):
    """Apply per-item affines to a staged DeviceScene (traceable).

    Args:
      dev: prepare_scene(...) output (the staged base scene).
      ab: build_base(...) output.
      mats: (NI, 6) f32 per-item [a, b, c, d, e, f], or (6,) applied to
        every item.

    Returns a DeviceScene for the transformed frame.
    """
    NI = dev.tags.shape[0]
    mats = jnp.asarray(mats, jnp.float32)
    if mats.ndim == 1:
        mats = jnp.broadcast_to(mats[None, :], (NI, 6))

    # ---- points ------------------------------------------------------
    A = mats[jnp.minimum(ab.point_item, NI - 1)]      # (NP, 6)
    live = (ab.point_item < NI)[:, None]
    x = dev.points[:, 0]
    y = dev.points[:, 1]
    nx = (A[:, 0] * x + A[:, 1] * y) + A[:, 4]
    ny = (A[:, 2] * x + A[:, 3] * y) + A[:, 5]
    points = jnp.where(live, jnp.stack([nx, ny], axis=1), dev.points)

    # ---- bboxes ------------------------------------------------------
    seg = jnp.where(ab.point_item < NI, ab.point_item, NI)
    big = jnp.float32(3.4e38)
    mnx = jax.ops.segment_min(jnp.where(seg < NI, nx, big), seg,
                              num_segments=NI + 1)[:NI]
    mny = jax.ops.segment_min(jnp.where(seg < NI, ny, big), seg,
                              num_segments=NI + 1)[:NI]
    mxx = jax.ops.segment_max(jnp.where(seg < NI, nx, -big), seg,
                              num_segments=NI + 1)[:NI]
    mxy = jax.ops.segment_max(jnp.where(seg < NI, ny, -big), seg,
                              num_segments=NI + 1)[:NI]
    # Point-free items (circles): transform the staged bbox corners.
    cx = (mats[:, 0, None] * ab.corners[:, :, 0]
          + mats[:, 1, None] * ab.corners[:, :, 1]) + mats[:, 4, None]
    cy = (mats[:, 2, None] * ab.corners[:, :, 0]
          + mats[:, 3, None] * ab.corners[:, :, 1]) + mats[:, 5, None]
    mnx = jnp.where(ab.has_pts, mnx, cx.min(axis=1))
    mny = jnp.where(ab.has_pts, mny, cy.min(axis=1))
    mxx = jnp.where(ab.has_pts, mxx, cx.max(axis=1))
    mxy = jnp.where(ab.has_pts, mxy, cy.max(axis=1))
    lo_x, hi_x = (jnp.clip(jnp.floor(mnx - ab.inflate), 0.0, 65535.0),
                  jnp.clip(jnp.ceil(mxx + ab.inflate), 0.0, 65535.0))
    lo_y, hi_y = (jnp.clip(jnp.floor(mny - ab.inflate), 0.0, 65535.0),
                  jnp.clip(jnp.ceil(mxy + ab.inflate), 0.0, 65535.0))
    bboxes = jnp.stack([lo_x, lo_y, hi_x, hi_y],
                       axis=1).astype(jnp.int32)

    # ---- rect clips (bounding rect of transformed corners) -----------
    ccx0, ccy0 = dev.clips[:, 0], dev.clips[:, 1]
    ccx1, ccy1 = dev.clips[:, 2], dev.clips[:, 3]
    kx = jnp.stack([ccx0, ccx1, ccx0, ccx1], axis=1)
    ky = jnp.stack([ccy0, ccy0, ccy1, ccy1], axis=1)
    tkx = (mats[:, 0, None] * kx + mats[:, 1, None] * ky) + mats[:, 4, None]
    tky = (mats[:, 2, None] * kx + mats[:, 3, None] * ky) + mats[:, 5, None]
    # The NO_CLIP sentinel rect must stay the sentinel bitwise (its
    # coverage multiply is an exact *1.0): only remap real clip rects.
    has_clip = (ccx0 > -1e9) | (ccy0 > -1e9) | (ccx1 < 1e9) | (ccy1 < 1e9)
    clips = jnp.where(
        has_clip[:, None],
        jnp.stack([tkx.min(1), tky.min(1), tkx.max(1), tky.max(1)], axis=1),
        dev.clips)

    # ---- gradient brushes --------------------------------------------
    a_, b_, c_, d_ = mats[:, 0], mats[:, 1], mats[:, 2], mats[:, 3]
    e_, f_ = mats[:, 4], mats[:, 5]
    det = a_ * d_ - b_ * c_
    safe = jnp.where(det != 0.0, det, 1.0)
    g = dev.grads
    # Linear: g'(p') = g(A^-1 (p' - T)) -- compose the plane equation
    # with the inverse affine.
    gx, gy, gofs = g[:, 0], g[:, 1], g[:, 2]
    ngx = (gx * d_ - gy * c_) / safe
    ngy = (gy * a_ - gx * b_) / safe
    ngofs = gofs - (ngx * e_ + ngy * f_)
    # Radial: center through the affine; 1/r by 1/sqrt(|det|).
    rcx, rcy, rinv = g[:, 0], g[:, 1], g[:, 2]
    nrcx = (a_ * rcx + b_ * rcy) + e_
    nrcy = (c_ * rcx + d_ * rcy) + f_
    nrinv = rinv / jnp.sqrt(jnp.abs(safe))
    g0 = jnp.where(ab.is_grad_lin, ngx, jnp.where(ab.is_grad_rad, nrcx,
                                                  g[:, 0]))
    g1 = jnp.where(ab.is_grad_lin, ngy, jnp.where(ab.is_grad_rad, nrcy,
                                                  g[:, 1]))
    g2 = jnp.where(ab.is_grad_lin, ngofs, jnp.where(ab.is_grad_rad, nrinv,
                                                    g[:, 2]))
    grads = g.at[:, 0].set(g0).at[:, 1].set(g1).at[:, 2].set(g2)

    return dev._replace(points=points, bboxes=bboxes, clips=clips,
                        grads=grads, seg_pre=None)


def host_transform_scene(scene, m):
    """Numpy twin of ``transform_device_scene`` for ONE global affine
    ``m`` (6,) -- used to fit capacity ENVELOPES over a t sweep (record
    counts change with the transform) and by tests.  Transforms points,
    recomputes quantized bboxes (with stroke inflation), and remaps rect
    clips; gradient payloads are irrelevant to capacity fitting and are
    left untouched."""
    import dataclasses

    m = np.asarray(m, np.float32)
    x, y = scene.points[:, 0], scene.points[:, 1]
    nx = (m[0] * x + m[1] * y) + m[4]
    ny = (m[2] * x + m[3] * y) + m[5]
    points = np.stack([nx, ny], axis=1).astype(np.float32)
    n = scene.n_items
    bboxes = scene.bboxes.copy()
    is_stroke = (scene.tags == TAG_POLY) | (scene.tags == TAG_LINE)
    for i in range(n):
        o, k = int(scene.pt_offset[i]), int(scene.n_pts[i])
        if k > 0 and scene.tags[i] != TAG_CIRCLE:
            mn = points[o:o + k].min(0)
            mx = points[o:o + k].max(0)
        else:
            bb = scene.bboxes[i].astype(np.float32)
            cx = (m[0] * bb[[0, 2, 0, 2]] + m[1] * bb[[1, 1, 3, 3]]) + m[4]
            cy = (m[2] * bb[[0, 2, 0, 2]] + m[3] * bb[[1, 1, 3, 3]]) + m[5]
            mn = np.array([cx.min(), cy.min()])
            mx = np.array([cx.max(), cy.max()])
        infl = 0.5 * float(scene.widths[i]) if is_stroke[i] else 0.0
        bboxes[i] = [
            int(np.clip(np.floor(mn[0] - infl), 0, 65535)),
            int(np.clip(np.floor(mn[1] - infl), 0, 65535)),
            int(np.clip(np.ceil(mx[0] + infl), 0, 65535)),
            int(np.clip(np.ceil(mx[1] + infl), 0, 65535))]
    return dataclasses.replace(scene, points=points, bboxes=bboxes)


def make_affine_render_fn(config, scene, mats_fn: Callable,
                          fine_impl: str = "auto",
                          interpret: bool = False):
    """Jitted ``t -> (image_u32, stats)`` rendering ``scene`` under
    ``mats_fn(t)`` (returning (NI, 6) or (6,) affines) -- geometry
    transform, coarse, fine, and present all in ONE device dispatch.

    The answer to the reference's re-encode-then-render loop
    (PietRenderer.m:105-146): the scene is staged once; a frame costs
    one dispatch with one f32 argument.
    """
    from ..renderer.renderer import make_render_fn, prepare_scene

    base = prepare_scene(scene, config, seg_pre=False)
    ab = build_base(scene, config)
    render = make_render_fn(config, interpret=interpret,
                            fine_impl=fine_impl)

    @jax.jit
    def render_t(t):
        dev = transform_device_scene(base, ab, mats_fn(jnp.float32(t)))
        return render(dev)

    return render_t
