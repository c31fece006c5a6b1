"""piet-style RenderContext (piet_tpu/api.py) + shape helpers.

Checks run through the CPU oracle rasterizer: the context compiles to a
plain Scene, whose device/oracle equality is covered elsewhere; here we
pin the API semantics -- transform stack, clip-until-restore, brush
transformation, shape conversion."""

import math

import numpy as np
import pytest

from piet_tpu.api import RenderContext
from piet_tpu.config import RenderConfig
from piet_tpu.geometry import Affine
from piet_tpu.geometry.shapes import (CirclePath, Ellipse, Line, Rect,
                                      RoundedRect)
from piet_tpu.raster.cpu_fine import cpu_render_scene
from piet_tpu.scene.scene import LinearGradient, RadialGradient

CFG = RenderConfig(width=128, height=128, tile_height=16, tile_width=128,
                   cmd_capacity=128)


def _render(ctx):
    return cpu_render_scene(ctx.finish(), CFG)


def test_fill_rect_and_default_state():
    ctx = RenderContext()
    ctx.fill(Rect(8.5, 8.5, 60.5, 60.5), 0xFF0000FF)
    img = _render(ctx)
    assert (img[30, 30][:3] == [255, 0, 0]).all()
    assert (img[100, 100][:3] == [255, 255, 255]).all()


def test_transform_stack_save_restore():
    ctx = RenderContext()
    ctx.save()
    ctx.transform(Affine.translate(64.0, 0.0))
    ctx.fill(Rect(0.5, 8.5, 30.5, 38.5), 0x00FF00FF)
    ctx.restore()
    ctx.fill(Rect(0.5, 64.5, 30.5, 94.5), 0x0000FFFF)  # untranslated
    img = _render(ctx)
    assert (img[20, 70][:3] == [0, 255, 0]).all()      # translated green
    assert (img[80, 10][:3] == [0, 0, 255]).all()      # untranslated blue
    assert (img[20, 10][:3] == [255, 255, 255]).all()


def test_restore_without_save_raises():
    ctx = RenderContext()
    with pytest.raises(ValueError, match="restore"):
        ctx.restore()
    ctx.save()
    with pytest.raises(ValueError, match="unmatched save"):
        ctx.finish()


def test_clip_until_restore():
    ctx = RenderContext()
    with ctx.clipped(Rect(0.5, 0.5, 64.5, 64.5)):
        ctx.fill(Rect(-10.0, -10.0, 200.0, 200.0), 0xFF0000FF)
    ctx.fill(Rect(80.5, 80.5, 110.5, 110.5), 0x0000FFFF)  # unclipped
    img = _render(ctx)
    assert (img[30, 30][:3] == [255, 0, 0]).all()    # inside clip
    assert (img[30, 100][:3] == [255, 255, 255]).all()  # clipped away
    assert (img[100, 100][:3] == [0, 0, 255]).all()  # after restore


def test_fill_with_hole_via_path():
    ctx = RenderContext()
    ring = Rect(8.5, 8.5, 119.5, 119.5).to_path()
    inner = Rect(40.5, 40.5, 87.5, 87.5).to_path()
    ring.elements.extend(inner.elements)
    ctx.fill(ring, 0x000000FF, even_odd=True)
    img = _render(ctx)
    assert (img[20, 20][:3] == [0, 0, 0]).all()
    assert (img[64, 64][:3] == [255, 255, 255]).all()  # real hole


def test_gradient_brush_transforms_with_shape():
    ctx = RenderContext()
    ctx.transform(Affine.translate(0.0, 64.0) * Affine.scale(0.5))
    # User-space vertical ramp over y 0..128 -> device y 64..128.
    ctx.fill(Rect(-2.0, -2.0, 258.0, 130.0),
             LinearGradient((0.0, 0.0), (0.0, 128.0),
                            0x000000FF, 0xFFFFFFFF))
    img = _render(ctx)
    col = img[:, 64, 0].astype(int)
    assert col[66] < 64 and col[126] > 215
    assert (np.diff(col[66:127]) >= 0).all()


def test_stroke_width_scales():
    ctx = RenderContext()
    ctx.transform(Affine.scale(4.0))
    ctx.stroke(Line((4.0, 8.0), (28.0, 8.0)), 0x000000FF, 2.0)
    scene = ctx.finish()
    assert float(scene.widths[0]) == pytest.approx(8.0)
    with pytest.raises(ValueError, match="gradient strokes"):
        RenderContext().stroke(Line((0, 0), (1, 1)),
                               RadialGradient((0, 0), 1, 0, 0), 1.0)


def test_shapes_render():
    ctx = RenderContext()
    ctx.fill(CirclePath((32.0, 32.0), 20.0), 0xFF0000FF)
    ctx.fill(Ellipse((96.0, 32.0), 24.0, 12.0), 0x00FF00FF)
    ctx.fill(RoundedRect(8.5, 72.5, 60.5, 119.5, 10.0), 0x0000FFFF)
    img = _render(ctx)
    assert (img[32, 32][:3] == [255, 0, 0]).all()
    assert (img[32, 96][:3] == [0, 255, 0]).all()
    assert (img[96, 30][:3] == [0, 0, 255]).all()
    # Rounded corner cut off.
    assert (img[74, 9][:3] == [255, 255, 255]).all()


def test_clear_paints_over():
    ctx = RenderContext()
    ctx.fill(Rect(8.5, 8.5, 119.5, 119.5), 0xFF0000FF)
    ctx.clear(0x102030FF)
    img = _render(ctx)
    assert (img[64, 64][:3] == [16, 32, 48]).all()


def test_device_matches_oracle_end_to_end():
    """One mixed-API scene through the real renderer (XLA path)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from piet_tpu.renderer.renderer import Renderer

    ctx = RenderContext()
    ctx.transform(Affine.rotate(math.radians(10.0))
                  * Affine.translate(10.0, -10.0))
    with ctx.clipped(CirclePath((64.0, 64.0), 56.0)):
        ctx.fill(Rect(-50.0, -50.0, 250.0, 250.0),
                 RadialGradient((64.0, 64.0), 70.0, 0xFFE000FF,
                                0x0030A0FF))
        ctx.stroke(Line((0.0, 20.0), (128.0, 100.0)), 0x000000FF, 3.0)
    ctx.fill(RoundedRect(70.5, 70.5, 120.5, 120.5, 8.0), 0x20C040FF)
    scene = ctx.finish()
    gold = cpu_render_scene(scene, CFG)
    img = Renderer(CFG, fine_impl="xla").render(scene)
    # XLA:CPU carries the documented FMA-contraction tolerance
    # (tests/_imgcmp.py); the GPU is bit-exact (test_gpu_exact.py).
    diff = np.abs(img.astype(int) - gold.astype(int))
    assert diff.max() <= 2 and (diff.max(axis=-1) > 0).mean() < 1e-3
