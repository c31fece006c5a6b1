"""Gradient brushes (2-stop linear/radial fill extension).

No reference analog (piet-metal encodes only solid colors,
src/lib.rs:177-207); the contract is piet's Brush semantics with the
project's oracle discipline: the device PTCL must match the CPU golden
tiler command-for-command, and rendered images must match the numpy
oracle (bitwise on the XLA CPU path for these scenes -- the gradient math
has no FMA-contraction-sensitive cancellations at demo scale).
"""

import numpy as np
import pytest

from piet_tpu.config import RenderConfig
from piet_tpu.raster.cpu_fine import cpu_render_scene
from piet_tpu.raster.cpu_tiler import cpu_tile_scene
from piet_tpu.raster.ptcl import CMD_DRAW_LIN_GRAD, CMD_DRAW_RAD_GRAD
from piet_tpu.scene.fixtures import make_gradient_demo
from piet_tpu.scene.scene import LinearGradient, RadialGradient, SceneBuilder

CFG = dict(width=256, height=256, tile_height=16, tile_width=128,
           cmd_capacity=256)


def _demo_cfg():
    return RenderConfig(**CFG)


def test_linear_params_affine_form():
    g = LinearGradient((10.0, 20.0), (10.0, 120.0), 0xFF0000FF, 0x0000FFFF)
    gx, gy, g0 = g.params3()
    # t(p0) == 0, t(p1) == 1 (up to f32 rounding).
    assert abs(gx * 10.0 + gy * 20.0 + g0) < 1e-6
    assert abs(gx * 10.0 + gy * 120.0 + g0 - 1.0) < 1e-6
    # Degenerate axis paints stop 0 (t == 0 everywhere).
    assert LinearGradient((5.0, 5.0), (5.0, 5.0), 0, 0).params3() == \
        (0.0, 0.0, 0.0)


def test_radial_params():
    g = RadialGradient((50.0, 60.0), 25.0, 0xFF0000FF, 0x0000FFFF)
    cx, cy, inv_r = g.params3()
    assert (cx, cy) == (50.0, 60.0)
    assert abs(inv_r * 25.0 - 1.0) < 1e-6
    assert RadialGradient((0, 0), 0.0, 0, 0).params3()[2] == 0.0


def test_builder_rejects_unsupported_combos():
    b = SceneBuilder()
    g = LinearGradient((0, 0), (0, 10), 0xFF0000FF, 0x00FF00FF)
    with pytest.raises(ValueError, match="nonzero winding"):
        b.fill([(0, 0), (10, 0), (5, 10)], g, even_odd=True)
    b.set_clip(0, 0, 5, 5)
    with pytest.raises(ValueError, match="rect clip"):
        b.fill([(0, 0), (10, 0), (5, 10)], g)


def test_wire_codec_roundtrips_gradients():
    # Round 3 gave extension items wire-format layouts; gradient fills
    # now round-trip (full coverage in tests/test_scene.py).
    import numpy as np
    from piet_tpu.scene.wire import decode_scene, encode_scene
    b = SceneBuilder()
    b.fill([(0, 0), (10, 0), (5, 10)],
           LinearGradient((0, 0), (0, 10), 0xFF0000FF, 0x00FF00FF))
    scene = b.build()
    back = decode_scene(encode_scene(scene))
    np.testing.assert_array_equal(scene.tags, back.tags)
    np.testing.assert_array_equal(scene.grads, back.grads)


def test_oracle_gradient_math_closed_form():
    """Pin the oracle's gradient evaluation against the closed form at a
    few pixels (linear ramp, radial distance), through the full pipeline
    scale: an untiled single-command evaluation."""
    size = 64
    b = SceneBuilder()
    b.fill([(-1.0, -1.0), (65.0, -1.0), (65.0, 65.0), (-1.0, 65.0)],
           LinearGradient((0.0, 0.0), (0.0, 64.0), 0x000000FF, 0xFFFFFFFF))
    cfg = RenderConfig(width=size, height=size, tile_height=16,
                       tile_width=128, cmd_capacity=128)
    img = cpu_render_scene(b.build(), cfg)
    # Vertical ramp: rows monotone nondecreasing, top ~black, bottom ~white.
    col = img[:, 32, 0].astype(int)
    assert col[0] <= 4 and col[-1] >= 251
    assert (np.diff(col) >= 0).all()
    # sRGB-encoded midpoint of the LINEAR ramp (t = 32.5/64 at pixel row
    # 32's center): linear 0.5078 -> sRGB code ~188.
    assert abs(col[32] - 188) <= 2


def test_coarse_commands_match_oracle():
    from tests.test_coarse import assert_ptcl_equal, run_coarse
    scene = make_gradient_demo(256)
    cfg = RenderConfig(max_items=64, max_points=1024, max_segments=1024,
                       max_hits=1 << 13, max_candidates=1 << 10,
                       max_deltas=1 << 10, **CFG)
    gold = cpu_tile_scene(scene, cfg)
    out = run_coarse(scene, cfg)
    # The demo must actually exercise both gradient kinds.
    gold_tags = gold.tags[gold.tags > 0]
    assert (gold_tags == CMD_DRAW_LIN_GRAD).sum() > 0
    assert (gold_tags == CMD_DRAW_RAD_GRAD).sum() > 0
    assert_ptcl_equal(out, gold, cfg)


def test_render_matches_oracle_xla():
    scene = make_gradient_demo(256)
    cfg = _demo_cfg()
    from piet_tpu.renderer.renderer import Renderer
    gold = cpu_render_scene(scene, cfg)
    img = Renderer(cfg, fine_impl="xla").render(scene)
    # Bit-exact up to XLA:CPU's FMA contraction (tests/_imgcmp.py);
    # strict on the card (tests/test_gpu_exact.py::test_gradient_scene).
    from tests._imgcmp import assert_images_match
    assert_images_match(img, gold)


def test_render_matches_oracle_entries():
    """The production entry-stream path (coarse entries output + the
    Pallas kernel in interpret mode), incl. the word-8 payload aliasing
    (entry_stream.py) and pairing coexistence."""
    scene = make_gradient_demo(256)
    cfg = _demo_cfg()
    from piet_tpu.renderer.renderer import Renderer
    gold = cpu_render_scene(scene, cfg)
    img = Renderer(cfg, fine_impl="pallas", interpret=True).render(scene)
    from tests._imgcmp import assert_images_match
    assert_images_match(img, gold)


def test_gradient_inside_clip_group():
    """Gradient draws still honor the clip-STACK coverage (the arbitrary
    path clip extension), despite carrying no rect clip."""
    b = SceneBuilder()
    tri = [(20.0, 20.0), (236.0, 40.0), (128.0, 236.0)]
    b.clip_path(tri)
    b.fill([(-1.0, -1.0), (257.0, -1.0), (257.0, 257.0), (-1.0, 257.0)],
           RadialGradient((128.0, 128.0), 140.0, 0xFF2000FF, 0x0020FFFF))
    b.pop()
    scene = b.build()
    cfg = _demo_cfg()
    from piet_tpu.renderer.renderer import Renderer
    gold = cpu_render_scene(scene, cfg)
    img = Renderer(cfg, fine_impl="pallas", interpret=True).render(scene)
    from tests._imgcmp import assert_images_match
    assert_images_match(img, gold)
    # Outside the clip triangle: background white.
    assert (img[250, 5] == [255, 255, 255, 255]).all()
    # Inside: gradient color, not white.
    assert (img[100, 128][:3] != [255, 255, 255]).any()
