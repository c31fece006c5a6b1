"""On-card exactness: the GPU fine kernel and the whole pipeline vs the
oracles.

The kernel's contraction barriers (ops/fine.py) and the structural
exactness of the shared math (ops/cmd_math.py) make the compiled path
bitwise equal to the numpy oracle and the C++ golden; these tests hold it
to that (tests/_imgcmp.py states the tolerance, zero).

Each test takes the ``gpu_device`` fixture and skips without a GPU.  On
the card, ``chip_smoke.py`` calls them in-process (one JAX process per
card).
"""

import math

import numpy as np
import pytest

from tests._imgcmp import assert_images_match_gpu

pytestmark = pytest.mark.gpu


def _render(scene, tile_h, tile_w, size):
    from piet_tpu.renderer.renderer import Renderer
    return Renderer.for_scene(scene, size, size, fine_impl="pallas",
                              tile_height=tile_h, tile_width=tile_w)


def test_fine_kernel_matches_golden(gpu_device):
    """The tiger through the kernel vs the C++ golden (16-row tiles)."""
    from piet_tpu import native
    from piet_tpu.scene import encode_scene
    from piet_tpu.scene.svg import make_tiger

    scene = make_tiger(scale=1.0)
    r = _render(scene, 16, 128, 224)
    img = r.render(scene)
    gold, overflow = native.render_golden(
        encode_scene(scene), 224, 224, tile_w=128, tile_h=16,
        cmd_capacity=r.config.cmd_capacity)
    assert overflow == 0
    assert_images_match_gpu(img, gold)


def test_full_renderer_32row_tiles(gpu_device):
    """Production tile geometry (32x128) vs the numpy oracle."""
    from piet_tpu.raster.cpu_fine import cpu_render_scene
    from piet_tpu.scene.svg import make_tiger

    scene = make_tiger(scale=1.2)
    r = _render(scene, 32, 128, 256)
    assert_images_match_gpu(r.render(scene), cpu_render_scene(scene,
                                                               r.config))


def test_clip_layer_scene(gpu_device):
    """Arbitrary-path clips + opacity layers (the scratch-plane stacks)."""
    from piet_tpu.raster.cpu_fine import cpu_render_scene
    from piet_tpu.scene.scene import SceneBuilder

    b = SceneBuilder()
    star = []
    for k in range(10):
        ang = -math.pi / 2 + k * math.pi / 5
        rad = 100 if k % 2 == 0 else 40
        star.append((127.5 + rad * math.cos(ang), 128 + rad * math.sin(ang)))
    b.clip_path(star)
    b.fill([(1, 1), (255, 1), (255, 255), (1, 255)], 0x2040C0FF)
    for i in range(8):
        b.stroke_line((1, i * 32), (256, i * 32 + 30), 3.0, 0xFF8000FF)
    b.push_layer(0.5)
    b.circle(128, 128, 60)
    b.pop()
    b.pop()
    scene = b.build()
    r = _render(scene, 16, 128, 256)
    assert_images_match_gpu(r.render(scene), cpu_render_scene(scene,
                                                               r.config))


def test_gradient_scene(gpu_device):
    """Gradient brushes (word-8 payload aliasing) vs the numpy oracle."""
    from piet_tpu.raster.cpu_fine import cpu_render_scene
    from piet_tpu.scene.fixtures import make_gradient_demo

    scene = make_gradient_demo(256)
    r = _render(scene, 16, 128, 256)
    assert_images_match_gpu(r.render(scene), cpu_render_scene(scene,
                                                               r.config))


def test_paired_stream(gpu_device):
    """A paired entry stream (F2/L2 entries) through the kernel."""
    import jax

    from piet_tpu.ops.coarse import coarse_rasterize
    from piet_tpu.ops.fine import fine_rasterize_entries
    from piet_tpu.raster.cpu_fine import cpu_render_scene
    from piet_tpu.renderer.capacity import fit_capacities
    from piet_tpu.config import RenderConfig
    from piet_tpu.renderer.renderer import _solid_to_present_u32, \
        prepare_scene
    from piet_tpu.scene.fixtures import make_cardioid

    scene = make_cardioid(center=(256.0, 256.0), r=200.0)
    cfg = fit_capacities(scene, RenderConfig(width=512, height=512,
                                             tile_height=16,
                                             tile_width=128))

    @jax.jit
    def run(d):
        ce = coarse_rasterize(
            d, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
            tile_w=cfg.tile_width, tile_h=cfg.tile_height,
            cmd_capacity=cfg.cmd_capacity, max_segments=cfg.max_segments,
            max_hits=cfg.max_hits, max_candidates=cfg.max_candidates,
            max_deltas=cfg.max_deltas, output="entries", pair="compact")
        return fine_rasterize_entries(
            ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
            ce.stream, 0, tile_h=cfg.tile_height, tile_w=cfg.tile_width,
            tiles_x=cfg.tiles_x)

    img = np.ascontiguousarray(np.asarray(run(prepare_scene(scene, cfg))))
    img = img.view(np.uint8).reshape(cfg.padded_height, cfg.padded_width, 4)
    assert_images_match_gpu(img[:cfg.height, :cfg.width],
                            cpu_render_scene(scene, cfg))
