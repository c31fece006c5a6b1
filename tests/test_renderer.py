"""End-to-end: one-jit device renderer vs the full CPU golden path.

Covers the whole translated stack (reference: scene encode -> tileKernel ->
renderKernel -> present, TestApp/PietRenderer.m:59-103) as a single
pixel-exact comparison, plus determinism and the capacity-error reporting
the reference lacks (silent PTCL overflow, PietShaderTypes.h:24-27).
"""

import dataclasses

import numpy as np
import pytest

from piet_tpu.config import RenderConfig
from piet_tpu.raster.cpu_fine import cpu_render_scene
from piet_tpu.renderer.renderer import Renderer, SceneCapacityError
from piet_tpu.scene.fixtures import make_cardioid, make_path_test
from piet_tpu.scene.svg import make_tiger

TIGER_CFG = RenderConfig(
    width=224, height=224, tile_height=16, tile_width=16, cmd_capacity=768,
    max_items=512, max_points=1 << 15, max_segments=1 << 15,
    max_hits=1 << 17, max_candidates=1 << 15, max_deltas=1 << 15)


CASES = [
    ("path_test", make_path_test,
     RenderConfig(width=320, height=832, tile_height=16, tile_width=16,
                  cmd_capacity=128, max_items=64, max_points=1024,
                  max_segments=1024, max_hits=1 << 14,
                  max_candidates=1 << 12, max_deltas=1 << 12)),
    ("cardioid", lambda: make_cardioid(center=(256.0, 256.0), r=200.0),
     RenderConfig(width=512, height=512, tile_height=16, tile_width=16,
                  cmd_capacity=128, max_items=256, max_points=1024,
                  max_segments=1024, max_hits=1 << 17,
                  max_candidates=1 << 14, max_deltas=1 << 12)),
    ("tiger_1x", lambda: make_tiger(scale=1.0), TIGER_CFG),
    ("tiger_1x_wide_tiles", lambda: make_tiger(scale=1.0),
     dataclasses.replace(TIGER_CFG, tile_width=128, cmd_capacity=2688,
                         max_candidates=1 << 14)),
]


@pytest.mark.parametrize("name,make,cfg", CASES, ids=[c[0] for c in CASES])
def test_render_matches_golden(name, make, cfg):
    scene = make()
    r = Renderer(cfg, fine_impl="xla")
    img = r.render(scene)
    gold = cpu_render_scene(scene, cfg)
    # Bit-exact up to XLA:CPU's discretionary FMA contraction (see
    # tests/_imgcmp.py); on the GPU the full pipeline is bit-exact
    # (tests/test_gpu_exact.py).
    from tests._imgcmp import assert_images_match
    assert_images_match(img, gold)


def test_render_deterministic():
    cfg = CASES[0][2]
    scene = make_path_test()
    r = Renderer(cfg, fine_impl="xla")
    a = r.render(scene)
    b = r.render(scene)
    np.testing.assert_array_equal(a, b)


def test_item_capacity_error():
    cfg = dataclasses.replace(TIGER_CFG, max_items=16)
    with pytest.raises(SceneCapacityError):
        Renderer(cfg, fine_impl="xla").render(make_tiger(scale=1.0))


def test_hit_capacity_error():
    cfg = dataclasses.replace(CASES[1][2], max_hits=1 << 10)
    with pytest.raises(SceneCapacityError):
        Renderer(cfg, fine_impl="xla").render(
            make_cardioid(center=(256.0, 256.0), r=200.0))


def test_render_entries_path_interpret():
    """The GPU path (entry-stream coarse + the Pallas kernel) through the
    interpreter, within the XLA:CPU FMA tolerance."""
    name, make, cfg = CASES[0]
    scene = make()
    r = Renderer(cfg, fine_impl="pallas", interpret=True)
    img = r.render(scene)
    gold = cpu_render_scene(scene, cfg)
    diff = np.abs(img.astype(np.int32) - gold.astype(np.int32))
    assert diff.max() <= 2
    assert (diff.max(-1) > 0).mean() < 1e-4


@pytest.mark.parametrize("name,make", [
    ("beziers_small", lambda: __import__(
        "piet_tpu.scene.fixtures", fromlist=["x"]).make_random_beziers(
            n=150, size=384)),
    ("glyphs_small", lambda: __import__(
        "piet_tpu.scene.fixtures", fromlist=["x"]).make_glyph_page(
            n_glyphs=300, size=384)),
    ("animated_small", lambda: __import__(
        "piet_tpu.scene.fixtures", fromlist=["x"]).make_animated_frame(
            0.7, size=384, n=40)),
])
def test_render_baseline_families(name, make):
    """Small instances of the BASELINE benchmark scene families vs the
    CPU golden path (full-size runs are benchmarked on hardware)."""
    scene = make()
    from piet_tpu.renderer.capacity import fit_capacities
    cfg = fit_capacities(
        scene, RenderConfig(width=384, height=384, tile_height=16,
                            tile_width=16, cmd_capacity=768))
    img = Renderer(cfg, fine_impl="xla").render(scene)
    gold = cpu_render_scene(scene, cfg)
    diff = np.abs(img.astype(np.int32) - gold.astype(np.int32))
    assert diff.max() <= 2, f"maxdiff {diff.max()}"
    assert (diff.max(-1) > 0).mean() < 1e-4


def test_render_sequence_matches_per_frame():
    """Batched multi-frame rendering (one dispatch) equals per-frame."""
    from piet_tpu.scene.fixtures import make_animated_frame
    scenes = [make_animated_frame(t / 10.0, size=256, n=20)
              for t in range(3)]
    from piet_tpu.renderer.capacity import fit_capacities
    cfg = fit_capacities(scenes[0],
                         RenderConfig(width=256, height=256, tile_height=16,
                                      tile_width=16), bucket=True)
    r = Renderer(cfg, fine_impl="xla")
    batch = r.render_sequence(scenes)   # auto impl resolves to xla on CPU
    
    for i, s in enumerate(scenes):
        np.testing.assert_array_equal(batch[i], r.render(s))


def test_render_sequence_checks_capacity():
    """A frame in a batch that exceeds record capacity must raise, not
    render corrupted pixels (ADVICE round 1: render_sequence previously
    discarded per-frame stats)."""
    import pytest
    from piet_tpu.renderer.renderer import SceneCapacityError
    from piet_tpu.scene.fixtures import make_animated_frame
    scenes = [make_animated_frame(t / 10.0, size=256, n=20)
              for t in range(2)]
    cfg = RenderConfig(width=256, height=256, tile_height=16, tile_width=16,
                       cmd_capacity=128, max_items=256, max_points=2048,
                       max_segments=16,  # far below the scene's segments
                       max_hits=1 << 12, max_candidates=1 << 12,
                       max_deltas=1 << 10)
    r = Renderer(cfg, fine_impl="xla")
    with pytest.raises(SceneCapacityError):
        r.render_sequence(scenes)


def test_packed_staging_matches_prepare_scene():
    """pack_scene -> unpack_scene round-trips to the exact DeviceScene of
    prepare_scene, and the packed single-transfer render path produces
    the identical image (the per-frame re-encode fast path)."""
    import jax
    import jax.numpy as jnp
    from piet_tpu.renderer.renderer import (pack_scene, prepare_scene,
                                            unpack_scene)
    from piet_tpu.scene.fixtures import make_animated_frame

    scene = make_animated_frame(0.4, size=256, n=24)
    cfg = RenderConfig(width=256, height=256, tile_height=16, tile_width=128,
                       cmd_capacity=256, max_items=64, max_points=512,
                       max_segments=1 << 10, max_hits=1 << 12,
                       max_candidates=1 << 10, max_deltas=1 << 10)
    ref = prepare_scene(scene, cfg)
    got = jax.jit(lambda b: unpack_scene(b, cfg))(
        jnp.asarray(pack_scene(scene, cfg)))
    for name in ref._fields:
        if name == "seg_pre":
            # The packed single-buffer path carries no precomputed
            # segment stage (it device-derives); prepare_scene does.
            continue
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
            err_msg=name)
    r = Renderer(cfg, fine_impl="xla")
    img_packed = np.asarray(r.render_packed_u32(scene))
    img_ref = np.asarray(r.render_u32(scene))
    np.testing.assert_array_equal(img_packed, img_ref)
