"""Host-precomputed segment stage (renderer/segstage.py) vs the device
derivation: the coarse outputs must be BITWISE identical -- the
precompute is the same arithmetic run once at staging time."""

import numpy as np
import pytest

pytestmark = pytest.mark.smoke

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.config import RenderConfig                  # noqa: E402
from piet_tpu.ops.coarse import coarse_rasterize          # noqa: E402
from piet_tpu.renderer.capacity import fit_capacities     # noqa: E402
from piet_tpu.renderer.renderer import prepare_scene      # noqa: E402
from piet_tpu.scene import fixtures                       # noqa: E402
from piet_tpu.scene.svg import make_tiger                 # noqa: E402

LEAVES = ("stream", "first", "n_entries", "counts", "solid")


def _run(scene, wh, seg_pre):
    cfg = fit_capacities(scene, RenderConfig(
        width=wh[0], height=wh[1], tile_height=16, tile_width=128,
        cmd_capacity=1024), bucket=True)
    dev = prepare_scene(scene, cfg, seg_pre=seg_pre)
    if seg_pre:
        assert dev.seg_pre is not None
    out = coarse_rasterize(
        dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        cmd_capacity=cfg.cmd_capacity, max_segments=cfg.max_segments,
        max_hits=cfg.max_hits, max_candidates=cfg.max_candidates,
        max_deltas=cfg.max_deltas, output="entries")
    return out


@pytest.mark.parametrize("name,make,wh", [
    ("tiger", lambda: make_tiger(scale=1.0), (256, 256)),
    ("clips", lambda: fixtures.get_scene("animated"), (512, 512)),
    ("holes", lambda: fixtures.get_scene("holes"), (256, 256)),
    ("gradients", lambda: fixtures.get_scene("gradients", size=256),
     (256, 256)),
    ("circles_rects", lambda: fixtures.get_scene(
        "circles_rects", n_circles=64, n_rects=64, size=256), (256, 256)),
])
def test_precomputed_stage_bitwise_equal(name, make, wh):
    scene = make()
    ref = _run(scene, wh, seg_pre=False)
    got = _run(scene, wh, seg_pre=True)
    for leaf in LEAVES:
        a = np.asarray(getattr(ref, leaf))
        b = np.asarray(getattr(got, leaf))
        np.testing.assert_array_equal(
            a.view(np.uint32) if a.dtype.kind == "f" else a,
            b.view(np.uint32) if b.dtype.kind == "f" else b,
            err_msg=f"{name}:{leaf}")
    for k in ("n_segments", "n_hits", "n_deltas", "live_entries"):
        assert int(np.asarray(ref.diag[k]).sum()) == \
            int(np.asarray(got.diag[k]).sum()), (name, k)


def test_offscreen_and_degenerate_segments():
    """The delta-fold widening cases (offscreen-left fills, exact
    tile-boundary verticals) through the precompute."""
    from piet_tpu.scene.scene import SceneBuilder
    b = SceneBuilder()
    # Path partially left of the viewport: winding must survive.
    b.fill([(-120.0, 30.0), (90.0, 40.0), (60.0, 180.0), (-100.0, 170.0)],
           0xAA2211FF)
    # Vertical edge exactly on a tile boundary (x = 128).
    b.fill([(128.0, 16.0), (200.0, 20.0), (128.0, 90.0)], 0x2266CCFF)
    # Degenerate zero-length segment inside a path.
    b.fill([(30.0, 200.0), (30.0, 200.0), (120.0, 210.0), (80.0, 250.0)],
           0x11AA55FF)
    scene = b.build()
    ref = _run(scene, (256, 256), seg_pre=False)
    got = _run(scene, (256, 256), seg_pre=True)
    for leaf in LEAVES:
        a = np.asarray(getattr(ref, leaf))
        b2 = np.asarray(getattr(got, leaf))
        np.testing.assert_array_equal(
            a.view(np.uint32) if a.dtype.kind == "f" else a,
            b2.view(np.uint32) if b2.dtype.kind == "f" else b2,
            err_msg=leaf)
