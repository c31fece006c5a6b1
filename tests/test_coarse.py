"""Device coarse pass vs the CPU golden tiler: command-for-command equality.

The XLA binning pass (piet_tpu/ops/coarse.py) must produce the exact PTCL
the reference's tileKernel would (reference: TestApp/PietRender.metal:160-454),
as modeled by the CPU oracle (piet_tpu/raster/cpu_tiler.py): same tags, same
f32 operands, same counts, same solid/bail colors, same overflow counters.
"""

import numpy as np
import pytest

from piet_tpu.config import RenderConfig
from piet_tpu.ops.coarse import coarse_rasterize
from piet_tpu.raster.cpu_tiler import cpu_tile_scene
from piet_tpu.raster.ptcl import ARG_WORDS
from piet_tpu.renderer.renderer import prepare_scene
from piet_tpu.scene.fixtures import (make_animated_frame, make_cardioid,
                                     make_circles_rects, make_path_test)
from piet_tpu.scene.svg import make_tiger


def run_coarse(scene, cfg: RenderConfig):
    dev = prepare_scene(scene, cfg)
    out = coarse_rasterize(
        dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        cmd_capacity=cfg.cmd_capacity, max_segments=cfg.max_segments,
        max_hits=cfg.max_hits, max_candidates=cfg.max_candidates,
        max_deltas=cfg.max_deltas)
    for k in ("seg_overflow", "hit_overflow", "cand_overflow",
              "delta_overflow"):
        assert int(out.diag[k]) == 0, (k, out.diag)
    return out


def assert_ptcl_equal(out, gold, cfg: RenderConfig):
    tags = np.asarray(out.tags)
    args = np.asarray(out.args).reshape(-1, cfg.cmd_capacity, ARG_WORDS)
    counts = np.asarray(out.counts)
    solid = np.asarray(out.solid)
    overflow = np.asarray(out.overflow)

    np.testing.assert_array_equal(solid, gold.solid)
    np.testing.assert_array_equal(counts, gold.counts)
    np.testing.assert_array_equal(overflow, gold.overflow)
    for t in range(gold.n_tiles):
        n = int(gold.counts[t])
        np.testing.assert_array_equal(tags[t, :n], gold.tags[t, :n],
                                      err_msg=f"tile {t} tags")
        np.testing.assert_array_equal(args[t, :n], gold.args[t, :n],
                                      err_msg=f"tile {t} args")


CASES = [
    ("path_test", make_path_test,
     dict(width=320, height=832, tile_height=16, tile_width=16,
          cmd_capacity=128, max_items=64, max_points=1024, max_segments=1024,
          max_hits=1 << 14, max_candidates=1 << 12, max_deltas=1 << 12)),
    ("cardioid", lambda: make_cardioid(center=(256.0, 256.0), r=200.0),
     dict(width=512, height=512, tile_height=16, tile_width=16,
          cmd_capacity=128, max_items=256, max_points=1024, max_segments=1024,
          max_hits=1 << 17, max_candidates=1 << 14, max_deltas=1 << 12)),
    ("circles_rects", lambda: make_circles_rects(80, 80, size=512),
     dict(width=512, height=512, tile_height=16, tile_width=16,
          cmd_capacity=256, max_items=256, max_points=1 << 13,
          max_segments=1 << 13, max_hits=1 << 16, max_candidates=1 << 14,
          max_deltas=1 << 13)),
    ("animated", lambda: make_animated_frame(0.3, size=512, n=60),
     dict(width=512, height=512, tile_height=16, tile_width=16,
          cmd_capacity=256, max_items=256, max_points=1024,
          max_segments=1024, max_hits=1 << 14, max_candidates=1 << 13,
          max_deltas=1 << 12)),
    ("tiger_1x", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=16, tile_width=16,
          cmd_capacity=768, max_items=512, max_points=1 << 15,
          max_segments=1 << 15, max_hits=1 << 17, max_candidates=1 << 15,
          max_deltas=1 << 15)),
    # Wide tiles (16x128).
    ("tiger_1x_wide_tiles", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=16, tile_width=128,
          cmd_capacity=2688, max_items=512, max_points=1 << 15,
          max_segments=1 << 15, max_hits=1 << 17, max_candidates=1 << 14,
          max_deltas=1 << 15)),
    # Taller tiles (32x128): fewer tiles/records, more pixels per command.
    ("tiger_1x_tall_tiles", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=32, tile_width=128,
          cmd_capacity=4096, max_items=512, max_points=1 << 15,
          max_segments=1 << 15, max_hits=1 << 17, max_candidates=1 << 14,
          max_deltas=1 << 15)),
]


@pytest.mark.parametrize("name,make,cfg_kw", CASES,
                         ids=[c[0] for c in CASES])
def test_coarse_matches_cpu_tiler(name, make, cfg_kw):
    cfg = RenderConfig(**cfg_kw)
    scene = make()
    out = run_coarse(scene, cfg)
    gold = cpu_tile_scene(scene, cfg)
    assert_ptcl_equal(out, gold, cfg)


def test_sort_fallback_unpacked_keys():
    """Configs whose packed sort key (tile * 2*(NI+1) + item*2 + class)
    would overflow int32 must fall back to the unpacked two-key sort --
    the packed key silently wraps otherwise, corrupting tile assignment
    (ADVICE round 1).  This config trips packed_ok=False."""
    cfg = RenderConfig(width=1024, height=1024, tile_height=16,
                       tile_width=16, cmd_capacity=128,
                       max_items=1 << 19, max_points=1024,
                       max_segments=1024, max_hits=1 << 16,
                       max_candidates=1 << 16, max_deltas=1 << 12)
    n_tiles = cfg.tiles_x * cfg.tiles_y
    stride = 2 * (cfg.max_items + 1)
    assert n_tiles * stride >= 2**31 - 2, "config no longer trips fallback"
    scene = make_cardioid(center=(512.0, 512.0), r=400.0)
    out = run_coarse(scene, cfg)
    gold = cpu_tile_scene(scene, cfg)
    assert_ptcl_equal(out, gold, cfg)
