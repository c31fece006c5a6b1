"""Fine rasterizers vs the CPU golden fine rasterizer.

Both device implementations of the reference renderKernel
(TestApp/PietRender.metal:457-566) are checked against the numpy oracle
(piet_tpu/raster/cpu_fine.py):

* the pure-XLA path (ops/fine_xla.py) over the oracle's own dense PTCL,
* the Pallas GPU kernel (ops/fine.py) in interpret mode over the device
  coarse pass's entry stream of the same frame.

Both execute through XLA:CPU, whose LLVM backend contracts mul+add chains
into FMAs at its own discretion, so a tiny fraction of pixels land one u8
code off the oracle; the tolerance below documents exactly that.  On the
GPU both are bit-identical to the oracle (tests/test_gpu_exact.py).
"""

import jax
import numpy as np
import pytest

from piet_tpu.config import RenderConfig
from piet_tpu.ops.coarse import coarse_rasterize
from piet_tpu.ops.fine import fine_rasterize_entries
from piet_tpu.ops.fine_xla import fine_rasterize_xla
from piet_tpu.raster.cpu_fine import cpu_render_ptcl
from piet_tpu.raster.cpu_tiler import cpu_tile_scene
from piet_tpu.scene.fixtures import make_cardioid, make_path_test
from piet_tpu.scene.svg import make_tiger

CASES = [
    ("path_test", make_path_test,
     dict(width=320, height=832, tile_height=16, tile_width=16,
          cmd_capacity=128)),
    ("cardioid", lambda: make_cardioid(center=(256.0, 256.0), r=200.0),
     dict(width=512, height=512, tile_height=16, tile_width=16,
          cmd_capacity=128)),
    ("tiger_1x", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=16, tile_width=16,
          cmd_capacity=768)),
    ("tiger_1x_wide_tiles", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=16, tile_width=128,
          cmd_capacity=2688)),
]


def _render_and_mask(cfg, make, impl):
    scene = make()
    ptcl = cpu_tile_scene(scene, cfg)
    gold = cpu_render_ptcl(ptcl, cfg)
    counts2d = ptcl.counts.reshape(cfg.tiles_y, cfg.tiles_x)
    flat_args = ptcl.args.reshape(ptcl.n_tiles, -1)
    if impl == "xla":
        img_u32 = fine_rasterize_xla(
            counts2d, ptcl.tags, flat_args, tile_h=cfg.tile_height,
            tile_w=cfg.tile_width, cmd_capacity=cfg.cmd_capacity)
    else:
        from piet_tpu.renderer.capacity import fit_capacities
        from piet_tpu.renderer.renderer import (_solid_to_present_u32,
                                                prepare_scene)
        fit = fit_capacities(scene, cfg)
        ce = jax.jit(lambda d: coarse_rasterize(
            d, tiles_x=fit.tiles_x, tiles_y=fit.tiles_y,
            tile_w=fit.tile_width, tile_h=fit.tile_height,
            cmd_capacity=fit.cmd_capacity, max_segments=fit.max_segments,
            max_hits=fit.max_hits, max_candidates=fit.max_candidates,
            max_deltas=fit.max_deltas, output="entries"))(
                prepare_scene(scene, fit))
        img_u32 = fine_rasterize_entries(
            ce.first, ce.n_entries, _solid_to_present_u32(ce.solid),
            ce.stream, tile_h=cfg.tile_height, tile_w=cfg.tile_width,
            tiles_x=cfg.tiles_x, interpret=True)
    img = (np.ascontiguousarray(np.asarray(img_u32)).view(np.uint8)
           .reshape(cfg.padded_height, cfg.padded_width, 4))
    img = img[:cfg.height, :cfg.width]
    # Bailed tiles are owned by the present composite, not the fine kernel.
    solid2d = ptcl.solid.reshape(cfg.tiles_y, cfg.tiles_x)
    bail_px = np.repeat(np.repeat(solid2d != 0, cfg.tile_height, 0),
                        cfg.tile_width, 1)[:cfg.height, :cfg.width]
    return img, gold, bail_px


def _assert_near_exact(img, gold, bail):
    diff = np.abs(img.astype(np.int32) - gold.astype(np.int32))
    diff[bail] = 0
    # XLA:CPU FMA double-rounding: at most 2 codes (two contracted chains
    # can compound), on a small fraction of pixels.  The fraction bound is
    # loose at wide tiles: LLVM contraction on a per-ROW intermediate
    # (fill w0/wa/rsy chains depend only on Y) perturbs a whole 128-pixel
    # row at once.  On the GPU the image tests are strict equality
    # (tests/test_gpu_exact.py).
    assert diff.max() <= 2, f"maxdiff {diff.max()}"
    frac = (diff.max(-1) > 0).mean()
    assert frac < 1e-3, f"{frac:.2%} pixels differ (FMA tolerance)"


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name,make,cfg_kw", CASES,
                         ids=[c[0] for c in CASES])
def test_fine_near_exact_on_cpu(name, make, cfg_kw, impl):
    cfg = RenderConfig(**cfg_kw)
    img, gold, bail = _render_and_mask(cfg, make, impl)
    _assert_near_exact(img, gold, bail)
