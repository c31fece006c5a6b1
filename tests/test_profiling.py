"""Profiler smoke test: stage probes cover the pipeline and the profiler
returns a full, finite timing table on the CPU backend.

The numbers themselves are meaningless on CPU; what this pins is the
*machinery* -- that every probe name in STAGE_ORDER exists in the coarse
diag (no silent bitrot when the pipeline changes, the round-1 failure mode
of the old debug_stage hooks), and that profile_render runs end to end.
"""

import jax
import numpy as np

from piet_tpu.config import RenderConfig
from piet_tpu.ops.coarse import coarse_rasterize
from piet_tpu.profiling import STAGE_ORDER, format_profile, profile_render
from piet_tpu.renderer.capacity import fit_capacities
from piet_tpu.renderer.renderer import prepare_scene
from piet_tpu.scene.fixtures import make_circles_rects


def _tiny():
    scene = make_circles_rects(n_circles=8, n_rects=8, size=256)
    cfg = fit_capacities(scene, RenderConfig(
        width=256, height=256, tile_height=32, tile_width=128,
        cmd_capacity=128))
    return scene, cfg


def test_probes_cover_stage_order():
    # The device-DERIVATION path carries the full probe set; the
    # precomputed segment stage (seg_pre) legitimately skips the seg
    # stages, so probe against the derivation.
    scene, cfg = _tiny()
    dev = prepare_scene(scene, cfg, seg_pre=False)
    out = coarse_rasterize(
        dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        cmd_capacity=cfg.cmd_capacity, max_segments=cfg.max_segments,
        max_hits=cfg.max_hits, max_candidates=cfg.max_candidates,
        max_deltas=cfg.max_deltas, output="entries",
        with_probes=True)
    probes = out.diag["probes"]
    missing = [n for n in STAGE_ORDER if n not in probes]
    assert not missing, f"stage probes missing: {missing}"
    # Probes are cheap scalars and must be finite (they sum live data).
    for name, v in probes.items():
        assert v.shape == (), name
        assert np.isfinite(float(jax.device_get(v))), name


def test_probes_off_by_default():
    scene, cfg = _tiny()
    dev = prepare_scene(scene, cfg)
    out = coarse_rasterize(
        dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        cmd_capacity=cfg.cmd_capacity, max_segments=cfg.max_segments,
        max_hits=cfg.max_hits, max_candidates=cfg.max_candidates,
        max_deltas=cfg.max_deltas, output="entries")
    assert "probes" not in out.diag


def test_profile_render_smoke(monkeypatch):
    from piet_tpu import gpu
    monkeypatch.setattr(gpu, "WARMUP_S", 0.0)
    monkeypatch.setattr(gpu, "WARMUP_MAX_S", 0.0)
    scene, cfg = _tiny()
    results = profile_render(scene, cfg, fine_impl="xla", reps=2)
    assert "coarse_total" in results and "end_to_end" in results
    for name in STAGE_ORDER:
        if name in ("rows", "sorted_gather", "runs"):
            continue  # entries-only stages, xla path skips them
        assert name in results, name
    table = format_profile(results)
    assert "end_to_end" in table
