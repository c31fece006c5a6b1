"""Roofline model (piet_tpu/roofline.py) + partial restaging."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from piet_tpu.config import RenderConfig
from piet_tpu.roofline import (PEAKS, coarse_model, fine_model,
                               frame_roofline, peaks)

H100 = "NVIDIA H100 80GB HBM3"


def _cfg(**kw):
    base = dict(width=1024, height=1024, tile_height=32, tile_width=128,
                cmd_capacity=1024, max_hits=1 << 15)
    base.update(kw)
    return RenderConfig(**base)


def test_fine_model_scales_with_entries():
    kw = dict(tile_h=32, tile_w=128, n_tiles=256)
    small = fine_model({"live_entries": 1000, "bail_tiles": 0}, **kw)
    big = fine_model({"live_entries": 100000, "bail_tiles": 0}, **kw)
    assert big["ops"] == pytest.approx(
        small["ops"] + 99000 * 32 * 128 * 35.0)
    assert big["bytes_moved"] > small["bytes_moved"]


def test_frame_roofline_shape():
    cfg = _cfg()
    stats = {"live_entries": 50000, "bail_tiles": 10, "n_hits": 40000,
             "n_candidates": 5000, "n_deltas": 1000, "n_segments": 30000}
    r = frame_roofline(stats, cfg, coarse_ms=2.0, fine_ms=3.0, total_ms=5.0,
                       device_kind=H100)
    for stage in ("fine", "coarse", "frame"):
        d = r[stage]
        assert d["ms_floor"] == max(d["ms_mem"], d["ms_ops"]) > 0
        assert d["pct_of_roofline"] == pytest.approx(
            100 * d["ms_floor"] / d["measured_ms"])
    # floors must not exceed measured (the model is a LOWER bound).
    assert r["frame"]["ms_floor"] < 5.0 * 10  # sanity scale


def test_coarse_model_counts_records():
    a = coarse_model({"n_hits": 1000, "n_candidates": 0, "n_deltas": 0,
                      "n_segments": 0}, max_hits=1 << 15,
                     max_candidates=1 << 10, max_deltas=1 << 10)
    b = coarse_model({"n_hits": 100000, "n_candidates": 0, "n_deltas": 0,
                      "n_segments": 0}, max_hits=1 << 15,
                     max_candidates=1 << 10, max_deltas=1 << 10)
    assert b["bytes_moved"] > a["bytes_moved"]


def test_unknown_device_kind_raises():
    """No peak rate is assumed for a device outside the table."""
    assert peaks(H100) == PEAKS[H100]
    with pytest.raises(ValueError, match="no published peaks"):
        peaks("Unknown Accelerator 9000")
    with pytest.raises(ValueError):
        frame_roofline({}, _cfg(), None, None, 1.0, device_kind="cpu")


def test_render_updated_partial_restage():
    """Dirty-field restage renders identically to a full re-prepare."""
    jax.config.update("jax_platforms", "cpu")
    from piet_tpu.renderer.renderer import Renderer
    from piet_tpu.scene.scene import SceneBuilder

    def build(dx):
        b = SceneBuilder()
        b.fill([(10 + dx, 10), (120 + dx, 20), (60 + dx, 120)], 0xCC2200FF)
        b.polyline([(5, 5), (125, 125)], 0x0033CCFF, 3.0)
        return b.build()

    cfg = RenderConfig(width=128, height=128, tile_height=16,
                       tile_width=128, cmd_capacity=256, max_items=128,
                       max_points=256, max_segments=256, max_hits=1 << 10,
                       max_candidates=256, max_deltas=256)
    r = Renderer(cfg, fine_impl="xla")
    r.render_u32(build(0.0))  # stage
    moved = build(7.0)
    img_inc = np.asarray(r.render_updated(moved,
                                          fields=("points", "bboxes")))
    img_full = np.asarray(r.render_u32(moved))
    np.testing.assert_array_equal(img_inc, img_full)
