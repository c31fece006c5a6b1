"""Roofline model of the render pipeline: per-stage bytes and f32 operations
from the coarse pass's record counts, divided by the card's peaks.

Peaks are keyed by JAX's ``device_kind``; a device that is not in the
table is an error, never a default.

Work model (counts from ``coarse.diag`` / renderer ``last_stats``):

* fine: reads ``live_entries`` 16-word f32 rows, writes the non-bailed
  framebuffer pixels once, and executes ~``OPS_PER_ENTRY`` f32 operations
  per pixel of its (tile_h, tile_w) plane per entry plus the
  ~``OPS_RESOLVE`` per-pixel epilogue (sRGB encode + pack).
* coarse: every record class (hits, candidates, deltas) rides one
  expansion write + one sorted gather read + the sort's two crossings of
  its 16-word row, plus the sort's comparisons ~ E log^2(E) / 2 ops.

These are estimates of the unavoidable traffic (capacity padding
excluded): pct_of_roofline ~ 100 means the stage is at the card's speed of
light; low pct means structural headroom.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: device_kind -> (device-memory bytes/s, f32 FLOP/s outside the tensor
#: cores).  Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5: 3.35
#: TB/s HBM3, 67 TFLOP/s FP32; PCIe: 2.0 TB/s HBM2e, 51 TFLOP/s FP32),
#: at the full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
    "NVIDIA H100 PCIe": (2.0e12, 51e12),
}

ENTRY_BYTES = 16 * 4          # one 16-word f32 entry row
#: Mean f32 ops per pixel per interpreted entry (fill delta ~30, line
#: field ~20, resolves ~60; weighted toward fills on real scenes).
OPS_PER_ENTRY = 35.0
#: Per-pixel epilogue: deterministic sRGB encode of 3 channels + pack.
OPS_RESOLVE = 80.0


def peaks(device_kind: str):
    """(bytes/s, f32 op/s) of ``device_kind``; ValueError if unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device {device_kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


def fine_model(stats: Dict, *, tile_h: int, tile_w: int,
               n_tiles: int) -> Dict[str, float]:
    live_entries = float(np.asarray(stats.get("live_entries", 0)).sum())
    bail_tiles = float(np.asarray(stats.get("bail_tiles", 0)).sum())
    live_tiles = max(n_tiles - bail_tiles, 0.0)
    px = live_tiles * tile_h * tile_w
    bytes_moved = live_entries * ENTRY_BYTES + px * 4.0
    ops = live_entries * tile_h * tile_w * OPS_PER_ENTRY + px * OPS_RESOLVE
    return _bound(bytes_moved, ops)


def coarse_model(stats: Dict, *, max_hits: int, max_candidates: int,
                 max_deltas: int) -> Dict[str, float]:
    import math

    n_hits = float(np.asarray(stats.get("n_hits", 0)).sum())
    n_cand = float(np.asarray(stats.get("n_candidates", 0)).sum())
    n_deltas = float(np.asarray(stats.get("n_deltas", 0)).sum())
    n_segs = float(np.asarray(stats.get("n_segments", 0)).sum())
    records = n_hits + n_cand + n_deltas
    # Expansion write + sorted gather read + sort in/out: 4 crossings of
    # the 16-word row per record; segment derivation reads its point
    # pairs (4 f32) and writes ~16 attribute words once.
    bytes_moved = records * 4 * ENTRY_BYTES + n_segs * (4 + 16) * 4.0
    # A comparison sort network over the padded capacity as the op-side
    # floor: E/2 * log2(E)*(log2(E)+1)/2 exchanges x ~8 ops.
    e_pad = max(float(max_hits + max_candidates + max_deltas), 1.0)
    lg = math.log2(e_pad)
    ops = e_pad / 2 * lg * (lg + 1) / 2 * 8 + records * 64
    return _bound(bytes_moved, ops)


def _bound(bytes_moved: float, ops: float) -> Dict[str, float]:
    return {"bytes_moved": bytes_moved, "ops": ops}


def _floor(model: Dict[str, float], device_kind: str) -> Dict[str, float]:
    bw, flops = peaks(device_kind)
    ms_mem = model["bytes_moved"] / bw * 1e3
    ms_ops = model["ops"] / flops * 1e3
    return {**model, "ms_mem": ms_mem, "ms_ops": ms_ops,
            "ms_floor": max(ms_mem, ms_ops)}


def frame_roofline(stats: Dict, config, coarse_ms: float | None,
                   fine_ms: float | None, total_ms: float,
                   device_kind: str) -> Dict:
    """Per-stage speed-of-light floors on ``device_kind`` + percent of
    roofline for whatever measured splits exist."""
    n_tiles = config.tiles_x * config.tiles_y
    fine = fine_model(stats, tile_h=config.tile_height,
                      tile_w=config.tile_width, n_tiles=n_tiles)
    coarse = coarse_model(stats, max_hits=config.max_hits,
                          max_candidates=config.max_candidates,
                          max_deltas=config.max_deltas)
    frame = _bound(fine["bytes_moved"] + coarse["bytes_moved"],
                   fine["ops"] + coarse["ops"])
    return {name: _stage(_floor(model, device_kind), ms)
            for name, model, ms in (("fine", fine, fine_ms),
                                    ("coarse", coarse, coarse_ms),
                                    ("frame", frame, total_ms))}


def _stage(model: Dict[str, float], measured_ms: float | None) -> Dict:
    d = {"ms_floor": model["ms_floor"], "ms_mem": model["ms_mem"],
         "ms_ops": model["ms_ops"], "gbytes": model["bytes_moved"] / 1e9}
    if measured_ms is not None and measured_ms > 0:
        d["measured_ms"] = measured_ms
        d["pct_of_roofline"] = 100 * model["ms_floor"] / measured_ms
    return d
