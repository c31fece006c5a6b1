"""Entry pairing (ops/pairing.py): command-sequence preservation.

Pairing packs two same-class records (two plain Fills, or two Lines) of
one (tile, item) group into a single 16-word entry.  The invariant is
that the DECODED per-tile command sequence -- tags and operand words, in
painter's order -- is identical to the unpaired stream's, so the fine
interpreter (which applies slot 0 before slot 1) reproduces the oracle's
exact sequential accumulation (reference order semantics:
TestApp/PietRender.metal:474-560).
"""

import numpy as np
import pytest

from piet_tpu.config import RenderConfig
from piet_tpu.layout.entry_stream import (W_S0_ARG, W_S0_TAG,
                                          W_S1_ARG, W_S1_TAG)
from piet_tpu.ops.coarse import coarse_rasterize
from piet_tpu.raster.cpu_fine import cpu_render_scene
from piet_tpu.raster.ptcl import CMD_FILL, CMD_LINE
from piet_tpu.renderer.renderer import Renderer, prepare_scene
from piet_tpu.scene.fixtures import (make_cardioid, make_circles_rects,
                                     make_path_test)
from piet_tpu.scene.svg import make_tiger


def run_entries(scene, cfg: RenderConfig, pair: bool):
    dev = prepare_scene(scene, cfg)
    return coarse_rasterize(
        dev, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_width, tile_h=cfg.tile_height,
        cmd_capacity=cfg.cmd_capacity, max_segments=cfg.max_segments,
        max_hits=cfg.max_hits, max_candidates=cfg.max_candidates,
        max_deltas=cfg.max_deltas, output="entries",
        pair=pair)


def decode_stream(out):
    """Per-tile ordered command list [(tag, operand-words tuple), ...].

    LINE/FILL compare on their 4 geometry words (slot-1 merges copy
    exactly those; slot-0 word 4 carries a cull hint the math never
    reads, see cmd_math.line_field_sq).  Every other tag compares on the
    full slot-0 payload including the clip-rect words.
    """
    rows = np.asarray(out.stream)
    first = np.asarray(out.first)
    n_entries = np.asarray(out.n_entries)
    tiles = []
    for t in range(first.shape[0]):
        cmds = []
        for e in range(first[t], first[t] + n_entries[t]):
            row = rows[e]
            tag0 = int(row[W_S0_TAG])
            tag1 = int(row[W_S1_TAG])
            if tag0 in (CMD_LINE, CMD_FILL):
                cmds.append((tag0, tuple(row[W_S0_ARG:W_S0_ARG + 4])))
            elif tag0 > 0:
                cmds.append((tag0, tuple(row[W_S0_ARG:W_S0_ARG + 7])
                             + tuple(row[W_S1_ARG:W_S1_ARG + 4])))
            if tag1 in (CMD_LINE, CMD_FILL):
                cmds.append((tag1, tuple(row[W_S1_ARG:W_S1_ARG + 4])))
        tiles.append(cmds)
    return tiles


CASES = [
    ("path_test", make_path_test,
     dict(width=320, height=832, tile_height=16, tile_width=16,
          cmd_capacity=128, max_items=64, max_points=1024, max_segments=1024,
          max_hits=1 << 14, max_candidates=1 << 12, max_deltas=1 << 12)),
    ("cardioid", lambda: make_cardioid(center=(256.0, 256.0), r=200.0),
     dict(width=512, height=512, tile_height=16, tile_width=16,
          cmd_capacity=128, max_items=256, max_points=1024, max_segments=1024,
          max_hits=1 << 17, max_candidates=1 << 14, max_deltas=1 << 12)),
    ("circles_rects", lambda: make_circles_rects(40, 40, size=384),
     dict(width=384, height=384, tile_height=16, tile_width=16,
          cmd_capacity=256, max_items=256, max_points=1 << 13,
          max_segments=1 << 13, max_hits=1 << 16, max_candidates=1 << 14,
          max_deltas=1 << 13)),
    ("tiger_1x", lambda: make_tiger(scale=1.0),
     dict(width=224, height=224, tile_height=16, tile_width=16,
          cmd_capacity=768, max_items=512, max_points=1 << 15,
          max_segments=1 << 15, max_hits=1 << 17, max_candidates=1 << 15,
          max_deltas=1 << 15)),
]


@pytest.mark.parametrize("mode", ["compact", "hole"])
@pytest.mark.parametrize("name,make,cfg_kw", CASES,
                         ids=[c[0] for c in CASES])
def test_pairing_preserves_command_sequence(name, make, cfg_kw, mode):
    cfg = RenderConfig(**cfg_kw)
    scene = make()
    plain = run_entries(scene, cfg, pair=False)
    paired = run_entries(scene, cfg, pair=mode)

    np.testing.assert_array_equal(np.asarray(paired.solid),
                                  np.asarray(plain.solid))
    np.testing.assert_array_equal(np.asarray(paired.counts),
                                  np.asarray(plain.counts))

    tiles_plain = decode_stream(plain)
    tiles_paired = decode_stream(paired)
    for t, (a, b) in enumerate(zip(tiles_plain, tiles_paired)):
        assert a == b, f"tile {t}: {a[:4]} vs {b[:4]}"

    # Pairing must shrink the stream on multi-segment scenes (the
    # cardioid's stroke items are single-segment -- nothing pairs, and
    # the stream must come through untouched).  "compact" shrinks the
    # live entry ranges; "hole" keeps ranges but zeroes merged seconds
    # in place (counted by decoding: a zero row emits no commands).
    n_plain = int(np.asarray(plain.n_entries).sum())
    n_paired = int(np.asarray(paired.n_entries).sum())
    if mode == "hole":
        assert n_paired == n_plain, (n_paired, n_plain)
        merged = _count_nonempty(plain) - _count_nonempty(paired)
        if name == "cardioid":
            assert merged == 0, merged
        else:
            assert merged > 0, merged
    elif name == "cardioid":
        assert n_paired == n_plain, (n_paired, n_plain)
    else:
        assert n_paired < n_plain, (n_paired, n_plain)


def _count_nonempty(out):
    """Non-zero entry rows inside live tile ranges."""
    rows = np.asarray(out.stream)
    first = np.asarray(out.first)
    n_entries = np.asarray(out.n_entries)
    total = 0
    for t in range(first.shape[0]):
        r = rows[first[t]:first[t] + n_entries[t]]
        total += int((np.abs(r).sum(axis=1) > 0).sum())
    return total


@pytest.mark.parametrize("seed", list(range(8)) + [200, 201])
def test_pairing_fuzz_command_sequence(seed):
    """Random scenes (incl. degenerate shapes and clip/layer groups,
    seeds 200+): paired and unpaired streams decode to identical
    per-tile command sequences.  One shared config keeps this to two
    XLA compiles for the whole sweep."""
    from tests.test_fuzz import SHARED_CFG, random_scene

    scene = random_scene(seed, groups=seed >= 200)
    plain = run_entries(scene, SHARED_CFG, pair=False)
    for mode in ("compact", "hole"):
        paired = run_entries(scene, SHARED_CFG, pair=mode)
        np.testing.assert_array_equal(np.asarray(paired.solid),
                                      np.asarray(plain.solid))
        np.testing.assert_array_equal(np.asarray(paired.counts),
                                      np.asarray(plain.counts))
        for t, (a, b) in enumerate(zip(decode_stream(plain),
                                       decode_stream(paired))):
            assert a == b, f"seed {seed} {mode} tile {t}"


def test_pairing_image_exact_interpret():
    """Paired entries through the Pallas interpreter (CPU) vs the oracle:
    strokes (L2 pairs) + fills (F2 pairs) in one scene."""
    name, make, cfg_kw = CASES[1]  # cardioid: lines + circle fills
    cfg = RenderConfig(**cfg_kw)
    scene = make()
    img = Renderer(cfg, fine_impl="pallas", interpret=True).render(scene)
    gold = cpu_render_scene(scene, cfg)
    diff = np.abs(img.astype(np.int32) - gold.astype(np.int32))
    assert diff.max() <= 2, f"maxdiff {diff.max()}"
    assert (diff.max(-1) > 0).mean() < 1e-4
