"""The GPU fine kernel's wrapper and control paths, in interpret mode.

Hand-built entry streams (layout/entry_stream.py word map) pin the
wrapper's shapes, strips and ``row0`` offsets, the empty and bail tiles,
and paired entries; scenes at MAX_GROUP_DEPTH pin the scratch-plane
stacks against the numpy oracle.  Also: how ``fine_impl`` resolves, the
compile-cache location, and that nothing imports a Pallas backend that
cannot compile for the GPU.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from piet_tpu.layout.entry_stream import (ENTRY_WORDS, W_S0_ARG, W_S0_TAG,
                                          W_S1_ARG, W_S1_TAG)
from piet_tpu.config import MAX_GROUP_DEPTH, RenderConfig
from piet_tpu.ops.fine import fine_rasterize_entries
from piet_tpu.raster.ptcl import (CMD_DRAW_FILL, CMD_DRAW_LIN_GRAD,
                                  CMD_FILL, CMD_SOLID)

REPO = pathlib.Path(__file__).resolve().parents[1]
WHITE = 0xFFFFFFFF


def _entry(tag0, args0=(), tag1=0.0, args1=()):
    """One 16-word entry row: slot-0 tag + its operand words 0..11
    (words 8-11 land past W_S1_TAG, as in layout/entry_stream.py), slot-1
    tag + operand words 0..4."""
    row = np.zeros(ENTRY_WORDS, np.float32)
    row[W_S0_TAG] = tag0
    for k, v in enumerate(args0):
        row[W_S0_ARG + k] = v
    if tag1:
        row[W_S1_TAG] = tag1
        for k, v in enumerate(args1):
            row[W_S1_ARG + k] = v
    return row


NO_CLIP = (-1e9, -1e9, 1e9, 1e9)


def _solid(r, g, b, a=1.0):
    return _entry(CMD_SOLID, (r, g, b, a, 0.0, 0.0, 0.0, 0.0) + NO_CLIP)


def _run(stream, first, n, solid=None, row0=0, **kw):
    n_tiles = len(first)
    solid = np.zeros(n_tiles, np.uint32) if solid is None else solid
    out = fine_rasterize_entries(
        jnp.asarray(first, jnp.int32), jnp.asarray(n, jnp.int32),
        jnp.asarray(solid, jnp.uint32), jnp.asarray(np.stack(stream)),
        row0, interpret=True, **kw)
    return np.asarray(out)


@pytest.mark.parametrize("tile_h,tile_w", [
    (32, 128), (16, 16), (4, 32), (12, 128)])
def test_output_shape_and_strips(tile_h, tile_w):
    """Framebuffer layout for any tile height (a strip is STRIP_H rows, or
    fewer where the tile height is not a multiple); every strip of a tile
    sees the same entries."""
    stream = [_solid(1.0, 0.0, 0.0), _solid(0.0, 0.0, 1.0)]
    img = _run(stream, first=[0, 1, 0], n=[1, 1, 0], tile_h=tile_h,
               tile_w=tile_w, tiles_x=3)
    assert img.shape == (tile_h, 3 * tile_w) and img.dtype == np.uint32
    np.testing.assert_array_equal(img[:, :tile_w], 0xFF0000FF)
    np.testing.assert_array_equal(img[:, tile_w:2 * tile_w], 0xFFFF0000)
    np.testing.assert_array_equal(img[:, 2 * tile_w:], WHITE)


def test_bad_stream_width_and_group_depth_rejected():
    with pytest.raises(ValueError):
        _run([_solid(1.0, 1.0, 1.0)], [0], [1], tile_h=16, tile_w=16,
             tiles_x=1, group_depth=MAX_GROUP_DEPTH + 1)
    with pytest.raises(ValueError):
        fine_rasterize_entries(
            jnp.zeros(1, jnp.int32), jnp.ones(1, jnp.int32),
            jnp.zeros(1, jnp.uint32), jnp.zeros((4, 8), jnp.float32),
            tile_h=16, tile_w=16, tiles_x=1, interpret=True)


def test_empty_and_bail_tiles():
    """n == 0 tiles take the present fast path: the bail colour bytes, or
    white without one; they read no entries."""
    stream = [_solid(0.0, 1.0, 0.0)]
    img = _run(stream, first=[0, 0, 0], n=[0, 1, 0],
               solid=[0, 0, 0x11223344], tile_h=8, tile_w=16, tiles_x=3)
    np.testing.assert_array_equal(img[:, :16], WHITE)
    np.testing.assert_array_equal(img[:, 16:32], 0xFF00FF00)
    np.testing.assert_array_equal(img[:, 32:], 0x11223344)


def test_row0_offsets_pixel_rows():
    """A slab starting at tile row ``row0`` renders the rows that the
    whole-viewport call renders there (pixel coordinates are absolute)."""
    # Linear gradient in y: t = y / 64 over the winding-1 area.
    grad = _entry(CMD_DRAW_LIN_GRAD,
                  (1.0, 0.0, 1.0 / 64, 0.0, 1.0, 0.0, 0.0, 1.0,
                   0.0, 0.0, 1.0, 1.0))
    full = _run([grad], first=[0, 0], n=[1, 1], tile_h=16, tile_w=16,
                tiles_x=1)
    slab = _run([grad], first=[0], n=[1], row0=1, tile_h=16, tile_w=16,
                tiles_x=1)
    np.testing.assert_array_equal(slab, full[16:])
    assert not np.array_equal(full[:16], full[16:])


def test_paired_entries_match_unpaired():
    """Slot 0 applies before slot 1, each by its own tag: an F2 entry
    (two fills) equals the same fills as two entries."""
    # Fill operands [sx, sy, ey, m, K]: two vertical edges (m = 0) with
    # opposite winding, then a DrawFill of the covered strip.
    f1 = (3.0, 0.0, 16.0, 0.0, 1.0)
    f2 = (11.0, 16.0, 0.0, 0.0, -1.0)
    draw = _entry(CMD_DRAW_FILL, (0.0, 0.2, 0.4, 0.6, 1.0, 0.0, 0.0, 0.0)
                  + NO_CLIP)
    unpaired = [_entry(0.0, (), CMD_FILL, f1), _entry(0.0, (), CMD_FILL, f2),
                draw]
    paired = [_entry(CMD_FILL, f1, CMD_FILL, f2), draw]
    a = _run(unpaired, first=[0], n=[3], tile_h=16, tile_w=16, tiles_x=1)
    b = _run(paired, first=[0], n=[2], tile_h=16, tile_w=16, tiles_x=1)
    np.testing.assert_array_equal(a, b)
    assert (a[:, 4:11] != WHITE).all() and (a[:, 12:] == WHITE).all()


def _nested(kind, depth=MAX_GROUP_DEPTH):
    from piet_tpu.scene.scene import SceneBuilder
    b = SceneBuilder()
    b.fill([(0, 0), (128, 0), (128, 64), (0, 64)], 0x336699FF)
    for d in range(depth):
        if kind == "clip" or (kind == "mixed" and d % 2 == 0):
            m = 6 + 10 * d
            b.clip_path([(m, m), (128 - m, m + 3), (128 - m, 64 - m),
                         (m + 5, 64 - m)], even_odd=d % 2 == 1)
        else:
            b.push_layer(0.8 - 0.15 * d)
        b.fill([(10 * d, 0), (128, 20 + 5 * d), (30, 64)],
               0xCC3311FF + (d << 16))
    for _ in range(depth):
        b.pop()
    # A group-free fill after the pops.
    b.fill([(100, 40), (128, 40), (128, 64)], 0x11AA44FF)
    return b.build()


def _kernel_vs_oracle(scene):
    from piet_tpu.raster.cpu_fine import cpu_render_scene
    from piet_tpu.renderer.renderer import Renderer
    from tests._imgcmp import assert_images_match

    r = Renderer.for_scene(scene, 128, 64, fine_impl="pallas",
                           interpret=True, tile_height=16, tile_width=32)
    img = r.render(scene)
    gold = cpu_render_scene(scene, r.config)
    assert_images_match(img, gold)
    return r.config, gold


@pytest.mark.parametrize("kind", ["clip", "layer", "mixed"])
def test_max_group_depth_matches_oracle(kind):
    """Clip and layer stacks at MAX_GROUP_DEPTH (the scratch planes)."""
    cfg, gold = _kernel_vs_oracle(_nested(kind))
    assert cfg.max_group_depth == MAX_GROUP_DEPTH
    assert len(np.unique(gold.reshape(-1, 4), axis=0)) > 4


@pytest.mark.parametrize("kind,depth", [("mixed", 1), ("clip", 2),
                                        ("layer", 3), ("clip", 0)])
def test_stacks_sized_to_scene_depth(kind, depth):
    """The config carries the scene's own nesting, and the kernel keeps
    that many stack levels (none, and no scratch output, at 0)."""
    cfg, _ = _kernel_vs_oracle(_nested(kind, depth))
    assert cfg.max_group_depth == depth


def test_depth_zero_kernel_equals_full_depth_kernel():
    """Without groups the depth-0 kernel (no scratch planes, no group
    branches) draws what the full-depth kernel draws."""
    fill = _entry(CMD_FILL, (3.0, 0.0, 16.0, 0.0, 1.0))
    draw = _entry(CMD_DRAW_FILL, (0.0, 0.2, 0.4, 0.6, 1.0, 0.0, 0.0, 0.0)
                  + NO_CLIP)
    stream = [fill, draw, _solid(0.5, 0.25, 1.0, 0.5)]
    args = dict(first=[0, 2], n=[2, 1], tile_h=16, tile_w=16, tiles_x=2)
    a = _run(stream, group_depth=0, **args)
    b = _run(stream, group_depth=MAX_GROUP_DEPTH, **args)
    np.testing.assert_array_equal(a, b)
    assert (a != WHITE).any()


def test_scene_deeper_than_config_rejected():
    """Staging a scene whose groups nest deeper than the config's stacks
    fails loudly (the kernel would clamp them)."""
    from piet_tpu.renderer.capacity import fit_capacities
    from piet_tpu.renderer.renderer import (SceneCapacityError, pack_scene,
                                            prepare_scene)
    scene = _nested("mixed", 2)
    assert scene.group_depth == 2
    cfg = fit_capacities(_nested("clip", 1), RenderConfig(
        width=128, height=64, tile_height=16, tile_width=32))
    assert cfg.max_group_depth == 1
    for stage in (prepare_scene, pack_scene):
        with pytest.raises(SceneCapacityError, match="max_group_depth"):
            stage(scene, cfg)
    with pytest.raises(ValueError):
        RenderConfig(max_group_depth=MAX_GROUP_DEPTH + 1)


def test_fine_impl_resolution(monkeypatch):
    from piet_tpu.renderer import renderer
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert renderer._resolve_fine_impl("auto") == "pallas"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert renderer._resolve_fine_impl("auto") == "xla"
    assert renderer._resolve_fine_impl("pallas") == "pallas"
    assert renderer._resolve_fine_impl("xla") == "xla"


def test_compile_cache_dir(monkeypatch):
    from piet_tpu import compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert compile_cache.enable_compile_cache() == "/some/cache"
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = compile_cache.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_no_non_gpu_pallas_imports():
    """No module and no test imports a Pallas backend that cannot compile
    for the GPU."""
    # Built from pieces, so this file does not match itself.
    backend = "t" + "pu"
    pat = re.compile(r"pallas(\.|\s+import\s+)(%s|mosaic)\b" % backend)
    files = list((REPO / "piet_tpu").rglob("*.py"))
    files += list((REPO / "tests").glob("*.py"))
    files += [REPO / "bench.py", REPO / "chip_smoke.py",
              REPO / "__graft_entry__.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
