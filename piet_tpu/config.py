"""Render configuration for piet-tpu.

Mirrors the reference's compile-time configuration header
(reference: TestApp/PietShaderTypes.h:17-32), but as a runtime dataclass so a
single build supports many tile geometries, and so benchmark configs are
driven by data instead of recompiles.

Choices vs the reference:

* The reference uses 16x16-pixel tiles because that is the natural Metal
  threadgroup shape.  The default here is **32x128-pixel tiles**, which
  keeps the (segment, tile) record counts low; a sweep of tile geometries
  on the GPU is still open.  The binning/coverage algorithm is
  tile-size-parametric, so any power-of-two geometry works (16x16
  reproduces the reference).
* The dense PTCL's capacity is an explicit array dimension
  (``cmd_capacity``) instead of a byte budget; overflow is *detected and
  reported* (the reference's 4096-byte cap silently corrupts --
  PietShaderTypes.h:24-27 "for production we'd want a mechanism to
  overflow").  The GPU path's entry stream has no per-tile capacity.
"""

from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


#: Maximum clip/layer nesting depth of a scene (sizes the fine kernels'
#: plane stacks).
MAX_GROUP_DEPTH = 4


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Geometry/capacity configuration for one compiled renderer.

    All sizes are static under ``jax.jit``; changing any field triggers a
    recompile (by design -- shapes must be static for XLA).
    """

    # Viewport, in pixels. Padded internally to a whole number of tiles.
    width: int = 1024
    height: int = 1024

    # Fine-raster tile size in pixels (reference: 16x16 via
    # PietShaderTypes.h:17-18). Default: 32 rows x 128 cols (see module
    # docstring).
    tile_height: int = 32
    tile_width: int = 128

    # Max commands per tile of the dense PTCL (reference: 4096 B / 24 B =
    # 170 cmds, PietShaderTypes.h:24-27).
    cmd_capacity: int = 384

    # Capacity buckets for scene padding (recompilation trap avoidance,
    # SURVEY.md section 7 "hard parts" item 6).
    max_items: int = 1 << 11      # scene items (fills/polys/lines/circles)
    max_points: int = 1 << 16     # flattened points across all items
    max_segments: int = 1 << 16   # derived segments (points incl. fill wrap)

    # Capacity for expanded (segment x tile) hit records and per-(item,tile)
    # candidate records in the coarse/binning pass.  Defaults are sized for
    # ~1024^2 scenes of a few thousand items; coarse passes do fixed-shape
    # work over these CAPACITIES every frame, so oversizing costs frame
    # time.  Undersizing fails loud (SceneCapacityError);
    # ``Renderer.for_scene`` fits exact counts.
    max_hits: int = 1 << 18
    max_candidates: int = 1 << 16

    # Capacity for per-row winding (backdrop) delta records.
    max_deltas: int = 1 << 17

    # Deepest clip/layer nesting the GPU fine kernel keeps stacks for:
    # 4 bytes x 4 planes per level per pixel of scratch, so a scene with
    # no groups should carry 0 (``fit_capacities`` sets the scene's own).
    max_group_depth: int = MAX_GROUP_DEPTH

    def __post_init__(self):
        if self.tile_width <= 0 or self.tile_height <= 0:
            raise ValueError("tile size must be positive")
        if not 0 <= self.max_group_depth <= MAX_GROUP_DEPTH:
            raise ValueError(f"max_group_depth must be in "
                             f"[0, {MAX_GROUP_DEPTH}]")

    # -- derived tile-grid geometry -------------------------------------
    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_width)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_height)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_width

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_height

    def with_viewport(self, width: int, height: int) -> "RenderConfig":
        return dataclasses.replace(self, width=width, height=height)


#: Reference-compatible configuration: 16x16 tiles, 170-cmd PTCL, used by the
#: parity test-suite so our CPU tiler can be compared against the reference's
#: exact tiling geometry (PietShaderTypes.h:17-27).
REFERENCE_CONFIG = RenderConfig(tile_height=16, tile_width=16, cmd_capacity=256)

# Scene-level constants shared with the reference implementation.
TOLERANCE: float = 0.1          # flattening tolerance (src/lib.rs:330)
THIN_LINE: float = 0.7          # thin-stroke clamp width (src/lib.rs:351)
TIGER_SCALE: float = 8.0        # demo scene scale (src/lib.rs:287)
