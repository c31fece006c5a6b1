"""Viewport resize without recompile.

The reference handles ``drawableSizeWillChange`` as a *runtime* event: it
reuses its compiled pipeline states and just re-allocates textures sized to
the new drawable (TestApp/PietRenderer.m:105-146), with one static maximum
(4096x4096, PietShaderTypes.h:29-32).  Under XLA every shape is static, so
a naive per-viewport ``Renderer`` pays a full recompile (~minutes at 4K)
for each new window size.

``ResizableRenderer`` is the equivalent of the reference's
max-tiles contract: compile ONCE for the maximum tile grid, then render
any viewport that fits it with zero recompiles.

Why this is exact: pixel coordinates in the whole pipeline are absolute
(tiles know their own x0/y0; see ops/fine.py), so rendering a LARGER tile
grid and cropping yields bit-identical pixels inside the crop -- tiles
beyond the requested viewport only add commands to tiles that are cropped
away, and per-candidate state (backdrop prefix sums, bail analysis) is
computed per tile row in ascending column order, so in-viewport tiles see
identical records either way (pinned by tests/test_resize.py against
dedicated per-viewport renderers).

Cost model: out-of-viewport tiles are empty or cropped; empty tiles take
the fine kernel's fast path (no DMA, constant write), so the overhead of
rendering the max grid for a small viewport is the grid-step floor, not
real raster work.  Interactive use trades that for never recompiling --
matching the reference's behavior, where resize never rebuilds pipelines.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import RenderConfig
from .renderer import Renderer


class ResizableRenderer:
    """A renderer compiled once for a maximum viewport, rendering any
    smaller viewport with no recompilation.

    Usage:
        r = ResizableRenderer(RenderConfig(width=2048, height=2048))
        img_a = r.render(scene, 1024, 1024)   # compiles (first use)
        img_b = r.render(scene, 1664, 1664)   # NO recompile

    The config's width/height set the maximum; record capacities are the
    config's (use :meth:`for_scene` to fit them to a scene at the max
    grid).
    """

    def __init__(self, config: RenderConfig, interpret: bool = False,
                 fine_impl: str = "auto"):
        # Compile at the full padded grid so the jitted crop is a no-op;
        # the per-viewport crop happens on host (a numpy slice).
        self.max_width = config.padded_width
        self.max_height = config.padded_height
        self._config = dataclasses.replace(
            config, width=config.padded_width, height=config.padded_height)
        self._renderer = Renderer(self._config, interpret=interpret,
                                  fine_impl=fine_impl)

    @classmethod
    def for_scene(cls, scene, max_width: int, max_height: int,
                  fine_impl: str = "auto", **config_kw) -> "ResizableRenderer":
        """Capacities fitted to ``scene`` at the maximum grid (bucketed,
        so moderate scene edits don't recompile either)."""
        from .capacity import fit_capacities
        base = RenderConfig(width=max_width, height=max_height, **config_kw)
        return cls(fit_capacities(scene, base, bucket=True),
                   fine_impl=fine_impl)

    @property
    def config(self) -> RenderConfig:
        return self._config

    @property
    def last_stats(self) -> Optional[dict]:
        return self._renderer.last_stats

    def n_compiles(self) -> int:
        """Compiled-executable count of the underlying render step (the
        zero-recompile contract: stays 1 across resizes)."""
        return self._renderer._render._cache_size()

    def render(self, scene, width: int, height: int) -> np.ndarray:
        """Render ``scene`` at ``width x height`` -> (H, W, 4) uint8 RGBA.

        Any viewport with width <= max_width and height <= max_height
        reuses the one compiled executable."""
        if width > self.max_width or height > self.max_height:
            raise ValueError(
                f"viewport {width}x{height} exceeds compiled maximum "
                f"{self.max_width}x{self.max_height}; build a new "
                f"ResizableRenderer for larger viewports")
        if width <= 0 or height <= 0:
            raise ValueError("viewport must be positive")
        full = self._renderer.render(scene)
        return full[:height, :width]
