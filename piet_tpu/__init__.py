"""piet-tpu: a compute-based 2D vector graphics renderer in JAX.

A from-scratch JAX/XLA/Pallas reimplementation of the capabilities of
linebender/piet-metal (Raph Levien's compute-shader 2D renderer research
prototype): scene encoding, coarse tile binning, and per-pixel antialiased
rasterization (winding-number fills, distance-field strokes) -- with dense
sort-based binning in XLA instead of SIMT ballots, a Pallas GPU kernel per
tile strip, and a single XLA-compiled render step.

Layering (mirrors SURVEY.md section 1, bottom-up):
  geometry/  -- Bezier flattening, SVG paths          (ref L4: flatten.rs)
  scene/     -- SoA scene + byte-exact wire encoder   (ref L4: lib.rs encoder)
  layout/    -- struct-layout codegen (C++/Python)    (ref L3: piet-gpu-derive)
  raster/    -- CPU golden rasterizer + CPU tiler     (oracle for ref L2/L1)
  ops/       -- XLA passes + the Pallas GPU fine kernel (ref L2/L1 kernels)
  renderer/  -- one-jit host orchestration, CLI       (ref L5/L6)
  parallel/  -- multi-device mesh sharding            (not in the reference)
"""

__version__ = "0.2.0"

from .config import REFERENCE_CONFIG, RenderConfig, THIN_LINE, TIGER_SCALE, TOLERANCE

__all__ = ["RenderConfig", "REFERENCE_CONFIG", "TOLERANCE", "THIN_LINE",
           "TIGER_SCALE", "__version__"]
