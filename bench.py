#!/usr/bin/env python
"""Benchmark: ms/frame of every benchmark scene on one GPU.

    python bench.py

Prints one JSON line per scene, then a summary line last:
  {"metric": "tiger_4k_ms_per_frame", "value": <ms>, "unit": "ms/frame",
   "device": {...}, "card": "<name>, <power limit>", "configs": {...}}

Each scene is encoded and staged to the device once (the reference
likewise encodes only on resize, PietRenderer.m:105-146); the timed region
is the jitted render step (coarse binning + fine raster + present).  A
sample dispatches ``FRAMES`` steps and ends with ``block_until_ready``;
the value is the median of ``SAMPLES`` samples after a timed warm-up
(``piet_tpu.gpu.time_render``, which chip_smoke.py phase 5 shares).
Without a GPU the script fails: a CPU number is never reported as a
device number.
"""

import json
import sys


def main() -> int:
    import jax

    from piet_tpu.compile_cache import enable_compile_cache
    from piet_tpu.gpu import (FRAMES, SAMPLES, card_info, require_gpu,
                              time_render)
    from piet_tpu.scene.fixtures import BENCH_SCENES

    devices = require_gpu(jax.devices())
    enable_compile_cache()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    card = card_info()

    results = {}
    for name, (make, w, h) in BENCH_SCENES.items():
        t = time_render(make(), w, h)
        results[name] = t["median_ms"]
        print(json.dumps({"config": name, "ms_per_frame": t["median_ms"],
                          "min_ms": t["min_ms"], "max_ms": t["max_ms"],
                          "warmup_samples": t["warmup_samples"],
                          "viewport": f"{w}x{h}",
                          "n_segments": t["n_segments"],
                          "max_tile_cmds": t["max_tile_cmds"]}),
              flush=True)

    print(json.dumps({
        "metric": "tiger_4k_ms_per_frame", "value": results["tiger_4k"],
        "unit": "ms/frame", "device": device, "card": card,
        "frames": FRAMES, "samples": SAMPLES,
        "timing": "median of samples; block_until_ready; timed warm-up",
        "configs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
