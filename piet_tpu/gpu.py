"""The card a measurement runs on: presence, identity, and timing."""

from __future__ import annotations

import subprocess
import time

import numpy as np


def require_gpu(devices):
    """``devices`` if the first is a GPU; RuntimeError otherwise (a
    measurement never falls back to the CPU)."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise RuntimeError(f"a GPU is required; JAX found {found!r}")
    return devices


def card_info() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives
    them (a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


#: Frames per timing sample and samples per measurement of the benchmark
#: scenes (bench.py, chip_smoke.py phase 5).
FRAMES = 20
SAMPLES = 5
#: Warm-up: samples run until at least WARMUP_S seconds have passed and
#: two successive samples agree within WARMUP_AGREE, for at most
#: WARMUP_MAX_S seconds -- the card's clocks settle over the first
#: hundreds of milliseconds of load, so one call is not enough.
WARMUP_S = 1.0
WARMUP_AGREE = 0.05
WARMUP_MAX_S = 20.0


def time_frames(fn, arg, frames: int, samples: int) -> dict:
    """ms/frame of ``fn(arg)``: median, min and max over ``samples`` runs
    of ``frames`` back-to-back calls, each run ended by
    ``block_until_ready``, after the warm-up above (``warmup_samples``
    counts its runs)."""
    import jax

    def sample():
        t0 = time.perf_counter()
        for _ in range(frames):
            out = fn(arg)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) * 1e3 / frames

    jax.block_until_ready(fn(arg))
    t0 = time.perf_counter()
    warm = [sample(), sample()]
    while time.perf_counter() - t0 < WARMUP_MAX_S and (
            time.perf_counter() - t0 < WARMUP_S
            or abs(warm[-1] - warm[-2]) > WARMUP_AGREE * warm[-2]):
        warm.append(sample())
    ms = [sample() for _ in range(samples)]
    return {"median_ms": float(np.median(ms)), "min_ms": float(min(ms)),
            "max_ms": float(max(ms)), "warmup_samples": len(warm)}


def bench_config(scene, width: int, height: int):
    """The benchmark geometry: 32x128 tiles, capacities fitted to the
    scene."""
    from .config import RenderConfig
    from .renderer.capacity import fit_capacities
    return fit_capacities(scene, RenderConfig(width=width, height=height,
                                              tile_height=32,
                                              tile_width=128))


def time_render(scene, width: int, height: int, *, fine_impl: str = "auto",
                frames: int = FRAMES, samples: int = SAMPLES,
                interpret: bool = False) -> dict:
    """ms/frame of the jitted render step (coarse + fine + present) of a
    scene staged on the device once, at the benchmark geometry; the first
    frame goes through ``Renderer.render_u32`` (compile + capacity
    check)."""
    from .renderer.renderer import Renderer, prepare_scene
    r = Renderer(bench_config(scene, width, height), interpret=interpret,
                 fine_impl=fine_impl)
    r.render_u32(scene)
    dev = prepare_scene(scene, r.config)
    t = time_frames(lambda d: r._render(d)[0], dev, frames, samples)
    return {**t, "n_segments": int(r.last_stats["n_segments"]),
            "max_tile_cmds": int(r.last_stats["max_tile_cmds"])}
