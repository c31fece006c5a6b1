"""Per-stage pipeline profiler (user-invocable, tested).

Times each stage of the coarse binning pass plus the fine rasterizer on the
attached backend.  The coarse pass exposes cheap probe scalars, one per
stage (``coarse_rasterize(..., with_probes=True)`` -> ``diag["probes"]``);
jitting the cumulative prefix of probes 1..k makes XLA dead-code-eliminate
every later stage, so the measured time is exactly the dependency closure
of stage k.  Stage time = prefix(k) - prefix(k-1).

This replaces the reference's externally-tooled profiling story (Xcode GPU
capture, SURVEY.md section 5) with an in-repo, scriptable one:

    python -m piet_tpu profile --width 3840 --height 2160 --scale 19.2

Timing dispatches ``reps`` steps and waits once with
``jax.block_until_ready``.
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import numpy as np

from .config import RenderConfig
from .gpu import time_frames
from .ops.coarse import coarse_rasterize
from .ops.pairing import pair_mode_from_env
from .ops.fine import fine_rasterize_entries
from .renderer.renderer import (_resolve_fine_impl, _solid_to_present_u32,
                                make_render_fn, prepare_scene)

#: Probe order: each entry depends on all earlier ones, so cumulative
#: prefix timings are monotone and differences are per-stage costs.
STAGE_ORDER = (
    "cand_expand",    # item bbox -> candidate record expansion
    "seg_expand",     # per-item attribute row -> per-segment expansion
    "seg_points",     # segment endpoint gathers
    "seg_derive",     # line equations + bboxes over segments
    "seg_rects",      # per-segment tile emission rects
    "hit_expand",     # (segment, tile) hit-record expansion
    "hit_gather",     # packed per-segment attribute row gather
    "hit_tests",      # exact per-record f32 sign tests + slot args
    "cand_emit",      # per-candidate emitted-command counts
    "del_scatter",    # keyed delta sums (crossings ride the hit records
                      # -- the round-5 fold; no separate expansion)
    "deltas",         # backdrop prefix sums
    "rows",           # pre-sort 16-word row assembly
    "sort",           # the global stable sort
    "sorted_gather",  # sorted-order row gather
    "pairing",        # same-class entry pairing + compaction
    "tile_reduce",    # fused per-tile range/bail reductions
)


def _time_step(fn, arg, reps: int) -> float:
    """Median ms/step of three samples of ``reps`` steps (gpu.time_frames,
    with its warm-up)."""
    return round(time_frames(fn, arg, reps, 3)["median_ms"], 3)


def _isotonic(y: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators: the L2-nearest non-decreasing sequence."""
    vals = list(map(float, y))
    wts = [1.0] * len(vals)
    out_v: list[float] = []
    out_w: list[float] = []
    for v, w in zip(vals, wts):
        out_v.append(v)
        out_w.append(w)
        while len(out_v) > 1 and out_v[-2] > out_v[-1]:
            v2, w2 = out_v.pop(), out_w.pop()
            v1, w1 = out_v.pop(), out_w.pop()
            out_v.append((v1 * w1 + v2 * w2) / (w1 + w2))
            out_w.append(w1 + w2)
    res = []
    for v, w in zip(out_v, out_w):
        res.extend([v] * int(w))
    return np.asarray(res)


def profile_render(scene, config: RenderConfig, *, fine_impl: str = "auto",
                   reps: int = 40, interpret: bool = False) -> Dict[str, float]:
    """Stage -> ms for one frame of ``scene`` under ``config``.

    Returns an ordered dict: every coarse stage (incremental cost), then
    ``coarse_total``, ``fine``, ``end_to_end`` (full jitted render step,
    including the present composite).  Stage increments are non-negative
    by construction: prefixes are sampled in interleaved rounds, medianed,
    and projected onto the nearest monotone sequence before differencing
    (prefix k's dependency closure contains prefix k-1's, so the true
    cumulative times ARE monotone).
    """
    dev = prepare_scene(scene, config)
    impl = _resolve_fine_impl(fine_impl)
    kw = dict(tiles_x=config.tiles_x, tiles_y=config.tiles_y,
              tile_w=config.tile_width, tile_h=config.tile_height,
              cmd_capacity=config.cmd_capacity,
              max_segments=config.max_segments, max_hits=config.max_hits,
              max_candidates=config.max_candidates,
              max_deltas=config.max_deltas,
              output="entries" if impl == "pallas" else "dense",
              pair=pair_mode_from_env())

    def prefix_fn(k):
        names = STAGE_ORDER[:k + 1]

        @jax.jit
        def run(d):
            out = coarse_rasterize(d, with_probes=True, **kw)
            pr = out.diag["probes"]
            return sum(pr[n] for n in names if n in pr)

        return run

    stage_names = [n for k, n in enumerate(STAGE_ORDER)
                   if kw["output"] == "entries"
                   or n not in ("rows", "sorted_gather")]
    stage_ks = [k for k, n in enumerate(STAGE_ORDER) if n in stage_names]

    # Stage attribution that cannot go negative (round-3 weak #6: the
    # independent per-prefix medians differenced to seg_derive -0.28 ms at
    # 4K -- useless at the 0.5 ms scale round-4 decisions need):
    # 1. compile every prefix first, then sample all prefixes in
    #    INTERLEAVED rounds (drift hits every prefix equally, not the
    #    later-timed ones);
    # 2. per-prefix median over the rounds;
    # 3. prefix times are cumulative dependency closures, so the true
    #    sequence is monotone -- project the medians onto the nearest
    #    monotone sequence (pool-adjacent-violators) before differencing.
    # Dispatch floor: a near-empty jit over the same inputs -- the
    # per-step dispatch + queueing cost every prefix (and the production
    # frame) pays.  Reported as its own row; stage ABSOLUTE values include
    # it, stage DIFFERENCES cancel it.
    @jax.jit
    def null_fn(d):
        return d.tags[:1]

    prefix_fns = [null_fn] + [prefix_fn(k) for k in stage_ks]
    for f in prefix_fns:
        jax.block_until_ready(f(dev))  # compile + warm outside the rounds
    rounds = 5
    samples = np.zeros((rounds, len(prefix_fns)))
    for r in range(rounds):
        for j, f in enumerate(prefix_fns):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = f(dev)
            jax.block_until_ready(out)
            samples[r, j] = (time.perf_counter() - t0) * 1e3 / reps
    med = np.median(samples, axis=0)
    mono = _isotonic(med)

    results: Dict[str, float] = {}
    results["dispatch_floor"] = round(float(mono[0]), 3)
    prev = float(mono[0])
    for name, ms in zip(stage_names, mono[1:]):
        results[name] = round(float(ms - prev), 3)
        prev = float(ms)

    @jax.jit
    def coarse_full(d):
        out = coarse_rasterize(d, **kw)
        return jax.tree.map(lambda x: x, out[:-1])  # all arrays, no diag

    results["coarse_total"] = _time_step(coarse_full, dev, reps)

    if impl == "pallas":
        entries = jax.block_until_ready(coarse_full(dev))
        stream, first, n_entries, _, solid = entries
        solid_u32 = jax.block_until_ready(_solid_to_present_u32(solid))

        def fine_fn(a):
            return fine_rasterize_entries(
                *a, 0, tile_h=config.tile_height, tile_w=config.tile_width,
                tiles_x=config.tiles_x, group_depth=config.max_group_depth,
                interpret=interpret)

        results["fine"] = _time_step(
            fine_fn, (first, n_entries, solid_u32, stream), reps)

    render = make_render_fn(config, interpret=interpret, fine_impl=impl)
    results["end_to_end"] = _time_step(lambda d: render(d)[0], dev, reps)
    return results


def format_profile(results: Dict[str, float]) -> str:
    lines = [f"{'stage':<16} {'ms':>8}"]
    for k, v in results.items():
        lines.append(f"{k:<16} {v:>8.3f}")
    return "\n".join(lines)
