#!/usr/bin/env python
"""On-card smoke run: the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py              # phases 1-5 on one card
    python chip_smoke.py --chips 4    # the row-sharded renderer on 4 cards

One process: JAX opens the card once and no child process touches JAX
(``nvidia-smi`` is the only child).  Each phase prints one JSON line; any
failure exits non-zero without the final line, which is exactly

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases (one card):

1. device -- refuse anything but a GPU; print the card, its power limit
   and the compile-cache directory.
2. kernel -- the 4K tiger through the GPU fine kernel (entry stream) and
   through the XLA interpreter (dense PTCL), each against the C++ golden;
   compile seconds and ``memory_analysis()`` of each jitted step.
3. coarse -- the device coarse pass at the small tests/test_coarse.py
   sizes against the numpy tiler, command for command.
4. main_path -- ``Renderer.for_scene(...).render`` for tiger_4k and
   beziers_10k against the golden, clip/layer/gradient scenes against the
   numpy oracle, a short ``render_sequence``, and the on-card exactness
   tests of tests/test_gpu_exact.py, called in-process.
5. timing -- ms/frame of every benchmark scene through both fine
   pipelines, timed as bench.py times it (``piet_tpu.gpu.time_render``).

Each phase is a function that the CPU tests call at tiny sizes with
``interpret=True`` (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

#: The XLA interpreter takes up to seconds a frame at 4K, so its pipeline
#: is timed with XLA_FRAMES x XLA_SAMPLES (the GPU kernel's with bench.py's
#: piet_tpu.gpu.FRAMES x SAMPLES).
XLA_FRAMES = 1
XLA_SAMPLES = 3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def to_rgba(img_u32, height: int, width: int) -> np.ndarray:
    img = np.ascontiguousarray(np.asarray(img_u32))
    return img.view(np.uint8).reshape(height, width, 4)


def image_diff(img, ref) -> dict:
    d = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    return {"max_codes": int(d.max()),
            "pixel_frac": float((d.max(-1) > 0).mean())}


def assert_close(diff: dict, what: str, interpret: bool) -> None:
    """Hold a comparison to the stated tolerance (tests/_imgcmp.py): the
    GPU's, or XLA:CPU's for an interpret-mode rehearsal."""
    from tests._imgcmp import CPU_FMA_FRAC, GPU_MAX_CODES, GPU_MAX_FRAC
    codes, frac = (2, CPU_FMA_FRAC) if interpret else (GPU_MAX_CODES,
                                                       GPU_MAX_FRAC)
    if diff["max_codes"] > codes or diff["pixel_frac"] > frac:
        raise AssertionError(f"{what}: {diff} exceeds the stated tolerance "
                             f"({codes} codes on {frac} of pixels)")


def golden(scene, cfg) -> np.ndarray:
    """The C++ golden rasterizer's image (cc/, built by make at first
    use) at the config's tile geometry."""
    from piet_tpu import native
    from piet_tpu.scene import encode_scene
    img, overflow = native.render_golden(
        encode_scene(scene), cfg.width, cfg.height, tile_w=cfg.tile_width,
        tile_h=cfg.tile_height, cmd_capacity=cfg.cmd_capacity)
    if overflow:
        raise AssertionError(f"golden PTCL overflow {overflow}")
    return img


def _sort_lowering(compiled) -> dict:
    """How the step's sorts were lowered: XLA:GPU hands a one-key +
    payload sort to CUB's radix sort as a custom call."""
    hlo = compiled.as_text() or ""
    return {"cub_sort_calls": hlo.count("DeviceRadixSort"),
            "hlo_sorts": hlo.count(" sort(")}


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, k)}


# ---------------------------------------------------------------------------
# Phases


def phase_device(jax) -> dict:
    from piet_tpu.compile_cache import enable_compile_cache
    from piet_tpu.gpu import card_info, require_gpu
    devices = require_gpu(jax.devices())
    return {"kind": devices[0].device_kind, "count": len(devices),
            "card": card_info(), "compile_cache": enable_compile_cache()}


def phase_kernel(scene, width: int, height: int, *,
                 interpret: bool = False) -> dict:
    """Both fine pipelines on one frame, each vs the C++ golden."""
    from piet_tpu.gpu import bench_config
    from piet_tpu.renderer.renderer import make_render_fn, prepare_scene
    cfg = bench_config(scene, width, height)
    dev = prepare_scene(scene, cfg)
    imgs, out = {}, {}
    for impl in ("pallas", "xla"):
        fn = make_render_fn(cfg, interpret=interpret, fine_impl=impl)
        t0 = time.perf_counter()
        compiled = fn.lower(dev).compile()
        compile_s = time.perf_counter() - t0
        img, stats = compiled(dev)
        imgs[impl] = to_rgba(img, cfg.height, cfg.width)
        out[impl] = {"compile_s": compile_s, "memory": _memory(compiled),
                     "sort": _sort_lowering(compiled),
                     "max_tile_cmds": int(stats["max_tile_cmds"])}
    gold = golden(scene, cfg)
    out["kernel_vs_xla"] = image_diff(imgs["pallas"], imgs["xla"])
    out["kernel_vs_golden"] = image_diff(imgs["pallas"], gold)
    out["xla_vs_golden"] = image_diff(imgs["xla"], gold)
    assert_close(out["kernel_vs_golden"], "kernel vs golden", interpret)
    assert_close(out["xla_vs_golden"], "xla vs golden", interpret)
    return out


def phase_coarse(cases, *, jit: bool = True) -> dict:
    """Device coarse pass vs the numpy tiler (tests/test_coarse.py),
    command for command.  ``jit=False`` runs it op by op: the CPU
    rehearsal, since XLA:CPU contracts mul+add inside fusions."""
    import jax

    from piet_tpu.config import RenderConfig
    from piet_tpu.ops.coarse import coarse_rasterize
    from piet_tpu.raster.cpu_tiler import cpu_tile_scene
    from piet_tpu.renderer.renderer import prepare_scene
    from tests.test_coarse import assert_ptcl_equal

    done = []
    for name, make, cfg_kw in cases:
        cfg = RenderConfig(**cfg_kw)
        scene = make()
        kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                  tile_w=cfg.tile_width, tile_h=cfg.tile_height,
                  cmd_capacity=cfg.cmd_capacity,
                  max_segments=cfg.max_segments, max_hits=cfg.max_hits,
                  max_candidates=cfg.max_candidates,
                  max_deltas=cfg.max_deltas)
        run = lambda d: coarse_rasterize(d, **kw)  # noqa: E731
        out = (jax.jit(run) if jit else run)(prepare_scene(scene, cfg))
        assert_ptcl_equal(out, cpu_tile_scene(scene, cfg), cfg)
        done.append(name)
    return {"exact": done}


def phase_main_path(big_scenes, small_scenes, sequence, *,
                    interpret: bool = False) -> dict:
    """The user entry points on the timed path, each against its oracle.

    big_scenes: [(name, scene, w, h)] vs the C++ golden;
    small_scenes: [(name, scene, w, h)] vs the numpy oracle (group
    commands: clips, layers, gradients); sequence: (scenes, w, h) for one
    ``render_sequence`` call, checked frame by frame against the golden.
    """
    from piet_tpu.raster.cpu_fine import cpu_render_scene
    from piet_tpu.renderer.renderer import Renderer

    out = {}
    for name, scene, w, h in big_scenes:
        r = Renderer.for_scene(scene, w, h, interpret=interpret,
                               tile_height=32, tile_width=128)
        d = image_diff(r.render(scene), golden(scene, r.config))
        assert_close(d, name, interpret)
        out[name] = {**d, "max_tile_cmds": int(r.last_stats["max_tile_cmds"]),
                     "dense_cmd_capacity": r.config.cmd_capacity}
    for name, scene, w, h in small_scenes:
        r = Renderer.for_scene(scene, w, h, interpret=interpret,
                               tile_height=16, tile_width=128)
        d = image_diff(r.render(scene), cpu_render_scene(scene, r.config))
        assert_close(d, name, interpret)
        out[name] = d
    scenes, w, h = sequence
    r = Renderer.for_scene(scenes[0], w, h, interpret=interpret,
                           tile_height=32, tile_width=128)
    imgs = r.render_sequence(scenes)
    worst = {"max_codes": 0, "pixel_frac": 0.0}
    for s, img in zip(scenes, imgs):
        d = image_diff(img, golden(s, r.config))
        assert_close(d, "render_sequence", interpret)
        worst = {k: max(worst[k], d[k]) for k in worst}
    out["render_sequence"] = {"frames": len(scenes), **worst}
    return out


def phase_gpu_exact(device) -> dict:
    """tests/test_gpu_exact.py, in this process (a pytest child could not
    reserve the card's memory)."""
    import tests.test_gpu_exact as t
    names = sorted(n for n in dir(t) if n.startswith("test_"))
    for n in names:
        getattr(t, n)(device)
    return {"passed": names}


def phase_timing(scenes, *, interpret: bool = False, runs=None) -> dict:
    """ms/frame of (a) entry stream + GPU kernel and (b) dense PTCL +
    fine_xla, per scene: scenes = [(name, scene, w, h)]; ``runs`` gives
    (frames, samples) for (a) and (b)."""
    from piet_tpu.gpu import FRAMES, SAMPLES, time_render
    runs = runs or ((FRAMES, SAMPLES), (XLA_FRAMES, XLA_SAMPLES))
    out = {}
    for name, scene, w, h in scenes:
        out[name] = {
            label: time_render(scene, w, h, fine_impl=impl, frames=frames,
                               samples=samples, interpret=interpret)
            for (label, impl), (frames, samples) in zip(
                (("kernel", "pallas"), ("xla", "xla")), runs)}
    return out


def phase_sharded(scene, width: int, height: int, devices, *,
                  interpret: bool = False) -> dict:
    """ShardedRenderer over a 1D mesh of ``devices`` vs the one-device
    Renderer (bitwise) and the golden."""
    from jax.sharding import Mesh

    from piet_tpu.gpu import bench_config
    from piet_tpu.parallel import ShardedRenderer
    from piet_tpu.renderer.renderer import Renderer

    cfg = bench_config(scene, width, height)
    sr = ShardedRenderer(cfg, Mesh(np.array(devices), ("y",)),
                         interpret=interpret)
    img_u32 = sr.render_u32(scene)
    shard_devices = sorted({str(s.device) for s in img_u32.addressable_shards})
    if len(shard_devices) != len(devices):
        raise AssertionError(f"output shards on {shard_devices}, expected "
                             f"{len(devices)} devices")
    img = sr.render(scene)
    one = Renderer(cfg, interpret=interpret).render(scene)
    if not np.array_equal(img, one):
        raise AssertionError(f"sharded != one-device: {image_diff(img, one)}")
    d = image_diff(img, golden(scene, cfg))
    assert_close(d, "sharded vs golden", interpret)
    return {"shard_devices": shard_devices, "bitwise_vs_one_device": True,
            "vs_golden": d}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the row-sharded path on four cards")
    args = ap.parse_args(argv)

    import jax

    dev_info = phase_device(jax)
    devices = jax.devices()
    emit("device", **dev_info)
    from piet_tpu.scene.fixtures import BENCH_SCENES

    def bench(name):
        make, w, h = BENCH_SCENES[name]
        return name, make(), w, h

    if args.chips == 4:
        if len(devices) < 4:
            raise RuntimeError(f"--chips 4 needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        _, scene, w, h = bench("tiger_4k")
        emit("sharded", **phase_sharded(scene, w, h, devices))
    else:
        devices = devices[:1]
        from piet_tpu.scene.fixtures import (make_animated_frame,
                                             make_gradient_demo)
        from tests.test_coarse import CASES
        from tests.test_group_clips import _clip_scene, _nested_scene
        _, scene, w, h = bench("tiger_4k")
        emit("kernel", scene="tiger_4k", **phase_kernel(scene, w, h))
        emit("coarse", **phase_coarse(CASES))
        small = [("clip_layer", _clip_scene(), 256, 256),
                 ("nested_clips", _nested_scene(), 256, 256),
                 ("gradients", make_gradient_demo(512), 512, 512)]
        seq = ([make_animated_frame(t / 8.0) for t in range(4)], 1024, 1024)
        emit("main_path", **phase_main_path(
            [bench("tiger_4k"), bench("beziers_10k")], small, seq))
        emit("gpu_exact", **phase_gpu_exact(devices[0]))
        emit("timing", card=dev_info["card"], **phase_timing(
            [bench(n) for n in BENCH_SCENES]))
    print(dev_info["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
