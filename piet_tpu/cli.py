"""Command-line entry points: render / bench / goldens / info.

The reference's "app shell" is a Cocoa window wired to a 60 Hz redraw
(TestApp/main.m, ViewController.m:12-29); headless GPU hosts get a CLI
instead, with PNG output and the fixture/benchmark scenes as subjects.

Usage:
    python -m piet_tpu render --scene tiger --out tiger.png
    python -m piet_tpu render --scene tiger --scale 19.2 --width 3840 \\
        --height 2160 --out tiger4k.png
    python -m piet_tpu bench --scene beziers_10k --frames 20
    python -m piet_tpu goldens --outdir goldens/
    python -m piet_tpu info
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_scene(args):
    from .scene.fixtures import get_scene
    kw = {}
    if args.scene == "tiger" and args.scale:
        kw["scale"] = args.scale
    if args.scene == "animated":
        kw["t"] = args.t
    return get_scene(args.scene, **kw)


def _config_for(args, scene):
    from .config import RenderConfig
    from .renderer.capacity import fit_capacities
    import numpy as np
    w = args.width or int(np.ceil(scene.bboxes[:, 2].max() + 8))
    h = args.height or int(np.ceil(scene.bboxes[:, 3].max() + 8))
    cfg = RenderConfig(width=w, height=h)
    # Record capacities fitted to the scene on host (exact counts --
    # renderer/capacity.py); padding directly costs frame time.
    return fit_capacities(scene, cfg, bucket=True)


def _timed_device(args) -> dict:
    """The device a timing runs on: a GPU, or the CPU only when ``--cpu``
    asks for it (a timing never falls back to the CPU)."""
    import jax

    from .gpu import require_gpu
    devices = jax.devices() if args.cpu else require_gpu(jax.devices())
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def cmd_render(args) -> int:
    from .renderer.renderer import Renderer
    from .scene.scene import Scene
    from .utils.png import write_png

    if args.load:
        scene = Scene.load(args.load)
    elif getattr(args, "svg", None):
        from .scene.svg_full import load_svg_file
        scene = load_svg_file(args.svg, scale=args.scale,
                              target_width=args.width)
    else:
        scene = _build_scene(args)
    if args.save_scene:
        scene.save(args.save_scene)
    cfg = _config_for(args, scene)
    t0 = time.time()
    renderer = Renderer(cfg, fine_impl=args.fine_impl)
    img = renderer.render(scene)
    print(f"rendered {cfg.width}x{cfg.height} in {time.time() - t0:.1f}s "
          f"(includes compile); stats: "
          f"{ {k: int(v) for k, v in renderer.last_stats.items()} }")
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


def cmd_bench(args) -> int:
    import jax

    from .compile_cache import enable_compile_cache
    from .renderer.renderer import Renderer, prepare_scene

    device = _timed_device(args)
    enable_compile_cache()
    scene = _build_scene(args)
    cfg = _config_for(args, scene)
    renderer = Renderer(cfg, fine_impl=args.fine_impl)
    renderer.render(scene)  # compile + capacity check
    if args.reencode:
        # Animated workload: re-encode the scene on host and re-upload
        # every frame (the reference only re-encodes on resize,
        # PietRenderer.m:105-146; per-frame re-encode is BASELINE config 5).
        # Host encode of frame t+1 overlaps device render of frame t.
        # Frame path: native C++ scene build (cc/src/fixtures.cc, ~0.1 ms
        # vs ~7 ms Python) -> ONE packed staging transfer (pack_scene)
        # -> async dispatch; capacity checked once at the end.
        import numpy as np

        from . import native
        from .renderer.renderer import pack_scene
        from .scene.fixtures import (make_animated_frame,
                                     make_animated_frame_native)
        build = (make_animated_frame_native if native.available()
                 else make_animated_frame)
        rfn = renderer.packed_render_fn()
        rfn(jax.numpy.asarray(pack_scene(scene, cfg)))  # compile
        img = stats = None
        t0 = time.perf_counter()
        for i in range(args.frames):
            frame_scene = (build(i / 60.0)
                           if args.scene == "animated" else scene)
            img, stats = rfn(jax.numpy.asarray(pack_scene(frame_scene, cfg)))
        jax.block_until_ready(img)
        value = (time.perf_counter() - t0) * 1e3 / args.frames
        renderer.last_stats = jax.tree.map(np.asarray, stats)
        renderer._check_capacity(renderer.last_stats)
    else:
        dev = prepare_scene(scene, cfg)
        jax.block_until_ready(renderer._render(dev))
        t0 = time.perf_counter()
        for _ in range(args.frames):
            img, _ = renderer._render(dev)
        jax.block_until_ready(img)
        value = (time.perf_counter() - t0) * 1e3 / args.frames
    print(json.dumps({
        "scene": args.scene, "viewport": f"{cfg.width}x{cfg.height}",
        "ms_per_frame": round(value, 3), "frames": args.frames,
        "reencode": bool(args.reencode),
        "fill_mpix_per_s": round(cfg.width * cfg.height / value / 1e3, 1),
        "device": device,
    }))
    return 0


def cmd_animate(args) -> int:
    """Render an N-frame animation to PNGs: the headless analog of the
    reference's live 60 Hz redraw loop (TestApp/PietRenderer.m:59-103,
    ViewController.m:12-29), driven through the batched
    ``Renderer.render_sequence`` path (one device dispatch per chunk)."""
    import dataclasses
    import os

    from .renderer.renderer import Renderer
    from .scene.fixtures import get_scene
    from .utils.png import write_png

    os.makedirs(args.outdir, exist_ok=True)

    if getattr(args, "affine", False) or getattr(args, "svg", None):
        return _animate_affine(args)
    if args.scene == "animated" and getattr(args, "device_anim", True):
        return _animate_device(args)

    t_enc0 = time.perf_counter()
    scenes = []
    for i in range(args.frames):
        t = args.t0 + i * args.dt
        if args.scene == "animated":
            scenes.append(get_scene("animated", t=t))
        elif args.scene == "tiger":
            # Breathing tiger: animate the scale around the requested one.
            import math
            s = (args.scale or 4.0) * (1.0 + 0.15 * math.sin(t * 2 * math.pi))
            scenes.append(get_scene("tiger", scale=s))
        else:
            scenes.append(_build_scene(args))
    encode_ms = (time.perf_counter() - t_enc0) * 1e3

    # One capacity envelope covering every frame (field-wise max), so the
    # whole sequence shares a single compiled render step.
    cfg = _config_for(args, scenes[0])
    for s in scenes[1:]:
        from .renderer.capacity import fit_capacities
        c = fit_capacities(s, cfg, bucket=True)
        cfg = dataclasses.replace(
            cfg,
            max_items=max(cfg.max_items, c.max_items),
            max_points=max(cfg.max_points, c.max_points),
            max_segments=max(cfg.max_segments, c.max_segments),
            max_hits=max(cfg.max_hits, c.max_hits),
            max_candidates=max(cfg.max_candidates, c.max_candidates),
            max_deltas=max(cfg.max_deltas, c.max_deltas),
            cmd_capacity=max(cfg.cmd_capacity, c.cmd_capacity),
            max_group_depth=max(cfg.max_group_depth, c.max_group_depth))
    renderer = Renderer(cfg, fine_impl=args.fine_impl)

    chunk = max(1, args.chunk)
    t_r0 = time.perf_counter()
    frames = []
    for lo in range(0, len(scenes), chunk):
        frames.append(renderer.render_sequence(scenes[lo:lo + chunk]))
    render_ms = (time.perf_counter() - t_r0) * 1e3
    n = 0
    for batch in frames:
        for img in batch:
            write_png(os.path.join(args.outdir, f"frame_{n:04d}.png"), img)
            n += 1
    print(json.dumps({
        "scene": args.scene, "frames": n,
        "viewport": f"{cfg.width}x{cfg.height}",
        "encode_ms_per_frame": round(encode_ms / n, 3),
        "render_ms_per_frame": round(render_ms / n, 3),
        "outdir": args.outdir,
    }))
    return 0


def _animate_device(args) -> int:
    """Device-side animation (scene/animate.py): geometry is a function of
    scalar t evaluated INSIDE the render jit -- zero host encode per frame
    (the answer to the reference's static-scene 60 Hz loop,
    TestApp/PietRenderer.m:59-103)."""
    import dataclasses
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np

    from .renderer.capacity import fit_capacities
    from .scene import animate
    from .scene.fixtures import make_animated_frame
    from .utils.png import write_png

    tmpl = animate.template_scene()
    cfg = _config_for(args, tmpl)
    # Capacity envelope over the t sweep (field-wise max of a few sampled
    # host-built frames + bucket headroom) so one executable covers the
    # whole animation; overflow is still checked per run via stats.
    for k in range(1, 5):
        t = args.t0 + (args.frames - 1) * args.dt * k / 4
        c = fit_capacities(make_animated_frame(t), cfg, bucket=True)
        cfg = dataclasses.replace(
            cfg,
            max_segments=max(cfg.max_segments, c.max_segments),
            max_hits=max(cfg.max_hits, c.max_hits),
            max_candidates=max(cfg.max_candidates, c.max_candidates),
            max_deltas=max(cfg.max_deltas, c.max_deltas),
            cmd_capacity=max(cfg.cmd_capacity, c.cmd_capacity))
    render_t, _ = animate.make_animated_render_fn(
        cfg, fine_impl=args.fine_impl)

    jax.block_until_ready(render_t(jnp.float32(args.t0)))  # compile + warm

    # The 60 fps loop: dispatch every frame (one f32 argument each -- no
    # host re-encode, no staging), sync once at the end.
    t_r0 = time.perf_counter()
    outs = [render_t(jnp.float32(args.t0 + i * args.dt))
            for i in range(args.frames)]
    jax.block_until_ready(outs)
    wall_ms = (time.perf_counter() - t_r0) * 1e3

    os.makedirs(args.outdir, exist_ok=True)
    for i, (img, st) in enumerate(outs):
        write_png(os.path.join(args.outdir, f"frame_{i:04d}.png"),
                  np.ascontiguousarray(np.asarray(img)).view(np.uint8)
                  .reshape(cfg.height, cfg.width, 4))
    print(json.dumps({
        "scene": "animated", "frames": args.frames, "device_anim": True,
        "viewport": f"{cfg.width}x{cfg.height}",
        "encode_ms_per_frame": 0.0,
        "wall_ms_per_frame": round(wall_ms / args.frames, 3),
        "fps_wall": round(1e3 * args.frames / wall_ms, 1),
        "outdir": args.outdir,
    }))
    return 0


def _animate_affine(args) -> int:
    """Device-side affine animation for ANY scene (scene/affine.py,
    round 5): stage the scene once, spin/zoom it about the viewport
    center with the per-frame transform computed INSIDE the render jit
    -- zero host encode per frame, the general-scene answer to the
    reference's re-encode loop (TestApp/PietRenderer.m:105-146)."""
    import dataclasses
    import math
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np

    from .renderer.capacity import fit_capacities
    from .scene import affine
    from .utils.png import write_png

    if getattr(args, "svg", None):
        from .scene.svg_full import load_svg_file
        scene = load_svg_file(args.svg, scale=args.scale or 1.0)
    else:
        scene = _build_scene(args)
    cfg = _config_for(args, scene)
    cx, cy = cfg.width / 2.0, cfg.height / 2.0

    def angle(t):
        return t * (2.0 * math.pi / args.period)

    def zoom(t):
        return 1.0 + args.zoom * math.sin(t * 2.0 * math.pi / args.period)

    # Capacity envelope over the t sweep: record counts change under
    # rotation, so fit a few HOST-transformed samples and take the max
    # (overflow is still checked per frame via stats).
    for k in range(5):
        t = args.t0 + (args.frames - 1) * args.dt * k / 4
        m = np.asarray(affine.rotation_about(cx, cy, angle(t), zoom(t)))
        c = fit_capacities(affine.host_transform_scene(scene, m), cfg,
                           bucket=True)
        cfg = dataclasses.replace(
            cfg,
            max_hits=max(cfg.max_hits, c.max_hits),
            max_candidates=max(cfg.max_candidates, c.max_candidates),
            max_deltas=max(cfg.max_deltas, c.max_deltas),
            cmd_capacity=max(cfg.cmd_capacity, c.cmd_capacity))

    period = args.period

    def mats_fn(t):
        a = t * jnp.float32(2.0 * math.pi / period)
        s = 1.0 + args.zoom * jnp.sin(a)
        return affine.rotation_about(cx, cy, a, s)

    render_t = affine.make_affine_render_fn(cfg, scene, mats_fn,
                                            fine_impl=args.fine_impl)
    jax.block_until_ready(render_t(jnp.float32(args.t0)))  # compile + warm

    t_r0 = time.perf_counter()
    outs = [render_t(jnp.float32(args.t0 + i * args.dt))
            for i in range(args.frames)]
    jax.block_until_ready(outs)
    wall_ms = (time.perf_counter() - t_r0) * 1e3

    os.makedirs(args.outdir, exist_ok=True)
    for i, (im, st) in enumerate(outs):
        write_png(os.path.join(args.outdir, f"frame_{i:04d}.png"),
                  np.ascontiguousarray(np.asarray(im)).view(np.uint8)
                  .reshape(cfg.height, cfg.width, 4))
    print(json.dumps({
        "scene": args.scene if not getattr(args, "svg", None) else args.svg,
        "frames": args.frames, "device_affine": True,
        "viewport": f"{cfg.width}x{cfg.height}",
        "encode_ms_per_frame": 0.0,
        "wall_ms_per_frame": round(wall_ms / args.frames, 3),
        "fps_wall": round(1e3 * args.frames / wall_ms, 1),
        "outdir": args.outdir,
    }))
    return 0


def cmd_profile(args) -> int:
    """Per-stage pipeline timing on the GPU, or the CPU with ``--cpu`` (see
    piet_tpu/profiling.py for methodology)."""
    from .compile_cache import enable_compile_cache
    from .profiling import format_profile, profile_render

    device = _timed_device(args)
    enable_compile_cache()
    scene = _build_scene(args)
    cfg = _config_for(args, scene)
    results = profile_render(scene, cfg, fine_impl=args.fine_impl,
                             reps=args.frames)
    print(format_profile(results))
    print(json.dumps({"device": device, "stages_ms": results}))
    return 0


def cmd_goldens(args) -> int:
    """Render every fixture through the device path and the CPU oracle,
    write PNG pairs, and report the max difference."""
    import os

    import numpy as np

    from .config import RenderConfig
    from .raster.cpu_fine import cpu_render_scene
    from .renderer.renderer import Renderer
    from .scene.fixtures import get_scene
    from .utils.png import write_png

    os.makedirs(args.outdir, exist_ok=True)
    # 512^2: the scalar CPU oracle is O(tiles x items) in Python; this
    # keeps a full golden sweep under a minute.
    names = ["path_test", "cardioid", "circles_rects", "glyph_page",
             "clip_star", "gradients", "holes"]
    worst = 0
    for name in names:
        scene = get_scene(name)
        from .renderer.capacity import fit_capacities
        cfg = fit_capacities(
            scene, RenderConfig(width=512, height=512, tile_height=16,
                                tile_width=128), bucket=True)
        img = Renderer(cfg, fine_impl=args.fine_impl).render(scene)
        gold = cpu_render_scene(scene, cfg)
        diff = int(np.abs(img.astype(int) - gold.astype(int)).max())
        worst = max(worst, diff)
        write_png(os.path.join(args.outdir, f"{name}.png"), img)
        write_png(os.path.join(args.outdir, f"{name}_golden.png"), gold)
        print(f"{name}: max |device - golden| = {diff}")
    return 0 if worst <= args.tolerance else 1


def cmd_dump(args) -> int:
    """Hexdump a scene's wire encoding (u32 words, annotated): the
    debugging aid of the reference's ``Encoder::debug_print``
    (src/lib.rs:242-253), reachable from the CLI instead of a code toggle."""
    from .scene.scene import Scene
    from .scene.wire import encode_scene, hexdump_scene

    scene = Scene.load(args.load) if args.load else _build_scene(args)
    print(hexdump_scene(encode_scene(scene)))
    return 0


def cmd_info(args) -> int:
    import jax

    from . import native
    print(f"backend: {jax.default_backend()}")
    print(f"devices: {jax.devices()}")
    print(f"native C++ library: "
          f"{'available' if native.available() else 'unavailable'}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="piet_tpu", description=__doc__)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend")
    sub = p.add_subparsers(dest="cmd", required=True)

    def scene_args(sp):
        sp.add_argument("--scene", default="tiger")
        sp.add_argument("--scale", type=float, default=None)
        sp.add_argument("--t", type=float, default=0.0)
        sp.add_argument("--width", type=int, default=None)
        sp.add_argument("--height", type=int, default=None)
        sp.add_argument("--fine-impl", default="auto",
                        choices=["auto", "pallas", "xla"])

    r = sub.add_parser("render", help="render a scene to PNG")
    scene_args(r)
    r.add_argument("--out", default="out.png")
    r.add_argument("--load", help="load scene from .npz instead")
    r.add_argument("--svg", help="render an SVG FILE via the general "
                   "parser (scene/svg_full.py; --scale applies)")
    r.add_argument("--save-scene", help="also save the scene as .npz")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench", help="time a scene, print JSON")
    scene_args(b)
    b.add_argument("--frames", type=int, default=20)
    b.add_argument("--reencode", action="store_true",
                   help="re-encode + re-upload the scene every frame")
    b.set_defaults(fn=cmd_bench)

    a = sub.add_parser("animate", help="render an N-frame animation to PNGs")
    scene_args(a)
    a.add_argument("--frames", type=int, default=24)
    a.add_argument("--t0", type=float, default=0.0)
    a.add_argument("--dt", type=float, default=1.0 / 60.0)
    a.add_argument("--chunk", type=int, default=8,
                   help="frames per device dispatch")
    a.add_argument("--outdir", default="frames")
    a.add_argument("--affine", action="store_true",
                   help="device-side affine animation of ANY scene "
                        "(spin/zoom about the viewport center; "
                        "scene/affine.py)")
    a.add_argument("--svg", help="affine-animate an SVG file (implies "
                                 "--affine scene source)")
    a.add_argument("--period", type=float, default=4.0,
                   help="seconds of t per full rotation (--affine)")
    a.add_argument("--zoom", type=float, default=0.15,
                   help="zoom oscillation amplitude (--affine)")
    a.add_argument("--host-encode", dest="device_anim",
                   action="store_false", default=True,
                   help="per-frame HOST re-encode instead of the "
                        "device-side animation path (scene/animate.py)")
    a.set_defaults(fn=cmd_animate)

    pr = sub.add_parser("profile", help="per-stage pipeline timing (JSON)")
    scene_args(pr)
    pr.add_argument("--frames", type=int, default=40)
    pr.set_defaults(fn=cmd_profile)

    g = sub.add_parser("goldens", help="device vs CPU-oracle PNG pairs")
    g.add_argument("--outdir", default="goldens")
    g.add_argument("--tolerance", type=int, default=0)
    g.add_argument("--fine-impl", default="auto",
                   choices=["auto", "pallas", "xla"])
    g.set_defaults(fn=cmd_goldens)

    d = sub.add_parser("dump", help="hexdump a scene's wire encoding")
    scene_args(d)
    d.add_argument("--load", help="load scene from .npz instead")
    d.set_defaults(fn=cmd_dump)

    i = sub.add_parser("info", help="backend / native library status")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
