"""Device-side animation (scene/animate.py): the per-frame path with NO
host encode -- geometry computed inside the render jit from scalar t.

Pins (1) structural agreement with the host-built fixture (same topology,
params, layout), (2) bit-exact RENDER of a device-animated frame vs the
CPU oracle fed the device-computed arrays, (3) determinism in t."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.config import RenderConfig
from piet_tpu.renderer.capacity import fit_capacities
from piet_tpu.renderer.renderer import prepare_scene
from piet_tpu.scene import animate
from piet_tpu.scene.fixtures import make_animated_frame
from piet_tpu.scene.scene import Scene

SIZE, N, SEED = 256, 24, 5


def _cfg(tmpl):
    return fit_capacities(tmpl, RenderConfig(
        width=SIZE, height=SIZE, tile_height=16, tile_width=128,
        cmd_capacity=512), bucket=True)


def _fetch_scene(dev, tmpl):
    """Device-animated DeviceScene -> host Scene (live prefix)."""
    n, npts = tmpl.n_items, tmpl.n_points
    return Scene(
        tags=np.asarray(dev.tags[:n]),
        colors=np.asarray(dev.colors_u32[:n]),
        widths=np.asarray(dev.widths[:n]),
        bboxes=np.asarray(dev.bboxes[:n]),
        pt_offset=np.asarray(dev.pt_offset[:n]),
        n_pts=np.asarray(dev.n_pts[:n]),
        points=np.asarray(dev.points[:npts]),
        flags=np.asarray(dev.flags[:n]),
        clips=np.asarray(dev.clips[:n]),
        grads=np.asarray(dev.grads[:n]),
    )


def test_template_layout_matches_host_fixture():
    """t-independent structure agrees with the host fixture at any t:
    same tags, counts, offsets, colors' rgb, widths."""
    tmpl = animate.template_scene(size=SIZE, n=N, seed=SEED)
    other = make_animated_frame(0.9, size=SIZE, n=N, seed=SEED)
    np.testing.assert_array_equal(tmpl.tags, other.tags)
    np.testing.assert_array_equal(tmpl.n_pts, other.n_pts)
    np.testing.assert_array_equal(tmpl.pt_offset, other.pt_offset)
    np.testing.assert_array_equal(tmpl.widths, other.widths)
    np.testing.assert_array_equal(tmpl.colors >> 8, other.colors >> 8)


def test_device_frame_structure():
    """Device-computed points/alpha track the host fixture to f32 trig
    tolerance (device jnp trig vs libm differs in the last ulps)."""
    tmpl = animate.template_scene(size=SIZE, n=N, seed=SEED)
    cfg = _cfg(tmpl)
    base = prepare_scene(tmpl, cfg)
    params = animate.host_params(size=SIZE, n=N, seed=SEED)
    t = 1.3
    dev = jax.jit(lambda tt: animate.animate_device_scene(base, params, tt)
                  )(jnp.float32(t))
    host = make_animated_frame(t, size=SIZE, n=N, seed=SEED)
    got = np.asarray(dev.points[:tmpl.n_points])
    np.testing.assert_allclose(got, host.points, rtol=2e-5, atol=2e-3)
    # Alpha codes match exactly except where floor sits within trig ulp
    # of an integer boundary.
    a_dev = np.asarray(dev.colors_u32[:N]) & 0xFF
    a_host = host.colors & 0xFF
    assert (np.abs(a_dev.astype(int) - a_host.astype(int)) <= 1).all()
    # Quantized bboxes: within one pixel (floor/ceil near-boundary ulp).
    assert (np.abs(np.asarray(dev.bboxes[:N]) - host.bboxes) <= 1).all()


def test_device_frame_renders_bit_exact_vs_oracle():
    """The frame rendered FROM the device-computed arrays is bit-identical
    to the CPU oracle fed those same arrays (the animation stage composes
    with the existing exactness contract)."""
    from piet_tpu.raster.cpu_fine import cpu_render_scene

    tmpl = animate.template_scene(size=SIZE, n=N, seed=SEED)
    cfg = _cfg(tmpl)
    render_t, _ = animate.make_animated_render_fn(
        cfg, size=SIZE, n=N, seed=SEED, fine_impl="xla")
    img_u32, stats = render_t(jnp.float32(0.7))
    img = (np.ascontiguousarray(np.asarray(img_u32)).view(np.uint8)
           .reshape(cfg.height, cfg.width, 4))

    base = prepare_scene(tmpl, cfg)
    params = animate.host_params(size=SIZE, n=N, seed=SEED)
    dev = jax.jit(lambda tt: animate.animate_device_scene(base, params, tt)
                  )(jnp.float32(0.7))
    gold = cpu_render_scene(_fetch_scene(dev, tmpl), cfg)
    # CPU backend carries the documented FMA-contraction tolerance
    # (tests/_imgcmp.py); bit-exactness on the card is pinned by
    # test_gpu_exact.py.
    diff = np.abs(img.astype(int) - gold.astype(int))
    bad = (diff > 2).sum()
    assert bad == 0, f"{bad} channel values differ by > 2 codes"
    assert (diff > 0).mean() < 1e-3


def test_device_frames_deterministic():
    tmpl = animate.template_scene(size=SIZE, n=N, seed=SEED)
    cfg = _cfg(tmpl)
    render_t, _ = animate.make_animated_render_fn(
        cfg, size=SIZE, n=N, seed=SEED, fine_impl="xla")
    a1, _ = render_t(jnp.float32(2.2))
    a2, _ = render_t(jnp.float32(2.2))
    b, _ = render_t(jnp.float32(2.3))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    assert (np.asarray(a1) != np.asarray(b)).any()
