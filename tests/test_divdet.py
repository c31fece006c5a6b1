"""div_det / dot2_det: the deterministic division layer (round 5).

The division-free fine math (ops/cmd_math.py module doc) rests on two
properties, pinned here on CPU (the on-chip twin rides the exactness
suite, tests/test_gpu_exact.py, whose strict image equality consumes
these constants end to end):

1. div_det equals IEEE division wherever the seed is exact (XLA:CPU
   divides IEEE, numpy divides IEEE) -- i.e. the selection, seeded with
   the correctly rounded quotient, returns it.
2. The numpy mirror div_det_np is BITWISE equal to the jitted jnp
   implementation -- the property the coarse pass's wire words rely on.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.smoke

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from piet_tpu.ops.cmd_math import div_det, dot2_det  # noqa: E402
from piet_tpu.raster.ptcl import div_det_np, dot2_det_np  # noqa: E402

F = np.float32


def _cases():
    rng = np.random.default_rng(7)
    a = rng.uniform(-4096, 4096, 4096).astype(F)
    b = rng.uniform(-4096, 4096, 4096).astype(F)
    # Adversarial: tiny/huge ratios, near-integers, exact powers of two,
    # sums of squares (the line-norm domain), zero denominators.
    a2 = np.concatenate([
        a, np.ones(512, F), rng.uniform(0, 1, 512).astype(F),
        (rng.integers(-1000, 1000, 512).astype(F)),
        np.zeros(8, F)])
    b2 = np.concatenate([
        b, rng.uniform(1e-5, 1e5, 512).astype(F),
        np.exp2(rng.integers(-20, 20, 512)).astype(F),
        (rng.integers(-1000, 1000, 512).astype(F)),
        np.concatenate([np.zeros(4, F), np.ones(4, F)])])
    return a2, b2


def test_div_det_equals_ieee_division():
    a, b = _cases()
    got = np.asarray(jax.jit(
        lambda x, y: div_det(x, y, jax.lax.optimization_barrier))(a, b))
    with np.errstate(divide="ignore", invalid="ignore"):
        want = a / b
    ok = np.isfinite(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  want[ok].view(np.uint32))
    # Non-finite quotients pass through the raw division result.
    nf = ~ok
    np.testing.assert_array_equal(np.isnan(got[nf]), np.isnan(want[nf]))


def test_div_det_np_bitwise_matches_jnp():
    a, b = _cases()
    got = np.asarray(jax.jit(
        lambda x, y: div_det(x, y, jax.lax.optimization_barrier))(a, b))
    mirror = div_det_np(a, b)
    ok = np.isfinite(got)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  np.asarray(mirror)[ok].view(np.uint32))


def test_dot2_det_np_bitwise_matches_jnp():
    rng = np.random.default_rng(3)
    x = rng.uniform(-4096, 4096, 4096).astype(F)
    y = rng.uniform(-4096, 4096, 4096).astype(F)
    got = np.asarray(jax.jit(
        lambda u, v: dot2_det(u, v, jax.lax.optimization_barrier))(x, y))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  dot2_det_np(x, y).view(np.uint32))


def test_div_det_seed_independence():
    """Perturbing the seed by up to +-2 ulp (the device rcp error bound)
    must not change the selection -- the property that makes the numpy
    oracle and the rcp-seeded device agree without sharing a seed."""
    a, b = _cases()
    with np.errstate(divide="ignore", invalid="ignore"):
        q = a / b
    ok = np.isfinite(q) & (q != 0.0)
    a, b, q = a[ok], b[ok], q[ok]
    base = div_det_np(a, b)

    def _with_seed(qs):
        # Re-run the selection math with a shifted seed.
        cb = b * F(4097.0)
        bh = cb - (cb - b)
        bl = b - bh
        u0 = np.ascontiguousarray(qs).view(np.uint32)
        best_q = qs.copy()
        best_r = np.full_like(qs, np.inf)
        best_even = np.zeros(qs.shape, bool)
        for delta in (-3, -2, -1, 0, 1, 2, 3):
            qq = (u0 + np.uint32(delta & 0xFFFFFFFF)).view(F)
            cq = qq * F(4097.0)
            qh = cq - (cq - qq)
            ql = qq - qh
            r = np.abs((((a - qh * bh) - qh * bl) - ql * bh) - ql * bl)
            even = (qq.view(np.uint32) & np.uint32(1)) == 0
            take = (r < best_r) | ((r == best_r) & even & ~best_even)
            best_q = np.where(take, qq, best_q)
            best_even = np.where(take, even, best_even)
            best_r = np.where(take, r, best_r)
        return best_q

    for shift in (-2, -1, 1, 2):
        seed = (np.ascontiguousarray(q).view(np.uint32)
                + np.uint32(shift & 0xFFFFFFFF)).view(F)
        good = np.isfinite(seed)
        got = _with_seed(seed.copy())
        np.testing.assert_array_equal(
            got[good].view(np.uint32),
            np.asarray(base)[good].view(np.uint32),
            err_msg=f"seed shift {shift}")
