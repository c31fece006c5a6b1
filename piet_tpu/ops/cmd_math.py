"""Shared fine-raster command math (single source of truth).

The per-command pixel math of the reference's ``renderKernel``
(TestApp/PietRender.metal:457-566), expressed over (tile_h, tile_w) f32
arrays with scalar operands, used by BOTH device implementations:

* ops/fine.py      -- the Pallas GPU kernel (production path),
* ops/fine_xla.py  -- the pure-XLA implementation (portable path and the
                      CPU test vehicle).

``bar`` is an FMA-contraction barrier: the numpy oracle
(raster/cpu_fine.py) rounds every multiply and add separately, so every
product that feeds an add is wrapped in ``bar``.  The GPU kernel's ``bar``
holds (the kernel is bitwise equal to the oracle on the H100); XLA:CPU's
LLVM backend contracts at its own discretion inside large fusions, so
CPU-side image tests carry a small tolerance (tests/_imgcmp.py).

Exactness is structural, not hoped for:

* sqrt rides ``ieee_sqrt`` (exact-residual candidate selection, = np.sqrt
  by construction, whatever the device's sqrt rounds to);
* the sRGB encode is a mul/add/floor/bitcast-only polynomial chain
  (srgb_encode_u32 / scene/color.py::linear_to_srgb_det);
* the per-pixel math is DIVISION-FREE: every quotient the fine math needs
  is a per-COMMAND constant (fill slope m = dx/dy, area scale
  K = -dy/|dx|, line 1/|v|^2), computed once per record by the COARSE pass
  through ``div_det`` -- a seed-independent exact-residual selection that
  the numpy oracle and the C++ golden mirror bitwise -- and shipped as
  operand words.  The per-pixel evaluators (fill_delta, line_field_sq)
  use only multiplies/adds/min/max/selects.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DF_INIT = 1e9
#: Initial SQUARED df for the Pallas kernel's deferred-sqrt accumulation;
#: any value whose sqrt exceeds every stroke threshold gives alpha == 0.0
#: through the saturate, identically to DF_INIT (see line_field_sq).
DF2_INIT = 1e18


def _saturate(v):
    return jnp.clip(v, 0.0, 1.0)


# NOTE on winding-delta QUANTIZATION (tried and reverted): rounding
# fill/edge deltas to multiples of 2^-13 makes f32 area accumulation exact
# and order-free, but any rounding boundary AMPLIFIES 1-ulp device-vs-oracle
# noise in the coverage inputs into a visible code.  Designs that reorder
# the accumulation must instead fix an explicit accumulation-tree order in
# the oracle and replicate it on device -- agreement needs a SHARED order,
# not an order-free one.


# -- Accumulation fields, factored out of the command evaluators so the
# Pallas kernel can apply them directly to its state (and accumulate the
# SQUARED line field, see line_field_sq).


def ieee_sqrt(x, bar):
    """IEEE-correctly-rounded f32 sqrt on every backend.

    A device sqrt need not be correctly rounded, and a 1-ulp difference
    flips the u8 rounding of isolated boundary pixels wherever a resolve
    consumes a sqrt (radial gradients, stroke distance, circles).  This
    wrapper makes the device agree with the oracle BY CONSTRUCTION: take
    the hardware estimate, step +-2 ulp, and pick the candidate minimizing |s^2 - x|
    with the residual computed exactly (Dekker-split products are exact in
    f32; hi*hi - x is Sterbenz-exact) -- the result is seed-independent,
    so numpy's IEEE sqrt trivially lands on the same value and the oracle
    keeps plain np.sqrt.  ~60 ops; used only in resolve paths (never
    per fill/line entry -- line distance accumulates SQUARED, see
    line_field_sq).
    """
    f32 = jnp.float32
    s0 = jnp.sqrt(x)
    ub = jax.lax.bitcast_convert_type(s0, jnp.uint32)
    best_s = s0
    best_a = jnp.full_like(s0, jnp.inf)
    for delta in (-2, -1, 0, 1, 2):
        s = jax.lax.bitcast_convert_type(
            ub + jnp.uint32(delta & 0xFFFFFFFF), f32)
        c = bar(s * f32(4097.0))         # Dekker split (12 + 12 bits)
        hi = c - bar(c - s)
        lo = s - hi
        # hi*hi, 2*hi*lo, lo*lo are all EXACT f32 products; hi*hi - x is
        # Sterbenz-exact; the final two adds round ~2^-45 relative --
        # far below the ~2^-22 inter-candidate gaps.
        d = (bar(hi * hi) - x) + bar(f32(2.0) * bar(hi * lo)) \
            + bar(lo * lo)
        a = jnp.abs(d)
        take = a < best_a
        best_s = jnp.where(take, s, best_s)
        best_a = jnp.where(take, a, best_a)
    return jnp.where(x > 0.0, best_s, s0)


def div_det(a, b, bar):
    """Deterministic shared f32 division: bitwise-equal on every backend.

    A device division need not be correctly rounded (a*rcp(b) with an
    approximate reciprocal), while the numpy oracle divides IEEE.  This
    wrapper is the ieee_sqrt construction applied to division: take the hardware quotient, step
    +-3 representation neighbors, and pick the candidate minimizing
    |a - q*b| with the residual computed through exact Dekker-split
    products (12+12-bit halves multiply exactly; a - qh*bh is
    Sterbenz-exact; the remaining subtractions round ~2^-45 relative,
    far below the ~2^-23 inter-candidate gaps).

    SEED INDEPENDENCE (why oracle == device bitwise): |a - q*b| is
    exactly V-shaped in q with a full inter-candidate step of slope, so
    the computed argmin always lands on one of the two representable
    neighbors of the true quotient; any seed within 2 ulp of the truth
    (the device's error bound; the oracle's IEEE seed trivially) has both
    neighbors inside its +-3 window, and the residual comparison itself
    is built only from exactly-rounded ops -- the same function of
    (a, b, q) on every backend.  Both sides therefore select the same
    winner even where the residual comparison's ~2^-21-relative noise
    makes the selection differ from true IEEE rounding (near-halfway
    quotients); exact ties break toward the even mantissa on both sides.

    Used on per-RECORD vectors in the coarse pass (fill slope/scale,
    line inverse norm, edge intercept) -- never on per-pixel planes.
    """
    f32 = jnp.float32
    q0 = a / b
    cb = bar(b * f32(4097.0))            # Dekker split of b (shared)
    bh = cb - bar(cb - b)
    bl = b - bh
    u0 = jax.lax.bitcast_convert_type(q0, jnp.uint32)
    best_q = q0
    best_r = jnp.full_like(q0, jnp.inf)
    # Evenness rides as f32 0/1; `ev > best_ev` == the candidate is even
    # and the incumbent odd -- exactly `even & ~best_even`.
    best_ev = jnp.zeros_like(q0)
    for delta in (-3, -2, -1, 0, 1, 2, 3):
        uq = u0 + jnp.uint32(delta & 0xFFFFFFFF)
        q = jax.lax.bitcast_convert_type(uq, f32)
        cq = bar(q * f32(4097.0))
        qh = cq - bar(cq - q)
        ql = q - qh
        r = jnp.abs((((a - bar(qh * bh)) - bar(qh * bl)) - bar(ql * bh))
                    - bar(ql * bl))
        ev = f32(1.0) - (uq & jnp.uint32(1)).astype(jnp.int32).astype(f32)
        take = (r < best_r) | ((r == best_r) & (ev > best_ev))
        best_q = jnp.where(take, q, best_q)
        best_ev = jnp.where(take, ev, best_ev)
        best_r = jnp.where(take, r, best_r)
    # Non-finite / zero cases keep the raw quotient (the candidates'
    # bitcast arithmetic wraps into garbage there; callers mask them).
    ok = (b != 0.0) & (jnp.abs(q0) < jnp.inf) & (q0 == q0)
    return jnp.where(ok, best_q, q0)


_INF = float("inf")


def dot2_det(x, y, bar):
    """Contraction-immune x*x + y*y (the line-norm denominator).

    A plain fl(x*x) + fl(y*y) is FMA-bait: a compiler that contracts the
    second square into the add (measured on XLA:CPU inside large fusion
    contexts) shifts the sum by an ulp, and a division constant derived
    from it then differs between compile contexts.  Here every product
    is EXACT by construction (Veltkamp 12+12-bit split squares), so
    fma(a, b, s) == s + fl(a*b) identically and no contraction decision
    can change the result.  The value is slightly MORE accurate than the
    two-rounding form; the numpy oracle (raster/ptcl.py::dot2_det_np)
    and the C++ golden mirror this exact op sequence.
    """
    f32 = jnp.float32

    def sq(v):
        c = bar(v * f32(4097.0))
        h = c - bar(c - v)
        l = v - h
        return bar(h * h), bar(f32(2.0) * bar(h * l)), bar(l * l)

    xh, xm, xl = sq(x)
    yh, ym, yl = sq(y)
    return ((xh + xm) + xl) + ((yh + ym) + yl)


def line_field_sq(arg, X, Y, bar):
    """SQUARED distance field of CmdLine (PietRender.metal:79-97).

    The Pallas kernel accumulates min over the squared field and defers
    the sqrt to the stroke resolve: f32 sqrt is correctly rounded and
    monotone, so sqrt(min(x)) == min(sqrt(x)) bit-exactly.

    Operand words: [sx, sy, ex, ey, hw, inv_denom].  Word 4 (unused by
    the math) carries the emitting stroke's hw + 0.5 threshold (a
    row-cull experiment; kept in the wire format).  Word 5 is the
    coarse-computed div_det(1, |v|^2) -- +inf marks a degenerate
    zero-length segment, which renders as a dot (t = 0; see
    cpu_fine.py)."""
    sx, sy, ex, ey = arg(0), arg(1), arg(2), arg(3)
    inv_denom = arg(5)
    lvx, lvy = ex - sx, ey - sy
    dpx, dpy = X - sx, Y - sy
    dotp = bar(lvx * dpx) + bar(lvy * dpy)
    tpar = jnp.where(inv_denom < _INF,
                     _saturate(bar(dotp * inv_denom)), 0.0)
    fx = bar(lvx * tpar) - dpx
    fy = bar(lvy * tpar) - dpy
    return bar(fx * fx) + bar(fy * fy)


def line_field(arg, X, Y, bar):
    """Distance field of CmdLine over pixel grids (PietRender.metal:79-97)."""
    return ieee_sqrt(line_field_sq(arg, X, Y, bar), bar)


def fill_delta(arg, X, Y, bar):
    """Signed-area delta of CmdFill (mask, delta), PietRender.metal:102-117.

    DIVISION-FREE evaluation of the reference's trapezoid coverage: the
    pixel-row y-window [w1, w0] maps to the segment's x-interval
    [umin, umax], and the signed area is the exact piecewise integral

        Sx = F(umax) - F(umin),  F(u) = min(u, 1) - 0.5 * clamp(u, 0, 1)^2
        delta = Sx * K

    where F is the antiderivative of clamp(1 - u, 0, 1) and the operand
    constants m = div_det(dx, dy) (x slope per unit y) and
    K = div_det(-dy, |dx|) (the y-window/x-interval Jacobian, carrying
    the winding sign) are computed once per command by the coarse pass.
    Equal to the reference's mean-coverage formula a_cov * (w0 - w1)
    (PietRender.metal:508-528) up to its 1e-6 denominator fudge -- and
    unlike it, exactly 0 for fully-uncovered pixels.  Near-vertical
    columns (x-span <= 1e-4) keep the analytic limit of the round-1
    oracle: (1 - clamp(u0)) * (w0 - w1).

    Operand words: [sx, sy, ey, m, K]."""
    sx, sy, ey, m, K = arg(0), arg(1), arg(2), arg(3), arg(4)
    rsy = sy - Y
    rey = ey - Y
    w0 = _saturate(rsy)
    w1 = _saturate(rey)
    mask = w0 != w1
    wa = jnp.minimum(w0, w1)
    wb = jnp.maximum(w0, w1)
    rx = sx - X
    ua = rx + bar(m * (wa - rsy))
    ub = rx + bar(m * (wb - rsy))
    umin = jnp.minimum(ua, ub)
    umax = jnp.maximum(ua, ub)

    def F(u):
        c = _saturate(u)
        return jnp.minimum(u, 1.0) - bar(0.5 * bar(c * c))

    delta = bar((F(umax) - F(umin)) * K)
    # Degenerate-column guard (near-vertical edges; see cpu_fine.py for
    # the rationale and the reference's narrower bug).  u0 is the x at
    # the w0 window end (== ua or ub by the direction of travel).
    u0 = jnp.where(w0 <= w1, ua, ub)
    deg = (1.0 - _saturate(u0)) * (w0 - w1)
    return mask, jnp.where(umax - umin > 1e-4, delta, deg)


def edge_delta(arg, Y, bar):
    """Winding delta of CmdFillEdge (PietRender.metal:119-123)."""
    sgn, ye = arg(0), arg(1)
    return bar(sgn * _saturate(Y - ye + 1.0))


def round_half_even(x):
    """Round to nearest, ties to even (= jnp.round / np.round), from floor
    and exact f32 steps only: x - floor(x) and the parity test are exact,
    and the Pallas Triton route has no rounding primitive."""
    f = jnp.floor(x)
    d = x - f
    odd = (f - 2.0 * jnp.floor(0.5 * f)) != 0.0
    return f + jnp.where((d > 0.5) | ((d == 0.5) & odd), 1.0, 0.0)


def clip_alpha(x, even_odd, bar):
    """Winding -> coverage (the DrawFill alpha formula, also used by
    BeginClip): nonzero rule min(|x|, 1) or even-odd |x - 2 round(x/2)|."""
    eo = jnp.abs(x - 2.0 * round_half_even(0.5 * x))
    nz = jnp.minimum(jnp.abs(x), 1.0)
    return jnp.where(even_odd != 0.0, eo, nz)


def make_commands(X, Y, bar, cov=None, rect_clip=True):
    """Build the 7 command evaluators over pixel grids X, Y.

    Each takes ``(arg, r, g, b, df, area)`` where ``arg(k)`` returns scalar
    operand word k, and returns the updated ``(r, g, b, df, area)``.
    Ordered by reference tag value (Circle=2 .. Solid=8, GenTypes.h:440-495).

    Draw commands read their item's clip rectangle from operand words 8-11
    (piet clip extension); the NO_CLIP default makes the coverage multiply
    an exact *1.0, so unclipped scenes are bit-identical to the reference
    semantics.

    ``cov``: optional thunk returning the current clip-STACK coverage
    plane (the arbitrary-path clip extension); every draw's alpha is
    multiplied by it.  When the plane is all-1.0 (no open clip) that
    multiply is an exact bitwise no-op -- so ``cov=None`` SKIPS it
    entirely, bitwise identically; the Pallas kernel's fast resolve path
    uses that when no clip group is open.  ``rect_clip=False`` likewise
    skips the rect-coverage computation and multiply -- bitwise
    identical for draws whose rect is the NO_CLIP sentinel (the
    META_CLIP_BIT gate, layout/entry_stream.py).
    """
    def apply_cov(arg, alpha):
        """alpha * rect coverage * stack coverage, with exact no-op
        factors skipped at trace time."""
        if rect_clip:
            alpha = alpha * clip_cov(arg)
        if cov is not None:
            alpha = alpha * cov()
        return alpha

    def clip_cov(arg):
        cx0, cy0, cx1, cy1 = arg(8), arg(9), arg(10), arg(11)
        covx = _saturate(jnp.minimum(cx1, X + 1.0) - jnp.maximum(cx0, X))
        covy = _saturate(jnp.minimum(cy1, Y + 1.0) - jnp.maximum(cy0, Y))
        return covx * covy

    def cmd_circle(arg, r, g, b, df, area):
        bx0, by0, bx1, by1 = arg(0), arg(1), arg(2), arg(3)
        cx = bx0 + 0.5 * (bx1 - bx0)
        cy = by0 + 0.5 * (by1 - by0)
        dx = X - cx
        dy = Y - cy
        rad = ieee_sqrt(bar(dx * dx) + bar(dy * dy), bar)
        circle_r = jnp.minimum(cx - bx0, cy - by0)
        alpha = apply_cov(arg, _saturate(circle_r - rad))
        # Blend toward black: color is never encoded for circles
        # (PietRender.metal:488-492).
        keep = 1.0 - alpha
        return r * keep, g * keep, b * keep, df, area

    def cmd_line(arg, r, g, b, df, area):
        field = line_field(arg, X, Y, bar)
        return r, g, b, jnp.minimum(df, field), area

    def _blend(r, g, b, fr, fg, fb, w):
        r = r + bar((fr - r) * w)
        g = g + bar((fg - g) * w)
        b = b + bar((fb - b) * w)
        return r, g, b

    def cmd_stroke(arg, r, g, b, df, area):
        half_width = arg(0)
        fr, fg, fb, fa = arg(1), arg(2), arg(3), arg(4)
        alpha = apply_cov(arg, _saturate(half_width + 0.5 - df))
        w = bar(fa * alpha)
        r, g, b = _blend(r, g, b, fr, fg, fb, w)
        return r, g, b, jnp.full_like(df, DF_INIT), area

    def cmd_fill(arg, r, g, b, df, area):
        mask, delta = fill_delta(arg, X, Y, bar)
        return r, g, b, df, jnp.where(mask, area + delta, area)

    def cmd_fill_edge(arg, r, g, b, df, area):
        return r, g, b, df, area + edge_delta(arg, Y, bar)

    def cmd_draw_fill(arg, r, g, b, df, area):
        backdrop = arg(0)
        fr, fg, fb, fa = arg(1), arg(2), arg(3), arg(4)
        x = area + backdrop
        # word 5 selects the fill rule: 0 = nonzero winding (reference
        # behavior), 1 = even-odd (piet FillRule::EvenOdd; the reference
        # has only the comment formula, PietRender.metal:543).  2*round(x/2)
        # is exact in f32, so the even-odd branch is FMA-immune.
        alpha = apply_cov(arg, clip_alpha(x, arg(5), bar))
        w = bar(fa * alpha)
        r, g, b = _blend(r, g, b, fr, fg, fb, w)
        return r, g, b, df, jnp.zeros_like(area)

    def cmd_solid(arg, r, g, b, df, area):
        fr, fg, fb, fa = arg(0), arg(1), arg(2), arg(3)
        r, g, b = _blend(r, g, b, fr, fg, fb,
                         fa * apply_cov(arg, jnp.float32(1.0)))
        return r, g, b, df, area

    return (cmd_circle, cmd_line, cmd_fill, cmd_stroke, cmd_fill_edge,
            cmd_draw_fill, cmd_solid)


def make_grad_commands(X, Y, bar, cov=None):
    """Gradient resolve evaluators (linear, radial) -- the 2-stop brush
    extension (raster/ptcl.py tags 14/15).  Same contract as
    make_commands' evaluators; operand layout:
      [backdrop, g0, g1, g2, c0r, c0g, c0b, c0a, c1r, c1g, c1b, c1a]
    Linear t = saturate(g0*x + g1*y + g2); radial t = saturate(|p - (g0,
    g1)| * g2).  Color/alpha lerp c0 -> c1 in LINEAR space, then the
    DrawFill nonzero-winding blend (gradient draws carry no rect clip --
    the payload rides those words -- but the clip-STACK coverage ``cov``
    still applies; ``cov=None`` skips that multiply, bitwise identical
    when no clip group is open).  The numpy oracle mirrors this op order
    exactly (raster/cpu_fine.py)."""

    def _grad(radial):
        def cmd(arg, r, g, b, df, area):
            if radial:
                dx = X - arg(1)
                dy = Y - arg(2)
                t = _saturate(ieee_sqrt(bar(dx * dx) + bar(dy * dy), bar)
                              * arg(3))
            else:
                t = _saturate(bar(arg(1) * X) + bar(arg(2) * Y) + arg(3))
            fr = arg(4) + bar((arg(8) - arg(4)) * t)
            fg = arg(5) + bar((arg(9) - arg(5)) * t)
            fb = arg(6) + bar((arg(10) - arg(6)) * t)
            fa = arg(7) + bar((arg(11) - arg(7)) * t)
            x = area + arg(0)
            alpha = jnp.minimum(jnp.abs(x), 1.0)
            if cov is not None:
                alpha = alpha * cov()
            w = bar(fa * alpha)
            r = r + bar((fr - r) * w)
            g = g + bar((fg - g) * w)
            b = b + bar((fb - b) * w)
            return r, g, b, df, jnp.zeros_like(area)
        return cmd

    return _grad(False), _grad(True)


def srgb_encode_u32(ch, bar):
    """Deterministic linear f32 -> u8 code as uint32.

    Mirrors scene/color.py::linear_to_srgb_det operation-for-operation (see
    there for the precision-policy rationale); keep the three in sync.
    x^(1/2.4) is 2^(log2(x)/2.4) with bit-level exponent/mantissa split and
    polynomial log2/exp2: ONLY mul/add/floor/compare/bitcast, all exactly
    rounded on every backend (a device sqrt or division need not be).
    """
    from ..scene.color import SRGB_PE, SRGB_PL
    f32 = jnp.float32
    i32 = jnp.int32
    ch = jnp.clip(ch, 0.0, 1.0)
    lo = ch * f32(12.92)
    u = jax.lax.bitcast_convert_type(ch, jnp.uint32)
    e = (jax.lax.shift_right_logical(u, jnp.uint32(23)).astype(i32)
         - 127).astype(f32)
    m = jax.lax.bitcast_convert_type(
        (u & jnp.uint32(0x007FFFFF)) | jnp.uint32(0x3F800000), f32)
    acc = jnp.full_like(m, f32(SRGB_PL[0]))
    for c in SRGB_PL[1:]:
        acc = bar(acc * m) + f32(c)
    t = (e + acc) * f32(1.0 / 2.4)
    k = jnp.floor(t)
    fr = t - k
    s = jax.lax.bitcast_convert_type(
        jax.lax.shift_left(k.astype(i32) + 127, i32(23)), f32)
    pe = jnp.full_like(fr, f32(SRGB_PE[0]))
    for c in SRGB_PE[1:]:
        pe = bar(pe * fr) + f32(c)
    hi = bar(f32(1.055) * (s * pe)) - f32(0.055)
    srgb = jnp.where(ch < 0.0031308, lo, hi)
    # Values are in [0, 255], so the cast through i32 is exact.
    return round_half_even(srgb * 255.0).astype(jnp.int32).astype(jnp.uint32)


def pack_rgba8(r, g, b, bar):
    """Encode three linear channels and pack RGBA8 into u32 (R low byte)."""
    return (srgb_encode_u32(r, bar) | (srgb_encode_u32(g, bar) << 8)
            | (srgb_encode_u32(b, bar) << 16) | jnp.uint32(0xFF000000))
