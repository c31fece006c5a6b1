"""Shared image-comparison policy: the stated tolerances and their reasons.

Precision is float32 throughout, on every path.

GPU (the Pallas fine kernel and the XLA coarse pass, compiled for the
H100): ZERO codes on zero pixels -- bitwise equal to the numpy oracle and
the C++ golden, for the kernel alone and for the whole frame (measured on
an H100 at the 4K tiger and beziers_10k; chip_smoke.py phases 2 and 4).
The reason it holds: every product that feeds an add goes through a
contraction barrier (an explicitly rounded ``add.rn.f32`` in the kernel,
``optimization_barrier`` in the coarse pass), sqrt and division are made
exact by residual selection, and the sRGB encode is mul/add/floor only
(ops/cmd_math.py).

CPU (XLA:CPU, and the kernel in interpret mode): XLA:CPU's LLVM backend
contracts mul+add chains into FMAs inside large fusions (neither
``optimization_barrier`` nor bitcast chains survive), double-rounding a
tiny fraction of pixels by at most 2 codes (two contracted chains can
compound).  The shared math itself is verified bitwise against the numpy
mirror when jitted stand-alone (tests/test_divdet.py).
"""

import numpy as np

#: Max fraction of PIXELS allowed off on CPU (loose at wide tiles:
#: contraction on a per-row intermediate perturbs 128 pixels at once).
CPU_FMA_FRAC = 1e-3

#: GPU tolerance: max code difference and max fraction of pixels.
GPU_MAX_CODES = 0
GPU_MAX_FRAC = 0.0


def assert_images_match(img, gold, err_msg=""):
    """assert_array_equal up to the documented XLA:CPU FMA artifact:
    at most 2 codes (two contracted chains can compound) on a small
    fraction of pixels."""
    img = np.asarray(img)
    gold = np.asarray(gold)
    assert img.shape == gold.shape, (img.shape, gold.shape)
    diff = np.abs(img.astype(np.int32) - gold.astype(np.int32))
    if not (diff > 0).any():
        return
    assert diff.max() <= 2, f"{err_msg} max code diff {diff.max()}"
    frac = (diff.max(-1) > 0).mean()
    assert frac <= CPU_FMA_FRAC, (
        f"{err_msg} {frac:.4%} of pixels differ "
        f"(XLA:CPU FMA tolerance is {CPU_FMA_FRAC:.1%})")


def assert_images_match_gpu(img, gold, err_msg=""):
    """The GPU tolerance (GPU_MAX_CODES on at most GPU_MAX_FRAC of the
    pixels; zero and zero: bitwise)."""
    img = np.asarray(img)
    gold = np.asarray(gold)
    assert img.shape == gold.shape, (img.shape, gold.shape)
    diff = np.abs(img.astype(np.int32) - gold.astype(np.int32))
    frac = (diff.max(-1) > 0).mean()
    assert diff.max() <= GPU_MAX_CODES and frac <= GPU_MAX_FRAC, (
        f"{err_msg} max code diff {diff.max()} on {frac:.6%} of pixels")
