"""expand_rows_xla: ragged expansion + row gather vs a numpy model.

Bit-exactness contract: for ANY 32-bit payload (f32 including -0.0, Inf,
NaN bit patterns, or bitcast int32), the expansion must equal the numpy
``np.repeat`` model word-for-word, with all-zero rows past the total.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from piet_tpu.ops.expand import expand_rows_xla

jax.config.update("jax_enable_x64", False)


def _expand_np(rows, counts, cap):
    out = np.zeros((cap,) + rows.shape[1:], rows.dtype)
    src = np.repeat(np.arange(len(counts)), counts)[:cap]
    out[:len(src)] = rows[src]
    return out


def _check(rows, counts, cap):
    got = np.asarray(expand_rows_xla(jnp.asarray(rows), jnp.asarray(counts),
                                     cap))
    want = _expand_np(rows, counts, cap)
    np.testing.assert_array_equal(
        got.view(np.uint32), want.view(np.uint32))


def test_basic_expansion():
    rows = np.arange(20, dtype=np.float32).reshape(5, 4) * 1.5
    counts = np.array([3, 0, 2, 5, 1], np.int32)
    _check(rows, counts, 2048)


def test_special_bit_patterns_roundtrip():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((37, 6)).astype(np.float32)
    rows[0, 0] = -0.0
    rows[1, 1] = np.inf
    rows[2, 2] = -np.inf
    rows[3, 3] = np.nan
    rows[4, 4] = np.float32.__call__(1e-42)      # subnormal
    rows[5, 5] = np.frombuffer(np.uint32(0xDEADBEEF).tobytes(),
                               np.float32)[0]
    counts = rng.integers(0, 4, 37).astype(np.int32)
    _check(rows, counts, 1024)


def test_int32_payload():
    rng = np.random.default_rng(1)
    rows = rng.integers(-2**31, 2**31 - 1, (64, 3), dtype=np.int64
                        ).astype(np.int32)
    counts = rng.integers(0, 9, 64).astype(np.int32)
    got = np.asarray(expand_rows_xla(jnp.asarray(rows), jnp.asarray(counts),
                                     1024))
    np.testing.assert_array_equal(got, _expand_np(rows, counts, 1024))


def test_zero_count_runs_and_multiblock():
    """Long zero-count runs and a source spanning most of the output."""
    rng = np.random.default_rng(2)
    S = 1500
    counts = np.zeros(S, np.int32)
    counts[::7] = rng.integers(1, 6, len(counts[::7])).astype(np.int32)
    counts[3] = 700          # one source spanning most of a block
    rows = rng.standard_normal((S, 5)).astype(np.float32)
    _check(rows, counts, 4096)


def test_cap_not_multiple_of_block():
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    counts = np.array([2, 1, 2], np.int32)
    _check(rows, counts, 1500)


def test_total_exceeds_cap_truncates():
    rows = np.arange(8, dtype=np.float32).reshape(2, 4)
    counts = np.array([900, 900], np.int32)
    _check(rows, counts, 1024)


def test_single_giant_source():
    rows = np.array([[7.0, -1.0]], np.float32)
    counts = np.array([5000], np.int32)
    _check(rows, counts, 8192)


@pytest.mark.parametrize("seed", [3, 4])
def test_fuzz_random(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.integers(1, 4000))
    counts = rng.integers(0, 5, S).astype(np.int32)
    rows = rng.standard_normal((S, int(rng.integers(1, 23)))
                               ).astype(np.float32)
    _check(rows, counts, 4096)


def test_xla_owner_lookup_both_directions():
    """expand_rows_xla picks its owner-lookup formulation by direction
    (search when S > cap, scatter+cummax otherwise) -- pin both against an
    independent numpy expansion."""
    rng = np.random.default_rng(3)
    for S, cap in ((300, 64), (64, 300)):
        counts = rng.integers(0, 4, S).astype(np.int32)
        rows = rng.integers(0, 2**32, (S, 3), dtype=np.uint64)
        rows = rows.astype(np.uint32).view(np.float32)
        want = np.zeros((cap, 3), np.float32)
        p = 0
        for s in range(S):
            for _ in range(int(counts[s])):
                if p < cap:
                    want[p] = rows[s]
                p += 1
        got = np.asarray(expand_rows_xla(jnp.asarray(rows),
                                         jnp.asarray(counts), cap))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
